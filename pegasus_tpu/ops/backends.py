"""The one compositor choice, keyed by the platform JAX runs on.

``gpu`` gets the Pallas Triton-route kernel (ops/rasterize_pallas.py);
``cpu`` gets the tiled XLA compositor (ops/rasterize_tiled.py), which is
what the tests run.  Any other platform is an error rather than a silent
fallback.  Every generation, validation and benchmark path asks here.
"""

from __future__ import annotations

import jax


def default_rasterize_fn(platform: str | None = None):
    """Rasterizer for ``platform`` (default: that of ``jax.devices()[0]``)."""
    if platform is None:
        platform = jax.devices()[0].platform
    if platform == "gpu":
        from pegasus_tpu.ops.rasterize_pallas import rasterize_pallas

        return rasterize_pallas
    if platform == "cpu":
        from pegasus_tpu.ops.rasterize_tiled import rasterize_tiled

        return rasterize_tiled
    raise ValueError(f"no compositor for platform {platform!r}")
