"""Renderer backend self-validation (PSNR gates as a library call).

BASELINE.md gates renderer parity at PSNR > 40 dB on composed scenes.
The test-suite enforces it on fixed fixtures; this utility lets users run
the same gate on THEIR scenes/backends (e.g. after changing binning
budgets or tile sizes):

    from pegasus_tpu.ops.validate import compare_backends
    report = compare_backends(scene, cam, max_objects=8)
    assert report["rgb_psnr_db"] > 40
"""

from __future__ import annotations

import numpy as np

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud


def psnr_db(a, b, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(peak**2 / mse)


def compare_backends(
    scene: GaussianCloud,
    cam: Camera,
    backend: str = "auto",
    max_objects: int = 8,
    background=(0.0, 0.0, 0.0),
    **backend_kwargs,
) -> dict:
    """Render `scene` with the golden compositor and the chosen fast
    backend; return per-channel PSNR and mask agreement."""
    from pegasus_tpu.ops.backends import default_rasterize_fn
    from pegasus_tpu.ops.rasterize_ref import rasterize_reference

    if backend == "auto":
        fast = default_rasterize_fn()
    elif backend == "pallas":
        from pegasus_tpu.ops.rasterize_pallas import rasterize_pallas as fast
    elif backend == "tiled":
        from pegasus_tpu.ops.rasterize_tiled import rasterize_tiled as fast
    else:
        raise ValueError(f"unknown backend {backend}")

    ref = rasterize_reference(
        scene, cam, background=background, max_objects=max_objects
    )
    out = fast(
        scene, cam, background=background, max_objects=max_objects,
        **backend_kwargs,
    )

    depth_peak = max(float(np.asarray(ref.depth).max()), 1e-6)
    report = {
        "backend": fast.__name__,
        "rgb_psnr_db": psnr_db(ref.rgb, out.rgb),
        "depth_psnr_db": psnr_db(ref.depth, out.depth, peak=depth_peak),
        "alpha_max_err": float(
            np.abs(np.asarray(ref.alpha) - np.asarray(out.alpha)).max()
        ),
    }
    for name in ("seg_weights", "vis_weights", "amodal"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        report[f"{name}_psnr_db"] = psnr_db(a, b)
        report[f"{name}_mask_disagree"] = float(
            np.mean((a >= 0.9) != (b >= 0.9))
        )
    report["pass_40db"] = all(
        report[k] > 40.0 for k in report if k.endswith("_psnr_db")
    )
    return report
