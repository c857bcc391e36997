"""Environment heightfields: mesh -> regular grid ground model.

PEGASUS environments are plane-aligned (align2plane puts the dominant
plane at z=0, SURVEY 2.3.3) but carry real relief — cobblestones, manhole
covers, grass.  Bullet collides against the full triangle mesh; here the
env collision proxy is a regular heightfield baked once per asset: contact
queries become a bilinear lookup + finite-difference normal, which is
ideal vectorized work (the physics inner loop stays pure elementwise).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp


class Heightfield(NamedTuple):
    grid: jnp.ndarray  # [R, R] height (z) samples
    x0: jnp.ndarray  # scalar, grid origin
    y0: jnp.ndarray
    inv_dx: jnp.ndarray  # scalar, 1 / cell size
    inv_dy: jnp.ndarray

    @classmethod
    def flat(cls, resolution: int = 2, extent: float = 10.0) -> "Heightfield":
        return cls(
            grid=jnp.zeros((resolution, resolution), jnp.float32),
            x0=jnp.float32(-extent / 2),
            y0=jnp.float32(-extent / 2),
            inv_dx=jnp.float32((resolution - 1) / extent),
            inv_dy=jnp.float32((resolution - 1) / extent),
        )


def bake_heightfield(vertices, faces, resolution: int = 128,
                     padding: float = 0.05, n_samples: int = 200_000,
                     rng=None) -> Heightfield:
    """Bake a mesh into a max-z heightfield (host-side, once per asset).

    Surface-samples the mesh and bins the max z per cell; empty cells fill
    from the plane (z=0), matching the align2plane invariant.
    """
    from pegasus_tpu.io.mesh import TriMesh

    mesh = TriMesh(np.asarray(vertices, np.float64), np.asarray(faces, np.int32))
    rng = rng or np.random.default_rng(0)
    pts = mesh.sample_points(n_samples, rng=rng)
    pts = np.concatenate([pts, mesh.vertices], axis=0)

    lo = pts[:, :2].min(axis=0) - padding
    hi = pts[:, :2].max(axis=0) + padding
    size = np.maximum(hi - lo, 1e-6)
    ix = np.clip(((pts[:, 0] - lo[0]) / size[0] * (resolution - 1)).astype(int),
                 0, resolution - 1)
    iy = np.clip(((pts[:, 1] - lo[1]) / size[1] * (resolution - 1)).astype(int),
                 0, resolution - 1)
    grid = np.zeros((resolution, resolution), np.float32)
    np.maximum.at(grid, (iy, ix), pts[:, 2].astype(np.float32))
    return Heightfield(
        grid=jnp.asarray(grid),
        x0=jnp.float32(lo[0]),
        y0=jnp.float32(lo[1]),
        inv_dx=jnp.float32((resolution - 1) / size[0]),
        inv_dy=jnp.float32((resolution - 1) / size[1]),
    )


def height_at(hf: Heightfield, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bilinear ground height at (x, y); outside the grid -> 0 (the plane)."""
    r = hf.grid.shape[0]
    fx = (x - hf.x0) * hf.inv_dx
    fy = (y - hf.y0) * hf.inv_dy
    inside = (fx >= 0) & (fx <= r - 1) & (fy >= 0) & (fy <= r - 1)
    fx = jnp.clip(fx, 0.0, r - 1 - 1e-5)
    fy = jnp.clip(fy, 0.0, r - 1 - 1e-5)
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    tx = fx - x0
    ty = fy - y0
    g = hf.grid
    h = (
        g[y0, x0] * (1 - tx) * (1 - ty)
        + g[y0, x0 + 1] * tx * (1 - ty)
        + g[y0 + 1, x0] * (1 - tx) * ty
        + g[y0 + 1, x0 + 1] * tx * ty
    )
    return jnp.where(inside, h, 0.0)


def normal_at(hf: Heightfield, x: jnp.ndarray, y: jnp.ndarray,
              eps: float = 1e-2) -> jnp.ndarray:
    """[..., 3] unit ground normal via central differences."""
    hx = (height_at(hf, x + eps, y) - height_at(hf, x - eps, y)) / (2 * eps)
    hy = (height_at(hf, x, y + eps) - height_at(hf, x, y - eps)) / (2 * eps)
    n = jnp.stack([-hx, -hy, jnp.ones_like(hx)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)
