"""k-nearest-neighbor distances in blocked JAX.

Replacement for the reference's ``simple-knn`` CUDA extension
(``distCUDA2``: mean squared distance to the 3 nearest neighbors, used to
initialize splat scales — reference: src/gs/gaussian_model.py:25,144-149).
Blocked pairwise distances keep memory at O(N * block) and map onto the
matrix products via the |a-b|^2 = |a|^2 + |b|^2 - 2ab expansion.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.lax import Precision

_PREC = Precision.HIGHEST


@functools.partial(jax.jit, static_argnames=("k", "block"))
def mean_knn_dist2(points: jnp.ndarray, k: int = 3, block: int = 2048) -> jnp.ndarray:
    """[N] mean SQUARED distance to each point's k nearest neighbors
    (matches distCUDA2 semantics: mean of the k smallest nonzero d^2)."""
    n = points.shape[0]
    pad = (-n) % block
    pts = jnp.pad(points.astype(jnp.float32), ((0, pad), (0, 0)), constant_values=jnp.inf)
    n_pad = pts.shape[0]
    sq = jnp.sum(jnp.where(jnp.isfinite(pts), pts, 0.0) ** 2, axis=-1)
    valid = jnp.isfinite(pts[:, 0])

    def body(carry, i):
        # top-k smallest distances seen so far for every point: [N_pad, k]
        best = carry
        blk = jax.lax.dynamic_slice_in_dim(pts, i * block, block, axis=0)
        blk_sq = jax.lax.dynamic_slice_in_dim(sq, i * block, block, axis=0)
        blk_valid = jax.lax.dynamic_slice_in_dim(valid, i * block, block, axis=0)
        blk0 = jnp.where(blk_valid[:, None], blk, 0.0)
        d2 = (
            sq[:, None]
            + blk_sq[None, :]
            - 2.0
            * jnp.matmul(
                jnp.where(valid[:, None], pts, 0.0),
                blk0.T,
                precision=_PREC,
            )
        )
        d2 = jnp.maximum(d2, 0.0)
        # exclude self and padding
        row_ids = jnp.arange(n_pad)[:, None]
        col_ids = i * block + jnp.arange(block)[None, :]
        d2 = jnp.where(
            (row_ids == col_ids) | ~blk_valid[None, :], jnp.inf, d2
        )
        merged = jnp.concatenate([best, d2], axis=1)
        best = -jax.lax.top_k(-merged, k)[0]
        return best, None

    init = jnp.full((n_pad, k), jnp.inf)
    best, _ = jax.lax.scan(body, init, jnp.arange(n_pad // block))
    mean_d2 = jnp.mean(best, axis=1)
    return mean_d2[:n]
