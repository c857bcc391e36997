"""Golden-model rasterizer: exact alpha-compositing semantics in plain JAX.

One pass over depth-sorted splats emits EVERY modality the PEGASUS pipeline
needs — RGB, expected depth, accumulated alpha, per-object visible weights
(with and without the environment) and per-object amodal accumulations.
The reference needs 3 + N_objects CUDA rasterizer invocations per frame for
the same outputs (reference: pegasus.py:293-332, src/gs/render.py:36-129)
and decodes masks by color-distance thresholding (src/gs/render.py:62-63,
90-93); here masks are exact functions of per-object compositing weights.

Front-to-back compositing is reformulated as a scan over depth-ordered
splat chunks with an exclusive cumulative product of (1 - alpha) inside the
chunk — a fully vectorized, associative form of the CUDA loop that XLA maps
onto elementwise kernels and matrix products.  This file favors clarity
over speed; it is the parity oracle for the tiled/Pallas backends.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision

_PREC = Precision.HIGHEST

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.ops.projection import (
    ProjectedGaussians,
    project_gaussians,
    splat_alpha_at_pixels,
)


class RenderOutputs(NamedTuple):
    rgb: jnp.ndarray  # [H, W, 3] composited color incl. background
    depth: jnp.ndarray  # [H, W] expected camera-space depth (sum w_i * z_i)
    alpha: jnp.ndarray  # [H, W] accumulated opacity of the full scene
    seg_weights: jnp.ndarray  # [H, W, K] per-object visible weight, full scene
    vis_weights: jnp.ndarray  # [H, W, K] same but environment splats removed
    amodal: jnp.ndarray  # [H, W, K] per-object standalone accumulated alpha
    # scalar bool: True when an entry-capped binning truncated LIVE entries
    # (bottom-right tiles silently lose far splats; raise entry_cap).  The
    # golden/tiled backends never truncate and always report False.
    overflow: jnp.ndarray = False


def _pixel_grid(width: int, height: int):
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def rasterize_projected(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    background: jnp.ndarray,
    max_objects: int = 8,
    chunk: int = 256,
) -> RenderOutputs:
    """Composite projected splats over all pixels.

    max_objects: static bound on distinct object ids (env id 0 occupies
    channel 0; object ids 1..max_objects-1 map to their own channel).
    """
    n = proj.mean_x.shape[0]
    pad = (-n) % chunk
    if pad:
        proj = jax.tree.map(
            lambda x: jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1)), proj
        )
        proj = proj._replace(valid=proj.valid.at[n:].set(False))
    n_padded = proj.mean_x.shape[0]
    n_chunks = n_padded // chunk

    # depth-ascending order among valid splats (invalid pushed to the back)
    sort_key = jnp.where(proj.valid, proj.depth, jnp.inf)
    order = jnp.argsort(sort_key)
    proj = jax.tree.map(lambda x: x[order], proj)

    px, py = _pixel_grid(width, height)
    p = px.shape[0]
    k = max_objects

    onehot = jax.nn.one_hot(
        jnp.clip(proj.object_id, 0, k - 1), k, dtype=jnp.float32
    )  # [N, K]
    is_env = proj.object_id == 0

    def body(carry, idx):
        (t_full, t_noenv, rgb, depth, seg_full, seg_noenv, amodal_log) = carry
        sl = jax.lax.dynamic_slice_in_dim
        start = idx * chunk
        cproj = jax.tree.map(lambda x: sl(x, start, chunk, axis=0), proj)
        c_onehot = sl(onehot, start, chunk, axis=0)  # [C, K]
        c_env = sl(is_env, start, chunk, axis=0)  # [C]

        alphas = splat_alpha_at_pixels(cproj, px, py)  # [P, C]

        # full-scene compositing weights: w_i = alpha_i * prod_{j<i}(1-alpha_j)
        log1m = jnp.log1p(-alphas)  # alphas <= 0.99 -> safe
        excl = jnp.exp(jnp.cumsum(log1m, axis=1) - log1m)  # exclusive cumprod
        w_full = alphas * excl * t_full[:, None]  # [P, C]

        c_rgb = jnp.stack([cproj.color_r, cproj.color_g, cproj.color_b], axis=1)
        rgb = rgb + jnp.matmul(w_full, c_rgb, precision=_PREC)  # [P, 3]
        depth = depth + jnp.matmul(w_full, cproj.depth, precision=_PREC)  # [P]
        seg_full = seg_full + jnp.matmul(w_full, c_onehot, precision=_PREC)  # [P, K]
        t_full = t_full * jnp.exp(jnp.sum(log1m, axis=1))

        # environment-free compositing (the reference's mask quirk:
        # objects are never occluded by the env in mask renders,
        # src/gs/render.py:81-83)
        alphas_ne = jnp.where(c_env[None, :], 0.0, alphas)
        log1m_ne = jnp.log1p(-alphas_ne)
        excl_ne = jnp.exp(jnp.cumsum(log1m_ne, axis=1) - log1m_ne)
        w_ne = alphas_ne * excl_ne * t_noenv[:, None]
        seg_noenv = seg_noenv + jnp.matmul(w_ne, c_onehot, precision=_PREC)
        t_noenv = t_noenv * jnp.exp(jnp.sum(log1m_ne, axis=1))

        # amodal: per object, log prod (1 - alpha) over ITS OWN splats only
        amodal_log = amodal_log + jnp.matmul(log1m, c_onehot, precision=_PREC)  # [P, K]

        return (t_full, t_noenv, rgb, depth, seg_full, seg_noenv, amodal_log), None

    init = (
        jnp.ones((p,), jnp.float32),
        jnp.ones((p,), jnp.float32),
        jnp.zeros((p, 3), jnp.float32),
        jnp.zeros((p,), jnp.float32),
        jnp.zeros((p, k), jnp.float32),
        jnp.zeros((p, k), jnp.float32),
        jnp.zeros((p, k), jnp.float32),
    )
    (t_full, _t_ne, rgb, depth, seg_full, seg_noenv, amodal_log), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks)
    )

    background = jnp.asarray(background, jnp.float32)
    rgb = rgb + t_full[:, None] * background[None, :]
    amodal = 1.0 - jnp.exp(amodal_log)

    return RenderOutputs(
        rgb=rgb.reshape(height, width, 3),
        depth=depth.reshape(height, width),
        alpha=(1.0 - t_full).reshape(height, width),
        seg_weights=seg_full.reshape(height, width, k),
        vis_weights=seg_noenv.reshape(height, width, k),
        amodal=amodal.reshape(height, width, k),
    )


def rasterize_reference(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
    chunk: int = 256,
) -> RenderOutputs:
    """Project + composite a full scene cloud for one camera."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    return rasterize_projected(
        proj,
        cam.width,
        cam.height,
        jnp.asarray(background, jnp.float32),
        max_objects=max_objects,
        chunk=chunk,
    )
