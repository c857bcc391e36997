"""Tiled rasterizer: XLA backend over shared tile bins.

The CPU compositor and the differentiable training path (the Pallas
kernel in rasterize_pallas.py is the GPU compositor).  Consumes the
depth-ordered per-tile entry
lists built by ops/binning.py, pads each tile's segment to a static budget
and composites with dense [n_tiles, px, chunk] vector math + batched
matmuls.  Semantics are pinned to the golden renderer
(ops/rasterize_ref.py) by a >40 dB PSNR gate in tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.ops import binning
from pegasus_tpu.ops.binning import TileBins, bin_splats
from pegasus_tpu.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu.ops.rasterize_ref import RenderOutputs

_PREC = Precision.HIGHEST


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def composite_tiles_xla(
    bins: TileBins,
    width: int,
    height: int,
    background: jnp.ndarray,
    max_objects: int = 8,
    max_per_tile: int = 1024,
    chunk: int = 256,
) -> RenderOutputs:
    tile = bins.tile
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = ntx * nty
    px_per_tile = tile * tile
    k = max_objects
    chunk = min(chunk, max_per_tile)

    params = bins.params_t.T  # [M_pad, 16]
    m_total = params.shape[0]
    counts = jnp.minimum(bins.tile_count, max_per_tile)
    l_idx = jnp.arange(max_per_tile, dtype=jnp.int32)
    pos = jnp.clip(bins.tile_start[:, None] + l_idx[None, :], 0, m_total - 1)
    entry_valid = l_idx[None, :] < counts[:, None]
    g = params[pos]  # [n_tiles, L, 16]

    g_opac = jnp.where(entry_valid, g[..., binning.P_OPAC], 0.0)
    obj_id = g[..., binning.P_OBJ].astype(jnp.int32)
    g_onehot = jax.nn.one_hot(jnp.clip(obj_id, 0, k - 1), k, dtype=jnp.float32)
    g_feat = jnp.concatenate(
        [
            g[..., binning.P_R : binning.P_B + 1],
            g[..., binning.P_DEPTH : binning.P_DEPTH + 1],
            jnp.ones_like(g_opac)[..., None],
            g_onehot,
        ],
        axis=-1,
    )  # [n_tiles, L, 5 + K]
    g_is_env = g[..., binning.P_ENV] > 0.5

    # per-tile pixel centers
    t_ids = jnp.arange(n_tiles, dtype=jnp.int32)
    in_y = jnp.arange(tile, dtype=jnp.float32)
    in_x = jnp.arange(tile, dtype=jnp.float32)
    pix_y = ((t_ids // ntx) * tile)[:, None, None] + in_y[None, :, None]
    pix_x = ((t_ids % ntx) * tile)[:, None, None] + in_x[None, None, :]
    pxs = jnp.broadcast_to(pix_x, (n_tiles, tile, tile)).reshape(n_tiles, -1)
    pys = jnp.broadcast_to(pix_y, (n_tiles, tile, tile)).reshape(n_tiles, -1)

    n_chunks = _cdiv(max_per_tile, chunk)
    f_dim = 5 + k

    def body(carry, c_i):
        t_full, t_ne, acc, acc_ne, amodal_log = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, c_i * chunk, chunk, axis=1)
        gm = sl(g)
        opac = sl(g_opac)
        feat = sl(g_feat)
        is_env = sl(g_is_env)

        dx = pxs[:, :, None] - gm[:, None, :, binning.P_MX]
        dy = pys[:, :, None] - gm[:, None, :, binning.P_MY]
        a = gm[:, None, :, binning.P_CA]
        b = gm[:, None, :, binning.P_CB]
        c = gm[:, None, :, binning.P_CC]
        rad = gm[:, None, :, binning.P_RADIUS]
        power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
        alpha = jnp.minimum(opac[:, None, :] * jnp.exp(jnp.minimum(power, 0.0)), 0.99)
        keep = (
            (power <= 0.0)
            & (alpha >= 1.0 / 255.0)
            & (jnp.abs(dx) <= rad)
            & (jnp.abs(dy) <= rad)
        )
        alphas = jnp.where(keep, alpha, 0.0)  # [T, P, C]

        log1m = jnp.log1p(-alphas)
        excl = jnp.exp(jnp.cumsum(log1m, axis=2) - log1m)
        w_full = alphas * excl * t_full[..., None]
        acc = acc + jnp.einsum("tpc,tcf->tpf", w_full, feat, precision=_PREC)
        t_full = t_full * jnp.exp(jnp.sum(log1m, axis=2))

        alphas_ne = jnp.where(is_env[:, None, :], 0.0, alphas)
        log1m_ne = jnp.log1p(-alphas_ne)
        excl_ne = jnp.exp(jnp.cumsum(log1m_ne, axis=2) - log1m_ne)
        w_ne = alphas_ne * excl_ne * t_ne[..., None]
        acc_ne = acc_ne + jnp.einsum(
            "tpc,tck->tpk", w_ne, feat[..., 5:], precision=_PREC
        )
        t_ne = t_ne * jnp.exp(jnp.sum(log1m_ne, axis=2))

        amodal_log = amodal_log + jnp.einsum(
            "tpc,tck->tpk", log1m, feat[..., 5:], precision=_PREC
        )
        return (t_full, t_ne, acc, acc_ne, amodal_log), None

    init = (
        jnp.ones((n_tiles, px_per_tile), jnp.float32),
        jnp.ones((n_tiles, px_per_tile), jnp.float32),
        jnp.zeros((n_tiles, px_per_tile, f_dim), jnp.float32),
        jnp.zeros((n_tiles, px_per_tile, k), jnp.float32),
        jnp.zeros((n_tiles, px_per_tile, k), jnp.float32),
    )
    (t_full, _t_ne, acc, acc_ne, amodal_log), _ = jax.lax.scan(
        body, init, jnp.arange(n_chunks)
    )

    background = jnp.asarray(background, jnp.float32)

    def untile(x):
        ch = x.shape[-1]
        x = x.reshape(nty, ntx, tile, tile, ch)
        x = jnp.transpose(x, (0, 2, 1, 3, 4)).reshape(nty * tile, ntx * tile, ch)
        return x[:height, :width]

    rgb = untile(acc[..., 0:3]) + untile(t_full[..., None]) * background[None, None, :]
    return RenderOutputs(
        rgb=rgb,
        depth=untile(acc[..., 3:4])[..., 0],
        alpha=untile(acc[..., 4:5])[..., 0],
        seg_weights=untile(acc[..., 5:]),
        vis_weights=untile(acc_ne),
        amodal=1.0 - jnp.exp(untile(amodal_log)),
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "width", "height", "max_objects", "tile", "max_per_tile", "chunk",
        "a_small", "big_budget", "a_big",
    ),
)
def rasterize_projected_tiled(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    background: jnp.ndarray,
    max_objects: int = 8,
    tile: int = 16,
    max_per_tile: int = 1024,
    chunk: int = 256,
    a_small: int = 4,
    big_budget: int = 16384,
    a_big: int = 36,
    abs_grad_sink: jnp.ndarray | None = None,
) -> RenderOutputs:
    """``abs_grad_sink`` ([N, 2] zeros) routes the entry gather through
    the binning's structure-aware VJP, whose cotangent w.r.t. the sink is
    the per-splat sum of |per-entry mean2d cotangents| (AbsGS)."""
    bins = bin_splats(
        proj, width, height, tile=tile,
        a_small=a_small, big_budget=big_budget, a_big=a_big, lane_pad=128,
        with_entry_origin=abs_grad_sink is not None,
        abs_grad_sink=abs_grad_sink,
    )
    return composite_tiles_xla(
        bins, width, height, background,
        max_objects=max_objects, max_per_tile=max_per_tile, chunk=chunk,
    )


def rasterize_tiled(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    max_objects: int = 8,
    tile: int = 16,
    max_per_tile: int = 1024,
    chunk: int = 256,
    a_small: int = 4,
    big_budget: int = 16384,
    a_big: int = 36,
    dup_factor: int = 0,  # legacy, unused (kept for call compatibility)
) -> RenderOutputs:
    """Drop-in alternative to rasterize_reference (same RenderOutputs)."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    big_budget = min(big_budget, cloud.num_splats)
    return rasterize_projected_tiled(
        proj,
        cam.width,
        cam.height,
        jnp.asarray(background, jnp.float32),
        max_objects=max_objects,
        tile=tile,
        max_per_tile=max_per_tile,
        chunk=chunk,
        a_small=a_small,
        big_budget=big_budget,
        a_big=a_big,
    )
