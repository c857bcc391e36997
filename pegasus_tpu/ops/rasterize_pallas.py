"""Pallas GPU compositor (Triton route): fused per-tile splat compositing.

The XLA backend (rasterize_tiled.py) materializes dense
[tiles, px, chunk] intermediates (alphas, log-terms, cumulative products,
weights) in device memory and truncates every tile at a static
``max_per_tile``.  This kernel keeps the whole per-tile pipeline in
registers, in the shape of the CUDA reference's ``renderCUDA``:

  grid = one program per 16x16 image tile, the 256 pixels as the block's
  vector;
  each program loads its own segment (``tile_start``/``tile_count``) of
  the transposed entry parameter matrix [16, M] built by ops/binning.py
  (entries depth-ordered within contiguous per-tile segments);
  a ``fori_loop`` walks the segment in power-of-two chunks with masked row
  loads, evaluates per-pixel alphas, turns front-to-back 'over' into an
  exclusive cumulative sum in log space, and accumulates every modality
  channel with [px, chunk] @ [chunk, F_OUT] products into one
  per-pixel accumulator.

Output channel layout (F_OUT columns per pixel, F_OUT = the next power of
two >= 5+3K+2):
  0:3 rgb (premultiplied), 3 depth, 4 alpha, 5:5+K seg_full,
  5+K:5+2K vis (environment excluded), 5+2K:5+3K amodal log-transmittance,
  5+3K t_full (scene transmittance), 5+3K+1 t_noenv.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.lax import Precision

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.ops import binning
from pegasus_tpu.ops.binning import TileBins, bin_splats
from pegasus_tpu.ops.projection import ProjectedGaussians, project_gaussians
from pegasus_tpu.ops.rasterize_ref import RenderOutputs

# chunk 16 / 16 warps: the fastest of the (chunk, warps) pairs tried on an
# H100 at both bench scenes (chunk 16-64, warps 4-16); wider chunks or
# fewer warps spill registers (PERF.md)
DEFAULT_CHUNK = 16
NUM_WARPS = 16


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def out_channels(max_objects: int) -> int:
    """Padded per-pixel output width: 5+3K+2 rounded up to a power of two
    (and at least 16, the smallest operand width of a Triton product)."""
    return max(16, _next_pow2(5 + 3 * max_objects + 2))


def _composite_kernel(
    start_ref,  # [n_tiles] i32: first entry of each tile's segment
    count_ref,  # [n_tiles] i32: entry count of each tile
    params_ref,  # [PARAM_DIM, M_pad] f32
    out_ref,  # [PX, F_OUT] f32 block of this tile
    *,
    tile: int,
    ntx: int,
    chunk: int,
    max_objects: int,
):
    i = pl.program_id(0)
    start = start_ref[i]
    count = count_ref[i]
    px_n = tile * tile
    k = max_objects
    f_out = out_ref.shape[-1]

    lin = jax.lax.broadcasted_iota(jnp.int32, (px_n, 1), 0)
    pxs = (lin % tile + (i % ntx) * tile).astype(jnp.float32)  # [PX, 1]
    pys = (lin // tile + (i // ntx) * tile).astype(jnp.float32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)
    # feature column c of entry e: which output channel entry e feeds
    col = jax.lax.broadcasted_iota(jnp.int32, (chunk, f_out), 1)
    col_f = col.astype(jnp.float32)

    def body(c_i, carry):
        t_full, t_ne, acc = carry
        off = c_i * chunk
        ok = off + lane < count

        def load(r):  # [chunk] parameter row r of this chunk's entries
            return plgpu.load(
                params_ref.at[r, pl.ds(start + off, chunk)],
                mask=ok, other=0.0,
            )

        def row(r):  # as a row [1, chunk], broadcast against pixels
            return load(r)[None, :]

        mx, my = row(binning.P_MX), row(binning.P_MY)
        ca, cb, cc = row(binning.P_CA), row(binning.P_CB), row(binning.P_CC)
        opac, rad = row(binning.P_OPAC), row(binning.P_RADIUS)
        obj_v = load(binning.P_OBJ)

        dx = pxs - mx  # [PX, chunk]
        dy = pys - my
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = jnp.minimum(opac * jnp.exp(jnp.minimum(power, 0.0)), 0.99)
        keep = (
            (power <= 0.0)
            & (alpha >= 1.0 / 255.0)
            & (jnp.abs(dx) <= rad)
            & (jnp.abs(dy) <= rad)
            & ok[None, :]
        )
        alphas = jnp.where(keep, alpha, 0.0)
        log1m = jnp.log1p(-alphas)
        excl = jnp.exp(jnp.cumsum(log1m, axis=1) - log1m)
        w_full = alphas * excl * t_full

        is_env = obj_v[None, :] < 0.5  # [1, chunk]
        alphas_ne = jnp.where(is_env, 0.0, alphas)
        log1m_ne = jnp.where(is_env, 0.0, log1m)
        excl_ne = jnp.exp(jnp.cumsum(log1m_ne, axis=1) - log1m_ne)
        w_ne = alphas_ne * excl_ne * t_ne

        # [chunk, F_OUT] feature matrices, one per weight kind: each puts
        # its entries' values in the output columns that kind feeds
        # ids >= K share channel K-1, as in the golden renderer
        obj_c = jnp.minimum(obj_v, float(k - 1))[:, None]

        def onehot_at(base):
            return jnp.where(jnp.abs(col_f - base - obj_c) < 0.5, 1.0, 0.0)

        def at(c, r):  # parameter row r in column c
            return jnp.where(col == c, load(r)[:, None], 0.0)

        feat_full = (
            at(0, binning.P_R) + at(1, binning.P_G)
            + at(2, binning.P_B) + at(3, binning.P_DEPTH)
            + jnp.where(col == 4, 1.0, 0.0) + onehot_at(5.0)
        )

        def dot(w, f):
            return jax.lax.dot(
                w, f, precision=Precision.HIGHEST,
                preferred_element_type=jnp.float32,
            )

        acc = (
            acc
            + dot(w_full, feat_full)
            + dot(w_ne, onehot_at(5.0 + k))
            + dot(log1m, onehot_at(5.0 + 2 * k))
        )
        t_full = t_full * jnp.exp(jnp.sum(log1m, axis=1, keepdims=True))
        t_ne = t_ne * jnp.exp(jnp.sum(log1m_ne, axis=1, keepdims=True))
        return t_full, t_ne, acc

    init = (
        jnp.ones((px_n, 1), jnp.float32),
        jnp.ones((px_n, 1), jnp.float32),
        jnp.zeros((px_n, f_out), jnp.float32),
    )
    n_chunks = (count + chunk - 1) // chunk
    t_full, t_ne, acc = jax.lax.fori_loop(0, n_chunks, body, init)
    out_col = jax.lax.broadcasted_iota(jnp.int32, (px_n, f_out), 1)
    out_ref[...] = (
        acc
        + jnp.where(out_col == 5 + 3 * k, t_full, 0.0)
        + jnp.where(out_col == 5 + 3 * k + 1, t_ne, 0.0)
    )


def composite_tiles_pallas(
    bins: TileBins,
    width: int,
    height: int,
    background: jnp.ndarray,
    max_objects: int = 8,
    chunk: int = DEFAULT_CHUNK,
    interpret: bool = False,
) -> RenderOutputs:
    """Composite binned entries.  ``bins.params_t`` must carry at least
    ``chunk`` lanes of padding past the last entry (``lane_pad >= chunk``),
    so every chunk's row loads stay in bounds."""
    if chunk < 16 or chunk & (chunk - 1):
        raise ValueError(f"chunk must be a power of two >= 16, got {chunk}")
    tile = bins.tile
    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    n_tiles = ntx * nty
    px_n = tile * tile
    k = max_objects
    f_out = out_channels(k)

    kernel = functools.partial(
        _composite_kernel, tile=tile, ntx=ntx, chunk=chunk, max_objects=k,
    )
    out = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        out_specs=pl.BlockSpec((None, px_n, f_out), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n_tiles, px_n, f_out), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="composite_tiles",
    )(bins.tile_start, bins.tile_count, bins.params_t)

    background = jnp.asarray(background, jnp.float32)

    def untile(x):
        ch = x.shape[-1]
        x = x.reshape(nty, ntx, tile, tile, ch)
        x = jnp.transpose(x, (0, 2, 1, 3, 4)).reshape(nty * tile, ntx * tile, ch)
        return x[:height, :width]

    acc = untile(out[..., 0 : 5 + 2 * k])
    amodal_log = untile(out[..., 5 + 2 * k : 5 + 3 * k])
    t_full = untile(out[..., 5 + 3 * k : 5 + 3 * k + 1])[..., 0]

    rgb = acc[..., 0:3] + t_full[..., None] * background[None, None, :]
    return RenderOutputs(
        rgb=rgb,
        depth=acc[..., 3],
        alpha=acc[..., 4],
        seg_weights=acc[..., 5 : 5 + k],
        vis_weights=acc[..., 5 + k : 5 + 2 * k],
        amodal=1.0 - jnp.exp(amodal_log),
        overflow=bins.overflow,
    )


LARGE_SCENE_SPLATS = 500_000
MEDIUM_SCENE_SPLATS = 300_000
SMALL_SCENE_SPLATS = 150_000


def rasterize_pallas(
    cloud: GaussianCloud,
    cam: Camera,
    background=(0.0, 0.0, 0.0),
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    **kwargs,
) -> RenderOutputs:
    """Drop-in alternative to rasterize_reference (same RenderOutputs);
    ``kwargs`` as for rasterize_projected_pallas."""
    proj = project_gaussians(cloud, cam, sh_degree, scaling_modifier)
    return rasterize_projected_pallas(
        proj, cam.width, cam.height, jnp.asarray(background, jnp.float32),
        **kwargs,
    )


def binning_defaults(
    num_splats: int,
    a_small: int | None = None,
    big_budget: int | None = None,
    a_big: int | None = None,
    mid_budget: int | None = None,
    a_mid: int = 4,
    adaptive_mid: bool | None = None,
    entry_cap: int | None = None,
) -> dict:
    """bin_splats budgets for a scene of ``num_splats`` (None = default).

    Budgets default by SPLAT COUNT (static at trace time): the sort
    length is num_splats * a_small + big_budget * a_big, and at ~1M
    splats most splats are subpixel (1-2 tiles), so large scenes trade
    per-splat slots for a bigger compacted budget.  These defaults decide
    which entries exist, and so what is drawn; the parity gate holds them
    above 40 dB at 210k and 1M splats.
    """
    if a_small is None:
        a_small = 2 if num_splats > LARGE_SCENE_SPLATS else 4
    if big_budget is None:
        big_budget = 32768 if num_splats > LARGE_SCENE_SPLATS else 16384
    if mid_budget is None:
        # footprint-stratified middle bucket (large scenes only): at 1M
        # splats a grazing view puts ~245k splats at a 2x2 footprint —
        # 7x big_budget — and the a_small=2 core clips half their tiles
        # (grazing-view parity fell to 36.8 dB vs the golden renderer
        # without it).  262144 a_mid=4 slots cover them at 1/4 the slot
        # cost of a_small=4 for all: sort 2.26M -> 3.31M instead of
        # 4.26M.  a_mid=4 is load-bearing: at 3 or 2 a 2x2 footprint
        # trips the oversize clamp and the isqrt-width clamped window
        # cannot cover the bbox-minus-core remainder (grazing parity
        # 36.85 dB).
        mid_budget = 262144 if num_splats > LARGE_SCENE_SPLATS else 0
    if a_big is None:
        # the big bucket's slot grid is ~95% dead at a_big=36 (210k scene:
        # 28k live extras in 590k slots); a_big=12 at 210k and 8 at 1M
        # hold the far-view parity of a_big=36 (a_big=8 dips it at 210k).
        # Large footprints clamp at a_small + a_big tiles, so unusually
        # close viewpoints lose parity (near view ~31.7 dB at 210k); pass
        # a_big=36, big_budget=32768 explicitly for closeups.
        a_big = 8 if num_splats > LARGE_SCENE_SPLATS else 12
    if entry_cap is None and num_splats > LARGE_SCENE_SPLATS:
        # with the mid bucket the live entry count is the splats' true
        # clipped-bbox coverage: 1.63N at the 1M bench orbit view, 1.65N
        # at the grazing view.  1.8N truncates only dead sentinel slots at
        # both.  The margin is NOT universal: a far view that keeps the
        # whole scene onscreen exceeds 1.8N and overflows — which is why
        # the generation paths surface TileBins.overflow per frame
        # (binning_overflow_frames in scene stats + warning) instead of
        # trusting the cap.  Callers hitting the warning pass a larger
        # entry_cap explicitly.
        entry_cap = int(1.8 * num_splats)
    elif entry_cap is None and num_splats > MEDIUM_SCENE_SPLATS:
        # mid-size tier (300k < N <= 500k, a_small=4): live entries
        # reach 2.8N at 500k; 3.2N holds full parity.
        entry_cap = int(3.2 * num_splats)
    elif entry_cap is None and num_splats > SMALL_SCENE_SPLATS:
        # 150k < N <= 300k: the bench scene at 210k has live 2.7N of
        # 4.94N slots (2.0N at a near viewpoint — footprints grow but
        # fewer splats stay onscreen), so 3.4N truncates only dead
        # sentinel slots; the live prefix is identical, so output is
        # bit-identical by construction.  NOT applied below 150k — small
        # scenes have larger per-splat footprints (live ~4.5N at 100k,
        # where a 3.2N cap collapsed parity to 15.6 dB).
        entry_cap = int(3.4 * num_splats)
    big_budget_eff = min(big_budget, num_splats)
    mid_budget_eff = min(mid_budget, max(num_splats - big_budget, 0))
    if adaptive_mid is None:
        # per-frame conditional mid bucket: the mid bucket only ADDS
        # coverage when > big_budget splats exceed the a_small core
        # (grazing views); orbit-style frames skip its a_mid*mid_budget
        # sort entries via lax.cond (binning.py).  Auto-on whenever the
        # static shapes allow it (entry cap below the base sort length
        # makes both cond branches emit identical shapes).
        adaptive_mid = (
            mid_budget_eff > 0
            and entry_cap is not None
            and entry_cap
            < a_small * num_splats + a_big * big_budget_eff
        )
    return dict(
        a_small=a_small, big_budget=big_budget_eff, a_big=a_big,
        mid_budget=mid_budget_eff, a_mid=a_mid, adaptive_mid=adaptive_mid,
        entry_cap=entry_cap,
    )


def rasterize_projected_pallas(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    background: jnp.ndarray,
    max_objects: int = 8,
    tile: int = 16,
    chunk: int = DEFAULT_CHUNK,
    interpret: bool = False,
    **budgets,
) -> RenderOutputs:
    """Bin (``budgets`` as for binning_defaults) and composite projected
    splats."""
    bins = bin_splats(
        proj, width, height, tile=tile, lane_pad=chunk,
        **binning_defaults(proj.mean_x.shape[0], **budgets),
    )
    return composite_tiles_pallas(
        bins, width, height, background, max_objects=max_objects,
        chunk=chunk, interpret=interpret,
    )
