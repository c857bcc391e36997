"""Tile binning: projected splats -> depth-ordered per-tile entry lists.

Shared front-end of the tiled XLA and Pallas rasterizer backends.  The
CUDA reference builds this structure with a global (tile|depth)-key radix
sort over dynamically-counted duplicates; this formulation keeps every
shape static and avoids gathers and scatters in the duplication step:

  * duplication uses per-splat slot grids with STATIC caps — a cheap
    'small' bucket (most splats cover 1-6 tiles) plus a top_k-compacted
    'big' bucket (and, for large scenes, a 'mid' bucket), instead of a
    searchsorted expansion or scatter/gather inverse maps;
  * depth ordering rides the sort key: key = tile_id << depth_bits |
    depth_rank, so ONE 32-bit sort yields per-tile depth-ordered segments;
  * the ENTRY sort carries ONE index payload and the 16 packed parameters
    are row-gathered from the compact [N+1, 16] matrix afterwards, which
    reads only live entries from a matrix that stays splat-sized (riding
    all 16 columns through the sort would first broadcast each to the
    slot-major entry layout).  The output is a transposed [16, M]
    parameter matrix whose lane axis is entry order: each parameter row
    of a tile's segment is contiguous, which is what the compositor
    kernels read;
  * the COMPACTION sort (big/mid winner selection) is the opposite
    trade: its payloads are splat-sized (no slot broadcast), so winner
    fields ride it as three bit-packed int32 words instead of being
    gathered post-sort.

Whether exact duplication (per-splat tile counts, a prefix sum and one
radix sort, as the CUDA reference does) beats these slot grids on the
GPU is an open question (ROADMAP).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pegasus_tpu.ops.projection import ProjectedGaussians

# packed parameter layout (row index in TileBins.params_t)
PARAM_DIM = 16
P_MX, P_MY = 0, 1
P_CA, P_CB, P_CC = 2, 3, 4
P_OPAC = 5
P_R, P_G, P_B = 6, 7, 8
P_DEPTH = 9
P_RADIUS = 10
P_OBJ = 11
P_ENV = 12  # 1.0 if environment splat (object_id == 0)


class TileBins(NamedTuple):
    """Depth-ordered per-tile entry segments, transposed parameter layout.

    params_t[f, e] = field f of entry e; entries are sorted by
    (tile, depth); each tile's entries are the contiguous range
    [tile_start[t], tile_start[t] + tile_count[t]).  The lane axis is
    padded so kernels may read 128-aligned windows past any segment.
    """

    params_t: jnp.ndarray  # [16, M_pad] f32
    tile_start: jnp.ndarray  # [n_tiles] i32 (arbitrary alignment)
    tile_count: jnp.ndarray  # [n_tiles] i32
    n_tiles_x: int
    n_tiles_y: int
    tile: int
    # scalar bool: live entries exceeded entry_cap, so the HIGHEST tile
    # ids (bottom image rows) were truncated.  Always False when
    # entry_cap is None (a Python False, so importing this module
    # initializes no backend).  Callers that enable capping on untested scene
    # shapes should surface this (the bench parity gate covers the
    # shipped defaults every round).
    overflow: jnp.ndarray = False


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6, 7, 8))
def _gather_rows_structured(
    packed: jnp.ndarray,   # [N+1, 16]
    src: jnp.ndarray,      # [M_pad] i32 entry -> splat row (n = dummy)
    pos: jnp.ndarray,      # [M_pad] i32 entry -> PRE-sort slot position
    b_idx: jnp.ndarray,    # [big_budget] i32 big-bucket winner rows
    abs_sink: jnp.ndarray,  # [N, 2] f32 zeros; see docstring
    n: int,
    a_small: int,
    a_big: int,
    big_budget: int,
) -> jnp.ndarray:
    """packed[src] whose transpose rides the binning's SLOT STRUCTURE.

    The plain gather's autodiff transpose is an XLA scatter-add of one
    16-float row per entry.  But the pre-sort entry layout is dense and
    slot-major ([a_small, N] core windows + [a_big, big_budget] big-bucket
    slots), so if the cotangent rows are returned to PRE-SORT order,
    per-splat sums are plain reshape+reduces plus one tiny scatter-add
    over the big_budget winners.  Getting them there is one payload sort
    by the `pos` column the forward sort carries.  Numerics are identical
    up to float addition order per splat.

    ``abs_sink`` is a gradient SIDE CHANNEL for AbsGS-style densification
    (Ye et al. 2024: signed per-pixel position gradients of a large splat
    cancel, so fine detail under one big splat never crosses the densify
    threshold).  The forward ignores it (pass zeros); its custom
    "cotangent" is the per-splat sum of |per-ENTRY mean2d cotangents| —
    tile-granular |grad| accumulation, the tiled analogue of AbsGS's
    per-pixel |grad| (cancellation across a footprint happens across
    tiles; within one 16x16 tile it is second-order).  Callers read it
    with jax.grad w.r.t. abs_sink.
    """
    return packed[src]


def _gather_rows_structured_fwd(packed, src, pos, b_idx, abs_sink, n,
                                a_small, a_big, big_budget):
    return packed[src], (src, pos, b_idx)


def _gather_rows_structured_bwd(n, a_small, a_big, big_budget, res, g):
    src, pos, b_idx = res  # g: [M_pad, 16]
    f = g.shape[1]
    total = a_small * n + a_big * big_budget
    ops = jax.lax.sort(
        (pos,) + tuple(g[:, j] for j in range(f)), num_keys=1,
        is_stable=False,
    )
    # pos is a permutation of 0..total-1 plus >= total pad sentinels, so
    # the first `total` sorted rows are exactly pre-sort dense order
    g_pre = jnp.stack(ops[1:], axis=1)[:total]  # [total, 16]
    small = g_pre[: a_small * n].reshape(a_small, n, f).sum(axis=0)
    big = g_pre[a_small * n :].reshape(a_big, big_budget, f).sum(axis=0)
    dpacked = jnp.concatenate(
        [small, jnp.zeros((1, f), g.dtype)], axis=0
    ).at[b_idx].add(big)
    # abs_sink side channel: same slot-structured reduction over the
    # |mean2d| cotangent columns (dead unless the caller differentiates
    # w.r.t. abs_sink — XLA removes it otherwise)
    ga = jnp.abs(g_pre[:, :2])
    small_abs = ga[: a_small * n].reshape(a_small, n, 2).sum(axis=0)
    big_abs = ga[a_small * n :].reshape(a_big, big_budget, 2).sum(axis=0)
    dabs = small_abs.at[b_idx].add(big_abs)
    f0 = lambda x: np.zeros(x.shape, jax.dtypes.float0)
    return dpacked, f0(src), f0(pos), f0(b_idx), dabs


_gather_rows_structured.defvjp(
    _gather_rows_structured_fwd, _gather_rows_structured_bwd
)


def _finish_bins(proj, sorted_key, sorted_src, overflow, n, n_tiles, ntx,
                 nty, tile, depth_bits, lane_pad) -> TileBins:
    """Sorted (key, src) entries -> TileBins (generation path: plain
    post-sort row gather, no entry-origin VJP structure)."""
    entry_tile = (sorted_key >> depth_bits).astype(jnp.int32)
    tile_ids = jnp.arange(n_tiles + 1, dtype=jnp.int32)
    bounds = jnp.searchsorted(entry_tile, tile_ids, side="left").astype(
        jnp.int32
    )
    seg_start, seg_end = bounds[:-1], bounds[1:]
    cols = _pack_columns(proj)
    packed = jnp.stack(cols, axis=1)
    packed = jnp.concatenate(
        [packed, jnp.zeros((1, len(cols)), jnp.float32)], axis=0
    )
    src_pad = jnp.pad(sorted_src, (0, lane_pad), constant_values=n)
    return TileBins(
        params_t=packed[src_pad].T,
        tile_start=seg_start,
        tile_count=seg_end - seg_start,
        n_tiles_x=ntx,
        n_tiles_y=nty,
        tile=tile,
        overflow=overflow,
    )


def _pack_columns(proj: ProjectedGaussians):
    """16 per-splat parameter columns (PARAM_DIM order)."""
    n = proj.mean_x.shape[0]
    zero = jnp.zeros((n,), jnp.float32)
    return [
        proj.mean_x,
        proj.mean_y,
        proj.conic_a,
        proj.conic_b,
        proj.conic_c,
        proj.opacity,
        proj.color_r,
        proj.color_g,
        proj.color_b,
        proj.depth,
        proj.radius,
        proj.object_id.astype(jnp.float32),
        (proj.object_id == 0).astype(jnp.float32),
        zero,
        zero,
        zero,
    ]


def bin_splats(
    proj: ProjectedGaussians,
    width: int,
    height: int,
    tile: int = 16,
    a_small: int = 4,
    big_budget: int = 16384,
    a_big: int = 36,
    mid_budget: int = 0,
    a_mid: int = 4,
    adaptive_mid: bool = False,
    lane_pad: int = 1024,
    entry_cap: int | None = None,
    with_entry_origin: bool = False,
    abs_grad_sink: jnp.ndarray | None = None,
    _stage: str | None = None,
) -> TileBins:
    """with_entry_origin: carry each entry's pre-sort slot position as an
    extra sort payload and route the parameter gather through the
    structure-aware custom VJP (fast training transpose).  Requires
    entry_cap=None (training binning is uncapped; capped generation never
    differentiates).

    mid_budget > 0 adds a footprint-stratified MIDDLE bucket between the
    per-splat core windows and the big bucket: the next mid_budget splats
    by area (after the big_budget biggest) emit bbox-minus-core into an
    a_mid-slot grid.  Used by the large-scene tier, where most splats are
    1-2 tiles but a grazing view puts ~25% at a 2x2 footprint: slot count
    then tracks the footprint distribution instead of paying a_small=4
    for every subpixel splat.  Generation-only (the training VJP
    transposes the 2-bucket slot structure).

    adaptive_mid=True makes the mid bucket PER-FRAME conditional: the
    mid bucket only ADDS coverage when more than big_budget splats have
    area > a_small (otherwise every over-core splat is a big-bucket
    winner with its full bbox — coverage is exact without it), so a
    device-side count picks between two lax.cond branches — base sort
    (a_small*N + a_big*big_budget entries) vs base+mid.  Orbit-style
    views over large scenes skip the a_mid*mid_budget sort entries they
    never needed; grazing views keep them.  Requires entry_cap strictly
    below the base sort length (both branches emit entry_cap entries)
    and mid_budget > 0."""
    if with_entry_origin and entry_cap is not None:
        raise ValueError("with_entry_origin requires entry_cap=None")
    n = proj.mean_x.shape[0]
    if adaptive_mid:
        if mid_budget <= 0:
            raise ValueError("adaptive_mid requires mid_budget > 0")
        if with_entry_origin:
            raise ValueError("adaptive_mid is generation-only")
        if entry_cap is None or entry_cap >= a_small * n + a_big * big_budget:
            raise ValueError(
                "adaptive_mid requires entry_cap < the base sort length "
                "(both cond branches must emit entry_cap entries)"
            )
    ntx = -(-width // tile)
    nty = -(-height // tile)
    n_tiles = ntx * nty

    tile_bits = max(1, math.ceil(math.log2(n_tiles + 2)))
    depth_bits = 31 - tile_bits

    # depth key: the IEEE-754 bit pattern of a POSITIVE float is monotone in
    # its value, so the top depth_bits of the depth's bits order splats
    # front-to-back directly — no argsort/rank-inversion pass needed
    # (saves a 210k sort + scatter per frame).  Depths are > 0 here (the
    # projection near-culls at 0.2; invalid splats never emit entries).
    depth_bits_u = jnp.asarray(proj.depth, jnp.float32).view(jnp.int32)
    rank_q = jax.lax.shift_right_logical(
        jnp.maximum(depth_bits_u, 0), 31 - depth_bits
    )

    # clipped tile bboxes
    mx, my = proj.mean_x, proj.mean_y
    r = proj.radius
    tx0 = jnp.clip(jnp.floor((mx - r) / tile), 0, ntx - 1).astype(jnp.int32)
    tx1 = jnp.clip(jnp.floor((mx + r) / tile), 0, ntx - 1).astype(jnp.int32)
    ty0 = jnp.clip(jnp.floor((my - r) / tile), 0, nty - 1).astype(jnp.int32)
    ty1 = jnp.clip(jnp.floor((my + r) / tile), 0, nty - 1).astype(jnp.int32)
    onscreen = (
        proj.valid
        & (mx + r >= 0) & (mx - r < width)
        & (my + r >= 0) & (my - r < height)
    )
    w_t = tx1 - tx0 + 1
    h_t = ty1 - ty0 + 1
    area = jnp.where(onscreen, w_t * h_t, 0)
    if _stage == 'area':  # test probe
        return area

    sentinel = jnp.int32(n_tiles << depth_bits)
    side = max(1, int(math.isqrt(a_small)))
    core_w, core_h = side, a_small // side

    def core_window(s_tx0, s_ty0, s_w, s_h, s_mx, s_my):
        """The <= a_small tile window every splat gets from the small
        bucket: its full bbox when it fits, else a core window around the
        mean tile, ORIENTED along the splat's longer bbox side (a 2-slot
        window covering a horizontal boundary crossing must be 2x1, not
        1x2).  Deterministic per splat, so the big bucket can exclude
        exactly this region (no double emission)."""
        over = (s_w * s_h) > a_small
        wide = s_w >= s_h  # orient the core along the crossing direction
        o_w = jnp.where(wide, jnp.int32(core_h), jnp.int32(core_w))
        o_h = jnp.where(wide, jnp.int32(core_w), jnp.int32(core_h))
        cw = jnp.clip(jnp.floor(s_mx / tile), 0, ntx - 1).astype(jnp.int32)
        ch = jnp.clip(jnp.floor(s_my / tile), 0, nty - 1).astype(jnp.int32)
        c_tx0 = jnp.where(over, jnp.clip(cw - o_w // 2, 0, ntx - 1), s_tx0)
        c_ty0 = jnp.where(over, jnp.clip(ch - o_h // 2, 0, nty - 1), s_ty0)
        c_w = jnp.where(over, jnp.minimum(o_w, ntx - c_tx0), s_w)
        c_h = jnp.where(over, jnp.minimum(o_h, nty - c_ty0), s_h)
        return c_tx0, c_ty0, c_w, c_h

    # -- small bucket: EVERY splat emits its core window ----------------------
    # layout: [a_small, N] (slot-major, the long axis minor).  Entry order
    # within the sort input is irrelevant: the (key, src) 2-key sort
    # canonicalizes.
    c_tx0, c_ty0, c_w, c_h = core_window(tx0, ty0, w_t, h_t, mx, my)
    slot = jnp.arange(a_small, dtype=jnp.int32)[:, None]  # [a_small, 1]
    s_txs = c_tx0[None, :] + slot % c_w[None, :]
    s_tys = c_ty0[None, :] + slot // c_w[None, :]
    s_valid = (slot < (c_w * c_h)[None, :]) & (area > 0)[None, :]
    small_key = jnp.where(
        s_valid,
        ((s_tys * ntx + s_txs) << depth_bits) | rank_q[None, :],
        sentinel,
    )  # [a_small, N]

    # -- big/mid buckets: top winners by area emit (bbox minus core) ----------
    # Winner FIELDS ride the compaction sort as three packed payload words
    # (bbox, core window, depth rank) and are sliced + bit-unpacked
    # afterwards instead of being gathered post-sort per column.
    bx = max(1, (ntx - 1).bit_length())
    by = max(1, (nty - 1).bit_length())
    # core dims reach a_small itself when the splat FITS (a 4x1 bbox at
    # a_small=4 keeps its full bbox as the core), so size the field for
    # a_small, not max(core_w, core_h)
    cbits = max(1, (a_small - 1).bit_length())
    if 2 * (bx + by) > 32 or bx + by + 2 * cbits + 1 > 32:
        raise ValueError(
            "tile grid too large for packed binning payloads "
            f"({ntx}x{nty} tiles at tile={tile}); increase `tile`"
        )
    pack_a = (
        tx0
        | (ty0 << bx)
        | ((w_t - 1) << (bx + by))
        | ((h_t - 1) << (2 * bx + by))
    )
    pack_b = (
        c_tx0
        | (c_ty0 << bx)
        | ((c_w - 1) << (bx + by))
        | ((c_h - 1) << (bx + by + cbits))
        | ((area > a_small).astype(jnp.int32) << (bx + by + 2 * cbits))
    )
    big_key_order = jnp.where(area > a_small, -area, 1)
    _, b_idx_all, pa_all, pb_all, rk_all = jax.lax.sort(
        (big_key_order, jnp.arange(n, dtype=jnp.int32),
         pack_a, pack_b, rank_q),
        num_keys=2,  # index as tiebreak: deterministic winner set
        is_stable=False,
    )
    b_idx = b_idx_all[:big_budget]

    def bucket_keys(pa, pb, rk, a_b):
        """[a_b, budget] keys for winner splats (payload slices `pa`,
        `pb`, `rk`): full bbox minus the core window (no double
        emission), clamped around the core at a_b slots when the bbox
        exceeds the grid."""
        srl = jax.lax.shift_right_logical
        sub = lambda v, s, b: srl(v, s) & ((1 << b) - 1)
        k_tx0 = sub(pa, 0, bx)
        k_ty0 = sub(pa, bx, by)
        k_w = sub(pa, bx + by, bx) + 1
        k_h = sub(pa, 2 * bx + by, by) + 1
        kc_tx0 = sub(pb, 0, bx)
        kc_ty0 = sub(pb, bx, by)
        kc_w = sub(pb, bx + by, cbits) + 1
        kc_h = sub(pb, bx + by + cbits, cbits) + 1
        k_isbig = sub(pb, bx + by + 2 * cbits, 1) == 1
        k_rank = rk
        # clamp oversized bboxes around the core (same shrink rule, cap a_b)
        over_k = (k_w * k_h) > a_b
        k_side = max(1, int(math.isqrt(a_b)))
        e_tx0 = jnp.where(
            over_k, jnp.clip(kc_tx0 - (k_side - core_w) // 2, 0, ntx - 1),
            k_tx0,
        )
        e_ty0 = jnp.where(
            over_k,
            jnp.clip(kc_ty0 - (a_b // k_side - core_h) // 2, 0, nty - 1),
            k_ty0,
        )
        e_w = jnp.where(over_k, jnp.minimum(k_side, ntx - e_tx0), k_w)
        e_h = jnp.where(over_k, jnp.minimum(a_b // k_side, nty - e_ty0), k_h)

        # same slot-major layout as the small bucket: [a_b, budget]
        kslot = jnp.arange(a_b, dtype=jnp.int32)[:, None]  # [a_b, 1]
        k_txs = e_tx0[None, :] + kslot % e_w[None, :]
        k_tys = e_ty0[None, :] + kslot // e_w[None, :]
        in_core = (
            (k_txs >= kc_tx0[None, :])
            & (k_txs < (kc_tx0 + kc_w)[None, :])
            & (k_tys >= kc_ty0[None, :])
            & (k_tys < (kc_ty0 + kc_h)[None, :])
        )
        k_valid = (
            (kslot < (e_w * e_h)[None, :]) & ~in_core & k_isbig[None, :]
        )
        return jnp.where(
            k_valid,
            ((k_tys * ntx + k_txs) << depth_bits) | k_rank[None, :],
            sentinel,
        )

    big_key = bucket_keys(
        pa_all[:big_budget], pb_all[:big_budget], rk_all[:big_budget], a_big
    )  # [a_big, big_budget]

    key_grids = [small_key, big_key]
    idx_grids = [
        jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                         small_key.shape),
        jnp.broadcast_to(b_idx[None, :], big_key.shape),
    ]

    if adaptive_mid and _stage is None:
        # per-frame mid-bucket predicate: with <= big_budget over-core
        # splats every one is a big-bucket winner carrying its full bbox,
        # so the mid bucket adds nothing — skip its emission AND its
        # a_mid*mid_budget sort entries.  Both branches produce exactly
        # entry_cap sorted entries (validated above), so lax.cond
        # type-checks and XLA executes only the taken sort.
        need_mid = jnp.sum((area > a_small).astype(jnp.int32)) > big_budget
        base_keys = jnp.concatenate([k.reshape(-1) for k in key_grids])
        base_vals = jnp.concatenate([v.reshape(-1) for v in idx_grids])
        m_end = big_budget + mid_budget

        def _sort_cap(keys, vals):
            vals = jnp.where(keys == sentinel, n, vals)
            sk, sv = jax.lax.sort((keys, vals), num_keys=2,
                                  is_stable=False)
            return sk[:entry_cap], sv[:entry_cap], sk[entry_cap] != sentinel

        def _with_mid(_):
            mid_key = bucket_keys(
                pa_all[big_budget:m_end], pb_all[big_budget:m_end],
                rk_all[big_budget:m_end], a_mid,
            )
            m_idx = b_idx_all[big_budget:m_end]
            keys = jnp.concatenate([base_keys, mid_key.reshape(-1)])
            vals = jnp.concatenate([
                base_vals,
                jnp.broadcast_to(m_idx[None, :], mid_key.shape).reshape(-1),
            ])
            sk, sv, over = _sort_cap(keys, vals)
            return sk, sv, over

        def _no_mid(_):
            return _sort_cap(base_keys, base_vals)

        sorted_key, sorted_src, overflow = jax.lax.cond(
            need_mid, _with_mid, _no_mid, None
        )
        return _finish_bins(
            proj, sorted_key, sorted_src, overflow, n, n_tiles, ntx, nty,
            tile, depth_bits, lane_pad,
        )

    if mid_budget > 0:
        # footprint-stratified MIDDLE bucket: large scenes keep the cheap
        # a_small=2 core (most splats are 1-2 tiles) but a grazing view
        # puts ~25% of splats at a 2x2 footprint — far beyond big_budget.
        # The next mid_budget splats by area get an a_mid-slot grid, so
        # slot count tracks the footprint distribution instead of paying
        # a_small=4 for every subpixel splat (sort 4.26M -> 3.3M at 1M).
        if with_entry_origin:
            raise ValueError(
                "mid_budget is generation-only (training keeps the "
                "2-bucket slot structure its custom VJP transposes)"
            )
        m_end = big_budget + mid_budget
        m_idx = b_idx_all[big_budget:m_end]
        mid_key = bucket_keys(
            pa_all[big_budget:m_end], pb_all[big_budget:m_end],
            rk_all[big_budget:m_end], a_mid,
        )  # [a_mid, mid_budget]
        key_grids.append(mid_key)
        idx_grids.append(jnp.broadcast_to(m_idx[None, :], mid_key.shape))

    keys = jnp.concatenate([k.reshape(-1) for k in key_grids])

    # entry source indices (the sort carries ONE index payload and the 16
    # param fields are row-gathered afterwards)
    vals = jnp.concatenate([v.reshape(-1) for v in idx_grids])
    vals = jnp.where(keys == sentinel, n, vals)  # dummy row for invalids

    # same-tile splats whose depths agree in the top depth_bits of the float
    # bit pattern produce duplicate keys; the source index rides as a SECOND
    # sort key so their compositing order is a deterministic function of
    # splat index (run-to-run and backend-to-backend reproducible)
    sorted_pos = None
    if with_entry_origin:
        pos = jnp.arange(keys.shape[0], dtype=jnp.int32)
        sorted_key, sorted_src, sorted_pos = jax.lax.sort(
            (keys, vals, pos), num_keys=2, is_stable=False
        )
    else:
        sorted_key, sorted_src = jax.lax.sort((keys, vals), num_keys=2,
                                              is_stable=False)
    if _stage == 'sort':
        return (sorted_key, sorted_src)
    overflow = False
    if entry_cap is not None and entry_cap < sorted_key.shape[0]:
        # static truncation: sentinel (invalid) entries sort PAST every live
        # one, so with cap >= live count this is free compaction.  If a
        # pathological scene overflows the cap, entries of the HIGHEST tile
        # ids are lost (bottom image rows) — callers enabling this must gate
        # parity (bench.py does, every round, at both 210k and 1M) or check
        # the overflow flag (the first entry PAST the cap being live means
        # at least one live entry was dropped).
        overflow = sorted_key[entry_cap] != sentinel
        sorted_key = sorted_key[:entry_cap]
        sorted_src = sorted_src[:entry_cap]

    if not with_entry_origin:
        return _finish_bins(
            proj, sorted_key, sorted_src, overflow, n, n_tiles, ntx, nty,
            tile, depth_bits, lane_pad,
        )

    entry_tile = (sorted_key >> depth_bits).astype(jnp.int32)
    # one searchsorted over 0..n_tiles: tile t's segment is
    # [bounds[t], bounds[t+1]) — sorted keys make right(t) == left(t+1)
    tile_ids = jnp.arange(n_tiles + 1, dtype=jnp.int32)
    bounds = jnp.searchsorted(entry_tile, tile_ids, side="left").astype(
        jnp.int32
    )
    seg_start, seg_end = bounds[:-1], bounds[1:]

    cols = _pack_columns(proj)
    packed = jnp.stack(cols, axis=1)  # [N, PARAM_DIM]
    packed = jnp.concatenate(
        [packed, jnp.zeros((1, len(cols)), jnp.float32)], axis=0
    )
    # pad the INDICES (a few hundred i32) instead of the [16, M] matrix —
    # index n hits the zero dummy row, so the lane tail is zeros either way
    src_pad = jnp.pad(sorted_src, (0, lane_pad), constant_values=n)
    total = keys.shape[0]
    pos_pad = jnp.pad(sorted_pos, (0, lane_pad), constant_values=total)
    if abs_grad_sink is None:
        abs_grad_sink = jnp.zeros((n, 2), jnp.float32)
    params_t = _gather_rows_structured(
        packed, src_pad, pos_pad, b_idx, abs_grad_sink,
        n, a_small, a_big, b_idx.shape[0],
    ).T  # [16, M + lane_pad]

    return TileBins(
        params_t=params_t,
        tile_start=seg_start,
        tile_count=seg_end - seg_start,
        n_tiles_x=ntx,
        n_tiles_y=nty,
        tile=tile,
        overflow=overflow,
    )
