"""Modality API: one fused render -> every PEGASUS data point.

Functional replacements for the reference's four per-frame render helpers
(reference: src/gs/render.py:14-129 — render_rgb_and_depth,
render_silhouette_mask, render_visib_mask, render_semanticsegmentation_mask),
which cost 3 + N_objects CUDA passes and decode masks from rendered colors
with a 0.1 color-distance hack.  Here a single rasterizer pass yields:

  rgb            — composited color
  depth          — expected camera-space depth (meters)
  mask_visib     — per-object visible masks (env excluded from occlusion,
                   matching the reference quirk at src/gs/render.py:81-83)
  mask_amodal    — per-object silhouettes ignoring ALL occlusion
  seg_image      — flat-color segmentation image (objects on black)
  sem_seg        — same as uint8

Masks are exact functions of per-object compositing weights, not color
comparisons.  The weight threshold 0.9 mirrors the reference's 0.1
color-distance acceptance for fully-covering pixels.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.lax import Precision

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.ops.rasterize_ref import RenderOutputs, rasterize_reference

_PREC = Precision.HIGHEST

MASK_THRESHOLD = 0.9


class FrameDataPoints(NamedTuple):
    rgb: jnp.ndarray  # [H, W, 3] float in [0,1]
    depth: jnp.ndarray  # [H, W] float meters
    alpha: jnp.ndarray  # [H, W]
    mask_visib: jnp.ndarray  # [H, W, K] bool (channel k-1 = object id k)
    mask_amodal: jnp.ndarray  # [H, W, K] bool
    seg_image: jnp.ndarray  # [H, W, 3] float
    vis_weights: jnp.ndarray  # [H, W, K] raw weights (debug/gt-info)
    # scalar bool from the rasterizer: True when an entry-capped binning
    # truncated LIVE entries for this frame (bottom-image tiles silently
    # lose far splats — see ops/binning.py TileBins.overflow).  The
    # generation loop surfaces it per scene (pegasus.py) so dense frames
    # over >500k-splat scenes cannot corrupt written datasets silently.
    overflow: jnp.ndarray = False


def decode_modalities(
    out: RenderOutputs,
    semantic_colors: jnp.ndarray,  # [K, 3] palette for object ids 1..K
    mask_threshold: float = MASK_THRESHOLD,
) -> FrameDataPoints:
    k = semantic_colors.shape[0]
    # channel 0 of seg/vis weights is the environment; objects are 1..K
    vis = out.vis_weights[..., 1 : k + 1]
    amodal = out.amodal[..., 1 : k + 1]
    seg_image = jnp.einsum(
        "hwk,kc->hwc", vis, jnp.asarray(semantic_colors, jnp.float32),
        precision=_PREC,
    )
    return FrameDataPoints(
        rgb=jnp.clip(out.rgb, 0.0, 1.0),
        depth=out.depth,
        alpha=out.alpha,
        mask_visib=vis >= mask_threshold,
        mask_amodal=amodal >= mask_threshold,
        seg_image=jnp.clip(seg_image, 0.0, 1.0),
        vis_weights=vis,
        overflow=getattr(out, "overflow", False),
    )


def render_frame(
    scene: GaussianCloud,
    cam: Camera,
    semantic_colors,
    background=(0.0, 0.0, 0.0),
    max_objects: int | None = None,
    rasterize_fn=rasterize_reference,
    **kwargs,
) -> FrameDataPoints:
    """Render every modality for one camera in one pass."""
    semantic_colors = jnp.asarray(semantic_colors, jnp.float32)
    if max_objects is None:
        max_objects = semantic_colors.shape[0] + 1
    out = rasterize_fn(
        scene, cam, background=background, max_objects=max_objects, **kwargs
    )
    return decode_modalities(out, semantic_colors)


# ---------------------------------------------------------------------------
# Reference-signature compatibility wrappers (src/gs/render.py:14-129).
# Each maps onto ONE fused pass over the composed scene instead of the
# reference's separate rasterizer invocations.  `gs_environment` /
# `gs_object_list` take GaussianModel facades or GaussianClouds.
# ---------------------------------------------------------------------------


def _as_cloud(x):
    return x.cloud if hasattr(x, "cloud") else x


def _compose(gs_environment, gs_object_list):
    from pegasus_tpu.gs.cloud import merge

    parts = [_as_cloud(gs_environment).with_object_id(0)]
    for oid, obj in gs_object_list.items():
        parts.append(_as_cloud(obj).with_object_id(int(oid)))
    return merge(parts), max(gs_object_list.keys(), default=0)


def render_rgb_and_depth(cam, gs_scene, pipe_settings=None, bg=(0, 0, 0),
                         debug=False):
    """(rgb [H,W,3], depth [H,W,1]) like the reference (render.py:14-33)."""
    out = rasterize_reference(_as_cloud(gs_scene), cam, background=bg)
    return jnp.clip(out.rgb, 0, 1), out.depth[..., None]


def render_visib_mask(cam, gs_environment, gs_object_list, color_set,
                      height=None, width=None, pipe_settings=None,
                      bg=(0, 0, 0)):
    """(per-object visible masks [H,W,K], seg color image) — env splats
    excluded from occlusion exactly like the reference quirk
    (render.py:68-97), but decoded from exact weights."""
    scene, max_id = _compose(gs_environment, gs_object_list)
    frame = render_frame(scene, cam, color_set, background=bg,
                         max_objects=max_id + 1)
    return frame.mask_visib, frame.seg_image


def render_silhouette_mask(cam, gs_object_list, gs_env, width=None,
                           height=None, color_set=None, pipe_settings=None,
                           bg=(0, 0, 0)):
    """Per-object amodal masks [H,W,K] (reference: render.py:36-65 — one
    CUDA pass per object there; one fused pass here)."""
    scene, max_id = _compose(gs_env, gs_object_list)
    k = color_set.shape[0] if color_set is not None else max_id
    frame = render_frame(
        scene, cam,
        color_set if color_set is not None else jnp.zeros((max_id, 3)),
        background=bg, max_objects=max_id + 1,
    )
    return frame.mask_amodal


def render_semanticsegmentation_mask(cam, gs_environment, gs_object_list,
                                     color_set, height=None, width=None,
                                     pipe_settings=None, bg=(0, 0, 0),
                                     debug=False):
    """uint8 semantic color image (reference: render.py:100-129)."""
    import numpy as np

    scene, max_id = _compose(gs_environment, gs_object_list)
    frame = render_frame(scene, cam, color_set, background=bg,
                         max_objects=max_id + 1)
    return (np.asarray(frame.seg_image) * 255).astype("uint8")


class FrameEncoded(NamedTuple):
    """Device-side encoded frame: exactly the bytes the BOP writer needs.

    Encoding on-device cuts the host readback ~4x (uint8 rgb/sem, uint16
    millimeter depth, bool masks instead of f32 weight planes).
    """

    rgb_u8: jnp.ndarray  # [H, W, 3] uint8
    depth_mm_u16: jnp.ndarray  # [H, W] uint16 millimeters (BOP)
    mask_visib: jnp.ndarray  # [H, W, K] bool
    mask_amodal: jnp.ndarray  # [H, W, K] bool
    depth_m: jnp.ndarray  # [H, W] float meters (video stream)


def encode_frame(frame: FrameDataPoints) -> FrameEncoded:
    return FrameEncoded(
        rgb_u8=jnp.clip(frame.rgb * 255.0 + 0.5, 0, 255).astype(jnp.uint8),
        depth_mm_u16=jnp.clip(frame.depth * 1000.0, 0, 65535).astype(
            jnp.uint16
        ),
        mask_visib=frame.mask_visib,
        mask_amodal=frame.mask_amodal,
        depth_m=frame.depth,
    )


def _packbits(masks: jnp.ndarray) -> jnp.ndarray:
    """[..., M] bool -> [..., ceil(M/8)] uint8 (little-endian bit order)."""
    m = masks.shape[-1]
    pad = (-m) % 8
    x = jnp.pad(masks.astype(jnp.uint8), [(0, 0)] * (masks.ndim - 1) + [(0, pad)])
    x = x.reshape(*x.shape[:-1], -1, 8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(x * weights, axis=-1).astype(jnp.uint8)


def pack_frame_bytes(enc: FrameEncoded) -> jnp.ndarray:
    """Pack an encoded frame into ONE uint8 tensor [H, W, 5 + ceil(2K/8)].

    Device->host links charge per transfer AND per byte: everything rides
    one tensor, and the 2K boolean mask planes are bit-packed (they are 1-bit
    PNGs on disk anyway).  The semantic color image is NOT shipped: it is
    exactly palette[k] wherever visib mask k is set (weights sum to <= 1,
    so at most one channel crosses the 0.9 threshold), so the host
    reconstructs it from the visib bits for free — a 3-byte/pixel (~33%)
    readback cut.  Channel layout:
      0:3 rgb, 3:5 depth_mm (lo, hi bytes),
      5: bit-packed [visib_0..K-1, amodal_0..K-1].
    """
    d = enc.depth_mm_u16
    lo = (d & 0xFF).astype(jnp.uint8)
    hi = (d >> 8).astype(jnp.uint8)
    bits = _packbits(
        jnp.concatenate([enc.mask_visib, enc.mask_amodal], axis=-1)
    )
    return jnp.concatenate(
        [
            enc.rgb_u8,
            lo[..., None],
            hi[..., None],
            bits,
        ],
        axis=-1,
    )


# ---------------------------------------------------------------------------
# Compacted chunk readback: RLE the sparse planes on-device.
#
# The 6 B/px packed frame splits into a dense half (rgb + depth-lo, 4 B/px,
# near-incompressible) and a sparse half (depth-hi + bit-packed masks,
# 2 B/px): the hi byte only changes every 256 mm of depth and the mask
# bytes are zero except where objects project (a small fraction of the
# frame).  Run-length encoding those planes device-side cuts ~30% of the
# transfer losslessly.  Everything stays
# static-shape for XLA: the RLE stream lives in a fixed budget of
# ``max_runs`` slots and the UNcompressed planes ride along as a
# device-resident fallback tensor the host only fetches when the run
# count overflows the budget (rare: a dense-noise frame).
# ---------------------------------------------------------------------------

RLE_HEADER_BYTES = 8  # n_runs u32 | n_elements u32 (little-endian)
RLE_BYTES_PER_RUN = 5  # value u8 | start offset u32 (little-endian)


def rle_max_runs(chunk: int, height: int, width: int, n_planes: int) -> int:
    """Default run budget: stream_bytes/48 runs -> 5/48 ~ 0.10 B per plane
    byte, i.e. a ~31% cut of the 6 B/px frame when n_planes = 2."""
    return max(1024, (chunk * height * width * n_planes) // 48)


def split_frame_planes(enc: FrameEncoded) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Encoded frame -> (dense [H,W,4] rgb+depth-lo, sparse [H,W,1+mb]
    depth-hi+maskbits).  Concatenating (dense, sparse) channel-wise gives
    exactly the pack_frame_bytes layout."""
    d = enc.depth_mm_u16
    lo = (d & 0xFF).astype(jnp.uint8)
    hi = (d >> 8).astype(jnp.uint8)
    bits = _packbits(
        jnp.concatenate([enc.mask_visib, enc.mask_amodal], axis=-1)
    )
    dense = jnp.concatenate([enc.rgb_u8, lo[..., None]], axis=-1)
    sparse = jnp.concatenate([hi[..., None], bits], axis=-1)
    return dense, sparse


def _u32_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """uint32 [...]-> little-endian uint8 [..., 4]."""
    x = x.astype(jnp.uint32)
    return jnp.stack(
        [((x >> (8 * i)) & 0xFF).astype(jnp.uint8) for i in range(4)],
        axis=-1,
    )


def rle_pack_chunk(dense, sparse, max_runs: int):
    """Pack a chunk ([C,H,W,4] dense, [C,H,W,P] sparse) into ONE uint8
    transfer buffer + the raw sparse planes as overflow fallback.

    Buffer layout: [8B header | 5*max_runs RLE slots | dense bytes].
    The sparse planes are flattened PLANE-major ([P,C,H,W]) so each mask
    byte-plane and the depth-hi plane keep their long spatial runs.
    Returns (buf [8+5*max_runs+dense.size] u8, sparse) — the caller ships
    ``buf`` and fetches ``sparse`` only if the header reports overflow.
    """
    x = jnp.transpose(sparse, (3, 0, 1, 2)).reshape(-1)
    n = x.shape[0]
    start = jnp.concatenate(
        [jnp.ones((1,), bool), x[1:] != x[:-1]]
    )
    rid = jnp.cumsum(start.astype(jnp.int32)) - 1
    n_runs = rid[-1] + 1
    pos = jnp.arange(n, dtype=jnp.uint32)
    # one scatter per run start; runs past the budget drop out of bounds
    idx = jnp.where(start, rid, max_runs)
    starts = (
        jnp.zeros((max_runs,), jnp.uint32).at[idx].set(pos, mode="drop")
    )
    values = x[starts.astype(jnp.int32)]
    rle = jnp.concatenate(
        [values[:, None], _u32_bytes(starts)], axis=-1
    ).reshape(-1)
    header = jnp.concatenate(
        [
            _u32_bytes(n_runs.astype(jnp.uint32)),
            _u32_bytes(jnp.uint32(n)),
        ],
        axis=-1,
    ).reshape(-1)
    buf = jnp.concatenate([header, rle, dense.reshape(-1)])
    return buf, sparse


def rle_unpack_chunk(buf, chunk_shape, k: int, max_runs: int, palette=None,
                     fallback_sparse=None, with_depth_m: bool = True):
    """Host inverse of rle_pack_chunk.

    chunk_shape = (C, H, W); ``fallback_sparse`` is a zero-arg callable
    returning the raw sparse planes [C,H,W,P] (e.g. lambda fetching the
    device tensor) used when the run count overflowed the budget.
    Returns the unpack_frame_bytes dict with a leading chunk axis.
    """
    import numpy as np

    c, h, w = chunk_shape
    mb = (2 * k + 7) // 8
    p = 1 + mb
    buf = np.asarray(buf)
    n_runs, n = np.frombuffer(
        buf[:RLE_HEADER_BYTES].tobytes(), dtype="<u4"
    )
    rle_end = RLE_HEADER_BYTES + RLE_BYTES_PER_RUN * max_runs
    if n_runs > max_runs:
        if fallback_sparse is None:
            raise ValueError(
                f"RLE overflow ({n_runs} runs > budget {max_runs}) and no "
                "fallback provided"
            )
        sparse = np.asarray(fallback_sparse())
    else:
        rle = buf[RLE_HEADER_BYTES:rle_end].reshape(max_runs,
                                                    RLE_BYTES_PER_RUN)
        values = rle[:n_runs, 0]
        starts = (
            rle[:n_runs, 1:5].astype(np.uint32)
            * np.uint32([1, 1 << 8, 1 << 16, 1 << 24])
        ).sum(axis=1)
        lengths = np.diff(starts, append=np.uint32(n)).astype(np.int64)
        flat = np.repeat(values, lengths)
        sparse = flat.reshape(p, c, h, w).transpose(1, 2, 3, 0)
    dense = buf[rle_end:].reshape(c, h, w, 4)
    # (dense, sparse) channel-concat == the pack_frame_bytes layout, but
    # the planes are consumed as views — no 5 MB/chunk concat copy
    return _unpack_planes(
        dense, sparse, k, palette=palette, with_depth_m=with_depth_m
    )


def _unpack_planes(dense, sparse, k: int, palette=None,
                   with_depth_m: bool = True):
    """Decode (dense [...,4] rgb+depth-lo, sparse [...,1+mb] depth-hi+bits)
    plane views into the frame dict.  This is the host hot loop of dataset
    generation (one call per chunk, single-core hosts): every step below is
    either a view or a single pass over the chunk.
    """
    import numpy as np

    rgb = dense[..., 0:3]
    # one allocation + two in-place passes (vs 2 astype copies + shift + or)
    depth_mm = sparse[..., 0].astype(np.uint16)
    depth_mm <<= 8
    depth_mm |= dense[..., 3]
    packed = sparse[..., 1:]
    bits = np.unpackbits(packed, axis=-1, bitorder="little")[..., : 2 * k]
    # unpackbits yields 0/1 uint8: reinterpreting as bool is a zero-copy
    # view, not the two 2x-size astype(bool) copies of the naive path
    visib = bits[..., :k].view(np.bool_)
    amodal = bits[..., k : 2 * k].view(np.bool_)
    if palette is None:
        sem = np.zeros(rgb.shape[:-1] + (3,), np.uint8)
    else:
        pal_u8 = np.clip(
            np.asarray(palette, np.float32)[:k] * 255.0 + 0.5, 0, 255
        ).astype(np.uint8)
        if k <= 8:
            # visib bits all live in mask byte 0 and are mutually
            # exclusive (weights sum <= 1): one 256-entry LUT gather
            # replaces the K-channel tensordot (7.3 -> ~1 ms/frame)
            lut = np.zeros((256, 3), np.uint8)
            for i in range(k):
                lut[1 << i] = pal_u8[i]
            sem = lut[packed[..., 0] & np.uint8((1 << k) - 1)]
        else:
            # masks are mutually exclusive per pixel -> plain sum is exact
            sem = np.tensordot(
                bits[..., :k], pal_u8, axes=([-1], [0])
            ).astype(np.uint8)
    out = {
        "rgb_u8": rgb,
        "sem_u8": sem,
        "depth_mm": depth_mm,
        "mask_visib": visib,
        "mask_amodal": amodal,
    }
    if with_depth_m:
        out["depth_m"] = depth_mm.astype(np.float32) / 1000.0
    return out


def unpack_frame_bytes(buf, k: int, palette=None, with_depth_m: bool = True):
    """Inverse of pack_frame_bytes on a host numpy array.

    ``palette`` is the [K, 3] semantic color set in [0, 1] (the same array
    given to ``render_frame``); when provided, the semantic color image is
    reconstructed host-side from the visib masks (flat palette color where
    the object is visible, black elsewhere — the modality's defined
    semantics; see ``pack_frame_bytes``).

    Returns dict(rgb_u8, sem_u8, depth_mm, mask_visib, mask_amodal), plus
    depth_m (float meters) unless ``with_depth_m=False`` (the float plane
    is only consumed by the video path; dataset writes use depth_mm).
    """
    import numpy as np

    buf = np.asarray(buf)
    return _unpack_planes(
        buf[..., :4], buf[..., 4:], k, palette=palette,
        with_depth_m=with_depth_m,
    )
