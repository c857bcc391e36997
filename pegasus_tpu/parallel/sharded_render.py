"""Splat-axis model parallelism for the rasterizer.

Front-to-back alpha compositing is associative under the 'over' operator:

    (c1, T1) over (c2, T2) = (c1 + T1 * c2, T1 * T2)

so a depth-sorted splat array split into contiguous shards composites
locally per device and then reduces ACROSS devices in shard order — the
tensor-parallel analog for scenes too large for one card's memory.

This generalizes to every channel the renderer emits:
  * premultiplied accumulations (rgb, depth, alpha, seg, vis) combine as
    acc = acc_near + T_near * acc_far (vis channels with their own
    environment-excluded transmittance);
  * amodal log-transmittances combine additively.

Implementation: shard_map over the 'splat' mesh axis; each shard runs a
selectable compositor backend on its slice — 'golden' (per-pixel oracle),
'tiled' (XLA), or 'pallas' (the GPU kernel) — then the per-shard
frames reduce with an ORDERED BUTTERFLY: log2(n) ppermute exchanges of one
shard-local payload each, where the lower-indexed half of every block is
the 'near' operand.  Each step halves the number of distinct partial
composites while every device carries its block's result, so after
log2(n) steps all devices hold the full frame — total traffic
log2(n) x |frame| per device instead of the (n-1) x |frame| an all_gather
ships, and no [n, H, W, C] gathered buffer is ever materialized.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.ops.projection import project_gaussians
from pegasus_tpu.ops.rasterize_ref import RenderOutputs


def _local_render(backend, proj_shard, width, height, k, chunk, interpret):
    """One shard's composite as a [H, W, 5+3K+2] payload."""
    if backend == "golden":
        from pegasus_tpu.ops.rasterize_ref import rasterize_projected

        out = rasterize_projected(
            proj_shard, width, height,
            background=jnp.zeros(3, jnp.float32),
            max_objects=k, chunk=chunk,
        )
    elif backend == "tiled":
        from pegasus_tpu.ops.rasterize_tiled import rasterize_projected_tiled

        out = rasterize_projected_tiled(
            proj_shard, width, height, jnp.zeros(3, jnp.float32),
            max_objects=k, chunk=chunk,
        )
    elif backend == "pallas":
        from pegasus_tpu.ops.rasterize_pallas import rasterize_projected_pallas

        out = rasterize_projected_pallas(
            proj_shard, width, height, jnp.zeros(3, jnp.float32),
            max_objects=k, chunk=chunk, interpret=interpret,
        )
    else:
        raise ValueError(f"unknown backend {backend!r}")

    t_full = (1.0 - out.alpha)[..., None]
    # vis channels need their own transmittance: environment-excluded
    # weights are overlap-free, so their sum = 1 - t_noenv exactly
    t_ne = 1.0 - jnp.sum(out.vis_weights, axis=-1, keepdims=True)
    amodal_log = jnp.log1p(-jnp.clip(out.amodal, 0.0, 1.0 - 1e-7))
    return jnp.concatenate(
        [
            out.rgb,
            out.depth[..., None],
            out.alpha[..., None],
            out.seg_weights,
            out.vis_weights,
            amodal_log,
            t_full,
            t_ne,
        ],
        axis=-1,
    )  # [H, W, 5 + 3K + 2]


def _over(near, far, k):
    """Ordered associative combine of two packed payloads."""
    acc_n = near[..., : 5 + 2 * k]
    acc_f = far[..., : 5 + 2 * k]
    tf_n = near[..., 5 + 3 * k : 5 + 3 * k + 1]
    tn_n = near[..., 5 + 3 * k + 1 : 5 + 3 * k + 2]
    full = acc_n[..., : 5 + k] + tf_n * acc_f[..., : 5 + k]
    vis = acc_n[..., 5 + k :] + tn_n * acc_f[..., 5 + k :]
    amodal = (
        near[..., 5 + 2 * k : 5 + 3 * k] + far[..., 5 + 2 * k : 5 + 3 * k]
    )
    tf = tf_n * far[..., 5 + 3 * k : 5 + 3 * k + 1]
    tn = tn_n * far[..., 5 + 3 * k + 1 : 5 + 3 * k + 2]
    return jnp.concatenate([full, vis, amodal, tf, tn], axis=-1)


def rasterize_splat_sharded(
    cloud: GaussianCloud,
    cam: Camera,
    mesh: Mesh,
    axis: str = "splat",
    background=(0.0, 0.0, 0.0),
    max_objects: int = 8,
    chunk: int = 256,
    backend: str = "golden",
    interpret: bool = False,
) -> RenderOutputs:
    """Render with the splat axis sharded over `axis`.

    The cloud must be padded so num_splats % axis_size == 0 (use
    GaussianCloud.padded).  Splats are depth-sorted globally first so each
    shard owns a depth-contiguous segment; the ordered butterfly combine
    then reproduces sequential compositing exactly (shard order = depth
    order, and every device evaluates the identical reduction tree, so
    the result is bitwise replicated)."""
    n_shards = mesh.shape[axis]
    n = cloud.num_splats
    if n % n_shards:
        raise ValueError(f"pad splats ({n}) to a multiple of {n_shards}")
    if n_shards & (n_shards - 1):
        raise ValueError(f"axis size {n_shards} must be a power of two")

    proj = project_gaussians(cloud, cam)
    # global depth order -> contiguous shards are depth-contiguous
    order = jnp.argsort(jnp.where(proj.valid, proj.depth, jnp.inf))
    proj = jax.tree.map(lambda x: x[order], proj)

    width, height = cam.width, cam.height
    k = max_objects
    steps = int(math.log2(n_shards))

    def shard_fn(proj_shard):
        payload = _local_render(
            backend, proj_shard, width, height, k, chunk, interpret
        )
        idx = jax.lax.axis_index(axis)
        for s in range(steps):
            d = 1 << s
            perm = [(i, i ^ d) for i in range(n_shards)]
            other = jax.lax.ppermute(payload, axis, perm)
            lower = (idx & d) == 0
            near = jnp.where(lower, payload, other)
            far = jnp.where(lower, other, payload)
            payload = _over(near, far, k)
        return payload

    specs = P(axis)
    payload = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: specs, proj),),
        out_specs=P(),
        check_vma=False,
    )(proj)

    acc = payload[..., : 5 + 2 * k]
    amodal_log = payload[..., 5 + 2 * k : 5 + 3 * k]
    t_full = payload[..., 5 + 3 * k : 5 + 3 * k + 1]

    background = jnp.asarray(background, jnp.float32)
    rgb = acc[..., 0:3] + t_full * background[None, None, :]
    return RenderOutputs(
        rgb=rgb,
        depth=acc[..., 3],
        alpha=acc[..., 4],
        seg_weights=acc[..., 5 : 5 + k],
        vis_weights=acc[..., 5 + k : 5 + 2 * k],
        amodal=1.0 - jnp.exp(amodal_log),
    )


def rasterize_splat_sharded_batch(
    clouds: GaussianCloud,
    cams: Camera,
    mesh: Mesh,
    width: int,
    height: int,
    scene_axis: str = "scene",
    splat_axis: str = "splat",
    background=(0.0, 0.0, 0.0),
    max_objects: int = 8,
    chunk: int = 256,
    backend: str = "golden",
    interpret: bool = False,
) -> RenderOutputs:
    """HYBRID 2D sharding: a scene batch data-parallel over `scene_axis`
    with every scene's splats model-parallel over `splat_axis` — one
    shard_map program on a 2D mesh (no reference counterpart; the
    reference is single-GPU, SURVEY 2.2 parallelism audit).

    `clouds`/`cams` carry a leading scene axis [S, ...]; S must be a
    multiple of the scene-axis size and the (padded) splat count a
    power-of-two-shardable multiple of the splat-axis size.  Each device
    composites its scene rows' splat shard locally, then the ordered
    butterfly runs along `splat_axis` only — scene rows never
    communicate.  Returns RenderOutputs with leading scene axis [S, ...].
    """
    n_sp = mesh.shape[splat_axis]
    n_sc = mesh.shape[scene_axis]
    s, n = clouds.xyz.shape[0], clouds.xyz.shape[1]
    if s % n_sc:
        raise ValueError(f"scene batch ({s}) must divide over {n_sc} shards")
    if n % n_sp:
        raise ValueError(f"pad splats ({n}) to a multiple of {n_sp}")
    if n_sp & (n_sp - 1):
        raise ValueError(f"splat axis size {n_sp} must be a power of two")

    proj = jax.vmap(lambda cl, c: project_gaussians(cl, c))(clouds, cams)
    order = jnp.argsort(jnp.where(proj.valid, proj.depth, jnp.inf), axis=1)
    proj = jax.tree.map(
        lambda x: jnp.take_along_axis(x, order, axis=1), proj
    )

    k = max_objects
    steps = int(math.log2(n_sp))

    def shard_fn(proj_shard):  # fields [S_local, N / n_sp]
        payload = jax.vmap(
            lambda p: _local_render(
                backend, p, width, height, k, chunk, interpret
            )
        )(proj_shard)  # [S_local, H, W, C]
        idx = jax.lax.axis_index(splat_axis)
        for st in range(steps):
            d = 1 << st
            perm = [(i, i ^ d) for i in range(n_sp)]
            other = jax.lax.ppermute(payload, splat_axis, perm)
            lower = (idx & d) == 0
            near = jnp.where(lower, payload, other)
            far = jnp.where(lower, other, payload)
            payload = _over(near, far, k)
        return payload

    payload = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(jax.tree.map(lambda _: P(scene_axis, splat_axis), proj),),
        out_specs=P(scene_axis),
        check_vma=False,
    )(proj)  # [S, H, W, C]

    acc = payload[..., : 5 + 2 * k]
    amodal_log = payload[..., 5 + 2 * k : 5 + 3 * k]
    t_full = payload[..., 5 + 3 * k : 5 + 3 * k + 1]
    background = jnp.asarray(background, jnp.float32)
    rgb = acc[..., 0:3] + t_full * background[None, None, None, :]
    return RenderOutputs(
        rgb=rgb,
        depth=acc[..., 3],
        alpha=acc[..., 4],
        seg_weights=acc[..., 5 : 5 + k],
        vis_weights=acc[..., 5 + k : 5 + 2 * k],
        amodal=1.0 - jnp.exp(amodal_log),
    )
