"""Sharded scene-variant generation: BASELINE eval config #5.

One XLA program simulates V randomized scene variants (vmapped physics)
and renders one frame per variant, with the variant axis sharded over the
device mesh.  This is the production form of the throughput-scale config
("1000 scene variants, vmapped physics + batched tiled rasterization
sharded across the devices") — the reference has no counterpart
(strictly sequential scenes, SURVEY 2.2).

Host I/O (BOP writing) consumes the returned arrays per variant; the
device side never synchronizes between variants.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pegasus_tpu.camera import Camera
from pegasus_tpu.ops.backends import default_rasterize_fn
from pegasus_tpu.ops.rasterize_tiled import rasterize_tiled
from pegasus_tpu.ops.render import decode_modalities
from pegasus_tpu.parallel.mesh import make_mesh, shard_batch
from pegasus_tpu.physics import rigid_body as rb
from pegasus_tpu.scene.composition import SceneTemplate, pose_scene
from pegasus_tpu.utils import quaternion as quat


class SceneBatchResult(NamedTuple):
    rgb: jnp.ndarray  # [V, H, W, 3]
    depth: jnp.ndarray  # [V, H, W]
    seg_weights: jnp.ndarray  # [V, H, W, K]
    vis_weights: jnp.ndarray  # [V, H, W, K]
    amodal: jnp.ndarray  # [V, H, W, K]
    final_pos: jnp.ndarray  # [V, B, 3] rest poses
    final_rot: jnp.ndarray  # [V, B, 4] wxyz


def generate_scene_variants(
    template: SceneTemplate,
    physics_params: rb.RigidBodyParams,
    cam: Camera,
    n_variants: int,
    n_steps: int = 310,
    drop_height=(0.25, 0.45),
    drop_region=(0.15, 0.15),
    seed: int = 0,
    mesh=None,
    max_objects: int = 8,
    rasterize_fn=None,
    rasterize_kwargs: Optional[dict] = None,
) -> SceneBatchResult:
    """Randomize drops, simulate to rest, render — V variants in parallel.

    mesh: a 1-D 'scene' Mesh (default: all devices).  physics_params /
    template are replicated; the variant axis is sharded over the mesh
    with shard_map and iterated per device with lax.map, so the Pallas
    compositor is usable (it has no vmap batching rule).  The compositor
    defaults to the platform's (ops/backends.py).
    """
    if mesh is None:
        mesh = make_mesh(axis_names=("scene",))
    if rasterize_fn is None:
        rasterize_fn = default_rasterize_fn()
        if rasterize_fn is rasterize_tiled and rasterize_kwargs is None:
            # variant scenes are small: tight tile budgets keep the dense
            # tiled path cheap
            rasterize_kwargs = dict(max_per_tile=512, big_budget=2048)
    rasterize_kwargs = rasterize_kwargs or {}
    n_bodies = template.num_bodies

    keys = jax.random.split(jax.random.PRNGKey(seed), n_variants)

    def init_state(key):
        kq, kp, kh = jax.random.split(key, 3)
        # the reference's drop randomization: uniform xy in the drop
        # region, uniform height, unnormalized uniform(0,1)^4 quaternion
        # (pegasus.py:213-215, physical_simulation.py:66-73)
        q = quat.normalize(jax.random.uniform(kq, (n_bodies, 4)))
        q = q.at[0].set(jnp.array([1.0, 0, 0, 0]))
        xy = jax.random.uniform(
            kp, (n_bodies, 2),
            minval=jnp.array([-drop_region[0], -drop_region[1]]),
            maxval=jnp.array([drop_region[0], drop_region[1]]),
        )
        z = jax.random.uniform(
            kh, (n_bodies,), minval=drop_height[0], maxval=drop_height[1]
        )
        pos = jnp.concatenate([xy, z[:, None]], axis=1)
        pos = pos.at[0].set(jnp.zeros(3))
        return rb.RigidBodyState.rest(pos, q)

    states = jax.vmap(init_state)(keys)
    states = shard_batch(states, mesh, "scene")

    fn = _variant_program(
        mesh, n_steps, max_objects, rasterize_fn,
        tuple(sorted(rasterize_kwargs.items())),
    )
    return fn(states, template, physics_params, cam)


@functools.lru_cache(maxsize=16)
def _variant_program(mesh, n_steps, max_objects, rasterize_fn, kw_items):
    """Compiled program cache: repeated calls (different seeds/poses,
    same shapes) must NOT re-jit — the closure-per-call pattern cost a
    full recompile per invocation."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rasterize_kwargs = dict(kw_items)

    def one_variant(state, template, physics_params, cam):
        _, final = rb.simulate(physics_params, state, n_steps=n_steps)
        body_R = quat.quat_to_rotmat(final.rot)
        body_R = body_R.at[0].set(jnp.eye(3))
        body_t = final.pos.at[0].set(jnp.zeros(3))
        scene = pose_scene(template, body_R[: template.num_bodies],
                           body_t[: template.num_bodies])
        out = rasterize_fn(
            scene, cam, max_objects=max_objects, **rasterize_kwargs
        )
        return SceneBatchResult(
            rgb=out.rgb,
            depth=out.depth,
            seg_weights=out.seg_weights,
            vis_weights=out.vis_weights,
            amodal=out.amodal,
            final_pos=final.pos,
            final_rot=final.rot,
        )

    def local(states, template, physics_params, cam):
        return jax.lax.map(
            lambda st: one_variant(st, template, physics_params, cam),
            states,
        )

    return jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P("scene"), P(), P(), P()),
            out_specs=P("scene"),
            check_vma=False,
        )
    )
