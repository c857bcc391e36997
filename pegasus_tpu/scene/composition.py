"""Scene composition: one merged cloud, poses applied by per-splat gather.

The reference composes scenes by deep-copying the environment cloud and
vstacking freshly transformed object clouds EVERY FRAME
(reference: pegasus.py:255-264, src/gs/render.py:36-129), and in dynamic
mode mutates the object tensors incrementally per timestep
(src/gs/pegasus_setup.py:178-193), accumulating fp drift.

Redesign:
  * merge env + canonical (untransformed) objects ONCE into a
    ``SceneTemplate`` with per-splat ``object_id``;
  * per frame, gather each splat's body pose (R[body], t[body]) and apply
    xyz / per-splat-quat / SH rotations batched over the whole cloud —
    no python loop over objects, no per-frame concat;
  * poses are ABSOLUTE samples of the physics trajectory: because the
    reference rotates about the (re-centered) object centroid, composing
    its per-step deltas telescopes to q_t q_0^-1 ... q_1 q_0^-1 q_0 = q_t —
    so absolute posing is the drift-free form of the same math
    (equivalence covered by tests/test_cloud.py::test_incremental_vs_direct_pose).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
from pegasus_tpu.utils import pytree
from jax.lax import Precision

from pegasus_tpu.gs.cloud import GaussianCloud, merge
from pegasus_tpu.utils import quaternion as quat
from pegasus_tpu.utils import sh as shlib

_PREC = Precision.HIGHEST


@pytree.dataclass
class SceneTemplate:
    """Merged canonical scene cloud + per-body metadata.

    body index == bullet body id (0 = environment, objects 1..B-1),
    matching the trajectory JSON ids
    (reference: src/engine/physical_simulation.py:124-152).
    """

    cloud: GaussianCloud  # merged, object_id = body id
    pivots: jnp.ndarray  # [B, 3] canonical per-body rotation pivot (centroid)
    num_bodies: int = pytree.field(pytree_node=False)

    @classmethod
    def build(
        cls,
        env: GaussianCloud,
        objects: Sequence[GaussianCloud],
        pad_to: int | None = None,
    ) -> "SceneTemplate":
        clouds: List[GaussianCloud] = [env.with_object_id(0)]
        pivots = [jnp.zeros(3, jnp.float32)]  # env never rotates
        for i, obj in enumerate(objects):
            clouds.append(obj.with_object_id(i + 1))
            pivots.append(obj.centroid())
        scene = merge(clouds)
        if pad_to is not None:
            scene = scene.padded(pad_to)
        return cls(
            cloud=scene,
            pivots=jnp.stack(pivots, axis=0),
            num_bodies=len(objects) + 1,
        )


def pose_scene(
    template: SceneTemplate,
    body_R: jnp.ndarray,  # [B, 3, 3]
    body_t: jnp.ndarray,  # [B, 3]
) -> GaussianCloud:
    """Apply per-body rigid poses to the merged scene cloud.

    Semantics per body match GaussianModel.apply_transformation about the
    body centroid (reference: src/gs/gaussian_model.py:579-582 via
    pegasus_setup.apply_transformation_on_gs, src/gs/pegasus_setup.py:195-207).

    Per-splat per-body matrices are fetched as ONE-HOT MATMULS
    (onehot[N,B] @ mats[B,k]) and applied with unrolled elementwise
    multiply-adds instead of gathered [N,d,d] batched-tiny-matmul einsums,
    which XLA lowers to padded per-splat d x d products.  One-hot
    weights are exactly 0/1, so the "gather" is bit-exact.
    """
    cloud = template.cloud
    nb = template.num_bodies
    bid = jnp.clip(cloud.object_id, 0, nb - 1)
    onehot = jax.nn.one_hot(bid, nb, dtype=jnp.float32)  # [N, B]

    def per_splat(mats: jnp.ndarray) -> jnp.ndarray:  # [B, k] -> [N, k]
        return jnp.einsum("nb,bk->nk", onehot, mats, precision=_PREC)

    R_flat = per_splat(body_R.reshape(nb, 9))  # [N, 9] row-major
    t_g = per_splat(body_t)  # [N, 3]
    p_g = per_splat(template.pivots)  # [N, 3]

    rel = cloud.xyz - p_g
    new_xyz = (
        jnp.stack(
            [
                sum(R_flat[:, 3 * i + j] * rel[:, j] for j in range(3))
                for i in range(3)
            ],
            axis=1,
        )
        + p_g
        + t_g
    )

    # per-splat quaternion premultiplied by the body rotation
    body_q = quat.rotmat_to_quat(body_R)  # [B, 4]
    new_rot = quat.quat_mul(per_splat(body_q), cloud.get_rotation())

    # SH rotation: per-body band matrices, one-hot-fetched per splat
    f_rest = cloud.f_rest
    if f_rest.shape[1] > 0:
        deg = cloud.sh_degree
        outs = []
        start = 0
        for band in range(1, deg + 1):
            dim = shlib._BAND_DIMS[band]
            D = shlib.sh_band_rotation(body_R, band)  # [B, dim, dim]
            D_g = per_splat(D.reshape(nb, dim * dim))  # [N, dim*dim]
            block = f_rest[:, start : start + dim, :]  # [N, dim, C]
            rows = [
                sum(
                    D_g[:, i * dim + j, None] * block[:, j]
                    for j in range(dim)
                )
                for i in range(dim)
            ]
            outs.append(jnp.stack(rows, axis=1))
            start += dim
        if start < f_rest.shape[1]:
            outs.append(f_rest[:, start:])
        f_rest = jnp.concatenate(outs, axis=1)

    return cloud.replace(xyz=new_xyz, rot=new_rot, f_rest=f_rest)


def poses_from_trajectory_step(times_t, times_q_xyzw, step):
    """Dense per-body (R, t) at a timestep from trajectory arrays.

    times_t: [B, T, 3]; times_q_xyzw: [B, T, 4] (Bullet layout,
    reference: src/engine/physical_simulation.py:137-152).
    Body 0 (environment) is forced to identity — the reference never poses
    the env cloud.
    """
    t = jnp.asarray(times_t, jnp.float32)[:, step, :]
    q = quat.xyzw_to_wxyz(jnp.asarray(times_q_xyzw, jnp.float32)[:, step, :])
    R = quat.quat_to_rotmat(q)
    R = R.at[0].set(jnp.eye(3, dtype=jnp.float32))
    t = t.at[0].set(jnp.zeros(3, jnp.float32))
    return R, t
