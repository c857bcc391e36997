"""Immutable Gaussian-splat cloud pytree and functional SE(3) ops.

Functional redesign of the reference's mutable ``GaussianModel``
(reference: src/gs/gaussian_model.py:35-654):

* parameters are raw (pre-activation), exactly as stored in the Inria PLY:
  log-scales, logit-opacities, unnormalized wxyz quaternions;
* every op returns a new cloud (pure functions compose under jit/vmap);
* an ``object_id`` channel replaces the reference's per-frame cloud
  surgery — one merged scene cloud renders every modality in one pass
  (the reference re-merges and re-colors clouds per frame,
  reference: pegasus.py:255-264, src/gs/render.py:36-129);
* ``alive`` padding mask gives XLA static shapes across scenes with
  varying splat counts (merge_gaussians in the reference is a vstack,
  src/gs/gaussian_model.py:584-591).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from pegasus_tpu.utils import pytree
from jax.lax import Precision

_PREC = Precision.HIGHEST  # geometry math must be f32 (build defaults matmul to bf16)

from pegasus_tpu.utils import quaternion as quat
from pegasus_tpu.utils import sh as shlib


@pytree.dataclass
class GaussianCloud:
    """A batch of N Gaussian splats (raw parameterization).

    Fields mirror the Inria PLY schema (reference:
    src/gs/gaussian_model.py:193-288):
      xyz       [N, 3]  float32 positions (world/model frame)
      f_dc      [N, 1, 3]  DC SH coefficient per channel
      f_rest    [N, 15, 3] higher-order SH (deg 3); [N, 0, 3] for deg 0
      opacity   [N, 1]  logit opacity (sigmoid -> alpha)
      scale     [N, 3]  log scales (exp -> stddevs)
      rot       [N, 4]  wxyz quaternion (normalized on use)
      object_id [N]     int32 semantic/instance id (0 = environment)
      alive     [N]     bool, False for padding splats
    """

    xyz: jnp.ndarray
    f_dc: jnp.ndarray
    f_rest: jnp.ndarray
    opacity: jnp.ndarray
    scale: jnp.ndarray
    rot: jnp.ndarray
    object_id: jnp.ndarray
    alive: jnp.ndarray

    # -- constructors -------------------------------------------------------

    @classmethod
    def create(
        cls,
        xyz,
        f_dc,
        f_rest,
        opacity,
        scale,
        rot,
        object_id: Optional[jnp.ndarray] = None,
        alive: Optional[jnp.ndarray] = None,
    ) -> "GaussianCloud":
        xyz = jnp.asarray(xyz, jnp.float32)
        n = xyz.shape[0]
        if object_id is None:
            object_id = jnp.zeros((n,), jnp.int32)
        if alive is None:
            alive = jnp.ones((n,), bool)
        return cls(
            xyz=xyz,
            f_dc=jnp.asarray(f_dc, jnp.float32).reshape(n, 1, 3),
            f_rest=jnp.asarray(f_rest, jnp.float32).reshape(n, -1, 3),
            opacity=jnp.asarray(opacity, jnp.float32).reshape(n, 1),
            scale=jnp.asarray(scale, jnp.float32).reshape(n, 3),
            rot=jnp.asarray(rot, jnp.float32).reshape(n, 4),
            object_id=jnp.asarray(object_id, jnp.int32).reshape(n),
            alive=jnp.asarray(alive, bool).reshape(n),
        )

    # -- derived quantities (activation layer of the reference,
    #    src/gs/gaussian_model.py:37-52) ------------------------------------

    @property
    def num_splats(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return {0: 0, 3: 1, 8: 2, 15: 3}[self.f_rest.shape[1]]

    def get_scaling(self) -> jnp.ndarray:
        return jnp.exp(self.scale)

    def get_opacity(self) -> jnp.ndarray:
        a = jax.nn.sigmoid(self.opacity)
        return jnp.where(self.alive[:, None], a, 0.0)

    def get_rotation(self) -> jnp.ndarray:
        return quat.normalize(self.rot)

    def get_features(self) -> jnp.ndarray:
        """[N, 16, 3] concatenated SH (DC first)."""
        return jnp.concatenate([self.f_dc, self.f_rest], axis=1)

    def get_rgb(self) -> jnp.ndarray:
        """Base color from the DC term only, clipped to [0,1]
        (reference: src/gs/gaussian_model.py:463-474)."""
        return jnp.clip(shlib.sh2rgb(self.f_dc[:, 0, :]), 0.0, 1.0)

    def covariance(self, scaling_modifier: float = 1.0) -> jnp.ndarray:
        """[N, 3, 3] world-space covariances R S S^T R^T
        (reference: src/gs/gaussian_model.py:38-47)."""
        R = quat.quat_to_rotmat(self.get_rotation())
        s = scaling_modifier * self.get_scaling()
        RS = R * s[:, None, :]
        return jnp.matmul(RS, jnp.swapaxes(RS, -1, -2), precision=_PREC)

    def centroid(self) -> jnp.ndarray:
        """Mean of alive splat positions (the reference's rotation pivot,
        src/gs/gaussian_model.py:485-493)."""
        w = self.alive.astype(jnp.float32)[:, None]
        return jnp.sum(self.xyz * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)

    # -- functional SE(3) ---------------------------------------------------

    def transformed(self, R: jnp.ndarray, t: jnp.ndarray, pivot="centroid") -> "GaussianCloud":
        """Apply a rigid transform to the full cloud.

        Matches the reference composite ``apply_transformation``:
        xyz rotates about the cloud centroid then translates
        (reference: src/gs/gaussian_model.py:482-497, 579-582), per-splat
        quats premultiply by R (:499-505), SH bands rotate (:507-546).

        pivot: 'centroid' (reference semantics), 'origin', or a [3] point.
        """
        R = jnp.asarray(R, jnp.float32)
        t = jnp.asarray(t, jnp.float32)
        if isinstance(pivot, str) and pivot == "centroid":
            p = self.centroid()
        elif isinstance(pivot, str) and pivot == "origin":
            p = jnp.zeros(3, jnp.float32)
        else:
            p = jnp.asarray(pivot, jnp.float32)

        new_xyz = jnp.matmul(self.xyz - p, R.T, precision=_PREC) + p + t

        r_quat = quat.rotmat_to_quat(R)
        new_rot = quat.quat_mul(r_quat[None, :], self.get_rotation())

        if self.f_rest.shape[1] > 0:
            new_rest = shlib.rotate_sh_rest(self.f_rest, R, deg=self.sh_degree)
        else:
            new_rest = self.f_rest

        return self.replace(xyz=new_xyz, rot=new_rot, f_rest=new_rest)

    def translated(self, t: jnp.ndarray) -> "GaussianCloud":
        return self.replace(xyz=self.xyz + jnp.asarray(t, jnp.float32))

    # -- composition --------------------------------------------------------

    def with_object_id(self, object_id: int) -> "GaussianCloud":
        return self.replace(
            object_id=jnp.full((self.num_splats,), object_id, jnp.int32)
        )

    def with_flat_color(self, rgb) -> "GaussianCloud":
        """Overwrite appearance with a flat color (semantic paint).

        Equivalent to the reference writing RGB2SH(color) into _features_dc
        and zeros into _features_rest (reference: pegasus.py:227-232,
        src/gs/render.py:51-52).
        """
        dc = jnp.broadcast_to(
            shlib.rgb2sh(jnp.asarray(rgb, jnp.float32)), (self.num_splats, 1, 3)
        )
        return self.replace(f_dc=dc, f_rest=jnp.zeros_like(self.f_rest))

    def masked(self, keep: jnp.ndarray) -> "GaussianCloud":
        """Soft-delete splats (padding-friendly ``mask_points``,
        reference: src/gs/gaussian_model.py:598-623).  Shape is preserved;
        dropped splats become dead padding."""
        keep = jnp.asarray(keep, bool)
        return self.replace(alive=self.alive & keep)

    def padded(self, n_total: int) -> "GaussianCloud":
        """Pad with dead splats to a static size (XLA bucketing)."""
        n = self.num_splats
        if n_total < n:
            raise ValueError(f"padded: n_total={n_total} < num_splats={n}")
        extra = n_total - n
        if extra == 0:
            return self

        def pad(x, fill=0.0):
            pad_width = [(0, extra)] + [(0, 0)] * (x.ndim - 1)
            return jnp.pad(x, pad_width, constant_values=fill)

        return GaussianCloud(
            xyz=pad(self.xyz),
            f_dc=pad(self.f_dc),
            f_rest=pad(self.f_rest),
            opacity=pad(self.opacity, -100.0),  # sigmoid -> 0
            scale=pad(self.scale, -20.0),  # exp -> ~0
            rot=pad(self.rot.at[:, :].get(), 0.0).at[n:, 0].set(1.0),
            object_id=pad(self.object_id),
            alive=pad(self.alive, False),
        )


def merge(clouds: Sequence[GaussianCloud]) -> GaussianCloud:
    """Concatenate clouds (reference ``merge_gaussians`` vstack,
    src/gs/gaussian_model.py:584-596) — done once per scene, not per frame."""
    return GaussianCloud(
        xyz=jnp.concatenate([c.xyz for c in clouds], axis=0),
        f_dc=jnp.concatenate([c.f_dc for c in clouds], axis=0),
        f_rest=jnp.concatenate([c.f_rest for c in clouds], axis=0),
        opacity=jnp.concatenate([c.opacity for c in clouds], axis=0),
        scale=jnp.concatenate([c.scale for c in clouds], axis=0),
        rot=jnp.concatenate([c.rot for c in clouds], axis=0),
        object_id=jnp.concatenate([c.object_id for c in clouds], axis=0),
        alive=jnp.concatenate([c.alive for c in clouds], axis=0),
    )
