"""Pinhole camera model (jittable pytree) and COLMAP-convention helpers.

Replaces the Inria ``scene.cameras.Camera`` consumed by the reference
(reference: src/gs/pegasus_setup.py:130-140).  Conventions:

* COLMAP extrinsics: x_cam = R_w2c @ x_world + t_w2c, +z forward.
* The Inria Camera is constructed with R = R_w2c^T (camera-to-world
  rotation) and T = t_w2c; ``from_inria`` accepts that layout.
* Pixel mapping follows the CUDA rasterizer's ndc2Pix:
  pix = ((ndc + 1) * size - 1) / 2, i.e. principal point (size-1)/2
  (the BOP writer instead reports cx = W/2; we keep both conventions in
  their respective places, like the reference does).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from pegasus_tpu.utils import pytree
from jax.lax import Precision

_PREC = Precision.HIGHEST

from pegasus_tpu.utils.pose import focal2fov, fov2focal  # noqa: F401 (re-export)


@pytree.dataclass
class Camera:
    """World-to-camera extrinsics + pinhole intrinsics.

    Array fields are leaves (vmap/scan over camera batches); image size is
    static so rendered shapes stay static under jit.
    """

    R_w2c: jnp.ndarray  # [3, 3]
    t_w2c: jnp.ndarray  # [3]
    fovx: jnp.ndarray  # scalar, radians
    fovy: jnp.ndarray  # scalar, radians
    width: int = pytree.field(pytree_node=False, default=640)
    height: int = pytree.field(pytree_node=False, default=480)
    znear: float = pytree.field(pytree_node=False, default=0.01)
    zfar: float = pytree.field(pytree_node=False, default=100.0)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_colmap(cls, qvec, tvec, fovx, fovy, width, height) -> "Camera":
        from pegasus_tpu.utils.pose import qvec2rotmat

        # leaves stay HOST numpy: cameras are built in per-scene host code
        # (trajectory interpolation) and device transfer happens once per
        # chunk at dispatch — eager jnp.asarray here would cost 4 tiny
        # host->device copies per camera
        return cls(
            R_w2c=np.asarray(qvec2rotmat(np.asarray(qvec)), np.float32),
            t_w2c=np.asarray(tvec, np.float32),
            fovx=np.float32(fovx),
            fovy=np.float32(fovy),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def from_inria(cls, R, T, FoVx, FoVy, width, height) -> "Camera":
        """Inria Camera ctor layout: R is camera-to-world rotation, T is the
        world-to-camera translation (reference: src/gs/pegasus_setup.py:130-140
        feeding getWorld2View2)."""
        R = np.asarray(R, np.float32)
        return cls(
            R_w2c=R.T,
            t_w2c=np.asarray(T, np.float32),
            fovx=np.float32(FoVx),
            fovy=np.float32(FoVy),
            width=int(width),
            height=int(height),
        )

    @classmethod
    def look_at(cls, eye, target, up, fovx, fovy, width, height) -> "Camera":
        """Convenience constructor (tests, turntable viewer)."""
        eye = np.asarray(eye, np.float64)
        target = np.asarray(target, np.float64)
        up = np.asarray(up, np.float64)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        R_w2c = np.stack([right, down, fwd], axis=0)
        t_w2c = -R_w2c @ eye
        return cls(
            R_w2c=np.asarray(R_w2c, np.float32),
            t_w2c=np.asarray(t_w2c, np.float32),
            fovx=np.float32(fovx),
            fovy=np.float32(fovy),
            width=int(width),
            height=int(height),
        )

    # -- derived -------------------------------------------------------------

    @property
    def camera_center(self) -> jnp.ndarray:
        return -self.R_w2c.T @ self.t_w2c

    def tan_half_fov(self):
        return jnp.tan(0.5 * self.fovx), jnp.tan(0.5 * self.fovy)

    def focal_px(self):
        tx, ty = self.tan_half_fov()
        return self.width / (2.0 * tx), self.height / (2.0 * ty)

    def K(self, bop_convention: bool = False) -> jnp.ndarray:
        """3x3 intrinsics.  bop_convention=True uses cx=W/2 (what the
        reference's BOP writer records, src/tools/pegasus_bop.py:358-366);
        False uses the rasterizer's (W-1)/2."""
        fx, fy = self.focal_px()
        if bop_convention:
            cx, cy = self.width / 2.0, self.height / 2.0
        else:
            cx, cy = (self.width - 1) / 2.0, (self.height - 1) / 2.0
        return jnp.array(
            [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=jnp.float32
        )

    def world_to_cam(self, pts: jnp.ndarray) -> jnp.ndarray:
        """[N,3] world points -> camera frame."""
        return jnp.matmul(pts, self.R_w2c.T, precision=_PREC) + self.t_w2c

    def T_w2c(self) -> jnp.ndarray:
        T = jnp.eye(4, dtype=jnp.float32)
        T = T.at[:3, :3].set(self.R_w2c)
        T = T.at[:3, 3].set(self.t_w2c)
        return T


def stack_cameras(cams) -> Camera:
    """Stack same-resolution cameras into a batched Camera (leading axis)."""
    import jax

    if not cams:
        raise ValueError("no cameras")
    w, h = cams[0].width, cams[0].height
    if any(c.width != w or c.height != h for c in cams):
        raise ValueError("stack_cameras requires uniform resolution")
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *cams)
