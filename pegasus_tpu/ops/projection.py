"""3D Gaussian -> 2D screen-space projection (EWA splatting), column form.

The shared geometric front-end of every rasterizer backend here (golden
JAX, tiled XLA, Pallas).  Replaces the CUDA ``preprocess`` stage of the
reference's depth-diff-gaussian-rasterization submodule (the kernel invoked
by ``render``, reference: src/gs/render.py:16): world->camera transform,
perspective Jacobian, cov2D with the +0.3 px low-pass, conic inversion,
radius estimate and SH->RGB view-dependent color.

Layout note: every output is a flat [N] column and ALL matrix algebra
is expanded into per-component column arithmetic, so XLA fuses the stage
into a few elementwise kernels instead of batches of tiny [3, 3] matrix
products.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.utils import sh as shlib


class ProjectedGaussians(NamedTuple):
    """Screen-space splats as flat columns (one entry per input splat)."""

    mean_x: jnp.ndarray  # [N] pixel coords
    mean_y: jnp.ndarray
    conic_a: jnp.ndarray  # inverse cov2D upper triangle
    conic_b: jnp.ndarray
    conic_c: jnp.ndarray
    color_r: jnp.ndarray  # view-dependent RGB (>= 0)
    color_g: jnp.ndarray
    color_b: jnp.ndarray
    opacity: jnp.ndarray  # post-sigmoid alpha multiplier
    depth: jnp.ndarray  # camera-space z
    radius: jnp.ndarray  # pixel radius (3 sigma); 0 for invalid
    object_id: jnp.ndarray  # int32
    valid: jnp.ndarray  # bool


def project_gaussians(
    cloud: GaussianCloud,
    cam: Camera,
    sh_degree: int | None = None,
    scaling_modifier: float = 1.0,
    near: float = 0.2,
) -> ProjectedGaussians:
    x, y, z = cloud.xyz[:, 0], cloud.xyz[:, 1], cloud.xyz[:, 2]
    R = cam.R_w2c
    t = cam.t_w2c

    # world -> camera (columns)
    tx_c = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    ty_c = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    tz_c = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    in_front = tz_c > near  # CUDA near-cull

    tanx, tany = cam.tan_half_fov()
    fx, fy = cam.focal_px()

    tz_safe = jnp.where(in_front, tz_c, 1.0)
    limx = 1.3 * tanx
    limy = 1.3 * tany
    txtz = jnp.clip(tx_c / tz_safe, -limx, limx)
    tytz = jnp.clip(ty_c / tz_safe, -limy, limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    # world-space covariance Sigma = Rq S^2 Rq^T, expanded per component
    q = cloud.get_rotation()
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s = scaling_modifier * cloud.get_scaling()
    s0, s1, s2 = s[:, 0] ** 2, s[:, 1] ** 2, s[:, 2] ** 2
    # Sigma_ij = sum_k r_ik s_k^2 r_jk (symmetric, 6 unique components)
    sg00 = r00 * r00 * s0 + r01 * r01 * s1 + r02 * r02 * s2
    sg01 = r00 * r10 * s0 + r01 * r11 * s1 + r02 * r12 * s2
    sg02 = r00 * r20 * s0 + r01 * r21 * s1 + r02 * r22 * s2
    sg11 = r10 * r10 * s0 + r11 * r11 * s1 + r12 * r12 * s2
    sg12 = r10 * r20 * s0 + r11 * r21 * s1 + r12 * r22 * s2
    sg22 = r20 * r20 * s0 + r21 * r21 * s1 + r22 * r22 * s2

    # M = J @ W rows (J = perspective Jacobian, W = R_w2c), per column
    z_inv = 1.0 / tz_safe
    z_inv2 = z_inv * z_inv
    j00 = fx * z_inv
    j02 = -fx * tx * z_inv2
    j11 = fy * z_inv
    j12 = -fy * ty * z_inv2
    # u = row0 of J@W, v = row1
    u0 = j00 * R[0, 0] + j02 * R[2, 0]
    u1 = j00 * R[0, 1] + j02 * R[2, 1]
    u2 = j00 * R[0, 2] + j02 * R[2, 2]
    v0 = j11 * R[1, 0] + j12 * R[2, 0]
    v1 = j11 * R[1, 1] + j12 * R[2, 1]
    v2 = j11 * R[1, 2] + j12 * R[2, 2]

    # cov2D = [u; v] Sigma [u; v]^T + 0.3 I
    su0 = sg00 * u0 + sg01 * u1 + sg02 * u2
    su1 = sg01 * u0 + sg11 * u1 + sg12 * u2
    su2 = sg02 * u0 + sg12 * u1 + sg22 * u2
    sv0 = sg00 * v0 + sg01 * v1 + sg02 * v2
    sv1 = sg01 * v0 + sg11 * v1 + sg12 * v2
    sv2 = sg02 * v0 + sg12 * v1 + sg22 * v2
    cov_a = u0 * su0 + u1 * su1 + u2 * su2 + 0.3
    cov_b = u0 * sv0 + u1 * sv1 + u2 * sv2
    cov_c = v0 * sv0 + v1 * sv1 + v2 * sv2 + 0.3

    det = cov_a * cov_c - cov_b * cov_b
    nondegenerate = det > 0.0
    det_safe = jnp.where(nondegenerate, det, 1.0)
    inv_det = 1.0 / det_safe
    conic_a = cov_c * inv_det
    conic_b = -cov_b * inv_det
    conic_c = cov_a * inv_det

    # 3-sigma radius from the larger eigenvalue (CUDA: ceil(3 sqrt(lambda1)))
    mid = 0.5 * (cov_a + cov_c)
    lam1 = mid + jnp.sqrt(jnp.maximum(0.1, mid * mid - det))
    radius = jnp.ceil(3.0 * jnp.sqrt(lam1))

    # pixel-space mean; ndc2Pix convention ((ndc+1)*S - 1) / 2
    mean_x = ((tx_c / (tanx * tz_safe) + 1.0) * cam.width - 1.0) * 0.5
    mean_y = ((ty_c / (tany * tz_safe) + 1.0) * cam.height - 1.0) * 0.5

    # view-dependent color: dir from camera center to splat (CUDA convention)
    if sh_degree is None:
        sh_degree = cloud.sh_degree
    c = cam.camera_center
    dx, dy, dz = x - c[0], y - c[1], z - c[2]
    inv_n = 1.0 / jnp.maximum(jnp.sqrt(dx * dx + dy * dy + dz * dz), 1e-12)
    dirs = jnp.stack([dx * inv_n, dy * inv_n, dz * inv_n], axis=-1)
    feats = cloud.get_features()[:, : (sh_degree + 1) ** 2, :]
    color = jnp.maximum(shlib.eval_sh(sh_degree, feats, dirs) + 0.5, 0.0)

    valid = cloud.alive & in_front & nondegenerate

    return ProjectedGaussians(
        mean_x=mean_x,
        mean_y=mean_y,
        conic_a=conic_a,
        conic_b=conic_b,
        conic_c=conic_c,
        color_r=color[:, 0],
        color_g=color[:, 1],
        color_b=color[:, 2],
        opacity=cloud.get_opacity()[:, 0],
        depth=tz_c,
        radius=jnp.where(valid, radius, 0.0),
        valid=valid,
        object_id=cloud.object_id,
    )


def splat_alpha_at_pixels(
    proj: ProjectedGaussians, px: jnp.ndarray, py: jnp.ndarray
) -> jnp.ndarray:
    """Per (pixel, splat) alpha with the CUDA cutoffs.

    px, py: [P] pixel centers. Returns [P, N] alphas in [0, 0.99].
    Contribution rules match the reference rasterizer: power > 0 -> skip,
    alpha < 1/255 -> skip, plus our (documented) pixel-granular 3-sigma box
    cull standing in for CUDA's tile-granularity rect cull.
    """
    dx = px[:, None] - proj.mean_x[None, :]  # [P, N]
    dy = py[:, None] - proj.mean_y[None, :]
    a, b, c = proj.conic_a[None, :], proj.conic_b[None, :], proj.conic_c[None, :]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = proj.opacity[None, :] * jnp.exp(jnp.minimum(power, 0.0))
    alpha = jnp.minimum(alpha, 0.99)
    inside = (jnp.abs(dx) <= proj.radius[None, :]) & (
        jnp.abs(dy) <= proj.radius[None, :]
    )
    keep = (
        (power <= 0.0)
        & (alpha >= 1.0 / 255.0)
        & inside
        & proj.valid[None, :]
    )
    return jnp.where(keep, alpha, 0.0)
