"""Real spherical harmonics in the Inria-3DGS basis, plus SH rotation.

The per-splat appearance of a Gaussian cloud is stored as SH coefficients
(deg 3: one DC + 15 higher-order coefficients per color channel,
reference: src/gs/gaussian_model.py:54-69, pegasus.py:41).

SH *rotation* is needed whenever an object is posed into a scene
(reference rotates bands l=1..3 with e3nn Wigner-D matrices and a yzx axis
permutation, src/gs/gaussian_model.py:507-546).  We avoid the Wigner
recursion + permutation quirks entirely: because the real SH of band l span
an invariant (2l+1)-dim space, the band rotation matrix is recovered
*exactly* from basis evaluations at a fixed well-conditioned direction set:

    Y_i(R d) = sum_j D[i, j] Y_j(d)   =>   D^T = pinv(Y(dirs)) @ Y(dirs @ R^T)

``pinv(Y(dirs))`` is a compile-time constant; computing D per (object,
frame) is a handful of tiny matmuls — ideal for XLA.  Correctness is gated
by the functional identity  rotated_f(d) == f(R^-1 d)  in tests.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax.lax import Precision

_PREC = Precision.HIGHEST  # this build defaults matmuls to bf16-class precision

# Inria sh_utils constants
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def rgb2sh(rgb):
    """RGB in [0,1] -> DC SH coefficient (Inria utils.sh_utils.RGB2SH)."""
    return (jnp.asarray(rgb) - 0.5) / C0


def sh2rgb(sh):
    """DC SH coefficient -> RGB (Inria utils.sh_utils.SH2RGB)."""
    return jnp.asarray(sh) * C0 + 0.5


def _basis_band1(d, xp=jnp):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return xp.stack([-C1 * y, C1 * z, -C1 * x], axis=-1)


def _basis_band2(d, xp=jnp):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return xp.stack(
        [
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z,
            C2[4] * (xx - yy),
        ],
        axis=-1,
    )


def _basis_band3(d, xp=jnp):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return xp.stack(
        [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * x * y * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ],
        axis=-1,
    )


_BAND_FNS = {1: _basis_band1, 2: _basis_band2, 3: _basis_band3}
_BAND_DIMS = {1: 3, 2: 5, 3: 7}


def eval_sh(deg: int, sh, dirs):
    """Evaluate SH radiance; matches Inria ``eval_sh``.

    Args:
      deg: active SH degree (0..3).
      sh:  [..., (deg+1)^2, C] coefficients (DC first, Inria storage order).
      dirs: [..., 3] unit view directions (splat -> camera convention of the
        rasterizer: direction from camera center to splat, normalized).

    Returns [..., C] raw radiance (caller adds +0.5 and clamps, as the CUDA
    rasterizer does).
    """
    # broadcast-FMA formulation: tiny contraction dims make einsum/matmul a
    # poor fit; explicit multiply-adds fuse into the elementwise kernel.
    result = C0 * sh[..., 0, :]
    if deg >= 1:
        b1 = _basis_band1(dirs)  # [..., 3]
        for i in range(3):
            result = result + b1[..., i : i + 1] * sh[..., 1 + i, :]
    if deg >= 2:
        b2 = _basis_band2(dirs)
        for i in range(5):
            result = result + b2[..., i : i + 1] * sh[..., 4 + i, :]
    if deg >= 3:
        b3 = _basis_band3(dirs)
        for i in range(7):
            result = result + b3[..., i : i + 1] * sh[..., 9 + i, :]
    return result


# ---------------------------------------------------------------------------
# SH rotation
# ---------------------------------------------------------------------------

def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return np.stack(
        [np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
        axis=-1,
    )


# module-level init stays numpy-only (no device work at import time)
_SAMPLE_DIRS = _fibonacci_sphere(32)  # well-spread, conditioning ~1
_PINV = {}
for _l, _fn in _BAND_FNS.items():
    _B0 = _fn(_SAMPLE_DIRS.astype(np.float32), xp=np)
    _PINV[_l] = np.linalg.pinv(_B0.astype(np.float64)).astype(np.float32)

_SAMPLE_DIRS_J = _SAMPLE_DIRS.astype(np.float32)
_PINV_J = {l: p for l, p in _PINV.items()}


def sh_band_rotation(R, band: int):
    """Exact rotation matrix D_band for the real-SH band under rotation R.

    Satisfies Y_i(R d) = sum_j D[i,j] Y_j(d); for coefficients it holds that
    rotating an object by R maps  c -> D c  (so that the radiance field
    rotates with the object).  Batched over leading dims of R.
    """
    # rotated_k = R @ d_k
    rotated = jnp.einsum("...ij,kj->...ki", R, _SAMPLE_DIRS_J, precision=_PREC)
    B1 = _BAND_FNS[band](rotated)  # [..., 32, 2l+1] where B1[k, i] = Y_i(R d_k)
    Dt = jnp.einsum("jk,...ki->...ji", _PINV_J[band], B1, precision=_PREC)  # [..., 2l+1, 2l+1] = D^T
    return jnp.swapaxes(Dt, -1, -2)


def rotate_sh_rest(f_rest, R, deg: int = 3):
    """Rotate higher-order SH coefficients by rotation matrix R.

    Functional equivalent of the reference's per-band Wigner-D rotation
    (reference: src/gs/gaussian_model.py:507-546) without e3nn.

    Args:
      f_rest: [N, 15, C] band-1..3 coefficients (Inria storage layout).
      R: [3, 3] rotation.
    Returns rotated [N, 15, C].
    """
    outs = []
    start = 0
    for band in range(1, deg + 1):
        dim = _BAND_DIMS[band]
        D = sh_band_rotation(R, band)  # [dim, dim]
        block = f_rest[:, start : start + dim, :]  # [N, dim, C]
        outs.append(jnp.einsum("ij,njc->nic", D, block, precision=_PREC))
        start += dim
    if start < f_rest.shape[1]:
        outs.append(f_rest[:, start:, :])
    return jnp.concatenate(outs, axis=1)


# Inria-submodule spelling (utils/sh_utils.py RGB2SH/SH2RGB), imported by
# reference-era code (SURVEY 2.3.4)
RGB2SH = rgb2sh
SH2RGB = sh2rgb
