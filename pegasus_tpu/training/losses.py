"""Training losses: L1 + D-SSIM, the Inria 3DGS objective.

The reference trains its assets through the gaussian-splatting submodule's
``train.training`` (reference: src/gs/gs_training.py:46-47), whose loss is
(1 - lambda) * L1 + lambda * (1 - SSIM), lambda = 0.2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _gaussian_1d(size: int = 11, sigma: float = 1.5) -> jnp.ndarray:
    x = jnp.arange(size, dtype=jnp.float32) - size // 2
    g = jnp.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> jnp.ndarray:
    g = _gaussian_1d(size, sigma)
    return jnp.outer(g, g)


def ssim(img1: jnp.ndarray, img2: jnp.ndarray, window_size: int = 11) -> jnp.ndarray:
    """Mean SSIM over an [H, W, C] image pair in [0, 1].

    The Gaussian window is SEPARABLE (outer(g, g)), so each blur is two
    rank-1 convs — 2*S instead of S^2 taps — and channels fold into the
    conv BATCH dim rather than a grouped-conv feature dim (grouped convs
    with feature_group_count > 1 can leave the fast conv path).  Numerics
    are identical to the 2-D window up to float addition order.
    """
    c1 = 0.01**2
    c2 = 0.03**2
    g = _gaussian_1d(window_size)

    def filt(x):
        # [H, W, C] -> channels as batch: [C, H, W, 1]
        ch = x.shape[-1]
        x4 = jnp.transpose(x, (2, 0, 1))[..., None]
        for k in (
            g[:, None, None, None],  # [S, 1, 1, 1] vertical
            g[None, :, None, None],  # [1, S, 1, 1] horizontal
        ):
            x4 = jax.lax.conv_general_dilated(
                x4, k,
                window_strides=(1, 1),
                padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                # fp32 taps: reduced-precision conv inputs would put
                # ~0.4% noise on mu/sigma; at 2x11 taps fp32 is free
                precision=jax.lax.Precision.HIGHEST,
            )
        return jnp.transpose(x4[..., 0], (1, 2, 0))  # back to [H, W, C]

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    s = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return jnp.mean(s)


def gs_loss(pred: jnp.ndarray, gt: jnp.ndarray, lambda_dssim: float = 0.2):
    l1 = jnp.mean(jnp.abs(pred - gt))
    s = ssim(pred, gt)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - s), {
        "l1": l1,
        "ssim": s,
    }
