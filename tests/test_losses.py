"""Loss numerics: the separable SSIM blur must equal the dense 11x11
window (reference: the gaussian-splatting submodule's utils/loss_utils.py
SSIM, driven by src/gs/gs_training.py:46-47), and gs_loss must match the
Inria objective shape (1-lambda)*L1 + lambda*(1-SSIM)."""

import numpy as np
import jax
import jax.numpy as jnp

from pegasus_tpu.training.losses import _gaussian_window, gs_loss, ssim


def _ssim_dense(img1, img2, window_size=11):
    """The pre-round-3 dense grouped-conv formulation (kept as the test
    oracle; the shipped ssim() is separable for speed)."""
    c1, c2 = 0.01**2, 0.03**2
    win = _gaussian_window(window_size)[:, :, None, None]

    def filt(x):
        x4 = x[None]
        ch = x.shape[-1]
        k = jnp.tile(win, (1, 1, 1, ch))
        return jax.lax.conv_general_dilated(
            x4, k, window_strides=(1, 1), padding="SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=ch,
        )[0]

    mu1, mu2 = filt(img1), filt(img2)
    s1 = filt(img1 * img1) - mu1 * mu1
    s2 = filt(img2 * img2) - mu2 * mu2
    s12 = filt(img1 * img2) - mu1 * mu2
    s = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    )
    return jnp.mean(s)


def test_separable_ssim_matches_dense(rng):
    a = jnp.asarray(rng.random((40, 56, 3)), jnp.float32)
    b = jnp.asarray(rng.random((40, 56, 3)), jnp.float32)
    np.testing.assert_allclose(
        float(ssim(a, b)), float(_ssim_dense(a, b)), atol=2e-6
    )
    # identical images -> SSIM 1
    np.testing.assert_allclose(float(ssim(a, a)), 1.0, atol=1e-5)


def test_separable_ssim_grads_match_dense(rng):
    a = jnp.asarray(rng.random((32, 32, 3)), jnp.float32)
    b = jnp.asarray(rng.random((32, 32, 3)), jnp.float32)
    g_new = jax.grad(lambda x: ssim(x, b))(a)
    g_ref = jax.grad(lambda x: _ssim_dense(x, b))(a)
    np.testing.assert_allclose(
        np.asarray(g_new), np.asarray(g_ref), atol=1e-6
    )


def test_gs_loss_objective_shape(rng):
    a = jnp.asarray(rng.random((24, 24, 3)), jnp.float32)
    b = jnp.asarray(rng.random((24, 24, 3)), jnp.float32)
    lam = 0.2
    loss, aux = gs_loss(a, b, lam)
    expect = (1 - lam) * float(aux["l1"]) + lam * (1 - float(aux["ssim"]))
    np.testing.assert_allclose(float(loss), expect, rtol=1e-6)
    np.testing.assert_allclose(
        float(aux["l1"]), float(jnp.mean(jnp.abs(a - b))), rtol=1e-6
    )
