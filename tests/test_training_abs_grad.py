"""AbsGS densification statistics (TrainConfig.densify_abs_grad) on the
tiled training backend: the per-entry |mean2d cotangent| sums ride the
binning's structure-aware gather VJP."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pegasus_tpu.camera import Camera
from pegasus_tpu.ops.rasterize_ref import rasterize_reference
from pegasus_tpu.testing import make_box_cloud
from pegasus_tpu.training.trainer import GSTrainer, TrainConfig, init_from_points


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    gt_cloud = make_box_cloud(
        rng, n=400, half_extents=(0.08, 0.08, 0.1), rgb=(0.7, 0.3, 0.2),
        object_id=0,
    )
    render = jax.jit(
        lambda cl, c: rasterize_reference(cl, c, max_objects=1, chunk=512)
    )
    cams, gts = [], []
    for az in np.linspace(0, 2 * np.pi, 4, endpoint=False):
        eye = (0.5 * np.cos(az), 0.5 * np.sin(az), 0.35)
        cam = Camera.look_at(
            eye=eye, target=(0, 0, 0), up=(0, 0, 1),
            fovx=np.deg2rad(50), fovy=np.deg2rad(50), width=32, height=32,
        )
        cams.append(cam)
        gts.append(jnp.clip(render(gt_cloud, cam).rgb, 0, 1))
    config = TrainConfig(capacity=512, densify_from_iter=10_000)
    rng2 = np.random.default_rng(0)
    idx = rng2.choice(gt_cloud.num_splats, 200, replace=False)
    pts = np.asarray(gt_cloud.xyz)[idx] + rng2.normal(size=(200, 3)) * 0.01
    cloud0 = init_from_points(pts, np.full((200, 3), 0.5, np.float32), config)
    return config, cams, gts, cloud0


def test_abs_grad_probe_dominates_signed(setup):
    """densify_abs_grad (AbsGS-style |per-tile| accumulation): the abs
    statistic must (a) dominate the signed norm per splat, (b) strictly
    exceed it for some multi-tile splat (signed per-tile gradients
    cancel; that cancellation is the statistic's whole point), and
    (c) preserve visibility semantics (nonzero exactly where the signed
    probe could be)."""
    config, cams, gts, cloud0 = setup
    t_signed = GSTrainer(config, width=32, height=32, backend="tiled")
    cfg_abs = TrainConfig(
        **{**config.__dict__, "densify_abs_grad": True}
    )
    t_abs = GSTrainer(cfg_abs, width=32, height=32)
    s0 = t_signed.init_state(cloud0, spatial_lr_scale=0.5)

    s_sig, m_sig = t_signed.train_step(s0, cams[0], gts[0])
    s_abs, m_abs = t_abs.train_step(s0, cams[0], gts[0])
    # the probe does not change the loss or the parameter step
    assert np.isclose(float(m_sig["loss"]), float(m_abs["loss"]), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(s_sig.cloud.xyz), np.asarray(s_abs.cloud.xyz),
        rtol=1e-5, atol=1e-7,
    )
    g_sig = np.asarray(s_sig.xyz_grad_accum)
    g_abs = np.asarray(s_abs.xyz_grad_accum)
    # dominance: sum of |per-tile| >= |sum| (triangle inequality), up to
    # float tolerance; both are post pixel->NDC rescale so directly
    # comparable
    assert np.all(g_abs >= g_sig * (1 - 1e-4) - 1e-12)
    # teeth: at 32x32 / tile 16 the box spans tiles, so cancellation is
    # present and the abs statistic strictly exceeds the signed one
    assert g_abs.max() > g_sig.max() * 1.01
    # visibility agreement
    np.testing.assert_array_equal(g_abs > 0, g_sig > 0)


def test_auto_backend_is_tiled_and_unknown_refused(setup):
    config, *_ = setup
    assert GSTrainer(config, width=32, height=32).backend == "tiled"
    with pytest.raises(ValueError, match="pallas"):
        GSTrainer(config, width=32, height=32, backend="pallas")
