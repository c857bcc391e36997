"""The Triton-route compositor kernel (ops/rasterize_pallas.py) in
interpret mode: channel padding, empty tiles, unaligned segment starts and
segments many chunks long, each against the golden renderer; and the
compiled kernel on an NVIDIA GPU (``gpu`` marker)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import merge
from pegasus_tpu.ops.binning import TileBins, bin_splats
from pegasus_tpu.ops.projection import project_gaussians
from pegasus_tpu.ops.rasterize_pallas import (composite_tiles_pallas,
                                              out_channels, rasterize_pallas)
from pegasus_tpu.ops.rasterize_ref import rasterize_reference
from pegasus_tpu.ops.validate import psnr_db
from pegasus_tpu.testing import make_box_cloud, make_plane_cloud

CHANNELS = ("rgb", "depth", "alpha", "seg_weights", "vis_weights", "amodal")


def _cam(width=32, height=32, eye=(0.4, 0.3, 0.5)):
    return Camera.look_at(
        eye=eye, target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=width, height=height,
    )


def _scene(rng, n_objects=1, n_env=300):
    env = make_plane_cloud(rng, n=n_env, size=1.0)
    objs = [
        make_box_cloud(
            rng, n=60, center=(0.06 * i - 0.1, 0.04 * i - 0.05, 0.08),
            half_extents=(0.04, 0.04, 0.04), object_id=i + 1,
            rgb=((0.2 + 0.1 * i) % 1.0, 0.5, (0.9 - 0.1 * i) % 1.0),
        )
        for i in range(n_objects)
    ]
    return merge([env] + objs)


def _assert_parity(ref, out, gate=40.0):
    for name in CHANNELS:
        a, b = np.asarray(getattr(ref, name)), np.asarray(getattr(out, name))
        assert a.shape == b.shape, name
        peak = max(float(a.max()), 1e-6) if name == "depth" else 1.0
        assert psnr_db(a, b, peak=peak) > gate, name


@pytest.mark.parametrize("k", [1, 3, 8])
def test_kernel_channel_padding(rng, k):
    """5+3K+2 output channels pad to a power of two (>= 16, the narrowest
    Triton product operand); every real channel matches the golden
    renderer, object ids >= K clip to channel K-1 as there."""
    f = out_channels(k)
    assert f >= max(16, 5 + 3 * k + 2) and f & (f - 1) == 0
    assert f < 2 * max(16, 5 + 3 * k + 2)
    scene = _scene(rng, n_objects=min(k + 1, 8))
    cam = _cam()
    ref = rasterize_reference(scene, cam, background=(0.1, 0.2, 0.3),
                              max_objects=k)
    out = rasterize_pallas(scene, cam, background=(0.1, 0.2, 0.3),
                           max_objects=k, chunk=32, interpret=True)
    assert out.seg_weights.shape == (32, 32, k)
    _assert_parity(ref, out)


def test_kernel_empty_tiles(rng):
    """Tiles with no entries composite to pure background, zero weights
    and zero amodal coverage."""
    box = make_box_cloud(rng, n=120, center=(0, 0, 0.08),
                         half_extents=(0.03, 0.03, 0.03), object_id=1)
    cam = _cam(64, 64)
    bins = bin_splats(project_gaussians(box, cam), 64, 64, lane_pad=32)
    counts = np.asarray(bins.tile_count)
    assert (counts == 0).any() and (counts > 0).any()
    bg = jnp.asarray([0.25, 0.5, 0.75], jnp.float32)
    out = composite_tiles_pallas(bins, 64, 64, bg, max_objects=2,
                                 chunk=32, interpret=True)
    _assert_parity(rasterize_reference(box, cam, background=bg,
                                       max_objects=2), out)
    empty = np.repeat(np.repeat(counts.reshape(4, 4) == 0, 16, 0), 16, 1)
    np.testing.assert_array_equal(np.asarray(out.rgb)[empty],
                                  np.broadcast_to(bg, (empty.sum(), 3)))
    for name in ("depth", "alpha", "seg_weights", "vis_weights", "amodal"):
        assert not np.asarray(getattr(out, name))[empty].any(), name


def test_kernel_unaligned_segment_starts(rng):
    """Segments may start at any entry offset, with foreign entries in
    between: the masked loads read exactly each tile's own segment, so
    moving segments to odd offsets amid garbage changes no output bit."""
    scene = _scene(rng, n_objects=2)
    cam = _cam()
    bins = bin_splats(project_gaussians(scene, cam), 32, 32, lane_pad=32)
    start = np.asarray(bins.tile_start)
    count = np.asarray(bins.tile_count)
    params = np.asarray(bins.params_t)
    gap = 5  # odd: no segment keeps a chunk-aligned start
    new_start = start + gap * (np.arange(start.size) + 1)
    width = int(new_start[-1] + count[-1]) + 32
    moved = np.full((params.shape[0], width), 7.0, np.float32)  # garbage
    moved[5] = 0.9  # opaque garbage would show if it were read
    for t in range(start.size):
        moved[:, new_start[t]:new_start[t] + count[t]] = (
            params[:, start[t]:start[t] + count[t]]
        )
    shifted = TileBins(jnp.asarray(moved), jnp.asarray(new_start, jnp.int32),
                       bins.tile_count, bins.n_tiles_x, bins.n_tiles_y,
                       bins.tile)
    bg = jnp.zeros(3, jnp.float32)
    a = composite_tiles_pallas(bins, 32, 32, bg, 3, chunk=16, interpret=True)
    b = composite_tiles_pallas(shifted, 32, 32, bg, 3, chunk=16,
                               interpret=True)
    for name in CHANNELS:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    _assert_parity(rasterize_reference(scene, cam, max_objects=3), b)


def test_kernel_long_segments(rng):
    """Segments many chunks long carry transmittance across chunks."""
    scene = _scene(rng, n_objects=2, n_env=2000)
    cam = _cam()
    chunk = 16
    bins = bin_splats(project_gaussians(scene, cam), 32, 32, lane_pad=chunk)
    assert int(np.asarray(bins.tile_count).max()) >= 8 * chunk
    out = composite_tiles_pallas(bins, 32, 32, jnp.zeros(3, jnp.float32), 3,
                                 chunk=chunk, interpret=True)
    _assert_parity(rasterize_reference(scene, cam, max_objects=3), out)


def test_kernel_rejects_bad_chunk(rng):
    scene = _scene(rng)
    with pytest.raises(ValueError, match="power of two"):
        rasterize_pallas(scene, _cam(), max_objects=2, chunk=24,
                         interpret=True)


@pytest.mark.gpu
def test_compiled_kernel_matches_golden(gpu, rng):
    """The Triton-compiled kernel (no interpreter) against the golden
    renderer, at a real frame size."""
    scene = jax.device_put(_scene(rng, n_objects=6, n_env=20_000), gpu)
    cam = _cam(640, 480)
    ref = jax.jit(lambda s, c: rasterize_reference(s, c, max_objects=8))(
        scene, cam)
    out = jax.jit(lambda s, c: rasterize_pallas(s, c, max_objects=8))(
        scene, cam)
    _assert_parity(ref, out)
