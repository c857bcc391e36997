"""Pallas compositor parity in interpret mode (tiny scenes; the compiled
GPU kernel is checked against the golden renderer by chip_smoke.py and the
``gpu``-marked test below)."""

import numpy as np
import pytest

from pegasus_tpu.camera import Camera
from pegasus_tpu.gs.cloud import merge
from pegasus_tpu.ops.rasterize_ref import rasterize_reference
from pegasus_tpu.ops.rasterize_pallas import rasterize_pallas
from pegasus_tpu.testing import make_box_cloud, make_plane_cloud


def psnr(a, b, peak=1.0):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10 * np.log10(peak**2 / mse) if mse > 0 else np.inf


def test_pallas_interpret_matches_golden(rng):
    env = make_plane_cloud(rng, n=300, size=1.0)
    box = make_box_cloud(rng, n=150, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=32, height=32,
    )
    ref = rasterize_reference(scene, cam, background=(0.1, 0.1, 0.1), max_objects=2)
    pal = rasterize_pallas(
        scene, cam, background=(0.1, 0.1, 0.1), max_objects=2,
        chunk=128, interpret=True,
    )
    assert psnr(ref.rgb, pal.rgb) > 40
    assert psnr(ref.depth, pal.depth, peak=float(np.asarray(ref.depth).max())) > 40
    for name in ("seg_weights", "vis_weights", "amodal"):
        assert psnr(getattr(ref, name), getattr(pal, name)) > 40, name


def test_entry_cap_overflow_flag(rng):
    """TileBins.overflow: False when the cap holds every live entry,
    True when live entries are truncated (and only then)."""
    import jax

    from pegasus_tpu.ops.binning import bin_splats
    from pegasus_tpu.ops.projection import project_gaussians

    env = make_plane_cloud(rng, n=400, size=1.0)
    box = make_box_cloud(rng, n=200, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=64, height=64,
    )
    proj = project_gaussians(scene, cam)
    free = bin_splats(proj, 64, 64, entry_cap=None)
    n_live = int(np.asarray(free.tile_count).sum())
    assert n_live > 8

    roomy = bin_splats(proj, 64, 64, entry_cap=n_live + 16)
    assert not bool(roomy.overflow)
    assert int(np.asarray(roomy.tile_count).sum()) == n_live

    exact = bin_splats(proj, 64, 64, entry_cap=n_live)
    assert not bool(exact.overflow)

    truncated = bin_splats(proj, 64, 64, entry_cap=n_live - 8)
    assert bool(truncated.overflow)
    assert int(np.asarray(truncated.tile_count).sum()) == n_live - 8

    # flag also computes under jit
    jf = jax.jit(
        lambda p: bin_splats(p, 64, 64, entry_cap=n_live - 8).overflow
    )
    assert bool(jf(proj))


def test_mid_bucket_recovers_clipped_footprints(rng):
    """Footprint-stratified mid bucket: a_small=2 alone clips >2-tile
    footprints once the big winners run out; routing the next splats by
    area through an a_mid-slot grid must restore coverage (image parity
    vs the golden renderer), and must never LOSE coverage (live entries
    are a superset of the clipped configuration's)."""
    import pytest

    from pegasus_tpu.ops.binning import bin_splats
    from pegasus_tpu.ops.projection import project_gaussians

    env = make_plane_cloud(rng, n=400, size=1.0)
    box = make_box_cloud(rng, n=200, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=64, height=64,
    )
    proj = project_gaussians(scene, cam)
    n = int(np.asarray(proj.mean_x).shape[0])

    ref = rasterize_reference(scene, cam, max_objects=2)
    kw = dict(max_objects=2, chunk=128, interpret=True, a_small=2,
              big_budget=8, a_big=16)
    clipped = rasterize_pallas(scene, cam, mid_budget=0, **kw)
    strat = rasterize_pallas(scene, cam, mid_budget=n, a_mid=16, **kw)
    psnr_clipped = psnr(ref.rgb, clipped.rgb)
    psnr_strat = psnr(ref.rgb, strat.rgb)
    # the scene genuinely clips without the mid bucket (the test has teeth)
    assert psnr_clipped < 40, psnr_clipped
    assert psnr_strat > 40, psnr_strat
    assert psnr_strat > psnr_clipped + 5

    # coverage is restored at the binning level too: the stratified
    # configuration's live entry count reaches unclipped binning's (the
    # core window of an over-budget splat may add harmless extra tiles,
    # so >= rather than ==)
    full = bin_splats(proj, 64, 64, a_small=64, big_budget=8, a_big=64)
    strat_bins = bin_splats(
        proj, 64, 64, a_small=2, big_budget=8, a_big=16,
        mid_budget=n, a_mid=16,
    )
    assert (
        int(np.asarray(strat_bins.tile_count).sum())
        >= int(np.asarray(full.tile_count).sum())
    )

    # training path refuses the mid bucket (its VJP transposes the
    # 2-bucket slot structure)
    with pytest.raises(ValueError):
        bin_splats(
            proj, 64, 64, a_small=2, mid_budget=16, with_entry_origin=True
        )


def _assert_bins_equal(a, b):
    for field in ("params_t", "tile_start", "tile_count"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, field)), np.asarray(getattr(b, field)),
            err_msg=field,
        )
    assert bool(a.overflow) == bool(b.overflow)


def test_adaptive_mid_matches_static(rng):
    """adaptive_mid picks per frame between the base and base+mid sorts
    via lax.cond; BOTH outcomes must be bit-identical to the equivalent
    static configuration (the mid bucket only adds coverage when over-core
    splats outnumber big_budget, so skipping it below that is exact)."""
    import jax

    from pegasus_tpu.ops.binning import bin_splats
    from pegasus_tpu.ops.projection import project_gaussians

    env = make_plane_cloud(rng, n=400, size=1.0)
    box = make_box_cloud(rng, n=200, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=64, height=64,
    )
    proj = project_gaussians(scene, cam)
    n = int(np.asarray(proj.mean_x).shape[0])
    area = np.asarray(bin_splats(proj, 64, 64, a_small=2, _stage="area"))
    n_over = int((area > 2).sum())

    # case B: over-core splats exceed the big budget -> mid branch taken
    assert n_over > 8  # the scenario has teeth
    kw = dict(a_small=2, big_budget=8, a_big=16, mid_budget=n, a_mid=16,
              entry_cap=800)
    static = bin_splats(proj, 64, 64, **kw)
    adaptive = jax.jit(
        lambda p: bin_splats(p, 64, 64, adaptive_mid=True, **kw)
    )(proj)
    _assert_bins_equal(adaptive, static)

    # case A: big budget swallows every over-core splat -> base branch
    # taken; must equal BOTH the static-mid and the no-mid configuration
    assert n_over <= n - 8
    kw_a = dict(a_small=2, big_budget=n - 8, a_big=16, mid_budget=8,
                a_mid=16, entry_cap=800)
    static_mid = bin_splats(proj, 64, 64, **kw_a)
    no_mid = bin_splats(
        proj, 64, 64, a_small=2, big_budget=n - 8, a_big=16, mid_budget=0,
        entry_cap=800,
    )
    adaptive_a = jax.jit(
        lambda p: bin_splats(p, 64, 64, adaptive_mid=True, **kw_a)
    )(proj)
    _assert_bins_equal(adaptive_a, static_mid)
    _assert_bins_equal(adaptive_a, no_mid)

    # invalid static-shape combinations are refused, not silently wrong
    with pytest.raises(ValueError, match="adaptive_mid"):
        bin_splats(proj, 64, 64, a_small=2, mid_budget=0, entry_cap=800,
                   adaptive_mid=True)
    with pytest.raises(ValueError, match="adaptive_mid"):
        bin_splats(proj, 64, 64, a_small=2, mid_budget=16,
                   adaptive_mid=True)  # no entry_cap
    with pytest.raises(ValueError, match="adaptive_mid"):
        bin_splats(proj, 64, 64, a_small=2, big_budget=8, a_big=16,
                   mid_budget=16, entry_cap=10_000, adaptive_mid=True)


def test_adaptive_mid_rasterize_parity(rng):
    """End-to-end through rasterize_pallas (interpret): adaptive output
    matches the always-on mid configuration pixel for pixel."""
    env = make_plane_cloud(rng, n=400, size=1.0)
    box = make_box_cloud(rng, n=200, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=64, height=64,
    )
    n = scene.num_splats
    kw = dict(max_objects=2, chunk=128, interpret=True, a_small=2,
              big_budget=8, a_big=16, mid_budget=n, a_mid=16,
              entry_cap=800)
    static = rasterize_pallas(scene, cam, adaptive_mid=False, **kw)
    adaptive = rasterize_pallas(scene, cam, adaptive_mid=True, **kw)
    for name in ("rgb", "depth", "seg_weights", "vis_weights", "amodal"):
        np.testing.assert_array_equal(
            np.asarray(getattr(static, name)),
            np.asarray(getattr(adaptive, name)), err_msg=name,
        )


def test_render_outputs_overflow_surface(rng):
    """rasterize_pallas surfaces TileBins.overflow; golden reports False."""
    env = make_plane_cloud(rng, n=300, size=1.0)
    box = make_box_cloud(rng, n=150, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=32, height=32,
    )
    ref = rasterize_reference(scene, cam, max_objects=2)
    assert not bool(ref.overflow)
    ok = rasterize_pallas(scene, cam, max_objects=2, chunk=128, interpret=True)
    assert not bool(ok.overflow)
    tight = rasterize_pallas(
        scene, cam, max_objects=2, chunk=128, interpret=True, entry_cap=64,
    )
    assert bool(tight.overflow)


@pytest.mark.parametrize("width,height", [(4096, 4096), (4096, 64)])
def test_payload_packing_at_large_tile_grids(rng, width, height):
    """Big/mid-bucket winner fields ride the compaction sort as
    bit-packed int32 payload words (binning.py bucket_keys).  4096x4096
    at tile=16 is a 256x256 tile grid — bx=by=8, the 32-bit packing
    boundary where the h-1 field occupies the sign bit; 4096x64 checks
    asymmetric bit widths.  The live (key, src) entry set from a
    small+big+mid configuration must equal a NumPy brute-force of the
    binning contract (every onscreen splat emits each tile of its
    clipped bbox exactly once, keyed tile << depth_bits | depth_rank)
    whenever no footprint exceeds its slot grid."""
    import math

    from pegasus_tpu.ops.binning import bin_splats
    from pegasus_tpu.ops.projection import project_gaussians

    env = make_plane_cloud(rng, n=400, size=1.0)
    box = make_box_cloud(rng, n=200, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(7.2, 5.6, 8.8), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45),
        width=width, height=height,
    )
    proj = project_gaussians(scene, cam)
    n = int(np.asarray(proj.mean_x).shape[0])
    tile = 16
    ntx, nty = -(-width // tile), -(-height // tile)
    n_tiles = ntx * nty
    depth_bits = 31 - max(1, math.ceil(math.log2(n_tiles + 2)))

    # brute-force expected entry set
    mx, my = np.asarray(proj.mean_x), np.asarray(proj.mean_y)
    r = np.asarray(proj.radius)
    tx0 = np.clip(np.floor((mx - r) / tile), 0, ntx - 1).astype(np.int64)
    tx1 = np.clip(np.floor((mx + r) / tile), 0, ntx - 1).astype(np.int64)
    ty0 = np.clip(np.floor((my - r) / tile), 0, nty - 1).astype(np.int64)
    ty1 = np.clip(np.floor((my + r) / tile), 0, nty - 1).astype(np.int64)
    onscreen = (
        np.asarray(proj.valid)
        & (mx + r >= 0) & (mx - r < width)
        & (my + r >= 0) & (my - r < height)
    )
    area = np.where(onscreen, (tx1 - tx0 + 1) * (ty1 - ty0 + 1), 0)
    a_slots = 144
    assert area.max() <= a_slots  # precondition: nothing clamps
    assert (area > 2).sum() > 8  # teeth: the mid bucket engages
    rank = (
        np.asarray(proj.depth, np.float32).view(np.int32).astype(np.int64)
        >> (31 - depth_bits)
    )
    expected = set()
    for i in np.nonzero(area > 0)[0]:
        for ty in range(ty0[i], ty1[i] + 1):
            for tx in range(tx0[i], tx1[i] + 1):
                expected.add((int(((ty * ntx + tx) << depth_bits)
                                  | rank[i]), int(i)))

    keys, srcs = bin_splats(
        proj, width, height, tile=tile, a_small=2, big_budget=8,
        a_big=a_slots, mid_budget=n, a_mid=a_slots, _stage="sort",
    )
    sentinel = n_tiles << depth_bits
    keys, srcs = np.asarray(keys), np.asarray(srcs)
    live = keys != sentinel
    got = set(zip(keys[live].tolist(), srcs[live].tolist()))
    assert got == expected


def test_payload_packing_sign_bit_fields():
    """A splat spanning the FULL 256x256 tile grid at 4096x4096 puts
    h_t-1 = 255 into packA's top byte — bits 24..31 including the int32
    sign bit (binning.py pack_a at bx=by=8).  The unpack must use
    logical shifts: every live entry of the giant splat must carry its
    own src index, a tile inside its bbox, and its exact depth rank."""
    import math

    import jax.numpy as jnp

    from pegasus_tpu.ops.binning import bin_splats
    from pegasus_tpu.ops.projection import ProjectedGaussians

    width = height = 4096
    tile = 16
    ntx = nty = width // tile
    n_tiles = ntx * nty
    depth_bits = 31 - max(1, math.ceil(math.log2(n_tiles + 2)))

    # splat 0: giant (covers the whole grid); splats 1..8: small fillers
    n = 9
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    proj = ProjectedGaussians(
        mean_x=f32([2048.0] + [100.0 * i for i in range(1, n)]),
        mean_y=f32([2048.0] + [80.0 * i for i in range(1, n)]),
        conic_a=f32([1e-6] + [0.1] * (n - 1)),
        conic_b=f32([0.0] * n),
        conic_c=f32([1e-6] + [0.1] * (n - 1)),
        color_r=f32([0.5] * n),
        color_g=f32([0.5] * n),
        color_b=f32([0.5] * n),
        opacity=f32([0.9] * n),
        depth=f32([5.0] + [1.0 + 0.1 * i for i in range(1, n)]),
        radius=f32([4096.0] + [24.0] * (n - 1)),
        object_id=jnp.zeros((n,), jnp.int32),
        valid=jnp.ones((n,), bool),
    )
    a_big = 64
    keys, srcs = bin_splats(
        proj, width, height, tile=tile, a_small=2, big_budget=4,
        a_big=a_big, _stage="sort",
    )
    sentinel = n_tiles << depth_bits
    keys, srcs = np.asarray(keys), np.asarray(srcs)
    live = keys != sentinel
    giant = live & (srcs == 0)
    # the giant splat emits its core + the clamped a_big grid (minus
    # core overlap), never more, never zero
    count = int(giant.sum())
    assert 2 <= count <= 2 + a_big
    rank_exp = int(
        np.float32(5.0).view(np.int32) >> np.int32(31 - depth_bits)
    )
    tiles = keys[giant] >> depth_bits
    assert np.all((keys[giant] & ((1 << depth_bits) - 1)) == rank_exp)
    assert np.all((tiles >= 0) & (tiles < n_tiles))
    # sign-bit corruption scatters tiles outside the clamped window
    # around the mean tile (128, 128); the window is at most 12x12
    txs, tys = tiles % ntx, tiles // ntx
    assert np.all(np.abs(txs - 128) <= 8)
    assert np.all(np.abs(tys - 128) <= 8)


def test_entry_cap_overflow_propagates_to_frame(rng):
    """A cap smaller than the live entry count must flag overflow, and the
    flag must survive decode_modalities so the generation loop can surface
    it per scene (pegasus.py generate_dataset -> binning_overflow_frames).
    Motivation: a distant camera that keeps the whole 1M bench scene
    onscreen overflows the 1.8N production cap."""
    from pegasus_tpu.ops.render import render_frame

    env = make_plane_cloud(rng, n=300, size=1.0)
    box = make_box_cloud(rng, n=150, center=(0, 0, 0.08), object_id=1)
    scene = merge([env, box])
    cam = Camera.look_at(
        eye=(0.4, 0.3, 0.5), target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(55), fovy=np.deg2rad(45), width=32, height=32,
    )
    colors = np.asarray([[1.0, 0.0, 0.0]], np.float32)

    frame = render_frame(
        scene, cam, colors, max_objects=2,
        rasterize_fn=rasterize_pallas, chunk=128, interpret=True,
        entry_cap=64,  # far below the live entry count of 450 splats
    )
    assert bool(frame.overflow)

    frame_ok = render_frame(
        scene, cam, colors, max_objects=2,
        rasterize_fn=rasterize_pallas, chunk=128, interpret=True,
    )
    assert not bool(frame_ok.overflow)
