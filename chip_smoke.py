#!/usr/bin/env python3
"""Run the generation path once on an NVIDIA GPU and check what it makes.

    python chip_smoke.py               # one card: phases a-e
    python chip_smoke.py --four-cards  # four cards: phase f only

Phases, each printing one fact per line:
  a  device: JAX's first device must be a GPU; prints the card's name and
     power limit as nvidia-smi reports them;
  b  compositor parity: the platform compositor (ops/backends.py) against
     the golden renderer, which runs at Precision.HIGHEST, on the 210k
     orbit, 1M orbit and 1M grazing bench views; every channel > 40 dB;
  c  physics: the 310-step drop of six objects on the GPU against the same
     drop on the CPU;
  d  timings: the Triton kernel against the plain XLA compositor
     (composite_tiles_xla) on the same binned entries — frames/s at both
     bench scenes and one whole 300-frame scene each;
  e  end to end: ``pegasus_tpu.generate.main`` writes a static and a
     dynamic 300-frame scene at 640x480; the BOP tree is checked;
  f  (--four-cards) scene-parallel generation of 4 scenes on a 4-card
     mesh against a 1-card mesh, and 2 data-parallel training steps on 4
     cards against 1 card.

A failed phase prints its traceback and the script goes on to the next;
any failure makes it exit 1.  Only when every phase passed does it print,
as the last line of standard output,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU it exits 2 and prints no result.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

GATE_DB = 40.0
# The drop's contractions run in float32 on both devices (rigid_body.py
# asks for HIGHEST; in TF32 the rest poses end centimetres apart), but
# the GPU sums in another order and XLA fuses differently, and 310 steps
# of contact resolution amplify last-bit differences (measured 2.3e-6 m
# on an H100).  0.1 mm and 1e-3 per quaternion entry leave room for that
# and still catch any change of contact model or precision.
PHYSICS_POS_TOL_M = 1e-4
PHYSICS_ROT_TOL = 1e-3  # max |q_gpu - q_cpu| per unit-quaternion entry
# plain-version caps: the smallest power of two holding the 40 dB gate
# at each bench scene (the densest tiles hold 5.7k / 15.8k entries)
XLA_CAP = {"210k": 8192, "1m": 16384}
OBJECTS = tuple(f"cup_noodles_{i:02d}" for i in range(1, 7))
OBJECT_CLASSES = [f"CupNoodle{i:02d}" for i in range(1, 7)]
MODALITIES = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]


def say(*parts):
    print(*parts, flush=True)


# -- shared helpers ----------------------------------------------------------


def make_dataset(root: Path, env_splats=150_000, obj_splats=10_000) -> Path:
    from pegasus_tpu.testing import build_synthetic_dataset

    # 48 registered views: 'random' trajectories of 30 cameras need > 30
    return build_synthetic_dataset(
        root, object_names=OBJECTS, env_splats=env_splats,
        obj_splats=obj_splats, n_colmap_images=48,
    )


def generation_config(data: Path, out: Path, name: str, **overrides):
    from pegasus_tpu.config import GenerationConfig

    kw = dict(
        dataset_path=str(data), env_dataset_path=str(data),
        dataset_base_path=str(out), dataset_name=name, num_scenes=1,
        min_num_objects=3, max_num_objects=6, mode="static",
        render_width=640, render_height=480, num_cameras=30,
        num_camera_interpolation_steps=10, simulation_steps=310,
        render_data_points=MODALITIES, save_video=False, seed=1,
        camera_trajectory_mode="random",
    )
    kw.update(overrides)
    return GenerationConfig(**kw)


def plain_rasterize_fn(max_per_tile: int):
    """The plain version: the kernel's own binning, composited by XLA."""
    import jax.numpy as jnp

    from pegasus_tpu.ops.binning import bin_splats
    from pegasus_tpu.ops.projection import project_gaussians
    from pegasus_tpu.ops.rasterize_pallas import binning_defaults
    from pegasus_tpu.ops.rasterize_tiled import composite_tiles_xla

    def rasterize(cloud, cam, background=(0.0, 0.0, 0.0), max_objects=8):
        proj = project_gaussians(cloud, cam)
        bins = bin_splats(
            proj, cam.width, cam.height, lane_pad=0,
            **binning_defaults(proj.mean_x.shape[0]),
        )
        out = composite_tiles_xla(
            bins, cam.width, cam.height,
            jnp.asarray(background, jnp.float32), max_objects=max_objects,
            max_per_tile=max_per_tile,
        )
        return out._replace(overflow=bins.overflow)

    return rasterize


def bench_scene(ctx, scale):
    import bench

    if scale not in ctx["scenes"]:
        ctx["scenes"][scale] = bench.bench_scene(scale)
    return ctx["scenes"][scale]


def golden(ctx, scale, view):
    import bench

    key = (scale, view)
    if key not in ctx["golden"]:
        ctx["golden"][key] = bench.golden_render(
            bench_scene(ctx, scale), bench.bench_camera(view)
        )
    return ctx["golden"][key]


def read_stats(dataset_dir: Path) -> list:
    lines = (dataset_dir / "generation_stats.jsonl").read_text().splitlines()
    return [json.loads(x) for x in lines if x.strip()]


# -- phases --------------------------------------------------------------------


def phase_parity(ctx):
    import jax

    import bench
    from pegasus_tpu.ops.backends import default_rasterize_fn

    rasterize = default_rasterize_fn()
    say(f"b compositor: {rasterize.__module__}.{rasterize.__name__}")
    render = jax.jit(lambda s, c: rasterize(s, c, max_objects=8))
    failed = []
    for scale, view in (("210k", "orbit"), ("1m", "orbit"),
                        ("1m", "grazing")):
        worst, report = bench.parity_report(
            bench_scene(ctx, scale), bench.bench_camera(view), render,
            ref=golden(ctx, scale, view),
        )
        for name, v in report.items():
            say(f"b parity {scale} {view} {name} {v}")
        if worst <= GATE_DB:
            failed.append(f"{scale} {view} {worst} dB")
    if failed:
        raise AssertionError(f"parity gate {GATE_DB} dB failed: {failed}")


def phase_physics(ctx):
    import jax

    from pegasus_tpu.assets.rosters import full_registry
    from pegasus_tpu.physics import rigid_body as rb
    from pegasus_tpu.physics.engine import PhysicsEngine

    data = ctx["data"]
    registry = full_registry(str(data), str(data))
    env = registry.by_class_name("Asphalt")
    rng = np.random.default_rng(5)
    engine = PhysicsEngine(
        asset_folder=str(data / "urdf"),
        output_path_json=str(ctx["tmp"] / "physics" / "drop.json"),
        simulation_steps=310, seed=5,
    )
    engine.add_object(env, start_pos=env.START_POSITION_PYBULLET)
    for name in OBJECT_CLASSES:
        engine.add_object(registry.by_class_name(name),
                          start_pos=env.define_start_pos(rng))
    params, state0 = engine._build()
    hf = engine.heightfield

    def drop(device):
        args = jax.device_put((params, state0, hf), device)
        run = jax.jit(lambda p, s, h: rb.simulate(p, s, 310, heightfield=h))
        traj, _ = run(*args)
        return np.asarray(traj.pos), np.asarray(traj.rot)

    t0 = time.perf_counter()
    pos_g, rot_g = drop(jax.devices()[0])
    say(f"c physics gpu seconds (incl. compile) {time.perf_counter() - t0:.3f}")
    pos_c, rot_c = drop(jax.devices("cpu")[0])
    nb = 1 + len(OBJECT_CLASSES)
    d_pos = np.abs(pos_g[:, :nb] - pos_c[:, :nb])
    d_rot = np.abs(rot_g[:, :nb] - rot_c[:, :nb])
    say(f"c physics steps {pos_g.shape[0]} bodies {nb}")
    say(f"c physics max |dpos| over all steps (m) {d_pos.max():.3e}")
    say(f"c physics final max |dpos| (m) {d_pos[-1].max():.3e} "
        f"tolerance {PHYSICS_POS_TOL_M}")
    say(f"c physics final max |dq| {d_rot[-1].max():.3e} "
        f"tolerance {PHYSICS_ROT_TOL}")
    drop_m = pos_c[0, 1:nb, 2] - pos_c[-1, 1:nb, 2]
    say(f"c physics objects fell (m) {np.round(drop_m, 4).tolist()}")
    if not (np.isfinite(pos_g).all() and np.isfinite(rot_g).all()):
        raise AssertionError("non-finite GPU trajectory")
    if d_pos[-1].max() > PHYSICS_POS_TOL_M or d_rot[-1].max() > PHYSICS_ROT_TOL:
        raise AssertionError("GPU drop departs from the CPU drop")
    if not (drop_m > 0.05).all():
        raise AssertionError("objects did not fall")


def phase_timings(ctx):
    import jax

    import bench
    from pegasus_tpu.generate import run_generation
    from pegasus_tpu.ops.rasterize_pallas import rasterize_pallas
    from pegasus_tpu.pegasus import PEGASUS
    from pegasus_tpu.assets.rosters import full_registry

    for scale in ("210k", "1m"):
        scene = bench_scene(ctx, scale)
        cam = bench.bench_camera("orbit")
        versions = {
            "kernel": rasterize_pallas,
            f"xla_cap{XLA_CAP[scale]}": plain_rasterize_fn(XLA_CAP[scale]),
        }
        for name, fn in versions.items():
            render = jax.jit(lambda s, c, fn=fn: fn(s, c, max_objects=8))
            fps = bench.frames_per_second(render, scene, cam, 20)
            say(f"d frame {scale} {name} frames_per_s {fps:.3f} "
                f"ms {1e3 / fps:.3f}")
            if name != "kernel":
                worst, _ = bench.parity_report(
                    scene, cam, render, ref=golden(ctx, scale, "orbit"))
                say(f"d frame {scale} {name} parity_min_db {worst}")

    # one whole scene (physics + 300 frames + BOP write) per version
    for scale, (env_n, obj_n) in (("210k", (150_000, 10_000)),
                                  ("1m", (820_000, 30_000))):
        data = ctx["data"] if scale == "210k" else make_dataset(
            ctx["tmp"] / "data_1m", env_splats=env_n, obj_splats=obj_n
        )
        registry = full_registry(str(data), str(data))
        envs = [registry.by_class_name("Asphalt")]
        objs = [registry.by_class_name(n) for n in OBJECT_CLASSES]
        for name, fn in (("kernel", rasterize_pallas),
                         ("xla", plain_rasterize_fn(XLA_CAP[scale]))):
            out = ctx["tmp"] / f"scene_{scale}_{name}"
            # six objects in both scenes: one compiled shape
            cfg = generation_config(data, out, "timing", num_scenes=2,
                                    min_num_objects=6,
                                    convert_scenewise_to_imagewise=False)
            pegasus = PEGASUS(
                dataset_path=str(data), env_dataset_path=str(data),
                urdf_asset_folder=str(data / "urdf"), gs_env_list=envs,
                gs_object_list=objs, render_height=cfg.render_height,
                render_width=cfg.render_width, num_cameras=cfg.num_cameras,
                num_camera_interpolation_steps=(
                    cfg.num_camera_interpolation_steps),
                simulation_steps=cfg.simulation_steps,
                dataset_base_path=str(out), seed=cfg.seed, QUIET=True,
                rasterize_fn=fn, splat_budget=env_n + 6 * obj_n,
            )
            # scene 1 compiles; scene 2 is the steady-state scene
            run_generation(cfg, envs, objs, pegasus=pegasus)
            s = read_stats(out / "timing")[-1]
            say(f"d scene {scale} {name} seconds {s['seconds']:.3f} "
                f"frames {s['frames']} render_s {s.get('t_render', 0):.3f} "
                f"physics_s {s.get('t_physics', 0):.3f} "
                f"overflow_frames {s.get('binning_overflow_frames')}")
            shutil.rmtree(out, ignore_errors=True)


def check_bop_scene(dataset_dir: Path, scene_id: int, n_frames: int):
    scene = dataset_dir / "train" / f"{scene_id:06d}"
    gt = json.loads((scene / "scene_gt.json").read_text())
    gt_info = json.loads((scene / "scene_gt_info.json").read_text())
    n_obj = len(gt["0"])
    counts = {
        "rgb": len(list((scene / "rgb").glob("*.png"))),
        "depth": len(list((scene / "depth").glob("*.png"))),
        "sem_mask": len(list((scene / "sem_mask").glob("*.png"))),
        "mask": len(list((scene / "mask").glob("*.png"))),
        "mask_visib": len(list((scene / "mask_visib").glob("*.png"))),
    }
    want = {"rgb": n_frames, "depth": n_frames, "sem_mask": n_frames,
            "mask": n_frames * n_obj, "mask_visib": n_frames * n_obj}
    if counts != want:
        raise AssertionError(f"scene {scene_id}: PNGs {counts} != {want}")
    if len(gt) != n_frames or len(gt_info) != n_frames:
        raise AssertionError(f"scene {scene_id}: annotations for "
                             f"{len(gt)}/{len(gt_info)} frames")
    if not (dataset_dir / "models" / "models_info.json").exists():
        raise AssertionError("models/models_info.json missing")
    return n_obj, counts


def phase_end_to_end(ctx):
    from pegasus_tpu import generate
    from pegasus_tpu.io.png import read_png

    data = ctx["data"]
    out = ctx["tmp"] / "e2e"
    for mode in ("static", "dynamic"):
        cfg = generation_config(data, out, f"smoke_{mode}", mode=mode,
                                seed=11 if mode == "static" else 12)
        path = ctx["tmp"] / f"{mode}.json"
        cfg.save(path)
        generate.main(["--config", str(path), "--envs", "Asphalt",
                       "--objects", *OBJECT_CLASSES])
        dataset_dir = out / f"smoke_{mode}"
        n_frames = cfg.num_cameras * cfg.num_camera_interpolation_steps
        n_obj, counts = check_bop_scene(dataset_dir, 1, n_frames)
        stats = read_stats(dataset_dir)[-1]
        mid = f"{n_frames // 2:06d}.png"
        rgb = read_png(dataset_dir / "train" / "000001" / "rgb" / mid)
        depth = read_png(dataset_dir / "train" / "000001" / "depth" / mid)
        say(f"e scene {mode} objects {n_obj} pngs {counts}")
        say(f"e scene {mode} seconds {stats['seconds']:.3f} "
            f"frames {stats['frames']} "
            f"binning_overflow_frames {stats.get('binning_overflow_frames')}")
        say(f"e scene {mode} frame {n_frames // 2} rgb mean "
            f"{rgb.mean():.2f} depth_mm max {int(depth.max())}")
        if (rgb.shape != (cfg.render_height, cfg.render_width, 3)
                or rgb.max() == 0 or depth.max() == 0):
            raise AssertionError(f"{mode}: blank frame {n_frames // 2}")


def phase_four_cards(ctx):
    import jax
    import jax.numpy as jnp

    from pegasus_tpu.assets.rosters import full_registry
    from pegasus_tpu.generate import run_generation
    from pegasus_tpu.io.png import read_png
    from pegasus_tpu.parallel.mesh import make_mesh

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    data = ctx["data"]
    registry = full_registry(str(data), str(data))
    envs = [registry.by_class_name("Asphalt")]
    objs = [registry.by_class_name(n) for n in OBJECT_CLASSES]
    roots = {}
    for n_cards in (1, 4):
        out = ctx["tmp"] / f"mesh{n_cards}"
        cfg = generation_config(data, out, "sharded", num_scenes=4,
                                mode="dynamic", num_cameras=2,
                                num_camera_interpolation_steps=5, seed=21)
        mesh = make_mesh(axis_names=("scene",), devices=devs[:n_cards])
        t0 = time.perf_counter()
        run_generation(cfg, envs, objs, mesh=mesh)
        say(f"f sharded generation {n_cards} card(s) seconds "
            f"{time.perf_counter() - t0:.3f} (incl. compile)")
        roots[n_cards] = out / "sharded" / "train"

    rgb_diff, n_png = 0, 0
    pose_diff = 0.0
    for scene in sorted(p.name for p in roots[1].iterdir()):
        a_dir, b_dir = roots[1] / scene, roots[4] / scene
        for sub in ("depth", "mask", "mask_visib"):
            for f in sorted((a_dir / sub).glob("*.png")):
                n_png += 1
                if f.read_bytes() != (b_dir / sub / f.name).read_bytes():
                    raise AssertionError(f"{scene}/{sub}/{f.name} differs")
        for f in sorted((a_dir / "rgb").glob("*.png")):
            d = np.abs(read_png(f).astype(int)
                       - read_png(b_dir / "rgb" / f.name).astype(int))
            rgb_diff = max(rgb_diff, int(d.max()))
        ga = json.loads((a_dir / "scene_gt.json").read_text())
        gb = json.loads((b_dir / "scene_gt.json").read_text())
        for fid in ga:
            for ea, eb in zip(ga[fid], gb[fid], strict=True):
                dr = np.abs(np.subtract(ea["cam_R_m2c"], eb["cam_R_m2c"]))
                dt = np.abs(np.subtract(ea["cam_t_m2c"], eb["cam_t_m2c"]))
                pose_diff = max(pose_diff, float(dr.max()),
                                float(dt.max()) / 1000.0)
    say(f"f sharded vs 1 card: {n_png} depth/mask PNGs byte-identical")
    say(f"f sharded vs 1 card: rgb max |diff| {rgb_diff} LSB (limit 1)")
    say(f"f sharded vs 1 card: pose max |diff| {pose_diff:.3e} "
        f"(limit 1e-5; t in m)")
    if rgb_diff > 1 or pose_diff > 1e-5:
        raise AssertionError("sharded generation departs from 1 card")

    # data-parallel training: 2 steps on a 4-camera batch
    from pegasus_tpu.camera import Camera
    from pegasus_tpu.ops.rasterize_ref import rasterize_reference
    from pegasus_tpu.testing import make_box_cloud
    from pegasus_tpu.training.trainer import (GSTrainer, TrainConfig,
                                              init_from_points)

    rng = np.random.default_rng(5)
    gt_cloud = make_box_cloud(rng, n=4000, half_extents=(0.08, 0.08, 0.1),
                              rgb=(0.7, 0.3, 0.2), object_id=0)
    cams = [
        Camera.look_at(eye=(0.5 * np.cos(a), 0.5 * np.sin(a), 0.35),
                       target=(0, 0, 0), up=(0, 0, 1),
                       fovx=np.deg2rad(50), fovy=np.deg2rad(50),
                       width=256, height=256)
        for a in np.linspace(0, 2 * np.pi, 4, endpoint=False)
    ]
    gts = jnp.stack([
        jnp.clip(rasterize_reference(gt_cloud, c, max_objects=1).rgb, 0, 1)
        for c in cams
    ])
    cams_b = jax.tree.map(lambda *x: jnp.stack(x), *cams)
    config = TrainConfig(capacity=8192, densify_from_iter=10**9)
    trainer = GSTrainer(config, width=256, height=256)
    pts = np.asarray(gt_cloud.xyz)[:2000] + rng.normal(size=(2000, 3)) * 0.01
    cloud0 = init_from_points(pts, np.full((2000, 3), 0.5, np.float32),
                              config)
    results = {}
    for n_cards in (1, 4):
        state = trainer.init_state(cloud0, spatial_lr_scale=0.5)
        step = trainer.make_dp_train_step(
            make_mesh((n_cards,), ("batch",), devs[:n_cards]))
        losses = []
        for _ in range(2):
            state, m = step(state, cams_b, gts)
            losses.append(float(m["loss"]))
        results[n_cards] = (losses, np.asarray(state.cloud.xyz),
                            np.asarray(state.cloud.opacity))
    (l1, x1, o1), (l4, x4, o4) = results[1], results[4]
    dx = float(np.abs(x1 - x4).max())
    do = float(np.abs(o1 - o4).max())
    say(f"f dp training losses 1 card {l1} 4 cards {l4}")
    say(f"f dp training max |dxyz| {dx:.3e} max |dopacity| {do:.3e}")
    if not np.allclose(l1, l4, rtol=1e-5) or dx > 1e-6 or do > 1e-5:
        raise AssertionError("DP training on 4 cards departs from 1 card")


# -- driver ------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the four-card phase (f)")
    args = parser.parse_args(argv)

    import jax

    import bench

    dev = bench.device_info()
    if dev["platform"] != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX found {dev}", file=sys.stderr)
        return 2
    say(f"a device {dev['platform']} {dev['kind']} x{dev['count']}")
    say(f"a card {bench.card_info()}")
    say(f"a jax {jax.__version__}")

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    ctx = {"tmp": tmp, "scenes": {}, "golden": {}}
    if args.four_cards:
        phases = [("f four cards", phase_four_cards)]
    else:
        phases = [("b parity", phase_parity), ("c physics", phase_physics),
                  ("d timings", phase_timings),
                  ("e end to end", phase_end_to_end)]
    failed = []
    try:
        ctx["data"] = make_dataset(tmp / "data")
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn(ctx)
            except Exception:  # noqa: BLE001 — reported, and fails the run
                traceback.print_exc()
                failed.append(name)
            say(f"phase {name} {'FAILED' if name in failed else 'ok'} "
                f"{time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
