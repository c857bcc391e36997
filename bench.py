"""Frame benchmark on one NVIDIA GPU: frames/s at 640x480, RGB + depth +
seg + masks in one pass, with the compositor parity gate.

Prints ONE JSON line: {"metric", "value", "unit"} plus, on the same line,
  device              — platform, device_kind and count as JAX reports
                        them, and the card's name and power limit;
  parity_db / parity_report — min and per-channel PSNR of the compiled
                        compositor vs the golden renderer on the 210k
                        scene (gate: > 40 dB; exits nonzero if violated);
  value_1m, parity_1m_db, parity_grazing_db — the same at 1M splats;
  scenes_per_hour     — one REAL reference-default scene (physics + 300
                        frames at 640x480 + BOP write) timed end to end.

Scenes: ~210k splats (150k environment + 6 objects x 10k), the scale of a
composed PEGASUS scene, and ~1M (820k + 6 x 30k), the top of the 1e5-1e6
range of environment reconstructions (SURVEY section 5).  One "frame" =
every data point the reference extracts per camera (RGB, metric depth,
per-object visible + amodal masks, semantic seg).

Measurement needs the card: off the GPU this script exits nonzero rather
than timing another device under the same metric name.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

PARITY_GATE_DB = 40.0


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_info() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def bench_scene(scale: str):
    """The 210k ("210k") or 1M ("1m") bench scene, made from a seed."""
    import jax

    from pegasus_tpu.gs.cloud import merge
    from pegasus_tpu.testing import make_box_cloud, make_plane_cloud

    n_env, n_obj, seed = {
        "210k": (150_000, 10_000, 7), "1m": (820_000, 30_000, 11),
    }[scale]
    rng = np.random.default_rng(seed)
    env = make_plane_cloud(rng, n=n_env, size=2.0)
    objs = [
        make_box_cloud(
            rng, n=n_obj,
            center=(0.1 * i - 0.2, 0.05 * i, 0.08),
            object_id=i + 1,
            rgb=((0.2 + 0.1 * i) % 1.0, 0.5, (0.9 - 0.1 * i) % 1.0),
        )
        for i in range(6)
    ]
    return jax.device_put(merge([env] + objs))


def bench_camera(view: str = "orbit"):
    """The orbit view, or the grazing view low over the dense plane, which
    stacks far more splats per tile (the deepest-overdraw point)."""
    from pegasus_tpu.camera import Camera

    eye, target = {
        "orbit": ((0.9, 0.7, 0.9), (0, 0, 0.05)),
        "grazing": ((0.85, 0.1, 0.10), (-0.6, 0, 0.04)),
    }[view]
    return Camera.look_at(
        eye=eye, target=target, up=(0, 0, 1),
        fovx=np.deg2rad(60), fovy=np.deg2rad(47), width=640, height=480,
    )


def golden_render(scene, cam):
    """The golden renderer's frame (it runs at Precision.HIGHEST)."""
    import jax

    from pegasus_tpu.ops.rasterize_ref import rasterize_reference

    return jax.jit(lambda s, c: rasterize_reference(s, c, max_objects=8))(
        scene, cam
    )


def parity_report(scene, cam, fast_render, ref=None):
    """Per-channel PSNR of ``fast_render`` vs the golden renderer's frame
    ``ref`` (rendered here when not given); returns (worst, report)."""
    import jax

    from pegasus_tpu.ops.validate import psnr_db

    if ref is None:
        ref = golden_render(scene, cam)
    out = fast_render(scene, cam)
    jax.block_until_ready((ref.rgb, out.rgb))

    depth_peak = max(float(np.asarray(ref.depth).max()), 1e-6)
    report = {
        "rgb_psnr_db": psnr_db(ref.rgb, out.rgb),
        "depth_psnr_db": psnr_db(ref.depth, out.depth, peak=depth_peak),
    }
    for name in ("seg_weights", "vis_weights", "amodal"):
        report[f"{name}_psnr_db"] = psnr_db(
            np.asarray(getattr(ref, name)), np.asarray(getattr(out, name))
        )
    report = {k: round(float(v), 2) for k, v in report.items()}
    return min(report.values()), report


def frames_per_second(render, scene, cam, n_iters: int) -> float:
    import jax

    jax.block_until_ready(render(scene, cam))  # compile + warm
    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = render(scene, cam)
    jax.block_until_ready(out)
    return n_iters / (time.perf_counter() - t0)


def _scenes_per_hour():
    """Time a REAL generation scene and project the reference default.

    Runs physics (310 steps) + 40 frames (10 cameras x 4 interpolation
    steps) at 640x480 with every modality and a full BOP write, then
    scales the frame loop linearly to the reference's 300 frames/scene
    (pegasus.py:502-503).  Also re-runs the same frames as one device
    program with no host fetch, so the wall/device gap — host readback +
    PNG writes — is measured, not inferred."""
    import shutil
    import tempfile

    import jax
    import jax.numpy as jnp

    from pegasus_tpu.assets.registry import Asset
    from pegasus_tpu.pegasus import PEGASUS
    from pegasus_tpu.testing import build_synthetic_dataset

    root = tempfile.mkdtemp(prefix="pegasus_bench_")
    try:
        build_synthetic_dataset(
            os.path.join(root, "data"), env_splats=150_000, obj_splats=10_000
        )
        data = os.path.join(root, "data")
        env = Asset(
            OBJECT_NAME="asphalt", ID=1003, TYPE="environment",
            dataset_path=data, DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3),
        )
        objs = [
            Asset(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=data),
            Asset(OBJECT_NAME="cup_noodles_07", ID=107, dataset_path=data),
        ]
        n_interp = 4
        pegasus = PEGASUS(
            dataset_path=data, env_dataset_path=data,
            urdf_asset_folder=os.path.join(data, "urdf"),
            gs_env_list=[env], gs_object_list=objs,
            render_height=480, render_width=640,
            num_cameras=10, simulation_steps=310,
            num_camera_interpolation_steps=n_interp,
            mode="static", camera_trajectory_mode="random",
            dataset_base_path=os.path.join(root, "out"),
            seed=3, QUIET=True, splat_budget=192_000,
        )
        modalities = ["rgb", "depth", "seg_vis", "seg_sil", "sem_seg"]

        def chunk_cams(idxs):
            cams = [pegasus.viewport_cam_list[i] for i in idxs]
            return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)

        # warm the physics + frame programs once (shape-stable across
        # scenes thanks to splat_budget), then time a full scene
        chunk = pegasus.frame_chunk
        pegasus.init_bullet([env], objs, "bench", 1, 2, 2, random=False)
        pegasus.init("bench", 1)
        pegasus.init_start_position()
        body_R, body_t = pegasus._body_poses_at(pegasus._initial_step)
        posed = pegasus._posed_scene(pegasus.template, body_R, body_t)
        warm, _ = pegasus._chunk_program(
            posed, chunk_cams(list(range(chunk))), pegasus._semantic_colors_dev
        )
        np.asarray(warm)

        t0 = time.perf_counter()
        pegasus.init_bullet([env], objs, "bench", 2, 2, 2, random=False)
        pegasus.init("bench", 2)
        pegasus.init_start_position()
        t_setup = time.perf_counter() - t0
        t1 = time.perf_counter()
        pegasus.generate_dataset(modalities, save_bop=True, save_video=False)
        pegasus.save2bop()
        t_frames = time.perf_counter() - t1
        n_timed = 10 * n_interp
        scene_s = t_setup + t_frames * (300.0 / n_timed)

        # device-only decomposition: all timed frames as ONE dispatch
        body_R, body_t = pegasus._body_poses_at(pegasus._initial_step)
        posed = pegasus._posed_scene(pegasus.template, body_R, body_t)
        cams_all = chunk_cams(list(range(n_timed)))
        buf, _ = pegasus._chunk_program(
            posed, cams_all, pegasus._semantic_colors_dev
        )  # compile + warm
        jax.block_until_ready(buf)
        reps = 3
        t2 = time.perf_counter()
        for _ in range(reps):
            buf, _ = pegasus._chunk_program(
                posed, cams_all, pegasus._semantic_colors_dev
            )
        jax.block_until_ready(buf)
        t_dev = (time.perf_counter() - t2) / reps
        return {
            "scenes_per_hour": 3600.0 / scene_s,
            "scene_seconds": scene_s,
            "device_scene_seconds": t_setup + t_dev * (300.0 / n_timed),
            "readback_bytes_per_scene": int(buf.nbytes) // n_timed * 300,
            "scene_setup_seconds": t_setup,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import jax

    from pegasus_tpu.ops.backends import default_rasterize_fn

    dev = device_info()
    if dev["platform"] != "gpu":
        print(f"bench.py measures the GPU; JAX found {dev}", file=sys.stderr)
        return 2
    rasterize = default_rasterize_fn()
    render = jax.jit(lambda s, c: rasterize(s, c, max_objects=8))

    line = {
        "metric": "frames/s (640x480 RGB+depth+seg+masks, 210k splats)",
        "unit": "frames/s",
        "device": dict(dev, card=card_info()),
    }
    scene, orbit = bench_scene("210k"), bench_camera("orbit")
    line["value"] = frames_per_second(render, scene, orbit, 50)
    line["parity_db"], line["parity_report"] = parity_report(
        scene, orbit, render
    )
    print(f"[bench] fps={line['value']:.1f}; 1M-splat scene...",
          file=sys.stderr)

    scene_1m = bench_scene("1m")
    line["value_1m"] = frames_per_second(render, scene_1m, orbit, 30)
    line["parity_1m_db"], _ = parity_report(scene_1m, orbit, render)
    line["parity_grazing_db"], _ = parity_report(
        scene_1m, bench_camera("grazing"), render
    )
    print("[bench] timing a real scene...", file=sys.stderr)
    line.update(_scenes_per_hour())
    print(json.dumps(line))

    worst = min(line["parity_db"], line["parity_1m_db"],
                line["parity_grazing_db"])
    if worst <= PARITY_GATE_DB:
        print(f"PARITY GATE FAILED: {worst} dB <= {PARITY_GATE_DB} dB",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
