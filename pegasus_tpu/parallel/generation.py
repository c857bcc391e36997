"""Sharded end-to-end dataset generation: scene-DP over a device mesh.

The reference generates scenes strictly sequentially on one GPU
(reference: pegasus.py:514-533).  Here S scenes run as ONE jitted
program — physics drop + full camera trajectory render + on-device frame
packing — with the scene axis sharded over a ``jax.sharding.Mesh``
(scene data parallelism; SURVEY section 7 step 7).  The host unpacks
each scene's frames and writes the same BOP tree as the sequential path.

Static-shape recipe (XLA requirement):
  * every scene's cloud is padded to ``config.splat_budget`` splats;
  * every scene carries ``max_num_objects`` body slots — scenes with
    fewer objects get placeholder bodies (dead splats, inert physics,
    zero palette rows) that the host-side writer skips;
  * all trajectories render the same number of frames.

Call via ``run_generation(config, envs, objs, mesh=mesh)`` or directly:

    from pegasus_tpu.parallel.generation import run_generation_sharded
    stats = run_generation_sharded(config, env_list, obj_list, mesh=mesh)
"""

from __future__ import annotations

import functools
import logging
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from pegasus_tpu.assets.registry import Asset
from pegasus_tpu.config import GenerationConfig
from pegasus_tpu.gs.cloud import GaussianCloud
from pegasus_tpu.gs.ply import load_gs_ply
from pegasus_tpu.io import colmap as colmap_io
from pegasus_tpu.io.bop_writer import BOPDatasetWriter, write_models
from pegasus_tpu.io.mesh import load_mesh
from pegasus_tpu.ops.backends import default_rasterize_fn
from pegasus_tpu.ops.render import (encode_frame, pack_frame_bytes,
                                    render_frame, unpack_frame_bytes)
from pegasus_tpu.parallel.mesh import make_mesh, shard_batch
from pegasus_tpu.physics import rigid_body as rb
from pegasus_tpu.physics.engine import PhysicsEngine
from pegasus_tpu.physics.heightfield import Heightfield
from pegasus_tpu.scene.camera_trajectory import create_camera_trajectory
from pegasus_tpu.scene.composition import (SceneTemplate, pose_scene,
                                           poses_from_trajectory_step)
from pegasus_tpu.scene.trajectory import AssetInfo, Trajectory
from pegasus_tpu.utils.colors import generate_colors
from pegasus_tpu.utils.observability import SceneStats

HF_RESOLUTION = 128  # uniform heightfield grid so scenes stack


def _placeholder_cloud(k_rest: int, n: int = 8) -> GaussianCloud:
    """Inert body filler: far below ground, ~zero opacity, dead splats."""
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 2] = -100.0
    return GaussianCloud.create(
        xyz=xyz,
        f_dc=np.zeros((n, 1, 3), np.float32),
        f_rest=np.zeros((n, k_rest, 3), np.float32),
        opacity=np.full((n, 1), -12.0, np.float32),
        scale=np.full((n, 3), -8.0, np.float32),
        rot=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        alive=np.zeros(n, bool),
    )


def _scene_setup(config, env_list, obj_list, rng, preload, scene_id):
    """Host-side per-scene randomization, mirroring PEGASUS.init_bullet
    (reference: pegasus.py:166-216) with padding to max_num_objects."""
    k_max = config.max_num_objects
    env = env_list[int(rng.integers(0, len(env_list)))]
    n_obj = int(
        rng.integers(
            min(config.min_num_objects, len(obj_list)),
            min(config.max_num_objects, len(obj_list)) + 1,
        )
    )
    idx = rng.choice(len(obj_list), n_obj, replace=False).tolist()
    selected = [obj_list[i] for i in idx]

    engine = PhysicsEngine(
        asset_folder=config.urdf_asset_folder
        or str(Path(config.dataset_path) / "urdf"),
        output_path_json=str(
            Path(config.dataset_base_path)
            / config.dataset_name
            / "engine"
            / f"{scene_id:06d}_simulation_steps.json"
        ),
        simulation_steps=config.simulation_steps,
        seed=int(rng.integers(0, 2**31)),
        # static capacity must cover rich scenes AND be equal across the
        # batch (stacked pytrees)
        max_bodies=max(8, config.max_num_objects + 1),
    )
    engine.add_object(env, start_pos=env.START_POSITION_PYBULLET)
    for obj in selected:
        engine.add_object(obj, start_pos=env.define_start_pos(rng))
    params, state0 = engine._build()
    hf = engine.heightfield
    if hf is None or hf.grid.shape[0] != HF_RESOLUTION:
        hf = Heightfield.flat(resolution=HF_RESOLUTION)

    env_entry = preload["envs"][env.object_name]
    clouds = [preload["objs"][o.object_name] for o in selected]
    k_rest = int(env_entry["gs"].f_rest.shape[1])
    clouds += [_placeholder_cloud(k_rest) for _ in range(k_max - n_obj)]
    template = SceneTemplate.build(
        env_entry["gs"], clouds, pad_to=config.splat_budget
    )

    cam_intr = env_entry["cam_intr"]
    intr0 = cam_intr[min(cam_intr.keys())]
    fx, fy, _, _ = colmap_io.colmap_intrinsics(intr0)
    cams = create_camera_trajectory(
        cam_extr=env_entry["cam_extr"],
        focal_x=fx,
        intr_width=intr0.width,
        intr_height=intr0.height,
        render_width=config.render_width,
        render_height=config.render_height,
        num_cameras=config.num_cameras,
        num_interpolation_steps=config.num_camera_interpolation_steps,
        mode=config.camera_trajectory_mode,
        rng=rng,
    )

    colors = np.zeros((k_max, 3), np.float32)
    colors[:n_obj] = generate_colors(n_obj, mode="rgb")

    return dict(
        scene_id=scene_id,
        engine=engine,
        env=env,
        selected=selected,
        n_obj=n_obj,
        params=params,
        state0=state0,
        heightfield=hf,
        template=template,
        cams=cams,
        colors=colors,
        camera_intr={
            "fx": fx, "fy": fy, "width": intr0.width, "height": intr0.height
        },
    )


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *trees)


@functools.lru_cache(maxsize=16)
def _make_batch_program(mesh, n_steps: int, rasterize_fn,
                        static_pose: bool = False):
    """S scenes x F frames as ONE program: the scene axis is sharded over
    the mesh with shard_map, and each device iterates its LOCAL scenes
    with lax.map — sequential per-scene iteration (a device renders one
    frame at a time anyway) that keeps the Pallas kernel usable (it has
    no vmap batching rule; under vmap only the XLA tiled backend would
    compile)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def one_scene(args):
        template, params, state0, hf, cams, colors, frame_steps = args
        traj, _ = rb.simulate(
            params, state0, n_steps=n_steps, heightfield=hf
        )
        nb = template.num_bodies
        times_t = jnp.transpose(traj.pos, (1, 0, 2))[:nb]  # [B, T, 3]
        times_q = jnp.roll(
            jnp.transpose(traj.rot, (1, 0, 2))[:nb], -1, axis=-1
        )  # xyzw

        if static_pose:
            # static scenes share one pose across all frames: pose ONCE
            # above the scan (XLA cannot hoist it because `step` is a
            # scanned input)
            body_R0, body_t0 = poses_from_trajectory_step(
                times_t, times_q, frame_steps[0]
            )
            scene0 = pose_scene(template, body_R0, body_t0)

        def frame(_, inputs):
            cam, step = inputs
            if static_pose:
                body_R, body_t, scene = body_R0, body_t0, scene0
            else:
                body_R, body_t = poses_from_trajectory_step(
                    times_t, times_q, step
                )
                scene = pose_scene(template, body_R, body_t)
            fr = render_frame(
                scene, cam, colors, rasterize_fn=rasterize_fn
            )
            packed = pack_frame_bytes(encode_frame(fr))
            return 0, (packed, body_R, body_t, fr.overflow)

        _, (packed, body_R, body_t, ovf) = jax.lax.scan(
            frame, 0, (cams, frame_steps)
        )
        return packed, body_R, body_t, times_t, times_q, ovf

    def local_batch(template_b, params_b, state0_b, hf_b, cams_b,
                    colors_b, frame_steps):
        return jax.lax.map(
            one_scene,
            (
                template_b, params_b, state0_b, hf_b, cams_b, colors_b,
                jnp.broadcast_to(
                    frame_steps, (colors_b.shape[0],) + frame_steps.shape
                ),
            ),
        )

    spec = P("scene")
    return jax.jit(
        shard_map(
            local_batch,
            mesh=mesh,
            in_specs=(spec, spec, spec, spec, spec, spec, P()),
            out_specs=spec,
            check_vma=False,
        )
    )


def run_generation_sharded(
    config: GenerationConfig,
    env_list: List[Asset],
    obj_list: List[Asset],
    mesh=None,
    rasterize_fn=None,
) -> SceneStats:
    """Generate ``config.num_scenes`` scenes in mesh-sized batches."""
    if mesh is None:
        mesh = make_mesh(axis_names=("scene",))
    # splat_budget (one static cloud size for every scene) is derived
    # from the preloaded assets below when the config leaves it unset
    if rasterize_fn is None:
        rasterize_fn = default_rasterize_fn()

    n_dev = int(np.prod(list(mesh.shape.values())))
    out_root = Path(config.dataset_base_path)
    dataset_dir = out_root / config.dataset_name
    dataset_dir.mkdir(parents=True, exist_ok=True)
    config.save(dataset_dir / "generation_config.json")

    rng = np.random.default_rng(config.seed)

    # preload GS clouds + COLMAP poses once (reference: pegasus.py:89-117)
    preload = {"envs": {}, "objs": {}}
    load_iter = 30_000
    for env in env_list:
        reco = Path(env.reconstruction_path)
        preload["envs"][env.object_name] = {
            "gs": load_gs_ply(env.gaussian_point_cloud_path(load_iter)),
            "cam_extr": colmap_io.read_images_binary(reco / "sparse/0/images.bin"),
            "cam_intr": colmap_io.read_cameras_binary(reco / "sparse/0/cameras.bin"),
        }
    for obj in obj_list:
        obj.mode = "fused"
        preload["objs"][obj.object_name] = load_gs_ply(
            obj.gaussian_point_cloud_path(load_iter)
        )

    if config.splat_budget is None:
        env_max = max(
            int(e["gs"].num_splats) for e in preload["envs"].values()
        )
        obj_sizes = sorted(
            (int(c.num_splats) for c in preload["objs"].values()),
            reverse=True,
        )
        worst = env_max + sum(obj_sizes[: config.max_num_objects])
        worst += 8 * config.max_num_objects  # placeholder bodies
        config.splat_budget = -(-worst // 1024) * 1024
        print(
            f"[pegasus-tpu] splat_budget auto-set to {config.splat_budget} "
            f"(max env {env_max} + {config.max_num_objects} largest objects)"
        )

    models = {
        obj.ID: load_mesh(obj.urdf_obj_path)
        for obj in obj_list
        if Path(obj.urdf_obj_path).exists()
    }
    if models:
        write_models(models, dataset_dir / "models", config.unit_scale)

    n_frames = config.num_cameras * config.num_camera_interpolation_steps
    if config.mode == "dynamic":
        frame_steps = np.clip(
            np.arange(n_frames), 0, config.simulation_steps - 1
        ).astype(np.int32)
    else:
        frame_steps = np.full(
            n_frames, config.simulation_steps - 1, np.int32
        )
    frame_steps = jnp.asarray(frame_steps)

    stats = SceneStats(path=str(dataset_dir / "generation_stats.jsonl"))
    scene_ids = list(range(1, config.num_scenes + 1))
    if config.resume:
        from pegasus_tpu.utils.observability import completed_scene_ids

        done = completed_scene_ids(out_root, config.dataset_name)
        scene_ids = [s for s in scene_ids if s not in done]
    batch_program = _make_batch_program(
        mesh, n_steps=config.simulation_steps, rasterize_fn=rasterize_fn,
        static_pose=config.mode != "dynamic",
    )

    def one_batch(batch_ids) -> None:
        t0 = time.perf_counter()
        setups = [
            _scene_setup(config, env_list, obj_list, rng, preload, sid)
            for sid in batch_ids
        ]
        # pad the final partial batch by repeating the last scene (its
        # duplicate outputs are simply not written)
        n_real = len(setups)
        while len(setups) < n_dev:
            setups.append(setups[-1])

        template_b = _stack([s["template"] for s in setups])
        params_b = _stack([s["params"] for s in setups])
        state0_b = _stack([s["state0"] for s in setups])
        hf_b = _stack([s["heightfield"] for s in setups])
        cams_b = _stack([_stack(s["cams"]) for s in setups])
        colors_b = jnp.asarray(
            np.stack([s["colors"] for s in setups]), jnp.float32
        )

        template_b = shard_batch(template_b, mesh, "scene")
        params_b = shard_batch(params_b, mesh, "scene")
        state0_b = shard_batch(state0_b, mesh, "scene")
        hf_b = shard_batch(hf_b, mesh, "scene")
        cams_b = shard_batch(cams_b, mesh, "scene")
        colors_b = shard_batch(colors_b, mesh, "scene")

        packed, body_R, body_t, times_t, times_q, ovf = batch_program(
            template_b, params_b, state0_b, hf_b, cams_b, colors_b,
            frame_steps,
        )
        # [n_dev, F] bool binning entry-cap flags (tiny fetch): surfaced
        # per scene so capped binning cannot silently truncate bottom-
        # image tiles in the written dataset (see ops/binning.py)
        ovf_np = np.asarray(ovf)

        # host writes (device->host pull + PNG/JSON) run on the writer
        # pool so the NEXT batch's setup + device compute overlap them
        k_max = config.max_num_objects
        for s_idx, setup in enumerate(setups[:n_real]):
            writers.append(
                write_pool.submit(
                    _write_scene,
                    config, setup, models,
                    packed[s_idx], body_R[s_idx], body_t[s_idx],
                    times_t[s_idx], times_q[s_idx], k_max,
                )
            )
        dt = time.perf_counter() - t0
        for s_idx, setup in enumerate(setups[:n_real]):
            n_ovf = int(ovf_np[s_idx].sum())
            if n_ovf:
                logging.getLogger("pegasus_tpu").warning(
                    "scene %d: binning entry cap overflowed on %d/%d "
                    "frames (far splats dropped in bottom-image tiles; "
                    "raise entry_cap or reduce splat_budget)",
                    setup["scene_id"], n_ovf, n_frames,
                )
            stats.record(
                setup["scene_id"],
                frames=n_frames,
                seconds=dt / n_real,
                frames_per_s=n_frames * n_real / dt,
                splats=int(config.splat_budget),
                n_objects=setup["n_obj"],
                env=setup["env"].object_name,
                object_ids=[int(o.ID) for o in setup["selected"]],
                binning_overflow_frames=n_ovf,
            )

    from concurrent.futures import ThreadPoolExecutor

    from pegasus_tpu.utils.observability import retry_scene

    write_pool = ThreadPoolExecutor(max_workers=2)
    writers = []
    try:
        for batch_start in range(0, len(scene_ids), n_dev):
            batch_ids = scene_ids[batch_start : batch_start + n_dev]
            # bounded retries per batch (SURVEY 5 failure handling; a
            # failed batch is re-randomized on retry, like the sequential
            # path's per-scene retry)
            retry_scene(lambda _sid: one_batch(batch_ids), batch_ids[0])
    finally:
        for fut in writers:
            fut.result()  # re-raises writer exceptions
        write_pool.shutdown(wait=True)
    print(f"[pegasus-tpu] sharded generation summary: {stats.summary()}")
    return stats


def _write_scene(
    config, setup, models, packed, body_R, body_t, times_t, times_q, k_max
):
    """Host-side BOP write of one scene from device outputs (same schema
    as the sequential path, reference: pegasus.py:333-396).  Runs on the
    writer pool; the device->host pulls happen here so they overlap the
    next batch's compute."""
    packed = np.asarray(packed)
    body_R = np.asarray(body_R)
    body_t = np.asarray(body_t)
    times_t = np.asarray(times_t)
    times_q = np.asarray(times_q)
    sid = setup["scene_id"]
    n_obj = setup["n_obj"]
    engine = setup["engine"]

    # trajectory JSON (reference schema, physical_simulation.py:163-168)
    env_name = list(engine.asset_list["environment"].keys())[0]
    env_info = AssetInfo(
        name=env_name,
        class_name=engine.asset_list["environment"][env_name]["class_name"],
        bullet_ids=engine.asset_list["environment"][env_name]["bullet_id"],
    )
    objects = {
        name: AssetInfo(
            name=name,
            class_name=d["class_name"],
            bullet_ids=d["bullet_id"],
            object_ID=d.get("object_ID"),
            center_of_mass=d.get("center_of_mass"),
        )
        for name, d in engine.asset_list["object"].items()
    }
    nb_real = 1 + n_obj
    Trajectory(
        environment=env_info,
        objects=objects,
        times_t=times_t[:nb_real],
        times_q=times_q[:nb_real],
    ).to_json(engine.trajectory_path)

    writer = BOPDatasetWriter(
        dataset_name=config.dataset_name,
        dataset_output_path=Path(config.dataset_base_path),
        camera_intr=setup["camera_intr"],
        render_width=config.render_width,
        render_height=config.render_height,
        object_models=models,
        scene_id=sid,
        unit_scale=config.unit_scale,
        write_models_now=False,
    )
    bullet_to_real = {
        bid: d.get("object_ID")
        for d in engine.asset_list["object"].values()
        for bid in d["bullet_id"]
    }
    data_points = config.render_data_points
    for i, cam in enumerate(setup["cams"]):
        data = unpack_frame_bytes(
            packed[i], k_max, palette=setup["colors"], with_depth_m=False
        )
        writer.add_scene_camera(i)
        writer.write_training_data(
            frame_id=i,
            rgb=data["rgb_u8"] if "rgb" in data_points else None,
            depth_mm=data["depth_mm"]
            if ("depth" in data_points or "rgb" in data_points)
            else None,
            mask_amodal=data["mask_amodal"][..., :n_obj]
            if "seg_sil" in data_points
            else None,
            mask_visib=data["mask_visib"][..., :n_obj]
            if "seg_vis" in data_points
            else None,
            sem_mask=data["sem_u8"] if "sem_seg" in data_points else None,
        )
        object_poses = [
            {
                "bullet_id": bid,
                "obj_id": bullet_to_real.get(bid, bid),
                "R_init": body_R[i, bid],
                "t_init": body_t[i, bid],
            }
            for bid in range(1, nb_real)
        ]
        writer.add_scene_gt(
            frame_id=i,
            cam_R_w2c=np.asarray(cam.R_w2c),
            cam_t_w2c=np.asarray(cam.t_w2c),
            object_poses=object_poses,
        )
    writer.save_scene_annotations()
    writer.close()
