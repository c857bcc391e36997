"""End-to-end SHARDED generation on the 8-device virtual CPU mesh.

The scene-data-parallel driver (pegasus_tpu/parallel/generation.py) must
produce the same BOP tree the sequential path writes — multi-scene, with
varying per-scene object counts — from ONE sharded XLA program per batch
(SURVEY section 7 step 7).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from pegasus_tpu.assets.registry import Asset
from pegasus_tpu.config import GenerationConfig
from pegasus_tpu.generate import run_generation
from pegasus_tpu.parallel.mesh import make_mesh
from pegasus_tpu.testing import build_synthetic_dataset


@pytest.fixture(scope="module")
def synthetic_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dataset")
    build_synthetic_dataset(root)
    return root


def test_sharded_generation_bop_tree(synthetic_root, tmp_path):
    env = Asset(
        OBJECT_NAME="asphalt", ID=1003, TYPE="environment",
        dataset_path=str(synthetic_root),
        DROP_REGION=(0.1, 0.1), DROP_HEIGHT=(0.2, 0.3),
    )
    objs = [
        Asset(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=str(synthetic_root)),
        Asset(OBJECT_NAME="cup_noodles_07", ID=107, dataset_path=str(synthetic_root)),
    ]
    out = tmp_path / "out"
    config = GenerationConfig(
        dataset_path=str(synthetic_root),
        env_dataset_path=str(synthetic_root),
        urdf_asset_folder=str(synthetic_root / "urdf"),
        dataset_name="sharded_run",
        dataset_base_path=str(out),
        num_scenes=4,
        min_num_objects=1,
        max_num_objects=2,
        render_width=48,
        render_height=40,
        num_cameras=1,
        num_camera_interpolation_steps=2,
        simulation_steps=20,
        mode="static",
        camera_trajectory_mode="sequence",
        seed=12,
        splat_budget=6000,
        save_video=False,
    )
    import jax
    mesh = make_mesh((4,), ("scene",), jax.devices()[:4])
    stats = run_generation(config, [env], objs, mesh=mesh)
    assert stats.summary()["scenes"] == 4

    root = out / "sharded_run"
    assert (root / "models" / "models_info.json").exists()
    assert (root / "generation_config.json").exists()

    import imageio.v2 as imageio

    n_objs_seen = set()
    for sid in range(1, 5):
        scene = root / "train" / f"{sid:06d}"
        for sub in ("rgb", "depth", "mask", "mask_visib", "sem_mask"):
            assert (scene / sub).is_dir()
        with open(scene / "scene_gt.json") as f:
            gt = json.load(f)
        assert len(gt) == 2  # frames
        n_obj = len(gt["0"])
        n_objs_seen.add(n_obj)
        assert 1 <= n_obj <= 2
        # per-object masks exist for exactly the REAL objects
        masks = sorted((scene / "mask_visib").glob("000000_*.png"))
        assert len(masks) == n_obj
        rgb = imageio.imread(scene / "rgb" / "000000.png")
        assert rgb.mean() > 5  # content, not black
        depth = imageio.imread(scene / "depth" / "000000.png")
        assert depth.dtype == np.uint16 and (depth > 0).any()
        # GT rotations orthonormal, obj ids real
        R = np.asarray(gt["0"][0]["cam_R_m2c"]).reshape(3, 3)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert gt["0"][0]["obj_id"] in (104, 107)
        # trajectory JSON replayable with the reference schema
        engine_json = root / "engine" / f"{sid:06d}_simulation_steps.json"
        raw = json.loads(engine_json.read_text())
        assert "asset_infos" in raw and "trajectory" in raw
        assert len(raw["trajectory"]) == 1 + n_obj

    # the batch really mixed object counts (exercises placeholder bodies)
    assert len(n_objs_seen) >= 2


def test_sharded_resume_skips_done_scenes(synthetic_root, tmp_path):
    import dataclasses
    import jax

    env = Asset(
        OBJECT_NAME="asphalt", ID=1003, TYPE="environment",
        dataset_path=str(synthetic_root),
        DROP_REGION=(0.05, 0.05), DROP_HEIGHT=(0.2, 0.25),
    )
    objs = [
        Asset(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=str(synthetic_root)),
    ]
    out = tmp_path / "out"
    base = dict(
        dataset_path=str(synthetic_root),
        env_dataset_path=str(synthetic_root),
        urdf_asset_folder=str(synthetic_root / "urdf"),
        dataset_name="resume_sh",
        dataset_base_path=str(out),
        min_num_objects=1, max_num_objects=1,
        render_width=48, render_height=40,
        num_cameras=1, num_camera_interpolation_steps=2,
        simulation_steps=15, mode="static",
        camera_trajectory_mode="sequence", seed=8,
        splat_budget=4000, save_video=False,
    )
    mesh = make_mesh((2,), ("scene",), jax.devices()[:2])
    run_generation(GenerationConfig(num_scenes=2, **base), [env], objs, mesh=mesh)
    s1_gt = out / "resume_sh" / "train" / "000001" / "scene_gt.json"
    mtime_before = s1_gt.stat().st_mtime_ns

    stats = run_generation(
        GenerationConfig(num_scenes=4, resume=True, **base),
        [env], objs, mesh=mesh,
    )
    # only the two NEW scenes were generated; scene 1 untouched
    assert stats.summary()["scenes"] == 2
    assert s1_gt.stat().st_mtime_ns == mtime_before
    for sid in range(1, 5):
        assert (out / "resume_sh" / "train" / f"{sid:06d}" / "scene_gt.json").exists()


def test_sharded_dynamic_mode_tracks_motion(synthetic_root, tmp_path):
    """Dynamic sharded scenes record per-frame poses from the trajectory
    (same contract as the sequential fix over the reference's frozen-t0
    behavior)."""
    import jax

    env = Asset(
        OBJECT_NAME="asphalt", ID=1003, TYPE="environment",
        dataset_path=str(synthetic_root),
        DROP_REGION=(0.05, 0.05), DROP_HEIGHT=(0.25, 0.3),
    )
    objs = [
        Asset(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=str(synthetic_root)),
    ]
    out = tmp_path / "out"
    config = GenerationConfig(
        dataset_path=str(synthetic_root),
        env_dataset_path=str(synthetic_root),
        urdf_asset_folder=str(synthetic_root / "urdf"),
        dataset_name="dyn_sh",
        dataset_base_path=str(out),
        num_scenes=2,
        min_num_objects=1,
        max_num_objects=1,
        render_width=48,
        render_height=40,
        num_cameras=1,
        num_camera_interpolation_steps=4,
        simulation_steps=60,
        mode="dynamic",
        camera_trajectory_mode="sequence",
        seed=2,
        splat_budget=4000,
        save_video=False,
    )
    run_generation(
        config, [env], objs, mesh=make_mesh((2,), ("scene",), jax.devices()[:2])
    )
    gt = json.loads(
        (out / "dyn_sh" / "train" / "000001" / "scene_gt.json").read_text()
    )
    t0 = np.asarray(gt["0"][0]["T_m2w"]).reshape(4, 4)[:3, 3]
    t3 = np.asarray(gt["3"][0]["T_m2w"]).reshape(4, 4)[:3, 3]
    assert np.linalg.norm(t3 - t0) > 1e-4  # falling between frames


def test_sharded_matches_sequential_schema(synthetic_root, tmp_path):
    """Sequential and sharded paths write interoperable scene trees."""
    env = Asset(
        OBJECT_NAME="asphalt", ID=1003, TYPE="environment",
        dataset_path=str(synthetic_root),
        DROP_REGION=(0.05, 0.05), DROP_HEIGHT=(0.2, 0.25),
    )
    objs = [
        Asset(OBJECT_NAME="cup_noodles_04", ID=104, dataset_path=str(synthetic_root)),
    ]
    common = dict(
        dataset_path=str(synthetic_root),
        env_dataset_path=str(synthetic_root),
        urdf_asset_folder=str(synthetic_root / "urdf"),
        num_scenes=2,
        min_num_objects=1,
        max_num_objects=1,
        render_width=48,
        render_height=40,
        num_cameras=1,
        num_camera_interpolation_steps=2,
        simulation_steps=15,
        mode="static",
        camera_trajectory_mode="sequence",
        seed=5,
        splat_budget=4000,
        save_video=False,
    )
    cfg_seq = GenerationConfig(
        dataset_name="seq", dataset_base_path=str(tmp_path / "a"), **common
    )
    cfg_sh = GenerationConfig(
        dataset_name="sh", dataset_base_path=str(tmp_path / "b"), **common
    )
    run_generation(cfg_seq, [env], objs)
    run_generation(cfg_sh, [env], objs, mesh=make_mesh((2,), ("scene",), __import__("jax").devices()[:2]))

    for sid in (1, 2):
        a = tmp_path / "a" / "seq" / "train" / f"{sid:06d}"
        b = tmp_path / "b" / "sh" / "train" / f"{sid:06d}"
        ga = json.loads((a / "scene_gt.json").read_text())
        gb = json.loads((b / "scene_gt.json").read_text())
        assert set(ga.keys()) == set(gb.keys())
        assert {e["obj_id"] for e in ga["0"]} == {e["obj_id"] for e in gb["0"]}
        ca = json.loads((a / "scene_camera.json").read_text())
        cb = json.loads((b / "scene_camera.json").read_text())
        np.testing.assert_allclose(ca["0"]["cam_K"], cb["0"]["cam_K"], rtol=1e-5)
