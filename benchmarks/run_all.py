"""Benchmark suite: the five BASELINE.json eval configs, one JSON report.

Usage:  python benchmarks/run_all.py [--out report.json] [--quick]

Configs (BASELINE.md):
  1. single static scene — cup-noodle-like object + environment,
     20 hemisphere cameras, 640x480 RGB(+depth+seg);
  2. physics placement — 5 objects dropped to rest + one annotated render;
  3. dynamic video scene — 300 physics timesteps rendered at 1280x720;
  4. PEGASET-style batch — objects x environments, randomized placements;
  5. throughput scale — vmapped physics + batched rendering of scene
     variants (sharded across the device mesh when several are present).

All scenes are synthetic (pegasus_tpu.testing) at realistic splat counts,
so the suite runs anywhere without the released 50 GB archives.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# make `python benchmarks/run_all.py` work from any cwd without installing
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _sync(x):
    import jax.numpy as jnp
    import jax

    _ = float(jnp.asarray(jax.tree.leaves(x)[0]).ravel()[0])


def _scene(rng, n_env=150_000, n_obj=10_000, n_objects=5):
    import jax

    from pegasus_tpu.gs.cloud import merge
    from pegasus_tpu.testing import make_box_cloud, make_plane_cloud

    env = make_plane_cloud(rng, n=n_env, size=2.0)
    objs = [
        make_box_cloud(
            rng, n=n_obj, center=(0.1 * i - 0.2, 0.05 * i, 0.08),
            object_id=i + 1,
        )
        for i in range(n_objects)
    ]
    return jax.device_put(merge([env] + objs))


def _cam(width, height, az=0.8):
    from pegasus_tpu.camera import Camera

    return Camera.look_at(
        eye=(0.9 * np.cos(az), 0.9 * np.sin(az), 0.9),
        target=(0, 0, 0.05), up=(0, 0, 1),
        fovx=np.deg2rad(60), fovy=np.deg2rad(47),
        width=width, height=height,
    )


def _render_fn():
    from pegasus_tpu.ops.backends import default_rasterize_fn

    r = default_rasterize_fn()
    return lambda s, c: r(s, c, max_objects=8)


def bench_static_scene(rng, iters):
    """Config 1: static scene, 20 hemisphere cameras at 640x480."""
    import jax

    from pegasus_tpu.viewer import orbit_cameras

    scene = _scene(rng, n_objects=1)
    cams = orbit_cameras(center=(0, 0, 0.05), radius=1.2, n_views=20,
                         width=640, height=480)
    fn = jax.jit(_render_fn())
    _sync(fn(scene, cams[0]))
    t0 = time.time()
    n = 0
    for _ in range(iters):
        for cam in cams:
            out = fn(scene, cam)
            n += 1
    _sync(out)
    dt = (time.time() - t0) / n
    return {"frames_per_s": 1.0 / dt, "ms_per_frame": dt * 1000, "frames": n}


def bench_physics_placement(rng):
    """Config 2: 5 objects dropped to rest (310 steps) + rest-pose sanity."""
    import jax.numpy as jnp

    from pegasus_tpu.physics import rigid_body as rb

    n_bodies = 6
    corners = np.array(
        [[sx * 0.04, sy * 0.04, sz * 0.06]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32,
    )
    params = rb.RigidBodyParams(
        inv_mass=jnp.array([0.0] + [5.0] * (n_bodies - 1)),
        inv_inertia=jnp.tile(jnp.full((1, 3), 1e3), (n_bodies, 1)),
        points=jnp.tile(corners[None], (n_bodies, 1, 1)),
        point_mask=jnp.ones((n_bodies, 8), bool),
        radius=jnp.full((n_bodies,), 0.09),
        friction=jnp.full((n_bodies,), 0.5),
        restitution=jnp.zeros((n_bodies,)),
        body_mask=jnp.ones((n_bodies,), bool),
        half_extents=jnp.tile(jnp.array([0.04, 0.04, 0.06]), (n_bodies, 1)),
    )
    pos0 = np.zeros((n_bodies, 3), np.float32)
    pos0[1:, 0] = np.linspace(-0.15, 0.15, n_bodies - 1)
    pos0[1:, 2] = np.linspace(0.15, 0.3, n_bodies - 1)
    state0 = rb.RigidBodyState.rest(
        pos0, np.tile([1, 0, 0, 0], (n_bodies, 1)).astype(np.float32)
    )
    _, final = rb.simulate(params, state0, n_steps=310)
    _sync(final.pos)
    t0 = time.time()
    for _ in range(3):
        traj, final = rb.simulate(params, state0, n_steps=310)
    _sync(final.pos)
    dt = (time.time() - t0) / 3
    z = np.asarray(final.pos)[1:, 2]
    return {
        "sim_ms_per_scene": dt * 1000,
        "steps_per_s": 310 / dt,
        "rest_z_ok": bool((z > 0.0).all() and (z < 0.2).all()),
    }


def bench_dynamic_hd(rng, iters):
    """Config 3: dynamic 300-step scene rendered at 1280x720."""
    import jax

    scene = _scene(rng, n_objects=5)
    cam = _cam(1280, 720)
    fn = jax.jit(_render_fn())
    _sync(fn(scene, cam))
    t0 = time.time()
    for _ in range(iters):
        out = fn(scene, cam)
    _sync(out)
    dt = (time.time() - t0) / iters
    return {"frames_per_s": 1.0 / dt, "ms_per_frame": dt * 1000,
            "seconds_per_300_frame_video": dt * 300}


def bench_batch(rng, iters):
    """Config 4: many object-set x environment combinations (render side)."""
    import jax

    fn = jax.jit(_render_fn())
    scenes = []
    for e in range(2 if iters > 1 else 1):
        scene = _scene(rng, n_env=120_000 + 30_000 * e, n_objects=6)
        cam = _cam(640, 480, az=0.5 + e)
        _sync(fn(scene, cam))  # compile every shape BEFORE the clock
        scenes.append((scene, cam))
    combos = 0
    out = None
    t0 = time.time()
    for scene, cam in scenes:
        for _ in range(iters):
            out = fn(scene, cam)
            combos += 1
    _sync(out)
    dt = (time.time() - t0) / combos
    return {"frames_per_s": 1.0 / dt, "ms_per_frame": dt * 1000}


def bench_variants(rng, n_variants):
    """Config 5: vmapped scene variants (sharded when devices allow)."""
    import jax

    from pegasus_tpu.parallel.mesh import make_mesh
    from pegasus_tpu.parallel.scene_batch import generate_scene_variants
    from pegasus_tpu.physics import rigid_body as rb
    from pegasus_tpu.scene.composition import SceneTemplate
    from pegasus_tpu.testing import make_box_cloud, make_plane_cloud
    import jax.numpy as jnp

    env = make_plane_cloud(rng, n=20_000, size=1.5)
    objs = [make_box_cloud(rng, n=2_000, object_id=i + 1) for i in range(3)]
    template = SceneTemplate.build(env, objs)
    n_bodies = template.num_bodies
    corners = np.array(
        [[sx * 0.04, sy * 0.04, sz * 0.06]
         for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32,
    )
    params = rb.RigidBodyParams(
        inv_mass=jnp.array([0.0] + [5.0] * (n_bodies - 1)),
        inv_inertia=jnp.tile(jnp.full((1, 3), 1e3), (n_bodies, 1)),
        points=jnp.tile(corners[None], (n_bodies, 1, 1)),
        point_mask=jnp.ones((n_bodies, 8), bool),
        radius=jnp.full((n_bodies,), 0.09),
        friction=jnp.full((n_bodies,), 0.5),
        restitution=jnp.zeros((n_bodies,)),
        body_mask=jnp.ones((n_bodies,), bool),
        half_extents=jnp.tile(jnp.array([0.04, 0.04, 0.06]), (n_bodies, 1)),
    )
    cam = _cam(320, 240)
    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev,), ("scene",))
    # memory-bounded chunks: 125 variants/device (frames at 240x320x3 f32
    # would be 39 GB for 1000 variants in one buffer)
    chunk = min(n_variants, 125 * n_dev)
    n_chunks = -(-n_variants // chunk)
    res = generate_scene_variants(
        template, params, cam, n_variants=chunk, n_steps=150, mesh=mesh,
        max_objects=4,
    )
    _sync(res.rgb)
    t0 = time.time()
    for i in range(n_chunks):
        res = generate_scene_variants(
            template, params, cam, n_variants=chunk, n_steps=150, mesh=mesh,
            max_objects=4, seed=1 + i,
        )
        _sync(res.rgb)
    dt = time.time() - t0
    return {
        "variants": chunk * n_chunks,
        "devices": n_dev,
        "chunk": chunk,
        "seconds": dt,
        "variants_per_s": chunk * n_chunks / dt,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="benchmark_report.json")
    parser.add_argument("--quick", action="store_true")
    parser.add_argument(
        "--configs", default="1,2,3,4,5",
        help="comma-separated subset to run; results merge into --out",
    )
    args = parser.parse_args(argv)

    import jax

    rng = np.random.default_rng(7)
    iters = 2 if args.quick else 10
    report = {}
    if os.path.exists(args.out):  # merge partial runs
        with open(args.out) as f:
            report = json.load(f)
    report["backend"] = jax.devices()[0].platform
    report["devices"] = len(jax.devices())
    selected = {int(s) for s in args.configs.split(",") if s}
    for num, name, fn in [
        (1, "config1_static_scene", lambda: bench_static_scene(rng, max(1, iters // 5))),
        (2, "config2_physics_placement", lambda: bench_physics_placement(rng)),
        (3, "config3_dynamic_hd", lambda: bench_dynamic_hd(rng, iters)),
        (4, "config4_batch", lambda: bench_batch(rng, iters)),
        (5, "config5_variants", lambda: bench_variants(rng, 8 if args.quick else 1000)),
    ]:
        if num not in selected:
            continue
        t0 = time.time()
        try:
            report[name] = fn()
            report[name]["wall_s"] = round(time.time() - t0, 2)
        except Exception as e:  # noqa: BLE001 — report, don't die
            report[name] = {"error": f"{type(e).__name__}: {e}"}
        print(name, json.dumps(report[name]))
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)

    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
