"""Device-mesh helpers for scene/camera/splat sharding.

The reference is a single-process, single-GPU program (SURVEY 2.2
parallelism audit: no DP/TP/PP anywhere).  PEGASUS-TPU's scale-out axes:

  * ``scene``  — data parallelism over scene variants (vmapped physics +
    independent renders; zero communication, pure throughput);
  * ``camera`` — parallelism over a scene's camera trajectory (the scene
    cloud is replicated, frames are independent);
  * ``splat``  — model parallelism over the splat axis of one huge scene:
    compositing is associative under the 'over' operator
    ((c1,T1) over (c2,T2) = (c1 + T1*c2, T1*T2)), so depth-contiguous
    splat shards composite locally and reduce across the axis
    (parallel/sharded_render.py).

The mesh is flat: every card of a host reaches every other over NVLink
at the same rate, so mesh shapes follow the algorithm alone.  Collectives
are XLA's (NCCL on GPUs); nothing here calls NCCL/MPI directly (there is
nothing to port — see SURVEY 2.2).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("scene",),
    devices=None,
) -> Mesh:
    """Build a Mesh over the available devices.

    Default: 1-D 'scene' mesh over all devices.  axis_sizes=(a, b) with
    axis_names=('scene', 'splat') gives the 2-D scene-DP x splat-MP mesh.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (n,)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover {n} devices")
    dev_array = np.asarray(devices).reshape(axis_sizes)
    return Mesh(dev_array, axis_names=tuple(axis_names))


def shard_batch(tree, mesh: Mesh, axis_name: str = "scene"):
    """Place a pytree with a leading batch axis so that axis is sharded
    over `axis_name` and everything else is replicated."""
    sharding = NamedSharding(mesh, P(axis_name))

    def place(x):
        return jax.device_put(x, sharding)

    return jax.tree.map(place, tree)


def replicate(tree, mesh: Mesh):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)
