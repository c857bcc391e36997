"""Worked example: create a PEGASUS asset from photos, end to end.

Mirrors the reference's offline asset-creation entry scripts
(reference: src/reconstruction/environment_reconstruction.py:40-92 and
spherical_object_reconstruction.py:96-215): COLMAP SfM -> metric scale
(ArUco or constant) -> plane alignment -> 3DGS training through the
differentiable tiled compositor -> alpha-shape URDF generation.  The
resulting folder plugs straight into the generator (see
examples/generate_dataset.py).

Usage:
  # environment from a folder of photos:
  python examples/reconstruct_asset.py env  <dataset_root> <AssetClassName>
  # turntable object (Ortery up+down sets):
  python examples/reconstruct_asset.py obj  <dataset_root> <AssetClassName>
  # in-the-wild object (masked image sets):
  python examples/reconstruct_asset.py wild <dataset_root> <AssetClassName>

<AssetClassName> is any roster class (pegasus_tpu/assets/rosters.py),
e.g. Asphalt, CupNoodle04, CrackerBox.  COLMAP must be on PATH (or set
COLMAP_EXE); training runs natively on the available JAX backend.
"""

import sys

from pegasus_tpu.assets.rosters import full_registry
from pegasus_tpu.reconstruction.recipes import (
    environment_reconstruction,
    in_the_wild_object_reconstruction,
    spherical_object_reconstruction,
)

RECIPES = {
    "env": environment_reconstruction,
    "obj": spherical_object_reconstruction,
    "wild": in_the_wild_object_reconstruction,
}

if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] not in RECIPES:
        print(__doc__)
        sys.exit(2)
    kind, root, class_name = sys.argv[1:4]
    asset = full_registry(root).by_class_name(class_name)
    RECIPES[kind](asset)
    print(f"[reconstruct_asset] {class_name}: GS model at "
          f"{asset.gs_model_path}, URDF at {asset.urdf_file_path}")
