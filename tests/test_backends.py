"""The one compositor choice (ops/backends.py)."""

import subprocess
import sys
from pathlib import Path

import pytest

from pegasus_tpu.ops.backends import default_rasterize_fn
from pegasus_tpu.ops.rasterize_pallas import rasterize_pallas
from pegasus_tpu.ops.rasterize_tiled import rasterize_tiled

REPO = Path(__file__).resolve().parents[1]


def test_cpu_maps_to_tiled():
    assert default_rasterize_fn("cpu") is rasterize_tiled
    # the tests run on the CPU: the default reads the platform
    assert default_rasterize_fn() is rasterize_tiled


def test_gpu_maps_to_kernel():
    assert default_rasterize_fn("gpu") is rasterize_pallas


def test_unknown_platform_raises():
    with pytest.raises(ValueError, match="rocm"):
        default_rasterize_fn("rocm")


def test_main_path_imports_without_optional_packages():
    """generate / pegasus / parallel.generation import with flax,
    imageio, tqdm, PIL and cv2 unavailable."""
    code = (
        "import sys\n"
        "for m in ('flax', 'imageio', 'tqdm', 'PIL', 'cv2'):\n"
        "    sys.modules[m] = None\n"
        "import pegasus_tpu.generate, pegasus_tpu.pegasus\n"
        "import pegasus_tpu.parallel.generation\n"
        "import pegasus_tpu.ops.rasterize_pallas\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin",
             "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
