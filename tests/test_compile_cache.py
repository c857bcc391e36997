"""Persistent compilation cache wiring (utils/compile_cache.py)."""

import subprocess
from pathlib import Path

import jax

from pegasus_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parents[1]


def _reset(monkeypatch):
    compile_cache._enabled = False
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("PEGASUS_TPU_COMPILE_CACHE", raising=False)


def test_enable_points_jax_at_dir(monkeypatch):
    _reset(monkeypatch)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = compile_cache.enable_compilation_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 2.0
        # idempotent: second call is a no-op
        assert compile_cache.enable_compilation_cache() is None
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        compile_cache._enabled = False


def test_env_var_disables(monkeypatch):
    _reset(monkeypatch)
    monkeypatch.setenv("PEGASUS_TPU_COMPILE_CACHE", "0")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compilation_cache() is None
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        compile_cache._enabled = False


def test_jax_cache_env_var_honoured(tmp_path, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory
    of its own (JAX reads the variable itself)."""
    _reset(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compilation_cache() is None
        assert jax.config.jax_compilation_cache_dir == before
        assert not (tmp_path / "c").exists()
    finally:
        compile_cache._enabled = False


def test_default_dir_is_in_checkout_and_ignored():
    d = Path(compile_cache.DEFAULT_DIR)
    assert d.parent == REPO
    rc = subprocess.run(
        ["git", "-C", str(REPO), "check-ignore", "-q", str(d / "x")],
        capture_output=True,
    ).returncode
    if rc == 128:  # not a git checkout: read .gitignore directly
        lines = (REPO / ".gitignore").read_text().split()
        assert f"{d.name}/" in lines
    else:
        assert rc == 0
