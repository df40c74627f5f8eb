"""Entry-point set-up (utils/device.py): the persistent compile cache
location and the refusal to measure without a GPU."""

import os
import subprocess
import sys

import jax

from cudavolumerenderer_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restore_cache_dir(value):
    jax.config.update("jax_compilation_cache_dir", value)


def test_compile_cache_uses_env_dir(tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and no other
    directory is configured."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    finally:
        _restore_cache_dir(before)


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = device.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        _restore_cache_dir(before)


def test_chip_smoke_refuses_cpu_only_process():
    """chip_smoke.py exits non-zero and prints no result line when JAX
    finds no GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr + proc.stdout
