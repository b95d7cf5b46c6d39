"""The on-GPU smoke check's guards and the compile-cache location, on CPU.

`chip_smoke.py` itself runs only on a GPU; what is checked here is that it
refuses anything else and where the persistent compile cache goes.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke
from gps_jamming_tpu.runtime import compile_cache

REPO = Path(__file__).resolve().parents[1]


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_require_gpu_refuses_no_devices():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu([])


def test_require_gpu_counts_devices():
    class Gpu:
        platform = "gpu"
    devs = [Gpu() for _ in range(4)]
    assert chip_smoke.require_gpu(devs, 4) == devs
    assert chip_smoke.require_gpu(devs) == devs[:1]
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        chip_smoke.require_gpu(devs[:1], 4)


def test_smoke_exits_nonzero_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cache_dir_uses_the_variable_when_set():
    env = {compile_cache.ENV_VAR: "/some/where/cache"}
    assert compile_cache.cache_dir(env) == "/some/where/cache"


def test_cache_dir_defaults_to_the_checkout():
    d = compile_cache.cache_dir({})
    assert d == str(REPO / ".jax_cache")
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().splitlines()


def test_cache_dir_treats_empty_variable_as_unset():
    assert compile_cache.cache_dir({compile_cache.ENV_VAR: ""}) == \
        str(REPO / ".jax_cache")


def test_enable_compile_cache_leaves_a_set_variable_alone(monkeypatch):
    monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == "/elsewhere"
    assert jax.config.jax_compilation_cache_dir == before


def test_enable_compile_cache_points_jax_at_the_checkout(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
