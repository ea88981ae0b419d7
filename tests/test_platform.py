"""The platform module (the one place that decides what each platform runs),
the compile-cache placement, and chip_smoke.py's refusal to run without a
GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from pose_refine import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,kernel,fused", [
    ("cpu", False, False),
    ("gpu", True, True),
])
def test_platform_choices(name, kernel, fused):
    assert platform.current(name) == name
    assert platform.raster_kernel(name) is kernel
    assert platform.nn_backend(name) in ("kdtree", "bruteforce")
    chunk = platform.icp_chunk_iters(24, name)
    assert chunk == (25 if fused else platform.CPU_CHUNK_ITERS)
    assert platform.is_accelerator(name) is (name != "cpu")


def test_cpu_nn_backend_is_kdtree():
    assert platform.nn_backend("cpu") == "kdtree"


@pytest.mark.parametrize("name", ["rocm", "neuron", "METAL", ""])
def test_unknown_platform_raises(name):
    with pytest.raises(RuntimeError, match="no platform choices"):
        platform.raster_kernel(name)
    with pytest.raises(RuntimeError, match="no platform choices"):
        platform.current(name)


def test_default_platform_is_jax_backend():
    # the tests run on the CPU backend
    assert platform.current() == "cpu"
    assert platform.raster_kernel() is False


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the helper sets nothing (JAX reads the
    variable itself) and reports that directory."""
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda *a: calls.append(a))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    """Unset: the cache lives in <checkout>/.jax_cache, derived from the
    package's location (never a temp name, pid or time)."""
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(platform.jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(REPO, ".jax_cache")
    assert platform.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]
    assert platform.enable_compile_cache(".jax_cache_cpu").endswith(
        os.path.join(os.path.basename(REPO), ".jax_cache_cpu"))


def _run_smoke(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return out


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke check fails and prints no result."""
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert _json_lines(r.stdout) == []


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the package next to it fails, with no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert _json_lines(r.stdout) == []
