"""Start-up rules: compile-cache directory, device tile budget, native
library naming."""
import os

import pytest

import burst_tpu
from burst_tpu import engine, native


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the code sets no directory."""
    import jax

    updates = {}
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    burst_tpu.enable_compile_cache()
    assert "jax_compilation_cache_dir" not in updates


def test_compile_cache_default_in_checkout(monkeypatch):
    """Unset: the fixed in-checkout path <repo>/.jax_cache."""
    import jax

    updates = {}
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert want == burst_tpu.REPO_CACHE_DIR
    burst_tpu.enable_compile_cache()
    assert updates["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 0}, 30 << 30),
    (None, engine.CPU_TILE_BUDGET),
    ({}, engine.CPU_TILE_BUDGET),
])
def test_tile_budget_from_memory_stats(monkeypatch, stats, want):
    import jax

    monkeypatch.delenv("BURST_TPU_TILE_HBM_MB", raising=False)
    monkeypatch.setattr(jax, "local_devices", lambda *a: [_Dev(stats)])
    assert engine._tile_budget_bytes() == want


def test_tile_budget_override(monkeypatch):
    monkeypatch.setenv("BURST_TPU_TILE_HBM_MB", "2")
    assert engine._tile_budget_bytes() == 2 << 20
    assert engine._slab_rows_for(100, 64) is None
    assert engine._slab_rows_for(1 << 20, 64) == 16384


def test_native_key_tracks_source_command_cpu():
    cmd = ["g++", "-O3", "-march=native"]
    base = native.library_key(b"int f();", cmd, "cpu A")
    assert base == native.library_key(b"int f();", cmd, "cpu A")
    assert base != native.library_key(b"int g();", cmd, "cpu A")
    assert base != native.library_key(b"int f();", cmd[:2], "cpu A")
    assert base != native.library_key(b"int f();", cmd, "cpu B")


def test_native_library_named_by_key():
    """The loaded library sits in build/ under its key for this CPU."""
    if native.load_host() is None:
        pytest.skip("native library disabled (BURST_TPU_NO_NATIVE)")
    path = native.host_library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    with open(os.path.join(os.path.dirname(native.__file__),
                           "burst_host.cpp"), "rb") as f:
        src = f.read()
    keys = {native.library_key(src, cmd, native.cpu_identity())
            for cmd in native._HOST_CMDS}
    assert os.path.basename(path)[len("burst_host-"):-3] in keys
