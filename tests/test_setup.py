"""Process set-up: where the compile cache goes, when the native library is
rebuilt, and that the GPU smoke run refuses to run anywhere else."""

import os
import subprocess
import sys

import pytest

from nyxus_tpu import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [True, False], ids=["env_set", "unset"])
def test_compile_cache_placement(tmp_path, env_dir):
    """A set JAX_COMPILATION_CACHE_DIR is the cache, and nothing overrides
    it; unset, the cache is <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    want = os.path.join(ROOT, ".jax_cache")
    if env_dir:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, nyxus_tpu; print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == want


def test_stale_host_stamp_rebuilds(tmp_path, monkeypatch):
    """A library whose stamp names another host (a .so copied from another
    CPU) is rebuilt; a current one is kept."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "t.cpp").write_text('extern "C" int nyx_t() { return 7; }\n')
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIBS", {"libt.so": (("t.cpp",), ())})
    out = str(tmp_path / "build")

    lib = native.build("libt.so", out)
    stamp = native._stamp()
    assert "host=" in stamp
    with open(lib + ".flags") as f:
        assert f.read() == stamp
    first = os.stat(lib).st_ino
    assert native.build("libt.so", out) == lib
    assert os.stat(lib).st_ino == first          # up to date: kept

    with open(lib + ".flags", "w") as f:
        f.write(stamp.split("host=")[0] + "host=another-cpu")
    assert native._needs_build(lib, ("t.cpp",), stamp)
    native.build("libt.so", out)
    assert os.stat(lib).st_ino != first          # rebuilt in place
    with open(lib + ".flags") as f:
        assert f.read() == stamp


def test_current_build_loads_without_compiler(tmp_path, monkeypatch):
    """An up-to-date library (a prebuilt one, say) is used as it is on a
    host with no g++ on PATH: the host stamp needs no compiler."""
    import ctypes
    src = tmp_path / "src"
    src.mkdir()
    (src / "t.cpp").write_text('extern "C" int nyx_t() { return 7; }\n')
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_LIBS", {"libt.so": (("t.cpp",), ())})
    out = str(tmp_path / "build")
    lib = native.build("libt.so", out)
    first = os.stat(lib).st_ino

    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    assert native.build("libt.so", out) == lib
    assert os.stat(lib).st_ino == first
    assert ctypes.CDLL(lib).nyx_t() == 7


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero and prints no result without a GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr
