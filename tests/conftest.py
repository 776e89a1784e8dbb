"""Test configuration.

Default lane: a virtual 8-device CPU mesh with fp64 enabled so kernel parity
can be checked against float64 numpy oracles.  It applies whenever
JAX_PLATFORMS is unset or "cpu".

GPU lane (``python -m pytest tests/ -m gpu`` on a machine with a card):
tests marked ``gpu`` take the ``gpu_device`` fixture, run in the engine's
production f32 mode on the card, and skip where JAX finds no GPU.
"""

import os

CPU_LANE = os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu"

if CPU_LANE:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if CPU_LANE:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on the GPU (python -m pytest tests/ -m gpu); "
        "skips where JAX finds no GPU")
    config.addinivalue_line(
        "markers", "nightly: heavy parity suites (full fixture sweeps); "
        "the quick per-commit tier deselects them with -m 'not nightly'")


import numpy as np
import pytest


@pytest.fixture(autouse=True, scope="module")
def _release_executables():
    """Free compiled executables after each test module.

    A long pytest process accumulates one live XLA:CPU executable per
    (kernel x shape x config); past ~250 tests the NEXT large compile
    aborts inside XLA (observed deterministically at whichever big *ALL*
    compile comes first -- an mmap/code-arena exhaustion, reproducible only
    with the near-full suite).  Dropping the jit caches between modules
    keeps the population bounded; the persistent on-disk cache makes
    re-tracing cheap."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first JAX device, which must be a GPU; skips the test otherwise
    (decided here, at run time, never at import or collection)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("no GPU: JAX's first device is %s" % dev.platform)
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def make_blobs(h=160, w=160, n_blobs=10, seed=0, intens_dtype=np.uint16,
               rmin=4, rmax=24):
    """Synthetic labeled image pair: elliptical blobs with textured interiors."""
    r = np.random.default_rng(seed)
    labels = np.zeros((h, w), np.int32)
    intens = np.zeros((h, w), np.float64)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = 1
    for _ in range(n_blobs):
        cy, cx = r.uniform(10, h - 10), r.uniform(10, w - 10)
        ry, rx = r.uniform(rmin, rmax), r.uniform(rmin, rmax)
        ang = r.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        u = (yy - cy) * ca + (xx - cx) * sa
        v = -(yy - cy) * sa + (xx - cx) * ca
        m = (u / ry) ** 2 + (v / rx) ** 2 <= 1.0
        m &= labels == 0
        if m.sum() < 8:
            continue
        base = r.uniform(100, 40000)
        tex = r.normal(0, base * 0.2, size=(h, w))
        wave = base * 0.3 * np.sin(yy / r.uniform(2, 9)) * np.cos(xx / r.uniform(2, 9))
        intens[m] = np.clip(base + tex[m] + wave[m], 1, 65535)
        labels[m] = lab
        lab += 1
    return np.floor(intens).astype(intens_dtype), labels


@pytest.fixture(scope="session")
def blob_pair():
    return make_blobs()


def make_blobs3d(d=14, h=28, w=28, n_blobs=3, seed=5):
    """Synthetic labeled volume pair: ellipsoidal blobs, textured interiors."""
    r = np.random.default_rng(seed)
    labels = np.zeros((d, h, w), np.int32)
    intens = np.zeros((d, h, w), np.float64)
    zz, yy, xx = np.mgrid[0:d, 0:h, 0:w]
    lab = 1
    for _ in range(n_blobs):
        cz, cy, cx = r.uniform(3, d - 3), r.uniform(6, h - 6), r.uniform(6, w - 6)
        rz, ry, rx = r.uniform(2.5, d / 2.6), r.uniform(4, 10), r.uniform(4, 10)
        m = ((zz - cz) / rz) ** 2 + ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        m &= labels == 0
        if m.sum() < 30:
            continue
        base = r.uniform(80, 4000)
        tex = r.normal(0, base * 0.25, size=(d, h, w))
        wave = base * 0.3 * np.sin(zz / 2.1) * np.cos(xx / r.uniform(2, 6))
        intens[m] = np.clip(base + tex[m] + wave[m], 1, 65535)
        labels[m] = lab
        lab += 1
    return np.floor(intens), labels


@pytest.fixture(scope="session")
def blob_volume():
    return make_blobs3d()
