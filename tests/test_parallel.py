"""Multi-device scale-out: 1-device vs N-device mesh parity.

The JAX analog of the reference's thread-count invariance (results must not
depend on --reduceThreads): sharding the ROI batch axis over a mesh must
reproduce the single-device values exactly.
"""

import numpy as np
import pytest

import jax

from nyxus_tpu.api import Nyxus
from nyxus_tpu import parallel as par

FEATS = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*BASIC_MORPHOLOGY*",
         "*ALL_NGTDM*", "PERIMETER", "SOLIDITY"]


def _vals(df):
    return df[df.columns[4:]].to_numpy(float)


def test_mesh_parity_8dev(blob_pair):
    I, L = blob_pair
    d1 = Nyxus(FEATS, precision="f64").featurize(I, L)
    d8 = Nyxus(FEATS, precision="f64", n_devices=-1).featurize(I, L)
    assert list(d1.columns) == list(d8.columns)
    np.testing.assert_allclose(_vals(d1), _vals(d8), rtol=1e-12, atol=1e-12)


def test_mesh_parity_8dev_f32(blob_pair):
    # f32 default: XLA may fuse differently per shard size, so only
    # round-off-level drift is allowed.  The single-device reference is
    # pinned to the DENSE transfer scheme: the mesh path ships dense
    # batches, and the tight-buffer path's on-device gathers fuse into
    # moment reductions differently (its own parity pins live in
    # test_reference_parity / the f64 mesh tests).
    import nyxus_tpu.pipeline.runner as rmod
    I, L = blob_pair
    old = rmod._FLAT_TRANSFER
    rmod._FLAT_TRANSFER = False
    try:
        d1 = Nyxus(FEATS).featurize(I, L)
    finally:
        rmod._FLAT_TRANSFER = old
    d8 = Nyxus(FEATS, n_devices=-1).featurize(I, L)
    np.testing.assert_allclose(_vals(d1), _vals(d8), rtol=2e-5, atol=1e-6)


def test_mesh_parity_batch_smaller_than_mesh():
    # 3 ROIs on an 8-device mesh exercises the row-padding path
    from conftest import make_blobs
    I, L = make_blobs(h=96, w=96, n_blobs=3, seed=3)
    d1 = Nyxus(FEATS, precision="f64").featurize(I, L)
    d8 = Nyxus(FEATS, precision="f64", n_devices=8).featurize(I, L)
    np.testing.assert_allclose(_vals(d1), _vals(d8), rtol=1e-12, atol=1e-12)


def test_mesh_parity_streamed(tmp_path, blob_pair):
    # file-backed (tile-streamed) path under a mesh
    from nyxus_tpu.native import write_tiff
    I, L = blob_pair
    ip = str(tmp_path / "int.tif")
    lp = str(tmp_path / "seg.tif")
    write_tiff(ip, I.astype(np.uint16))
    write_tiff(lp, L.astype(np.uint16))
    d1 = Nyxus(FEATS, precision="f64").featurize_files([ip], [lp])
    d4 = Nyxus(FEATS, precision="f64", n_devices=4).featurize_files([ip], [lp])
    np.testing.assert_allclose(_vals(d1), _vals(d4), rtol=1e-12, atol=1e-12)


def test_roi_mesh_sizes():
    m = par.roi_mesh()
    assert m.devices.size == len(jax.devices())
    m2 = par.roi_mesh(2)
    assert m2.devices.size == 2
    with pytest.raises(ValueError):
        par.roi_mesh(10_000)


def test_shard_batch_pads_and_shards():
    m = par.roi_mesh(4)
    a = np.arange(6, dtype=np.float32)[:, None] * np.ones((6, 3), np.float32)
    (sa,), b = par.shard_batch(m, (a,))
    assert b == 6 and sa.shape == (8, 3)
    np.testing.assert_array_equal(np.asarray(sa)[:6], a)
    np.testing.assert_array_equal(np.asarray(sa)[6:],
                                  np.tile(a[:1], (2, 1)))  # row-0 padding


def test_mesh_parity_3d(blob_volume, tmp_path):
    """Runs in a SUBPROCESS: compiling the sharded 3D megakernel late in a
    long pytest process aborts inside XLA:CPU (reproducible only with the
    near-full suite's accumulated executables; the identical compile
    succeeds in a fresh process).  The subprocess keeps the same assertion
    while isolating that XLA scalability issue from the suite."""
    import os
    import subprocess
    import sys
    I, L = blob_volume
    np.save(tmp_path / "I.npy", I)
    np.save(tmp_path / "L.npy", L)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = (
        "import sys, os\n"
        "sys.path.insert(0, %r)\n"
        "os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS', '') + "
        "' --xla_force_host_platform_device_count=8'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "jax.config.update('jax_enable_x64', True)\n"
        "import numpy as np\n"
        "from nyxus_tpu.api import Nyxus3D\n"
        "I = np.load(%r); L = np.load(%r)\n"
        "feats = ['*3D_ALL_INTENSITY*', '*3D_GLCM*']\n"
        "d1 = Nyxus3D(feats, precision='f64').featurize(I, L)\n"
        "d8 = Nyxus3D(feats, precision='f64', n_devices=8).featurize(I, L)\n"
        "v1 = d1[d1.columns[4:]].to_numpy(float)\n"
        "v8 = d8[d8.columns[4:]].to_numpy(float)\n"
        "np.testing.assert_allclose(v1, v8, rtol=1e-12, atol=1e-12)\n"
        "print('3d mesh parity ok')\n"
    ) % (root, str(tmp_path / "I.npy"), str(tmp_path / "L.npy"))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    p = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "3d mesh parity ok" in p.stdout


def test_use_gpu_device():
    nyx = Nyxus(["MEAN"])
    nyx.use_gpu_device(-1)          # default placement is always valid
    with pytest.raises(ValueError):
        nyx.use_gpu_device(10_000)


def test_process_shard_single_process():
    items = list(range(7))
    assert par.process_shard(items) == items  # 1 process -> everything


def test_process_shard_env_override(monkeypatch):
    from nyxus_tpu import parallel as par
    items = list(range(7))
    monkeypatch.setenv("NYXUS_PROCESS_INDEX", "1")
    monkeypatch.setenv("NYXUS_PROCESS_COUNT", "2")
    assert par.process_shard(items) == [1, 3, 5]
    monkeypatch.setenv("NYXUS_PROCESS_INDEX", "0")
    assert par.process_shard(items) == [0, 2, 4, 6]


def test_two_process_directory_shard(tmp_path):
    """Simulated 2-host run (VERDICT r1 long tail): two subprocesses, each a
    full Nyxus featurize_directory with shard_slides=True and a distinct
    NYXUS_PROCESS_INDEX, must cover the dataset disjointly."""
    import os
    import subprocess
    import sys

    import pandas as pd
    from nyxus_tpu import native
    if not native.tiff_available():
        import pytest
        pytest.skip("native toolchain unavailable")
    r = np.random.default_rng(3)
    int_dir = tmp_path / "int"
    seg_dir = tmp_path / "seg"
    int_dir.mkdir()
    seg_dir.mkdir()
    for k in range(4):
        img = r.integers(1, 900, (48, 48)).astype(np.uint16)
        lab = np.zeros((48, 48), np.uint16)
        lab[8:40, 8:40] = 1
        native.write_tiff(str(int_dir / ("s%d.ome.tif" % k)), img)
        native.write_tiff(str(seg_dir / ("s%d.ome.tif" % k)), lab)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    outs = []
    procs = []
    for pid in range(2):
        out = tmp_path / ("out%d.csv" % pid)
        outs.append(out)
        script = (
            "import sys; sys.path.insert(0, %r)\n"
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "from nyxus_tpu import Nyxus\n"
            "df = Nyxus(['MEAN'], shard_slides=True).featurize_directory(%r, %r)\n"
            "df.to_csv(%r, index=False)\n"
        ) % (root, str(int_dir), str(seg_dir), str(out))
        env = dict(os.environ)
        env["NYXUS_PROCESS_INDEX"] = str(pid)
        env["NYXUS_PROCESS_COUNT"] = "2"
        procs.append(subprocess.Popen([sys.executable, "-c", script],
                                      env=env))
    for p in procs:
        assert p.wait(timeout=600) == 0
    frames = [pd.read_csv(o) for o in outs]
    names = [sorted(f.intensity_image.tolist()) for f in frames]
    assert len(names[0]) + len(names[1]) == 4
    assert not (set(names[0]) & set(names[1]))
