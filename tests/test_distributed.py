"""Two-process jax.distributed run of the sharded directory path.

Net-new vs the reference (SURVEY section 5.8: the reference has no
distributed backend).  Each process brings up the JAX distributed runtime
(coordinator + worker) through ``nyxus_tpu.parallel.initialize_distributed``,
resolves its shard of the slide list via ``jax.process_index()`` (NOT the
env-var override, so the real JAX path is exercised), featurizes it, and
writes a CSV; the union of the shards must equal the single-process run.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
sys.path.insert(0, %(root)r)
os.environ.pop("NYXUS_PROCESS_INDEX", None)
os.environ.pop("NYXUS_PROCESS_COUNT", None)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
from nyxus_tpu.parallel import initialize_distributed
initialize_distributed(coordinator_address=%(coord)r, num_processes=2,
                       process_id=%(pid)d)
assert jax.process_count() == 2, jax.process_count()
assert jax.process_index() == %(pid)d, jax.process_index()
from nyxus_tpu import Nyxus

# full fixture sweeps: heavy; the quick per-commit tier deselects these
import pytest as _pt
pytestmark = _pt.mark.nightly
nyx = Nyxus(["MEAN", "AREA_PIXELS_COUNT", "PERIMETER"], shard_slides=True)
df = nyx.featurize_directory(%(intdir)r, %(segdir)r)
df.to_csv(%(out)r, index=False)
print("shard", %(pid)d, "rows", len(df))
"""


def test_two_process_distributed_directory(tmp_path):
    from nyxus_tpu import Nyxus, native
    if not native.tiff_available():
        pytest.skip("native toolchain unavailable")
    intd = tmp_path / "int"
    segd = tmp_path / "seg"
    intd.mkdir()
    segd.mkdir()
    r = np.random.default_rng(2)
    slides = {}
    for s in range(4):
        img = r.integers(1, 5000, (96, 96)).astype(np.uint16)
        lab = np.zeros((96, 96), np.uint16)
        lab[8:40, 8:40] = 1
        lab[50:90, 30:80] = 2
        native.write_tiff(str(intd / ("s%d.tif" % s)), img, tile_size=64)
        native.write_tiff(str(segd / ("s%d.tif" % s)), lab, tile_size=64)
        slides["s%d.tif" % s] = (img, lab)

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = "localhost:%d" % port

    procs = []
    outs = []
    for pid in range(2):
        out = str(tmp_path / ("shard%d.csv" % pid))
        outs.append(out)
        code = _WORKER % {"root": ROOT, "coord": coord, "pid": pid,
                          "intdir": str(intd), "segdir": str(segd),
                          "out": out}
        env = dict(os.environ)
        env.pop("NYXUS_PROCESS_INDEX", None)
        env.pop("NYXUS_PROCESS_COUNT", None)
        procs.append(subprocess.Popen([sys.executable, "-c", code],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, env=env,
                                      cwd=ROOT))
    logs = []
    for p in procs:
        try:
            outb, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(outb.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    import pandas as pd
    parts = [pd.read_csv(o) for o in outs]
    # disjoint, non-empty shards
    assert all(len(p) > 0 for p in parts)
    seen = [set(p.mask_image) for p in parts]
    assert not (seen[0] & seen[1])

    union = pd.concat(parts, ignore_index=True)
    ref = Nyxus(["MEAN", "AREA_PIXELS_COUNT", "PERIMETER"]).featurize_directory(
        str(intd), str(segd))
    assert len(union) == len(ref) == 8
    key = ["mask_image", "ROI_label"]
    u = union.sort_values(key).reset_index(drop=True)
    g = ref.sort_values(key).reset_index(drop=True)
    for c in ("MEAN", "AREA_PIXELS_COUNT", "PERIMETER"):
        np.testing.assert_allclose(u[c].to_numpy(), g[c].to_numpy(),
                                   rtol=1e-6, err_msg=c)
