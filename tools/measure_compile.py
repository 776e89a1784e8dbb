#!/usr/bin/env python3
"""Measure FRESH-CACHE compile time for the *ALL* and *3D_ALL* megakernels.

Runs each workload in a subprocess whose JAX_COMPILATION_CACHE_DIR is a
THROWAWAY directory -- on purpose, so nothing warm leaks in and the first
run measures a cold compile -- then once more with that now-warm directory
to report the persistent-cache reload cost.  Prints the times as JSON.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SNIPPET_2D = """
import sys, time; sys.path.insert(0, %(root)r)
import bench
from nyxus_tpu import taxonomy as tx
from nyxus_tpu.config import EngineConfig
from nyxus_tpu.pipeline.runner import PairRunner
intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
t0 = time.perf_counter()
PairRunner(tx.parse_feature_request(["*ALL*"]),
           EngineConfig(precision="f32")).run(intens, labels)
print("FIRST_RUN_SECONDS", time.perf_counter() - t0)
"""

SNIPPET_3D = """
import sys, time, numpy as np; sys.path.insert(0, %(root)r)
from nyxus_tpu import taxonomy as tx
from nyxus_tpu.config import EngineConfig
from nyxus_tpu.pipeline.runner3d import VolumeRunner
r = np.random.default_rng(0)
ii = r.integers(1, 400, (24, 28, 30)).astype(np.uint16)
ll = np.zeros((24, 28, 30), np.int32); ll[4:20, 4:24, 4:26] = 1
t0 = time.perf_counter()
VolumeRunner(tx.parse_feature_request(["*3D_ALL*"], dim=3),
             EngineConfig(precision="f32")).run(ii, ll)
print("FIRST_RUN_SECONDS", time.perf_counter() - t0)
"""


def run(snippet, cache, env_extra=None):
    env = dict(os.environ)
    env["JAX_COMPILATION_CACHE_DIR"] = cache
    if env_extra:
        env.update(env_extra)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", snippet % dict(root=HERE)],
                       capture_output=True, text=True, timeout=3600, env=env)
    wall = time.perf_counter() - t0
    first = None
    for line in p.stdout.splitlines():
        if line.startswith("FIRST_RUN_SECONDS"):
            first = float(line.split()[1])
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-2000:])
        raise SystemExit("workload failed")
    return wall, first


SNIPPET_SUBSET = """
import sys, time; sys.path.insert(0, %(root)r)
import bench
from nyxus_tpu import taxonomy as tx
from nyxus_tpu.config import EngineConfig
from nyxus_tpu.pipeline.runner import PairRunner
intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
t0 = time.perf_counter()
PairRunner(tx.parse_feature_request(["*ALL_INTENSITY*"]),
           EngineConfig(precision="f32")).run(intens, labels)
print("FIRST_RUN_SECONDS", time.perf_counter() - t0)
"""


def main():
    out = {}
    for name, snip in (("ALL_2d", SNIPPET_2D), ("ALL_3d", SNIPPET_3D),
                       ("ALL_INTENSITY_2d", SNIPPET_SUBSET)):
        with tempfile.TemporaryDirectory() as fresh:
            wall_f, first_f = run(snip, fresh)
            wall_w, first_w = run(snip, fresh)   # warm persistent cache
        out[name] = {
            "fresh_cache_first_run_s": round(first_f, 2),
            "fresh_cache_process_wall_s": round(wall_f, 2),
            "warm_cache_first_run_s": round(first_w, 2),
            "warm_cache_process_wall_s": round(wall_w, 2),
        }
        print(name, out[name])
    # AOT program cache (NYXUS_TPU_AOT_CACHE): the warm first run above is
    # TRACING-bound (the persistent cache already serves the backend
    # compile) -- measure how far the serialized-program path cuts it.
    # Run 1 populates both caches (and pays the export at exit); run 2 is
    # the fresh-process number users see.
    with tempfile.TemporaryDirectory() as fresh:
        aot = os.path.join(fresh, "aot")
        os.makedirs(aot)
        env = {"NYXUS_TPU_AOT_CACHE": aot}
        run(SNIPPET_2D, fresh, env)
        wall_w, first_w = run(SNIPPET_2D, fresh, env)
        out["ALL_2d_aot"] = {
            "warm_cache_first_run_s": round(first_w, 2),
            "warm_cache_process_wall_s": round(wall_w, 2),
            "note": ("NYXUS_TPU_AOT_CACHE serves the serialized program: "
                     "no megakernel re-trace in a fresh process"),
        }
        print("ALL_2d_aot", out["ALL_2d_aot"])

    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
