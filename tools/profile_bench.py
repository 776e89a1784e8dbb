#!/usr/bin/env python3
"""Stage-profile the end-to-end bench protocol.

Usage: python tools/profile_bench.py [--slides N]

Reports:
1. Per-stage Stopwatch totals for the file-based CLI run (steady state:
   second run, warm compile cache).
2. Pure device-time split for one slide in-memory: host stages wall,
   dispatch wall, time-to-execution-done (device busy + queue), D2H fetch.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

import bench  # noqa: E402


def profile_file_run(intens, labels, n_slides):
    from nyxus_tpu.timing import Stopwatch
    # warmup (compiles)
    t0 = time.perf_counter()
    bench.bench_file_based(n_slides)
    warm = time.perf_counter() - t0
    Stopwatch.enable()
    Stopwatch.reset()
    t0 = time.perf_counter()
    rois, wall, mpix = bench.bench_file_based(n_slides)
    print("\n=== file protocol: %d ROIs / %.3f s = %.1f ROIs/s "
          "(first run %.1f s) ===" % (rois, wall, rois / wall, warm))
    print(Stopwatch.summary())
    Stopwatch.enable(False)
    return wall


def profile_device_split(intens, labels):
    """One slide in-memory: break the runner wall into host / dispatch /
    device-exec / fetch by timing the async_collect boundary."""
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner import PairRunner

    cfg = EngineConfig(precision="f32")
    fset = tx.parse_feature_request(["*ALL*"])
    runner = PairRunner(fset, cfg)
    I = intens.astype(np.uint32)
    M = labels.astype(np.uint32)
    runner.run(I, M)  # warmup/compile

    for it in range(3):
        t0 = time.perf_counter()
        labs, fin = runner.run(I, M, async_collect=True)
        t_dispatch = time.perf_counter()
        out = fin()
        t_done = time.perf_counter()
        print("iter %d: host+dispatch %.1f ms | finish() (device wait + D2H "
              "+ phase3 + post-host) %.1f ms | total %.1f ms"
              % (it, (t_dispatch - t0) * 1e3, (t_done - t_dispatch) * 1e3,
                 (t_done - t0) * 1e3))

    # device-only: time the dispatched executable alone (no host stages), by
    # capturing the last dispatched output buffer.  The dense path goes
    # through _extract_pair_packed, the tight-buffer path through the
    # module-global _extract_slide_fused / _extract_bucket_flat -- wrap all.
    import nyxus_tpu.pipeline.runner as rmod
    rec = {}
    hooks = ("_extract_pair_packed", "_extract_slide_fused",
             "_extract_bucket_flat")
    origs = {nm: getattr(rmod, nm) for nm in hooks}

    def make_wrapper(fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            rec["dispatch_s"] = time.perf_counter() - t0
            rec["out"] = out
            return out
        return wrapper

    for nm, fn in origs.items():
        setattr(rmod, nm, make_wrapper(fn))
    try:
        t0 = time.perf_counter()
        labs, fin = runner.run(I, M, async_collect=True)
        t1 = time.perf_counter()
        jax.block_until_ready(rec["out"])
        t2 = time.perf_counter()
        fin()
        t3 = time.perf_counter()
    finally:
        for nm, fn in origs.items():
            setattr(rmod, nm, fn)
    print("\ndevice split: host stages+dispatch %.1f ms (of which dispatch "
          "call %.1f ms) | block_until_ready after host stages %.1f ms | "
          "rest of finish() %.1f ms"
          % ((t1 - t0) * 1e3, rec["dispatch_s"] * 1e3, (t2 - t1) * 1e3,
             (t3 - t2) * 1e3))

    # pure device execution: re-dispatch the same args with host idle
    with jax.profiler.TraceAnnotation("pure_exec"):
        pass
    t0 = time.perf_counter()
    labs, fin = runner.run(I, M, async_collect=True)
    jax.block_until_ready(rec.get("out"))
    # time a do-nothing loop? simpler: time dispatch->ready with no host work
    t_all = time.perf_counter() - t0
    print("run+block total (host busy overlapped): %.1f ms" % (t_all * 1e3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slides", type=int, default=8)
    ap.add_argument("--skip-file", action="store_true")
    args = ap.parse_args()
    intens, labels = bench.make_dsb_like()
    if not args.skip_file:
        profile_file_run(intens, labels, args.slides)
    print("\n=== in-memory device split ===")
    profile_device_split(intens, labels)


if __name__ == "__main__":
    main()
