#!/usr/bin/env python3
"""Precompile the production executable ladder into the persistent cache.

One-time (per machine / per engine version) warmup: drives the REAL
runner over synthetic slides so every executable a production run needs is
compiled and cached -- the universal slide program at each output-row
quantum (Nq 128/320/576 at the shared 2 MB buffer signature), the >64 px
per-bucket flat kernels, and (with --full) the common feature-group
subsets and the f64 lane.  A fresh process afterwards reaches its first
row at cache-load speed (tools/measure_compile.py measures both costs).

Usage:
    python tools/warmup_cache.py [--full] [--precision f32|f64]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# also persist the serialized program (skips the fresh-process re-trace,
# pipeline/aot_cache.py) unless the caller already chose a location
os.environ.setdefault("NYXUS_TPU_AOT_CACHE",
                      os.path.join(ROOT, ".jax_cache", "aot"))

import numpy as np  # noqa: E402


def make_slide(n_blobs, seed=0, h=1024, w=1024, big=False):
    """Nucleus-scale synthetic slide; ``big`` adds one 128-bucket ROI so
    the per-bucket flat kernel path warms too."""
    r = np.random.default_rng(seed)
    labels = np.zeros((h, w), np.int32)
    intens = r.integers(1, 40000, (h, w)).astype(np.uint16)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = 1
    for _ in range(n_blobs):
        cy, cx = r.uniform(12, h - 12), r.uniform(12, w - 12)
        ry, rx = r.uniform(4, 18), r.uniform(4, 18)
        m = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0) \
            & (labels == 0)
        if m.sum() < 12:
            continue
        labels[m] = lab
        lab += 1
    if big:
        labels[8:128, 820:1010] = lab
    return intens, labels


def warm(precision, feats, tag):
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner import PairRunner

    runner = PairRunner(tx.parse_feature_request(feats),
                        EngineConfig(precision=precision))
    # Nq quanta: <=128, <=320, <=576 real rows per universal execution
    for n_blobs, big, seed in ((60, False, 1), (300, True, 2), (560, False, 3)):
        t0 = time.perf_counter()
        runner.run(*make_slide(n_blobs, seed=seed, big=big))
        print("warmed %-18s %3d-ROI slide (%s): %.1f s"
              % (tag, n_blobs, precision, time.perf_counter() - t0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also warm group subsets and the f64 lane")
    ap.add_argument("--precision", default="f32", choices=["f32", "f64"])
    args = ap.parse_args()
    t0 = time.perf_counter()
    warm(args.precision, ["*ALL*"], "*ALL*")
    if args.full:
        texture = ["*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLSZM*",
                   "*ALL_GLDZM*", "*ALL_GLDM*", "*ALL_NGLDM*",
                   "*ALL_NGTDM*"]
        for feats, tag in ((["*ALL_INTENSITY*"], "*ALL_INTENSITY*"),
                           (texture, "texture-only"),
                           (["*ALL_MORPHOLOGY*"], "*ALL_MORPHOLOGY*")):
            warm(args.precision, feats, tag)
        if args.precision == "f32":
            warm("f64", ["*ALL*"], "*ALL*")
    print("ladder warm in %.1f s" % (time.perf_counter() - t0))


if __name__ == "__main__":
    main()
