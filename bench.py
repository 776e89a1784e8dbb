#!/usr/bin/env python3
"""Benchmark: full *ALL* (747-column) throughput on the GPU.

Workload: a DSB2018-like synthetic segmented slide (many nucleus-scale ROIs)
featurized with the complete *ALL* 2D feature group — every family, device
and host side, exactly what `nyxus --features=*ALL*` computes.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
``vs_baseline`` compares against the REFERENCE BINARY: the PolusAI/nyxus CLI
built from /root/reference (-DNOEXTRAS=ON Release) and measured on the same
slide content on this host's multicore CPU — see BASELINE_MEASURED.json for
the protocol.  The reference number includes its tile IO + CSV write (its
normal operating mode, ~6%% of its wall time on this corpus).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

FEATURES = ["*ALL*"]


def make_dsb_like(h=1024, w=1024, n_blobs=300, seed=7):
    """Nucleus-like elliptical ROIs, DSB2018-ish density and sizes."""
    r = np.random.default_rng(seed)
    labels = np.zeros((h, w), np.int32)
    intens = (r.normal(120, 30, (h, w))).clip(1, 255)
    yy, xx = np.mgrid[0:h, 0:w]
    lab = 1
    for _ in range(n_blobs):
        cy, cx = r.uniform(12, h - 12), r.uniform(12, w - 12)
        ry, rx = r.uniform(4, 18), r.uniform(4, 18)
        ang = r.uniform(0, np.pi)
        ca, sa = np.cos(ang), np.sin(ang)
        u = (yy - cy) * ca + (xx - cx) * sa
        v = -(yy - cy) * sa + (xx - cx) * ca
        m = ((u / ry) ** 2 + (v / rx) ** 2 <= 1.0) & (labels == 0)
        if m.sum() < 12:
            continue
        base = r.uniform(400, 40000)
        intens[m] = np.clip(base + r.normal(0, base * 0.15, m.sum()), 1, 65535)
        labels[m] = lab
        lab += 1
    return np.floor(intens).astype(np.uint16), labels


def make_grid_slide(h=512, w=512, seed=3):
    """A grid of 14x17 px ROIs (~300 on 512^2) over uniform random u16
    intensities in [1, 5000) -- the mesh-parity slide."""
    r = np.random.default_rng(seed)
    lab = np.zeros((h, w), np.int32)
    k = 1
    for y in range(8, h - 24, 26):
        for x in range(8, w - 24, 30):
            lab[y:y + 14, x:x + 17] = k
            k += 1
    inten = r.integers(1, 5000, lab.shape).astype(np.uint16)
    return inten, lab


COMET_LABEL = 60000


def make_comet_slide(side=2048, seed=9):
    """A side^2 u16 pair for the streamed phase-3 path, after
    tools/bench_streamed.py: a 64-px grid of 22x26 px ROIs and one giant
    "comet" ROI (COMET_LABEL; ~1 Mpix at side 2048) drawn over them -- an
    ellipse with a tapering tail, mirror-symmetric about its middle row,
    whose centroid lies ~0.09*side left of its AABB centre.  Uniform random
    intensities in [1, 40000)."""
    r = np.random.default_rng(seed)
    intens = r.integers(1, 40000, (side, side)).astype(np.uint16)
    labels = np.zeros((side, side), np.uint16)
    k = 1
    for y in range(20, side - 40, 64):
        for x in range(20, side - 40, 64):
            labels[y:y + 22, x:x + 26] = k
            k += 1
    yy, xx = np.mgrid[0:side, 0:side]
    cy, cx, tip = side / 2, 0.37 * side, 0.97 * side
    comet = (((yy - cy) / (0.195 * side)) ** 2
             + ((xx - cx) / (0.34 * side)) ** 2) <= 1.0
    comet |= (xx >= cx) & (np.abs(yy - cy) <= 0.3 * (tip - xx))
    labels[comet] = COMET_LABEL
    return intens, labels


def make_blob_volume(seed=4, shape=(48, 56, 60)):
    """3D pair: one ellipsoidal blob (label 3) filling ~0.84 of each axis
    plus a 4^3 cube (label 1), uniform random intensities in [1, 900)."""
    r = np.random.default_rng(seed)
    D, H, W = shape
    intens = r.integers(1, 900, shape).astype(np.uint16)
    labels = np.zeros(shape, np.int32)
    zz, yy, xx = np.mgrid[0:D, 0:H, 0:W]
    blob = (((zz - D / 2) / (D * 0.42)) ** 2 + ((yy - H / 2) / (H * 0.42)) ** 2
            + ((xx - W / 2) / (W * 0.42)) ** 2) <= 1.0
    labels[blob] = 3
    labels[2:6, 2:6, 2:6] = 1     # small trivial ROI
    return intens, labels


def run_once(intens, labels, runner):
    t0 = time.perf_counter()
    labs, values = runner.run(intens, labels)
    return len(labs), time.perf_counter() - t0


def bench_platform(intens, labels, platform=None):
    """Throughput (ROIs/sec) on the default device."""
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner import PairRunner

    cfg = EngineConfig(precision="f32")
    fset = tx.parse_feature_request(FEATURES)
    runner = PairRunner(fset, cfg)
    n, _ = run_once(intens, labels, runner)          # warmup + compile
    times = []
    for _ in range(3):
        _, dt = run_once(intens, labels, runner)
        times.append(dt)
    return n, n / min(times)


def reference_baseline_rps():
    """ROIs/sec of the reference binary on this corpus.

    Reads the committed measurement (BASELINE_MEASURED.json); if the built
    reference CLI is still present on this host, it could be re-measured with
    tools/measure_reference.py (same protocol)."""
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        with open(os.path.join(here, "BASELINE_MEASURED.json")) as f:
            return float(json.load(f)["rois_per_sec"])
    except Exception:
        return None


def write_corpus(n_slides=8, corpus=None, fmt="zarr"):
    """N DISTINCT bench slides (seeds 7..7+N-1) as int/seg pairs under
    ``corpus`` (a new temporary directory by default): OME-Zarr with
    512x512 blosc-lz4 chunks, or with ``fmt="tiff"`` 512x512-tiled LZW
    TIFF (what the reference binary reads; needs libtiff).  Returns
    (corpus_dir, total_rois)."""
    import tempfile

    if fmt == "zarr":
        from nyxus_tpu.io.zarr import write_zarr

        def write(path, arr):
            write_zarr(path + ".ome.zarr", arr, chunks=(1, 1, 1, 512, 512))
    else:
        from nyxus_tpu import native

        def write(path, arr):
            native.write_tiff(path + ".ome.tif", arr, tile_size=512)

    if corpus is None:
        corpus = tempfile.mkdtemp(prefix="nyxus_bench_corpus_")
    total = 0
    for d in ("int", "seg"):
        os.makedirs(os.path.join(corpus, d), exist_ok=True)
    for i in range(1, n_slides + 1):
        si, sl = make_dsb_like(seed=6 + i)
        total += int(sl.max())
        write(os.path.join(corpus, "int", "slide%d" % i),
              si.astype(np.uint16))
        write(os.path.join(corpus, "seg", "slide%d" % i),
              sl.astype(np.uint16))
    return corpus, total


def bench_file_based(n_slides=8):
    """End-to-end file protocol on the slides of BASELINE_MEASURED.json's
    reference run (which read them as tiled-LZW TIFF): N DISTINCT OME-Zarr
    int/seg pairs -> `*ALL*` -> one CSV, via the CLI entry point (includes
    dataset scan, chunk decode, compute, CSV write).  Returns (rois,
    wall_seconds, mpix)."""
    import shutil
    import tempfile

    from nyxus_tpu import cli

    corpus, _ = write_corpus(n_slides)

    outdir = tempfile.mkdtemp(prefix="nyxus_bench_out_")
    argv = ["--features=*ALL*", "--intDir=%s/int" % corpus,
            "--segDir=%s/seg" % corpus, "--outDir=" + outdir,
            "--outputType=singlecsv"]
    t0 = time.perf_counter()
    cli.main(argv)
    wall = time.perf_counter() - t0
    with open(os.path.join(outdir, "NyxusFeatures.csv")) as f:
        rois = sum(1 for _ in f) - 1
    shutil.rmtree(outdir, ignore_errors=True)
    shutil.rmtree(corpus, ignore_errors=True)
    mpix = n_slides * 1024 * 1024 / 1e6
    return rois, wall, mpix


def warm_signatures(n_slides=8):
    """One untimed in-memory pass over every corpus slide: compiles or
    loads each bucket-shape executable once (fixed-cap batch quantization
    makes the signature set one per shape).  The timed runs then measure
    steady-state throughput; time to first row is tools/measure_compile.py's
    subject."""
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner import PairRunner

    runner = PairRunner(tx.parse_feature_request(FEATURES),
                        EngineConfig(precision="f32"))
    for i in range(1, n_slides + 1):
        runner.run(*make_dsb_like(seed=6 + i))


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit("bench.py needs a GPU; JAX's first device is %s"
                 % dev.platform)
    intens, labels = make_dsb_like()

    warm_signatures()

    n, mem_rps = bench_platform(intens, labels)

    # end-to-end file-based run (the apples-to-apples headline: the
    # reference baseline includes its tile IO + prescan + CSV write)
    rois, wall, mpix = bench_file_based()
    file_rps = rois / wall

    baseline_rps = reference_baseline_rps()
    vs = (file_rps / baseline_rps) if baseline_rps else 1.0
    print(json.dumps({
        "metric": "rois_per_sec_ALL_file",
        "value": round(file_rps, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "unit": ("ROIs/sec, *ALL* 747 cols, END-TO-END file protocol (8 "
                 "DISTINCT 1024x1024 OME-Zarr pairs, seeds 7-14 -> "
                 "singlecsv); vs_baseline = "
                 "vs reference nyxus CLI multicore CPU "
                 "(BASELINE_MEASURED.json, %s ROIs/sec). In-memory path: "
                 "%.1f ROIs/sec. File run: %d ROIs / %.2f s, %.2f Mpix/s"
                 % (baseline_rps, mem_rps, rois, wall, mpix / wall)),
        "vs_baseline": round(vs, 3),
    }))


if __name__ == "__main__":
    main()
