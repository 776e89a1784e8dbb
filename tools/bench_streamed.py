#!/usr/bin/env python3
"""Big-slide STREAMED benchmark: the machinery bench.py's 1024^2 corpus
never engages (tile-streamed discovery, region-read crops, phase-3
oversized accumulation) measured end-to-end on a 3072x3072 chunked
OME-Zarr pair that is forced through the RAM gate.

Two sections:
1. dense nuclei (2k ROIs) on the streamed source -- trivial ROIs whose
   crops come from chunk region reads;
2. one giant ROI (~2.8 Mpix) -- the streamed phase-3 path across every
   family in `*ALL*`.

Prints the times as JSON.  For scale: the reference binary on the
identical pair (--ramLimit=16 --reduceThreads=2, as tiled TIFF) did not
finish within a 2400 s timeout on a 2-core x86 host.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def make_big(h=3072, w=3072, seed=9):
    r = np.random.default_rng(seed)
    intens = r.integers(1, 40000, (h, w)).astype(np.uint16)
    labels = np.zeros((h, w), np.uint16)
    lab = 1
    for y in range(20, h - 40, 64):
        for x in range(20, w - 40, 64):
            if lab > 2000:
                break
            labels[y:y + 22, x:x + 26] = lab
            lab += 1
    # giant ROI in the free band at the bottom
    yy, xx = np.mgrid[0:h, 0:w]
    blob = (((yy - (h - 500)) / 420.0) ** 2
            + ((xx - (w // 2)) / 1200.0) ** 2) <= 1.0
    blob &= labels == 0
    labels[blob] = 60000
    return intens, labels, lab - 1


def main():
    from nyxus_tpu import Nyxus
    from nyxus_tpu.io.zarr import write_zarr

    intens, labels, n_small = make_big()
    d = tempfile.mkdtemp(prefix="nyx_streambench_")
    ip = os.path.join(d, "i.ome.zarr")
    lp = os.path.join(d, "s.ome.zarr")
    write_zarr(ip, intens, chunks=(1, 1, 1, 512, 512))
    write_zarr(lp, labels, chunks=(1, 1, 1, 512, 512))

    # ram_limit forces the streamed source AND routes the giant ROI
    # (841x2401 AABB = 32 MB footprint) through phase 3; the small ROIs
    # stay trivial under a 16 MB budget
    nyx = Nyxus(["*ALL*"], ram_limit=16)
    t0 = time.perf_counter()
    df = nyx.featurize_files([ip], [lp])
    wall = time.perf_counter() - t0
    # warm second run (first includes any uncached bucket compiles)
    t0 = time.perf_counter()
    df = nyx.featurize_files([ip], [lp])
    wall_warm = time.perf_counter() - t0

    giant = df[df.ROI_label == 60000].iloc[0]
    assert len(df) == n_small + 1, (len(df), n_small)
    assert np.isfinite(giant.MEAN) and giant.AREA_PIXELS_COUNT > 1e6
    out = {
        "slide": "3072x3072 tiled-LZW OME-TIFF, streamed (ram_limit=16MB)",
        "rois": int(len(df)),
        "giant_roi_pixels": int(giant.AREA_PIXELS_COUNT),
        "wall_s_first": round(wall, 2),
        "wall_s_warm": round(wall_warm, 2),
        "rois_per_sec_warm": round(len(df) / wall_warm, 1),
        "mpix_per_sec_warm": round(intens.size / 1e6 / wall_warm, 2),
    }
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
