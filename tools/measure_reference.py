#!/usr/bin/env python3
"""Measure the reference nyxus CLI on the bench corpus -> BASELINE_MEASURED.json.

Protocol (VERDICT r1 'missing #1'):
  1. build the reference CLI:
       cmake -DNOEXTRAS=ON -DBUILD_CLI=ON -DBUILD_LIB=OFF \
             -DCMAKE_BUILD_TYPE=Release -GNinja /root/reference && ninja nyxus
  2. write N copies of bench.make_dsb_like() as tiled LZW TIFF int/seg pairs
  3. time `nyxus --features=*ALL* --outputType=singlecsv --reduceThreads=<cores>`
  4. record ROIs/sec + Mpix/sec here.

Usage: python tools/measure_reference.py [path-to-nyxus-binary] [n_slides]
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    binary = sys.argv[1] if len(sys.argv) > 1 else "/tmp/refbuild/nyxus"
    n_slides = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    if not os.path.exists(binary):
        sys.exit("reference binary not found at %s (build it first)" % binary)

    import bench

    # the distinct-seed slides bench.py measures (seeds 7..N+6), as the
    # tiled-LZW TIFF pairs the reference binary reads
    corpus, total_rois = bench.write_corpus(n_slides, fmt="tiff")

    outdir = "/tmp/refout_measure"
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    ncores = os.cpu_count()
    t0 = time.perf_counter()
    subprocess.run([binary, "--features=*ALL*", "--intDir=%s/int" % corpus,
                    "--segDir=%s/seg" % corpus, "--outDir=" + outdir,
                    "--outputType=singlecsv",
                    "--reduceThreads=%d" % ncores],
                   check=True, capture_output=True)
    wall = time.perf_counter() - t0
    mpix = 1024 * 1024 * n_slides / 1e6
    rec = {
        "what": ("Self-measured reference (PolusAI/nyxus) CLI throughput — "
                 "the real baseline bench.py compares against (VERDICT r1 "
                 "'missing #1')."),
        "binary": ("reference CLI built from /root/reference with cmake "
                   "-DNOEXTRAS=ON -DBUILD_CLI=ON -DCMAKE_BUILD_TYPE=Release"),
        "host": "%d-core x86-64 (same host that runs bench.py)" % ncores,
        "workload": ("%d DISTINCT bench slides (1024x1024 uint16, ~300 "
                     "nucleus-scale ROIs each, bench.make_dsb_like seeds "
                     "7..%d) as tiled LZW TIFF pairs; nyxus "
                     "--features=*ALL* --outputType=singlecsv "
                     "--reduceThreads=%d"
                     % (n_slides, n_slides + 6, ncores)),
        "wall_seconds": round(wall, 3),
        "rois": total_rois,
        "rois_per_sec": round(total_rois / wall, 1),
        "mpix_per_sec": round(mpix / wall, 3),
        "columns": 747,
        "notes": ("Includes the reference's prescan + tile IO + CSV write "
                  "(its normal operating mode)."),
        "date": time.strftime("%Y-%m-%d"),
    }
    with open(os.path.join(HERE, "BASELINE_MEASURED.json"), "w") as f:
        json.dump(rec, f, indent=2)
        f.write("\n")
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
