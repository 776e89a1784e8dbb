#!/usr/bin/env python3
"""End-to-end smoke run on NVIDIA GPUs: the quickest proof that the system
starts on the card and still computes the right numbers there.

Phases (one card, ``python chip_smoke.py``):

  a. 2D ``*ALL*`` through PairRunner on the reference-parity slide: f64 vs
     the reference binary's CSV, f32 vs that f64 run.
  b. 3D ``*3D_ALL*`` through VolumeRunner on the 48x56x60 fixture volume:
     f64 vs the reference binary's CSV, f32 vs that f64 run.
  c. ImageQuality ``*ALL_IMQ*`` on a 1024^2 frame, per ROI and as a whole
     frame.  In-memory IMQ is host numpy at f64 whatever the precision; the
     streamed path (ram_limit) runs its power spectrum on the card, as a
     c64 FFT at f32 and a c128 FFT at f64.  Checks: streamed f32 and
     streamed f64 vs in-memory f64.
  d. The CLI, ``--features=*ALL* --outputType=singlecsv``, over eight
     distinct 1024^2 OME-Zarr slide pairs (~2,400 ROIs x 747 columns): row
     count and header, finite values, and slide 1's rows vs
     ``Nyxus(precision="f64").featurize_files`` on that slide's pair.
  e. bench.make_comet_slide: ~800 small ROIs and one ~1 Mpix ROI whose
     centroid lies ~180 px from its AABB centre, as one OME-Zarr pair
     streamed under a RAM limit that sends the giant through phase 3, vs
     the same pair untiled, ``*ALL*`` at f64.

The f32 runs (a-d) and then the f64 runs (a-e) each run concurrently on
threads, so their programs compile in parallel; their times overlap.

``python chip_smoke.py --four-cards`` runs only phase f: ``*ALL*`` at f64
with the ROI batch sharded over a 4-card mesh vs one card (rtol 1e-9).

The f32 runs come first with JAX's 64-bit mode off, as the CLI runs;
64-bit mode is switched on once for the f64 runs that follow.  Tiers live
in nyxus_tpu/parity.py.  Wall and first-row times are printed beside the
card's name and power limit; they are informational, not a benchmark.

Exits non-zero and prints no result when JAX's first device is not a GPU,
the native library is unavailable, or any check fails.  The last line of a
passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
REF_2D = os.path.join(ROOT, "tests", "data", "ref_all_320x320_seed11.csv.gz")
REF_3D = os.path.join(ROOT, "tests", "data", "ref_3d_48x56x60_seed4.csv.gz")

# sizes of the phases
CORPUS_SLIDES = 8          # phase d: 1024^2 slides (bench.make_dsb_like)
IMQ_SIDE = 1024            # phase c frame side
GIANT_SIDE = 2048          # phase e slide side (comet of ~1 Mpix)
GIANT_RAM_LIMIT_MB = 16    # streams the slide and makes the giant oversized


def card_lines():
    """``nvidia-smi``'s name and power limit, one line per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


class Report:
    """Collects each check's outcome and each run's times."""

    def __init__(self, card):
        self.card = card
        self.failed = []

    def timing(self, name, wall, first_row):
        print("time  %-28s wall %.3f s, first row %.3f s  [%s]"
              % (name, wall, first_row, self.card), flush=True)

    def check(self, name, res, min_checked=1, extra=""):
        """``res``: a parity.Comparison."""
        ok = res.ok and res.checked >= min_checked
        if res.worst is None:
            worst = "none"
        else:
            c, err, tol = res.worst
            worst = "%s err %.3g (tol %.3g)" % (c, err, tol)
        print("check %-28s %s  %d columns, worst %s%s"
              % (name, "ok" if ok else "FAIL", res.checked, worst, extra),
              flush=True)
        if not ok:
            self.failed.append(name)
            for c, err, tol in res.failures[:20]:
                print("      %s err %.3g > tol %.3g" % (c, err, tol))
            if res.checked < min_checked:
                print("      only %d columns compared, want >= %d"
                      % (res.checked, min_checked))

    def require(self, name, cond, detail):
        print("check %-28s %s  %s" % (name, "ok" if cond else "FAIL",
                                      detail), flush=True)
        if not cond:
            self.failed.append(name)


def timed(fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0


def _frame(labs, values, header):
    import pandas as pd
    df = pd.DataFrame(values, columns=header[4:])
    df["ROI_label"] = labs
    return df.set_index("ROI_label")


def _reference(path):
    import pandas as pd
    ref = pd.read_csv(gzip.open(path, "rt"))
    return ref.sort_values("ROI_label").set_index("ROI_label")


# -- phase a: 2D reference slide ----------------------------------------------

def run_2d(precision):
    import bench
    from nyxus_tpu import columns as col
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner import PairRunner

    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    cfg = EngineConfig(precision=precision)
    fset = tx.parse_feature_request(["*ALL*"])
    labs, values = PairRunner(fset, cfg).run(intens, labels)
    return _frame(labs, values, col.build_header(fset, cfg)[0])


def compare_2d_reference(ours):
    """Phase a's check: the f64 2D table vs the reference binary's CSV."""
    from nyxus_tpu import parity
    return parity.compare_reference(ours, _reference(REF_2D))


# -- phase b: 3D reference volume ---------------------------------------------

def run_3d(precision):
    import bench
    from nyxus_tpu import columns as col
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    intens, labels = bench.make_blob_volume(seed=4, shape=(48, 56, 60))
    intens = (intens % 59 + 1).astype(np.uint16)
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    cfg = EngineConfig(precision=precision)
    labs, values = VolumeRunner(fset, cfg).run(intens,
                                               labels.astype(np.int32))
    return _frame(labs, values, col.build_header(fset, cfg)[0])


def compare_3d_reference(ours):
    from nyxus_tpu import parity
    return parity.compare_reference(ours, _reference(REF_3D),
                                    denom_floor=1e-6)


# -- phase c: image quality ---------------------------------------------------

IMQ_COLS = ("FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "POWER_SPECTRUM_SLOPE",
            "MIN_SATURATION", "MAX_SATURATION", "SHARPNESS")


def imq_frame():
    r = np.random.default_rng(21)
    n = IMQ_SIDE
    img = r.integers(0, 4000, (n, n)).astype(np.uint16)
    lab = np.zeros(img.shape, np.int32)
    lab[n // 24:n // 2, n // 16:n // 2] = 1
    lab[n // 2 + 8:n - 8, n // 5:n - 10] = 2
    return img, lab


def run_imq(precision, ram_limit=None):
    """(per-ROI table, whole-frame table) indexed by ROI label;
    ``ram_limit`` (MB) small enough streams both."""
    from nyxus_tpu import ImageQuality
    img, lab = imq_frame()
    nyx = ImageQuality(precision=precision, ram_limit=ram_limit)
    rois = nyx.featurize(img, lab).set_index("ROI_label")
    whole = nyx.featurize(img).set_index("ROI_label")
    return rois, whole


# -- phase d: CLI over the OME-Zarr corpus ------------------------------------

def run_cli(corpus, outdir):
    """The CLI's singlecsv run; returns (table, wall s, first-row s) where
    first row is when the output CSV first holds data."""
    import pandas as pd
    from nyxus_tpu import cli

    out = os.path.join(outdir, "NyxusFeatures.csv")
    argv = ["--features=*ALL*", "--intDir=%s" % os.path.join(corpus, "int"),
            "--segDir=%s" % os.path.join(corpus, "seg"),
            "--outDir=" + outdir, "--outputType=singlecsv"]
    first = []
    done = threading.Event()
    t0 = time.perf_counter()

    def watch():
        while not done.is_set():
            if os.path.exists(out) and os.path.getsize(out) > 0:
                first.append(time.perf_counter() - t0)
                return
            time.sleep(0.005)

    watcher = threading.Thread(target=watch, daemon=True)
    watcher.start()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    done.set()
    watcher.join(timeout=10)
    if rc != 0:
        raise RuntimeError("CLI exited with %r" % rc)
    return pd.read_csv(out), wall, first[0] if first else wall


def cli_header():
    from nyxus_tpu import columns as col
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    return col.build_header(tx.parse_feature_request(["*ALL*"]),
                            EngineConfig())[0]


def slide_rows(df, name):
    rows = df[df.intensity_image.map(os.path.basename) == name]
    return rows.set_index("ROI_label")[cli_header()[4:]]


def run_slide_api(corpus, name, precision):
    """One slide pair of the corpus through ``Nyxus.featurize_files``."""
    from nyxus_tpu import Nyxus
    return Nyxus(["*ALL*"], precision=precision).featurize_files(
        [os.path.join(corpus, "int", name)], [os.path.join(corpus, "seg", name)])


# -- phase e: one giant streamed ROI ------------------------------------------

def write_pair(d, intens, labels):
    from nyxus_tpu.io.zarr import write_zarr
    ip, lp = os.path.join(d, "i.ome.zarr"), os.path.join(d, "s.ome.zarr")
    write_zarr(ip, intens, chunks=(1, 1, 1, 512, 512))
    write_zarr(lp, labels, chunks=(1, 1, 1, 512, 512))
    return ip, lp


def check_giant(rep, labels, st, mem):
    """Phase e's checks: the streamed run (``st``) vs the untiled one
    (``mem``) on the comet slide ``labels``."""
    import bench
    from nyxus_tpu import parity
    giant = bench.COMET_LABEL
    ys, xs = np.nonzero(labels == giant)
    off = xs.mean() - (xs.min() + xs.max()) / 2.0
    n_rois = len(np.unique(labels[labels > 0]))
    rep.require("e rows", list(st.ROI_label) == list(mem.ROI_label)
                and len(st) == n_rois,
                "%d ROIs: %d small + one of %d px, centroid %.1f px from "
                "its AABB centre" % (len(st), n_rois - 1, len(ys), off))
    res, unserved = parity.compare_streamed_roi(mem, st, giant)
    rep.require("e every column served", not unserved,
                "unserved: %r" % unserved[:10])
    rep.check("e giant streamed vs untiled", res, min_checked=640)
    small_st = st[st.ROI_label != giant].set_index("ROI_label")
    small_mem = mem[mem.ROI_label != giant].set_index("ROI_label")
    feats = list(mem.columns[4:])
    rep.check("e small ROIs streamed vs untiled",
              parity.compare_allclose(small_st, small_mem, feats,
                                      rtol=1e-9, atol=1e-12),
              min_checked=700, extra="  (%d ROIs)" % len(small_st))


# -- phase f: four cards ------------------------------------------------------

def four_cards(rep):
    import jax
    import bench
    from nyxus_tpu import Nyxus, parity

    jax.config.update("jax_enable_x64", True)
    devs = jax.devices()[:4]
    inten, lab = bench.make_grid_slide()
    d1, t1 = timed(Nyxus(["*ALL*"], precision="f64").featurize, inten, lab)
    rep.timing("f *ALL* f64 1 card", t1, t1)
    nyx4 = Nyxus(["*ALL*"], precision="f64", n_devices=4)
    d4, t4 = timed(nyx4.featurize, inten, lab)
    rep.timing("f *ALL* f64 4 cards", t4, t4)
    feats = list(d1.columns[4:])
    res = parity.compare_allclose(d4.set_index("ROI_label")[feats],
                                  d1.set_index("ROI_label")[feats],
                                  feats, rtol=1e-9, atol=1e-12)
    rep.check("f 4 cards vs 1 (f64)", res, min_checked=600,
              extra="  (%d ROIs)" % len(d1))
    for c, raw in parity.ZERO_BY_CONSTRUCTION.items():
        print("      %s: max |4 cards - 1| %.3g; max |%s| %.3g"
              % (c, np.abs(d4[c] - d1[c]).max(), raw, np.abs(d1[raw]).max()))
    mesh_ids = sorted(d.id for d in nyx4._runner.mesh.devices.flat)
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devs]
    rep.require("f one shard per card",
                mesh_ids == sorted(d.id for d in devs) and min(peaks) > 0,
                "mesh devices %s, peak bytes per card %s" % (mesh_ids, peaks))


# -- phases a-e ---------------------------------------------------------------

def run_stage(jobs):
    """Run (name, fn, *args) jobs on one thread each and return
    {name: (result, wall s)}; any job's exception is raised here.  The
    jobs' programs trace in turn (the GIL) but compile concurrently."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = [(job[0], ex.submit(timed, *job[1:])) for job in jobs]
        return {name: fut.result() for name, fut in futs}


def one_card(rep, work):
    import jax
    import bench
    from nyxus_tpu import Nyxus, parity

    corpus, n_rois = bench.write_corpus(CORPUS_SLIDES,
                                        os.path.join(work, "corpus"))
    giant = bench.make_comet_slide(GIANT_SIDE)
    gdir = os.path.join(work, "giant")
    os.makedirs(gdir)
    gpaths = write_pair(gdir, *giant)

    # f32 runs, 64-bit mode off
    r = run_stage([
        ("a 2D *ALL* f32", run_2d, "f32"),
        ("b 3D *3D_ALL* f32", run_3d, "f32"),
        ("c IMQ f32 streamed", run_imq, "f32", 1),
        ("d CLI *ALL* f32 (%d slides)" % CORPUS_SLIDES, run_cli, corpus,
         os.path.join(work, "out32"))])
    for name, (res, t) in r.items():
        first = res[2] if name.startswith("d ") else t
        rep.timing(name, t, first)
    (a32, _), (b32, _), (c32s, _), ((d32, _, _), _) = r.values()
    feats = cli_header()
    rep.require("d rows", len(d32) == n_rois,
                "%d rows for %d labels discovered" % (len(d32), n_rois))
    rep.require("d header", list(d32.columns) == feats,
                "%d columns (build_header: %d)" % (len(d32.columns),
                                                   len(feats)))
    finite = bool(np.isfinite(d32[feats[4:]].to_numpy(float)).all())
    rep.require("d finite", finite, "all %d x %d values finite"
                % (len(d32), len(feats) - 4))

    # f64 runs
    jax.config.update("jax_enable_x64", True)
    r = run_stage([
        ("a 2D *ALL* f64", run_2d, "f64"),
        ("b 3D *3D_ALL* f64", run_3d, "f64"),
        ("c IMQ f64 in memory (host)", run_imq, "f64"),
        ("c IMQ f64 streamed", run_imq, "f64", 1),
        ("d API *ALL* f64 (slide 1)", run_slide_api, corpus,
         "slide1.ome.zarr", "f64"),
        ("e streamed comet slide f64",
         Nyxus(["*ALL*"], ram_limit=GIANT_RAM_LIMIT_MB,
               precision="f64").featurize_files, [gpaths[0]], [gpaths[1]]),
        ("e untiled f64", Nyxus(["*ALL*"], precision="f64").featurize,
         *giant)])
    for name, (_, t) in r.items():
        rep.timing(name, t, t)
    ((a64, _), (b64, _), (c64, _), (c64s, _), (d64, _), (st, _),
     (mem, _)) = r.values()

    rep.check("a f64 vs reference binary", compare_2d_reference(a64),
              min_checked=600)
    rep.check("a f32 vs f64", parity.compare_f32(a32, a64), min_checked=600)
    rep.check("b f64 vs reference binary", compare_3d_reference(b64),
              min_checked=200)
    rep.check("b f32 vs f64", parity.compare_f32(b32, b64), min_checked=150)
    # the in-memory side is host numpy; the streamed side's spectrum is the
    # card's FFT (c64 at f32, c128 at f64)
    for i, part in enumerate(("rois", "whole frame")):
        rep.check("c f32 streamed vs f64 (%s)" % part,
                  parity.compare_allclose(c32s[i], c64[i], IMQ_COLS,
                                          rtol=parity.F32_TOL, atol=1e-6))
        rep.check("c f64 streamed vs f64 (%s)" % part,
                  parity.compare_allclose(c64s[i], c64[i], IMQ_COLS,
                                          rtol=parity.IMQ_STREAMED_RTOL))
    rep.check("d slide 1 CLI f32 vs API f64",
              parity.compare_f32(slide_rows(d32, "slide1.ome.zarr"),
                                 slide_rows(d64, "slide1.ome.zarr")),
              min_checked=600)
    check_giant(rep, giant[1], st, mem)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh phase (f)")
    args = ap.parse_args(argv)
    need = 4 if args.four_cards else 1

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit("chip_smoke: needs a GPU; JAX's first device is %s"
                 % devs[0].platform)
    if len(devs) < need:
        sys.exit("chip_smoke: needs %d GPUs, JAX sees %d" % (need, len(devs)))
    cards = card_lines()

    from nyxus_tpu import native
    if not native.available():
        sys.exit("chip_smoke: native library unavailable: %r"
                 % native._build_err)

    rep = Report(cards[0])
    if args.four_cards:
        four_cards(rep)
    else:
        work = tempfile.mkdtemp(prefix="nyxus_chip_smoke_")
        try:
            one_card(rep, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if rep.failed:
        sys.exit("chip_smoke: FAILED %s" % ", ".join(rep.failed))
    for line in cards:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
