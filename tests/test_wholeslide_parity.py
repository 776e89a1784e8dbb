"""Whole-slide mode parity against the reference BINARY (VERDICT r1 weak
#10): int_dir == seg_dir turns the slide into one virtual ROI.

tests/data/ref_wholeslide_320x320_seed11.csv.gz is the reference CLI's
`*ALL*` output with --segDir == --intDir on the parity slide.  Pinned
whole-slide semantics (verified against the binary):

* the virtual ROI's AABB is INCLUSIVE 0..W, 0..H (init_from_wh,
  aabb.h:53-59): a (W+1)x(H+1) matrix whose last row/column stay empty --
  BBOX_WIDTH/HEIGHT = W+1/H+1, EXTENT < 1, erosion vanishes from the open
  margin, texture matrices carry the empty background column;
* the contour is SYNTHESIZED: the 4 AABB corners at the slide max intensity
  (buildWholeSlideContour, contour.cpp:917-933), with no +1 coordinate
  shift -- PERIMETER = 4W, EDGE_* collapse to corner statistics, the hull
  is the corner square.

EXCLUDED columns (reference-side artifacts, all verified in its output):
* EXTREMA_P3_Y/EXTREMA_P6_X print the uninitialized -1;
* POLYGONALITY/HEXAGONALITY and the three circle diameters stay at the
  fvals default 0 (the WSI workflow returns before the neighbor pass,
  workflow_2d_whole.cpp:84-86, and circles never run);
* GLSZM_SAE/LAE emit 0 / negative garbage (zone scan overflow on the
  virtual ROI);
* weighted moments (WEIGHTED_*/WT_NORM_*) disagree through the reference's
  corner-distance weighting pipeline; first central moments 23/33 are FP
  residue of near-zero values.
"""

import gzip
import os
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402

# full fixture sweeps: heavy; the quick per-commit tier deselects these
import pytest as _pt
pytestmark = _pt.mark.nightly

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "ref_wholeslide_320x320_seed11.csv.gz")

EXCLUDE_PREFIXES = ("WEIGHTED_", "WT_NORM_", "IMOM_W")
EXCLUDE_EXACT = {
    "EXTREMA_P3_Y", "EXTREMA_P6_X",
    "POLYGONALITY_AVE", "HEXAGONALITY_AVE", "HEXAGONALITY_STDDEV",
    "DIAMETER_MIN_ENCLOSING_CIRCLE", "DIAMETER_CIRCUMSCRIBING_CIRCLE",
    "DIAMETER_INSCRIBING_CIRCLE",
    "GLSZM_SAE", "GLSZM_LAE",
    "CENTRAL_MOMENT_23", "CENTRAL_MOMENT_33",
    "IMOM_CM_01", "IMOM_CM_10",     # zero by construction: FP residue
}
TOL = 2e-4


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    from nyxus_tpu import Nyxus, native
    if not native.tiff_available():
        pytest.skip("native toolchain unavailable")
    base = tmp_path_factory.mktemp("ws")
    intens, _ = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    native.write_tiff(str(base / "slide.ome.tif"),
                      intens.astype(np.uint16), tile_size=0)
    ref = pd.read_csv(gzip.open(FIXTURE, "rt"))
    ours = Nyxus(["*ALL*"], precision="f64").featurize_directory(
        str(base), str(base))
    return ref, ours


def test_wholeslide_single_roi(frames):
    ref, ours = frames
    assert len(ours) == 1 and int(ours.ROI_label.iloc[0]) == 1


def test_wholeslide_column_values(frames):
    ref, ours = frames
    checked = 0
    failures = []
    for c in ours.columns[4:]:
        if c not in ref.columns:
            continue
        if c.startswith(EXCLUDE_PREFIXES) or c in EXCLUDE_EXACT:
            continue
        a = float(ours[c].iloc[0])
        b = float(ref[c].iloc[0])
        if not (np.isfinite(a) and np.isfinite(b)):
            continue
        checked += 1
        rel = abs(a - b) / max(abs(b), 1e-8)
        if rel > TOL:
            failures.append((c, a, b))
    assert checked > 550, "exclusion list swallowed the test"
    assert not failures, ("whole-slide columns beyond tolerance vs the "
                          "reference binary: %r" % failures[:25])


def test_wholeslide_quirks_explicit(frames):
    """The load-bearing whole-slide quirks."""
    ref, ours = frames
    row = ours.iloc[0]
    assert row.BBOX_WIDTH == 321 and row.BBOX_HEIGHT == 321
    assert row.PERIMETER == pytest.approx(4 * 320)
    # 4-corner contour at the slide max
    assert row.EDGE_MIN_INTENSITY == row.EDGE_MAX_INTENSITY == row["MAX"]
    assert row.EDGE_INTEGRATED_INTENSITY == pytest.approx(4 * row["MAX"])
    assert row.EXTENT == pytest.approx(320 * 320 / 321.0 / 321.0, rel=1e-9)
