"""Parity tiers: how closely the engine's output must match a reference.

Shared by the test suite and ``chip_smoke.py`` so that a CPU run and a run on
the GPU are held to the same numbers.  The table comparisons take per-ROI
feature tables (pandas DataFrames indexed by ROI label) and judge each column
by the 90th percentile over ROIs of the relative error.

* Reference parity: the engine at ``precision="f64"`` against the reference
  binary's own CSV output (``tests/data/ref_*.csv.gz``).  Every column must
  hold ``REF_TOL``; ``LOOSE`` lists the documented exceptions, and the first
  central moments (zero by construction) are bounded by absolute size.
* Streamed parity: one oversized ROI through the streamed phase-3 path
  against the same ROI through the dense in-memory kernels, both at f64
  (``compare_streamed_roi``).
* Elementwise parity (``compare_allclose``): numpy ``allclose`` semantics
  per column, for the few-column image-quality tables and for runs that
  must agree to rounding (one device vs a mesh).
* f32 parity: the production ``precision="f32"`` engine against an f64 run of
  the same engine on the same device.  The default tier is ``F32_TOL``;
  ``F32_PREFIX_TOL`` loosens families whose arithmetic amplifies f32
  rounding, each with its reason; ``DISCRETE`` members are exempt.  Every
  float32 matmul, einsum and convolution in the engine runs at
  ``jax.lax.Precision.HIGHEST`` (full f32 products, no TF32 on GPUs), which
  is the precision these tiers were set at.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

# -- reference parity ---------------------------------------------------------

REF_TOL = 1e-4

# first central moments are ~0 by construction on both sides: pure FP
# residue of the raw first moment they cancel (the value), so no error
# relative to themselves applies.  Against the reference binary's CSV they
# are bounded by absolute size (ZERO_ABS_TOL); between two runs of this
# engine (compare_allclose), relative to that raw moment.
ZERO_BY_CONSTRUCTION = {"CENTRAL_MOMENT_01": "SPAT_MOMENT_01",
                        "CENTRAL_MOMENT_10": "SPAT_MOMENT_10",
                        "IMOM_CM_01": "IMOM_RM_01",
                        "IMOM_CM_10": "IMOM_RM_10"}
ZERO_ABS_TOL = 1e-3

# Known remaining divergences (documented, tracked)
LOOSE = {
    # The reference's IMEA-inspired enclosing-circle scan (circle.cpp:145-216)
    # accepts circles from near-singular point triples (|det| just above its
    # 1e-4 epsilon in float32), inflating the diameter far beyond the point
    # set on ~1/3 of ROIs (e.g. a 48px circle for a 12px blob).  Which ROIs
    # inflate depends on its exact contour traversal order, which we could
    # not reproduce from outside the binary.  Our port implements the same
    # algorithm and agrees on the ROIs where the reference's scan stays
    # regular.
    "DIAMETER_MIN_ENCLOSING_CIRCLE": 5.0,
}

# -- f32 parity ---------------------------------------------------------------

F32_TOL = 2e-3
F32_PREFIX_TOL = {
    # raw/central moments reach x^3*y^3 * I over 1e4-pixel ROIs: ~1e8-1e19
    # magnitudes; f32 keeps ~7 digits
    "IMOM": 5e-2, "SPAT_": 5e-2, "CENTRAL_": 5e-2, "NORM_": 5e-2,
    "HU_": 5e-1, "WEIGHTED_": 5e-2, "SMOM": 5e-2,
    # weighted (contour-log-distance) moments share the cancellation class
    # of NORM_/CENTRAL_; the log weight is computed in f32 on device from
    # the shipped integer d2, a ~1-ulp difference vs the f64 host log
    "WT_": 5e-2,
    # Hu invariants are alternating sums of near-cancelling terms
    "GLCM_CLUPROM": 2e-2, "GLCM_CLUSHADE": 2e-1,
    # fast_log2 entropy chains
    "GLCM_": 5e-3, "GLRLM_": 5e-3, "GLSZM_": 5e-3, "GLDZM_": 5e-3,
    "GLDM_": 5e-3, "NGLDM_": 5e-3, "NGTDM_": 2e-2,
    # 3D texture columns are prefixed '3' (featureset.cpp:676)
    "3GLCM_": 5e-3, "3GLRLM_": 5e-3, "3GLSZM_": 5e-3, "3GLDZM_": 5e-3,
    "3GLDM_": 5e-3, "3NGLDM_": 5e-3, "3NGTDM_": 2e-2,
    "GABOR": 5e-2,          # conv accumulation + threshold counting
    "ZERNIKE2D": 2e-2,
    "FRAC_AT_D": 2e-2, "MEAN_FRAC": 2e-2, "RADIAL_CV": 5e-2,
    "STDDEV": 5e-3, "SKEWNESS": 2e-2, "KURTOSIS": 2e-2,
    "EXCESS_KURTOSIS": 2e-2, "HYPER": 5e-2,
    "COV": 5e-3, "ENERGY": 5e-3, "VARIANCE": 5e-3,
    "EROSIONS": 1.01,       # integer step count may differ by 1
}
# f32 quantile/bin-edge flips move one pixel between bins; these members are
# discrete statistics of small counts (any column containing one is exempt)
DISCRETE = ("MODE", "MEDIAN", "P01", "P10", "P25", "P75", "P90", "P99",
            "EULER", "NUM_", "MIN", "MAX", "RANGE", "MAXCHORDS",
            "ALLCHORDS")
# denominator floor of the f32 relative error
F32_DENOM_FLOOR = 1e-4


def f32_tol(col: str) -> float:
    """The f32 tier of a column: the longest matching prefix wins."""
    best, best_len = F32_TOL, 0
    for pref, t in F32_PREFIX_TOL.items():
        if col.startswith(pref) and len(pref) > best_len:
            best, best_len = t, len(pref)
    return best


class Comparison(NamedTuple):
    """Outcome of one table comparison.  ``failures`` and ``worst`` hold
    (column, error, tolerance); ``worst`` is the column with the largest
    error-to-tolerance ratio (None when nothing was comparable)."""
    checked: int
    failures: list
    worst: tuple | None

    @property
    def ok(self) -> bool:
        return not self.failures


def _p90_rel(a, b, floor):
    """p90 over ROIs of |a-b| / max(|b|, floor) where both are finite, or
    None when no ROI has both values finite."""
    both = np.isfinite(a) & np.isfinite(b)
    if not both.any():
        return None
    rel = np.abs(a[both] - b[both]) / np.maximum(np.abs(b[both]), floor)
    return float(np.quantile(rel, 0.9))


def _judge(rows):
    """rows: (column, error, tolerance) per checked column."""
    failures = [r for r in rows if r[1] > r[2]]
    worst = max(rows, key=lambda r: r[1] / r[2]) if rows else None
    return Comparison(len(rows), failures, worst)


def _check_rows(ours, ref):
    if list(ours.index) != list(ref.index):
        raise AssertionError("ROI labels differ: %d vs %d rows"
                             % (len(ours.index), len(ref.index)))


def compare_reference(ours, ref, denom_floor: float = 1e-8,
                      skip_prefixes=()) -> Comparison:
    """Engine output (f64) vs the reference binary's table, per column
    common to both: p90 relative error <= ``LOOSE.get(col, REF_TOL)``."""
    _check_rows(ours, ref)
    rows = []
    for c in ours.columns:
        if c not in ref.columns or c.startswith(tuple(skip_prefixes)):
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        if c in ZERO_BY_CONSTRUCTION:
            both = np.isfinite(a) & np.isfinite(b)
            if both.any():
                rows.append((c, float(np.abs(a[both]).max()), ZERO_ABS_TOL))
            continue
        err = _p90_rel(a, b, denom_floor)
        if err is not None:
            rows.append((c, err, LOOSE.get(c, REF_TOL)))
    return _judge(rows)


def compare_f32(dev, ref) -> Comparison:
    """f32 engine output vs an f64 run of the same engine on the same
    device, per column at ``f32_tol``; DISCRETE and ZERO_BY_CONSTRUCTION
    columns are exempt."""
    _check_rows(dev, ref)
    rows = []
    for c in ref.columns:
        if any(t in c for t in DISCRETE) or c in ZERO_BY_CONSTRUCTION:
            continue
        err = _p90_rel(dev[c].to_numpy(float), ref[c].to_numpy(float),
                       F32_DENOM_FLOOR)
        if err is not None:
            rows.append((c, err, f32_tol(c)))
    return _judge(rows)


# -- elementwise parity --------------------------------------------------------

# image quality, one frame streamed (block-row accumulation, one device FFT)
# vs the same frame in memory, both at f64; columns not listed: 1e-9
IMQ_STREAMED_RTOL = {"SHARPNESS": 1e-6, "POWER_SPECTRUM_SLOPE": 1e-6}


def compare_allclose(dev, ref, columns, rtol, atol: float = 0.0) -> Comparison:
    """Per column, every row must satisfy |a-b| <= atol + rtol*|b| (NaN
    matches NaN).  ``rtol`` is a float or a {column: rtol} map whose
    missing columns take 1e-9.  Error = max over rows of
    (|a-b| - atol) / |b|, judged against the column's rtol.
    ZERO_BY_CONSTRUCTION columns hold FP residue on both sides: their |b|
    is replaced by |ref| of the raw first moment each maps to, which
    ``ref`` must hold."""
    _check_rows(dev, ref)
    rows = []
    for c in columns:
        a = dev[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        tol = rtol.get(c, 1e-9) if isinstance(rtol, dict) else rtol
        same_nonfinite = ~np.isfinite(a) & (np.isnan(a) & np.isnan(b)
                                            | (a == b))
        both = np.isfinite(a) & np.isfinite(b)
        if not (both | same_nonfinite).all():
            rows.append((c, float("inf"), tol))
            continue
        scale = np.abs(b[both])
        if c in ZERO_BY_CONSTRUCTION:
            scale = np.abs(ref[ZERO_BY_CONSTRUCTION[c]].to_numpy(float)[both])
        excess = np.maximum(np.abs(a[both] - b[both]) - atol, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            err = np.where(excess > 0, excess / scale, 0.0)
        rows.append((c, float(err.max()) if err.size else 0.0, tol))
    return _judge(rows)


# -- streamed (phase-3) parity ------------------------------------------------

# moment families: high-order central moments cancel catastrophically (values
# ~1e0-1e6 riding on ~1e15-scale sums), so they are held to STREAMED_TOL_LOOSE
# plus an absolute floor scaled by the family's largest member
STREAMED_MOMENTS = ("IMOM", "SMOM", "HU_", "NORM_", "CENTRAL_", "WT_",
                    "SPAT_", "WEIGHTED_")
# texture matrices and Gabor accumulate in another order when streamed
STREAMED_TEXTURE = ("GLCM_", "GLRLM_", "GLSZM_", "GLDZM_", "GLDM_", "NGLDM_",
                    "NGTDM_", "GABOR")
STREAMED_TOL = 1e-7
STREAMED_TOL_LOOSE = 1e-5


def _is_unassigned(v: float) -> bool:
    return v == 0.0 and bool(np.signbit(v))


def compare_streamed_roi(dense, streamed, label) -> tuple:
    """Row ``label`` of a streamed run against the same row of a dense run
    (DataFrames with a ROI_label column and the same feature columns).
    Returns (Comparison, unserved): ``unserved`` lists the columns the
    streamed path left unassigned (-0.0) where the dense path assigned a
    value.  Error = |a-b| / max(|b|, 1e-6), judged against
    tol + atol / max(|b|, 1e-6)."""
    i_d = list(dense.ROI_label).index(label)
    i_s = list(streamed.ROI_label).index(label)
    feats = [c for c in dense.columns if c in streamed.columns
             and c not in ("intensity_image", "mask_image", "ROI_label",
                           "t_index")]
    famscale = {}
    for c in feats:
        for pref in STREAMED_MOMENTS:
            if c.startswith(pref):
                famscale[pref] = max(famscale.get(pref, 1.0),
                                     abs(float(dense[c].iloc[i_d])))
    rows, unserved = [], []
    for c in feats:
        a = float(streamed[c].iloc[i_s])
        b = float(dense[c].iloc[i_d])
        if _is_unassigned(a) and not _is_unassigned(b):
            unserved.append(c)
            continue
        if not (np.isfinite(a) and np.isfinite(b)):
            continue
        tol, atol = STREAMED_TOL, 1e-12
        pref = next((p for p in STREAMED_MOMENTS if c.startswith(p)), None)
        if pref is not None:
            tol, atol = STREAMED_TOL_LOOSE, 1e-8 * famscale[pref]
        elif c.startswith(STREAMED_TEXTURE):
            tol = STREAMED_TOL_LOOSE
        scale = max(abs(b), 1e-6)
        rows.append((c, abs(a - b) / scale, tol + atol / scale))
    return _judge(rows), unserved
