"""Host-side geometry features: convex hull, calipers, chords, circles,
geodetic length, neighbors, hexagonality.

These are the reference's sequential per-ROI algorithms (quickhull, rotating
measurements, Welzl circle, cross-ROI neighbor search); they run host-side
exactly as the reference runs them on CPU threads.  References cited per
function.
"""

from __future__ import annotations

import math

import numpy as np


# ---------------------------------------------------------------------------
# batched native geometry pass: ALL contour/hull/caliper/chord/radius/radial
# host features in ONE threaded native call (native/src/geomfeats_batch.cpp).
# The per-family numpy implementations below remain as parity oracles and
# fallbacks when the native library is unavailable.

GEOM_GROUPS = {
    "ContourFeature": 1 << 0,
    "FractalDimensionFeature": 1 << 1,
    "ConvexHullFeature": 1 << 2,
    "CaliperFeretFeature": 1 << 3,
    "CaliperMartinFeature": 1 << 4,
    "CaliperNassensteinFeature": 1 << 5,
    "ChordsFeature": 1 << 6,
    "RoiRadiusFeature": 1 << 7,
    "RadialDistributionFeature": 1 << 8,
}
G_LOGW = 1 << 9
G_LOGW_D2 = 1 << 10     # with G_LOGW: emit raw squared distances (exact
                        # small integers -> compact device transfer)

# column layout of the [n, 74] geom matrix (mirrors geomfeats_batch.cpp)
GEOM_W = 74
_GC_CONTOUR = 0     # PERIM, DIAM_EQ_PERIM, EDGE_MEAN/STD/MAX/MIN/INTEG
_GC_FRACT = 7
_GC_HULL = 8        # CONVEX_HULL_AREA, SOLIDITY, CIRCULARITY
_GC_FERET = 11      # min_ang, max_ang, min, max, mean, median, stdev, mode
_GC_MARTIN = 19     # min, max, mean, median, stdev, mode
_GC_NASS = 25
_GC_CHORDS = 31     # MAXCHORDS 8 + ALLCHORDS 8
_GC_RRAD = 47       # MEAN, MAX, MEDIAN
_GC_FRAC_AT_D = 50
_GC_MEAN_FRAC = 58
_GC_RADIAL_CV = 66


def _oversized_hull_source(hc, i):
    """(xs, ys) global points whose hull is oversized row i's hull: its
    streamed column extremes, else (whole-slide rows) its contour."""
    if hc.hull_points[i] is not None:
        return hc.hull_points[i]
    K = hc.contours[i]
    r = hc.recs[i]
    # contour coords carry the reference's +1 shift
    return (K[:, 0].astype(np.int64) - 1 + r.x0,
            K[:, 1].astype(np.int64) - 1 + r.y0)


def _geom_inputs(hc):
    """(contours flat+offsets, recs matrix, flags, hull candidates
    flat+offsets) for the native geometry kernel, built once per
    HostContext."""
    cached = getattr(hc, "_geom_inputs", None)
    if cached is not None:
        return cached
    n = len(hc.recs)
    ctr_list = hc.contours if hc.contours is not None else [None] * n
    koff = np.zeros(n + 1, np.int64)
    parts = []
    for i, K in enumerate(ctr_list):
        k = 0 if K is None else len(K)
        koff[i + 1] = koff[i] + k
        if k:
            parts.append(np.ascontiguousarray(K[:, :3], np.int64))
    ctr = (np.concatenate(parts) if parts else np.zeros((0, 3), np.int64))
    recs_mat = np.zeros((n, 9), np.int64)
    flags = np.zeros(n, np.uint8)
    hoff = np.zeros(n + 1, np.int64)
    hparts = []
    for i, r in enumerate(hc.recs):
        if r.report_bbox is not None:
            ry0, ry1, rx0, rx1 = r.report_bbox
        else:
            ry0, ry1, rx0, rx1 = r.y0, r.y1, r.x0, r.x1
        recs_mat[i] = (r.x0, r.x1, r.y0, r.y1, rx0, rx1, ry0, ry1, r.area)
        # oversized rows have no dense pixel access; their hull comes from
        # their streamed column extremes
        flags[i] = 1 if hc.pixels_ok(i) else 2
        hk = 0
        if flags[i] == 2 and ctr_list[i] is not None:
            hx, hy = _oversized_hull_source(hc, i)
            hparts.append(np.stack([hx, hy], axis=1).astype(np.int64))
            hk = len(hx)
        hoff[i + 1] = hoff[i] + hk
    hpts = (np.concatenate(hparts) if hparts else np.zeros((0, 2), np.int64))
    hc._geom_inputs = ((ctr, koff), recs_mat, flags, (hpts, hoff))
    return hc._geom_inputs


# families whose per-pixel contour-distance pass is shared with the
# weighted-moment log distances: computing them in the SAME native call as
# logw avoids a second distance search over every cloud pixel
DIST_FAMILIES = ("RoiRadiusFeature", "RadialDistributionFeature")


def compute_geom(hc, cfg, families, want_logw=False, logw_eps=0.0,
                 phase="all", exclude=(), logw_raw=False):
    """Run the one-call geometry kernel over every host row; caches the
    result matrix on the HostContext so the per-family accessors below just
    slice columns.  Returns True when the native path ran.

    ``phase`` splits the work around the device dispatch: "logw" computes
    the per-pixel weighted-moment log distances (needed BEFORE the device
    batches are built) plus any families listed that share the distance
    pass; "rest" computes the remaining feature groups and runs while the
    dispatched device batches execute; "all" does both.  Calls accumulate
    into one cached matrix."""
    from .. import native
    if not native.available() or getattr(hc, "clouds", None) is None:
        return False
    groups = 0
    for f in families:
        if f not in exclude:
            groups |= GEOM_GROUPS.get(f, 0)
    if want_logw and phase in ("logw", "all"):
        groups |= G_LOGW
        if logw_raw:
            groups |= G_LOGW_D2
    if groups == 0:
        return False
    contours, recs_mat, flags, hull_points = _geom_inputs(hc)
    n = len(hc.recs)
    out = getattr(hc, "geom", None)
    if out is None:
        out = np.zeros((n, GEOM_W))
        out[:, _GC_FERET:_GC_CHORDS] = cfg.noval
        out[:, _GC_CHORDS:_GC_RRAD] = -0.0
        out[:, _GC_FRAC_AT_D:GEOM_W] = -0.0
    want_lw = bool(groups & G_LOGW)
    out, logw = native.geom_batch(hc.clouds, contours, recs_mat, flags,
                                  hull_points, groups, logw_eps=logw_eps,
                                  out=out,
                                  want_logw=want_lw)
    hc.geom = out
    if want_lw:
        hc.logw_flat = logw
        hc.logw_flat_is_d2 = bool(groups & G_LOGW_D2)
    return True


def _geom(hc):
    return getattr(hc, "geom", None)


# ---------------------------------------------------------------------------
# convex hull (convex_hull_nontriv.cpp:68-210)

def build_convex_hull(xs, ys):
    """Monotone-chain hull over pixel points, reference vertex order:
    upper chain then lower-chain leftovers.  Returns [K, 2] array (x, y).
    Native fast path (native/src/contour.cpp nyx_convex_hull); this Python
    body is the fallback and parity oracle."""
    from .. import native
    if native.available():
        return native.convex_hull(np.asarray(xs, np.int64),
                                  np.asarray(ys, np.int64))
    return build_convex_hull_py(xs, ys)


def build_convex_hull_py(xs, ys):
    pts = np.stack([xs, ys], axis=1)
    if len(pts) < 2:
        return pts.astype(np.float64)
    order = np.lexsort((ys, xs))
    pts = pts[order]
    # reduce to per-column extremes: hull vertices only occur there
    px, py = pts[:, 0], pts[:, 1]
    first = np.concatenate([[True], px[1:] != px[:-1]])
    starts = np.nonzero(first)[0]
    ends = np.concatenate([starts[1:] - 1, [len(px) - 1]])
    cand = np.unique(np.concatenate([starts, ends]))
    pts = pts[cand]

    def right_turn(p1, p2, p3):
        return ((p3[0] - p1[0]) * (p2[1] - p1[1])
                - (p3[1] - p1[1]) * (p2[0] - p1[0])) > 0

    n = len(pts)
    if n < 2:
        return pts.astype(np.float64)
    upper = [pts[0], pts[1]]
    for i in range(2, n):
        while len(upper) > 1 and not right_turn(upper[-2], upper[-1], pts[i]):
            upper.pop()
        upper.append(pts[i])
    lower = [pts[n - 1], pts[n - 2]]
    for i in range(2, n):
        p = pts[n - i - 1]
        while len(lower) > 1 and not right_turn(lower[-2], lower[-1], p):
            lower.pop()
        lower.append(p)
    seen = {tuple(p) for p in upper}
    hull = list(upper) + [p for p in lower if tuple(p) not in seen]
    return np.array(hull, np.float64)


def polygon_area(v):
    if len(v) == 0:
        return 0.0
    x, y = v[:, 0], v[:, 1]
    return abs(np.sum(x * np.roll(y, -1) - y * np.roll(x, -1))) / 2.0


def hull_boundary_points(v):
    if len(v) < 2:
        return 0
    d = np.abs(v - np.roll(v, -1, axis=0)).astype(np.int64)
    return int(sum(math.gcd(int(a), int(b)) for a, b in d))


def convex_hull_features(hc, cfg):
    """CONVEX_HULL_AREA / SOLIDITY / CIRCULARITY (convex_hull_nontriv.cpp:50-66)."""
    g = _geom(hc)
    if g is not None:
        return {"CONVEX_HULL_AREA": g[:, _GC_HULL].copy(),
                "SOLIDITY": g[:, _GC_HULL + 1].copy(),
                "CIRCULARITY": g[:, _GC_HULL + 2].copy()}
    n = len(hc.recs)
    out = {k: np.zeros(n) for k in ("CONVEX_HULL_AREA", "SOLIDITY", "CIRCULARITY")}
    perim = hc.get_feature("PERIMETER")
    for i, r in enumerate(hc.recs):
        if hc.pixels_ok(i):
            ys, xs = hc.roi_points(i)
            xs, ys = xs + r.x0, ys + r.y0
        else:
            xs, ys = _oversized_hull_source(hc, i)
        # hull in GLOBAL coordinates: the reference's caliper rotations
        # float32-round the rotated GLOBAL vertices (rotation.cpp:66), and
        # float32 rounding is not translation-invariant
        hull = build_convex_hull(xs, ys)
        hc.hulls[i] = hull
        s_hull = polygon_area(hull) + hull_boundary_points(hull) / 2.0 + 1.0
        s_roi = r.area
        out["CONVEX_HULL_AREA"][i] = s_hull
        out["SOLIDITY"][i] = s_roi / s_hull if s_hull > 0 else 0.0
        p = perim[i]
        out["CIRCULARITY"][i] = (math.sqrt(4 * math.pi * s_roi / (p * p))
                                 if p > 0 else 0.0)
    return out


# ---------------------------------------------------------------------------
# calipers (caliper_feret.cpp, caliper_martin.cpp, caliper_nassenstein.cpp)

def _seq_mean(v):
    """Sequential-order mean (the reference accumulates the hull centroid
    in a plain loop, rotation.cpp:47-53; numpy's pairwise sum can differ in
    the last bit and flip downstream ties)."""
    acc = 0.0
    for x in v:
        acc += float(x)
    return acc / len(v)


def _rotate_fp(hull, theta_deg):
    """rotate_around_center_fp (rotation.cpp:37-68): rotation around the
    hull's centroid; the rotated vertices are stored as FLOAT32 Point2f, so
    downstream caliper math runs on float32-rounded coordinates."""
    c = (_seq_mean(hull[:, 0]), _seq_mean(hull[:, 1]))
    th = np.float32(theta_deg) * np.float32(math.pi) / np.float32(180.0)
    # the reference's unqualified sin(float) picks the FLOAT overload
    s, co = float(np.float32(math.sin(float(th)))),         float(np.float32(math.cos(float(th))))
    d = hull - c
    out = np.stack([d[:, 0] * co - d[:, 1] * s + c[0],
                    d[:, 0] * s + d[:, 1] * co + c[1]], axis=1)
    return out.astype(np.float32).astype(np.float64)


def _common_stats(data):
    """ComputeCommonStatistics2 (common_stats.cpp:9-50)."""
    if len(data) == 0:
        return dict(min=0.0, max=0.0, mean=0.0, median=0.0, stdev=0.0, mode=0.0)
    data = np.asarray(data, np.float64)
    mx, mn = data.max(), data.min()
    mean = data.mean()
    stdev = math.sqrt(((data - mean) ** 2).sum() / len(data))
    imax, imin = int(math.ceil(mx)), int(math.floor(mn))
    # int(v) truncates toward zero == astype(int64) (diameters are >= 0)
    bins = np.bincount(data.astype(np.int64) - imin,
                       minlength=imax - imin + 1)
    # first strictly-greater scan == argmax first-tie (common_stats.cpp:29-33)
    mode = int(np.argmax(bins)) + imin
    s = np.sort(data)
    half = len(s) // 2
    median = s[half] if len(s) % 2 else (s[half] + s[half - 1]) / 2.0
    return dict(min=mn, max=mx, mean=mean, median=median, stdev=stdev, mode=mode)


def _hull_widths_at_ys(poly, ys):
    """Vectorized _hull_width_at_y over a batch of scanline ys.

    For each y: the horizontal extent of the polygon boundary at that y —
    min/max over edge crossings (same IEEE op order as the reference's
    per-edge loop, caliper_martin.cpp)."""
    a = poly                      # [K, 2]
    b = np.roll(poly, -1, axis=0)
    lo = np.minimum(a[:, 1], b[:, 1])   # [K]
    hi = np.maximum(a[:, 1], b[:, 1])
    y = np.asarray(ys, np.float64)[:, None]    # [G, 1]
    valid = (y >= lo) & (y <= hi)              # [G, K]
    horiz = b[:, 1] == a[:, 1]                 # [K]
    denom = np.where(horiz, 1.0, b[:, 1] - a[:, 1])
    with np.errstate(invalid="ignore", over="ignore"):
        x = a[:, 0] + (b[:, 0] - a[:, 0]) * (y - a[:, 1]) / denom
    e0 = np.where(horiz, np.minimum(a[:, 0], b[:, 0]), x)
    e1 = np.where(horiz, np.maximum(a[:, 0], b[:, 0]), x)
    xlo = np.where(valid, e0, np.inf).min(axis=1)
    xhi = np.where(valid, e1, -np.inf).max(axis=1)
    return np.where(valid.any(axis=1), xhi - xlo, 0.0)


def _hull_heights_at_xs(poly, xs):
    """Vertical extent at scanline x == width with axes swapped."""
    return _hull_widths_at_ys(poly[:, ::-1], xs)


def _hull_widths_at_ys_batch(polys, ys):
    """_hull_widths_at_ys batched over rotated polygons.

    polys: [A, K, 2] one polygon per angle; ys: [A, G] scanlines per angle.
    Returns [A, G] widths.  Same IEEE op order as the scalar version."""
    a = polys                                  # [A, K, 2]
    b = np.roll(polys, -1, axis=1)
    lo = np.minimum(a[:, :, 1], b[:, :, 1])[:, None, :]   # [A, 1, K]
    hi = np.maximum(a[:, :, 1], b[:, :, 1])[:, None, :]
    y = np.asarray(ys, np.float64)[:, :, None]            # [A, G, 1]
    valid = (y >= lo) & (y <= hi)                          # [A, G, K]
    horiz = (b[:, :, 1] == a[:, :, 1])[:, None, :]
    denom = np.where(horiz, 1.0, (b[:, :, 1] - a[:, :, 1])[:, None, :])
    a0 = a[:, None, :, 0]
    b0 = b[:, None, :, 0]
    a1 = a[:, None, :, 1]
    with np.errstate(invalid="ignore", over="ignore"):
        x = a0 + (b0 - a0) * (y - a1) / denom
    e0 = np.where(horiz, np.minimum(a0, b0), x)
    e1 = np.where(horiz, np.maximum(a0, b0), x)
    xlo = np.where(valid, e0, np.inf).min(axis=2)
    xhi = np.where(valid, e1, -np.inf).max(axis=2)
    return np.where(valid.any(axis=2), xhi - xlo, 0.0)


def _rotate_fp_batch(hull, thetas_deg):
    """_rotate_fp over a batch of angles: returns [A, K, 2].

    Matches _rotate_fp's float32 theta conversion and double trig."""
    c = (_seq_mean(hull[:, 0]), _seq_mean(hull[:, 1]))
    d = hull - c
    th = (np.asarray(thetas_deg, np.float32) * np.float32(math.pi)
          / np.float32(180.0)).astype(np.float64)
    # float-overload trig, bit-identical with the scalar _rotate_fp
    s = np.array([float(np.float32(math.sin(t))) for t in th])[:, None]
    co = np.array([float(np.float32(math.cos(t))) for t in th])[:, None]
    rx = d[None, :, 0] * co - d[None, :, 1] * s + c[0]
    ry = d[None, :, 0] * s + d[None, :, 1] * co + c[1]
    # Point2f storage: float32 rounding of the rotated vertices
    return np.stack([rx, ry], axis=2).astype(np.float32).astype(np.float64)


def caliper_feret_py(hc, cfg):
    n = len(hc.recs)
    nv = cfg.noval
    names = ("MIN_FERET_ANGLE", "MAX_FERET_ANGLE", "STAT_FERET_DIAM_MIN",
             "STAT_FERET_DIAM_MAX", "STAT_FERET_DIAM_MEAN",
             "STAT_FERET_DIAM_MEDIAN", "STAT_FERET_DIAM_STDDEV",
             "STAT_FERET_DIAM_MODE")
    out = {k: np.full(n, nv) for k in names}
    thetas = np.arange(0.0, 180.0 + 1e-9, 10.0)
    for i in range(n):
        hull = hc.hulls[i]
        if hull is None or len(hull) == 0:
            continue
        rot = _rotate_fp_batch(hull, thetas)           # [A, K, 2]
        all_ferets = rot[:, :, 0].max(axis=1) - rot[:, :, 0].min(axis=1)
        pos = all_ferets > 0
        if not pos.any():
            continue
        angles = thetas[pos]
        ferets = all_ferets[pos]
        st = _common_stats(ferets)
        out["MIN_FERET_ANGLE"][i] = angles[int(np.argmin(ferets))]
        out["MAX_FERET_ANGLE"][i] = angles[int(np.argmax(ferets))]
        out["STAT_FERET_DIAM_MIN"][i] = st["min"]
        out["STAT_FERET_DIAM_MAX"][i] = st["max"]
        out["STAT_FERET_DIAM_MEAN"][i] = st["mean"]
        out["STAT_FERET_DIAM_MEDIAN"][i] = st["median"]
        out["STAT_FERET_DIAM_STDDEV"][i] = st["stdev"]
        out["STAT_FERET_DIAM_MODE"][i] = st["mode"]
    return out


def caliper_martin_py(hc, cfg):
    n = len(hc.recs)
    out = {k: np.full(n, cfg.noval) for k in (
        "STAT_MARTIN_DIAM_MIN", "STAT_MARTIN_DIAM_MAX", "STAT_MARTIN_DIAM_MEAN",
        "STAT_MARTIN_DIAM_MEDIAN", "STAT_MARTIN_DIAM_STDDEV",
        "STAT_MARTIN_DIAM_MODE")}
    NGRID = 100
    thetas = np.arange(0.0, 180.0 - 1e-9, 10.0)
    for i in range(n):
        hull = hc.hulls[i]
        if hull is None or len(hull) == 0:
            continue
        rots = _rotate_fp_batch(hull, thetas)          # [A, K, 2]
        miny = rots[:, :, 1].min(axis=1)               # [A]
        maxy = rots[:, :, 1].max(axis=1)
        stepy = (maxy - miny) / NGRID
        yy = miny[:, None] + (np.arange(NGRID) + 0.5) * stepy[:, None]
        widths = _hull_widths_at_ys_batch(rots, yy)    # [A, G]
        total = widths.sum(axis=1)
        cum = np.cumsum(widths, axis=1)
        k = np.argmax(cum >= 0.5 * total[:, None], axis=1)
        ok = (maxy > miny) & (total > 0)
        D = widths[np.arange(len(thetas)), k][ok]
        if not len(D):
            continue
        st = _common_stats(np.asarray(D))
        out["STAT_MARTIN_DIAM_MIN"][i] = st["min"]
        out["STAT_MARTIN_DIAM_MAX"][i] = st["max"]
        out["STAT_MARTIN_DIAM_MEAN"][i] = st["mean"]
        out["STAT_MARTIN_DIAM_MEDIAN"][i] = st["median"]
        out["STAT_MARTIN_DIAM_STDDEV"][i] = st["stdev"]
        out["STAT_MARTIN_DIAM_MODE"][i] = st["mode"]
    return out


def caliper_nassenstein_py(hc, cfg):
    n = len(hc.recs)
    out = {k: np.full(n, cfg.noval) for k in (
        "STAT_NASSENSTEIN_DIAM_MIN", "STAT_NASSENSTEIN_DIAM_MAX",
        "STAT_NASSENSTEIN_DIAM_MEAN", "STAT_NASSENSTEIN_DIAM_MEDIAN",
        "STAT_NASSENSTEIN_DIAM_STDDEV", "STAT_NASSENSTEIN_DIAM_MODE")}
    thetas = np.arange(0.0, 180.0 - 1e-9, 10.0)
    for i in range(n):
        hull = hc.hulls[i]
        if hull is None or len(hull) < 3:
            continue
        rots = _rotate_fp_batch(hull, thetas)          # [A, K, 2]
        ymax = rots[:, :, 1].max(axis=1)
        sel = np.abs(rots[:, :, 1] - ymax[:, None]) < 1e-3
        # compacted per-angle sums keep the oracle's summation order
        xc = np.array([rots[a][sel[a], 0].sum() / max(int(sel[a].sum()), 1)
                       for a in range(len(thetas))])
        D = _hull_widths_at_ys_batch(rots[:, :, ::-1], xc[:, None])[:, 0]
        if not len(D):
            continue
        st = _common_stats(np.asarray(D))
        out["STAT_NASSENSTEIN_DIAM_MIN"][i] = st["min"]
        out["STAT_NASSENSTEIN_DIAM_MAX"][i] = st["max"]
        out["STAT_NASSENSTEIN_DIAM_MEAN"][i] = st["mean"]
        out["STAT_NASSENSTEIN_DIAM_MEDIAN"][i] = st["median"]
        out["STAT_NASSENSTEIN_DIAM_STDDEV"][i] = st["stdev"]
        out["STAT_NASSENSTEIN_DIAM_MODE"][i] = st["mode"]
    return out


# ---------------------------------------------------------------------------
# chords (chords.cpp:?-120)

def _chord_angles(n_angle_segments=20):
    """The reference's accumulated-angle sweep (ang += pi/20 while < pi),
    replicated with the same float accumulation for bit parity."""
    ang_step = math.pi / n_angle_segments
    angs = []
    ang = 0.0
    while ang < math.pi:
        angs.append(ang)
        ang += ang_step
    return np.asarray(angs, np.float64)


def chords_py(hc, cfg):
    """Chord statistics over a 20-angle rotation sweep (chords.cpp).

    Vectorized: instead of rasterizing every rotation and scanning columns
    with an interpreted run-length loop, all (angle, pixel) rotations are
    computed at once and per-column longest runs come from one lexsort +
    segment-boundary pass.  Semantics (float32 rotation truncation, column
    subsampling `step = wr // 100`, dedup via rasterization) are preserved
    exactly; tests/test_chords_vec.py pins bit-parity against the loop
    oracle."""
    n = len(hc.recs)
    names = ("MAXCHORDS_MAX", "MAXCHORDS_MAX_ANG", "MAXCHORDS_MIN",
             "MAXCHORDS_MIN_ANG", "MAXCHORDS_MEDIAN", "MAXCHORDS_MEAN",
             "MAXCHORDS_MODE", "MAXCHORDS_STDDEV", "ALLCHORDS_MAX",
             "ALLCHORDS_MAX_ANG", "ALLCHORDS_MIN", "ALLCHORDS_MIN_ANG",
             "ALLCHORDS_MEDIAN", "ALLCHORDS_MEAN", "ALLCHORDS_MODE",
             "ALLCHORDS_STDDEV")
    out = {k: np.full(n, -0.0) for k in names}
    n_side_segments = 100
    angs = _chord_angles()
    A = len(angs)
    # the reference passes theta through a FLOAT parameter (rotation.h:36)
    # and its unqualified sin(float) resolves to the FLOAT overload, so
    # trig runs entirely in float32
    sin_a = np.array([float(np.float32(math.sin(float(np.float32(a)))))
                      for a in angs])[:, None]
    cos_a = np.array([float(np.float32(math.cos(float(np.float32(a)))))
                      for a in angs])[:, None]
    aidx_row = np.arange(A)
    for i, r in enumerate(hc.recs):
        if not hc.pixels_ok(i):
            continue        # oversized: full pixel sweep unavailable
        ys, xs = hc.roi_points(i)
        if len(xs) == 0:
            continue
        ii_crop, _ = hc.pair_crop(i)
        inten = ii_crop[ys, xs]
        if r.report_bbox is not None:    # anisotropy: scaled-AABB center
            ry0, ry1, rx0, rx1 = r.report_bbox
            cenx = (rx0 + rx1) / 2.0
            ceny = (ry0 + ry1) / 2.0
        else:
            cenx = (r.x0 + r.x1) / 2.0
            ceny = (r.y0 + r.y1) / 2.0
        gx = (xs + r.x0)[None, :]            # [1, P]
        gy = (ys + r.y0)[None, :]
        # rotate_cloud + Pixel2(float) truncation toward zero
        xr = ((gx - cenx) * cos_a - (gy - ceny) * sin_a + cenx
              ).astype(np.float32)
        yr = ((gy - ceny) * cos_a + (gx - cenx) * sin_a + ceny
              ).astype(np.float32)
        xi = xr.astype(np.int64)             # [A, P]
        yi = yr.astype(np.int64)
        cx = xi - xi.min(axis=1, keepdims=True)
        cy = yi - yi.min(axis=1, keepdims=True)
        wr = cx.max(axis=1) + 1              # [A]
        step = np.where(wr >= 2 * n_side_segments,
                        wr // n_side_segments, 1)
        # keep only pixels on sampled columns (col % step == 0)
        keep = (cx % step[:, None]) == 0
        a_k = np.broadcast_to(aidx_row[:, None], cx.shape)[keep]
        x_k = cx[keep]
        y_k = cy[keep]
        # cell value = intensity of the LAST cloud pixel mapping there
        # (ImageMatrix rasterization overwrites, image_matrix.h:270-276);
        # zero-INTENSITY cells break chords (get_chlen tests != 0)
        i_k = np.broadcast_to(inten[None, :], cx.shape)[keep]
        c_k = np.broadcast_to(np.arange(len(xs))[None, :], cx.shape)[keep]
        order = np.lexsort((c_k, y_k, x_k, a_k))
        a_s, x_s, y_s = a_k[order], x_k[order], y_k[order]
        i_s = i_k[order]
        # dedup keeping the LAST writer of each cell
        if len(a_s) > 1:
            last = np.empty(len(a_s), bool)
            last[-1] = True
            last[:-1] = ((a_s[1:] != a_s[:-1]) | (x_s[1:] != x_s[:-1])
                         | (y_s[1:] != y_s[:-1]))
            a_s, x_s, y_s, i_s = (a_s[last], x_s[last], y_s[last],
                                  i_s[last])
        nzcell = i_s != 0
        a_s, x_s, y_s = a_s[nzcell], x_s[nzcell], y_s[nzcell]
        if len(a_s) == 0:
            continue
        # vertical run boundaries within each (angle, column)
        newrun = np.empty(len(a_s), bool)
        newrun[0] = True
        newrun[1:] = ((a_s[1:] != a_s[:-1]) | (x_s[1:] != x_s[:-1])
                      | (y_s[1:] != y_s[:-1] + 1))
        run_start = np.nonzero(newrun)[0]
        run_len = np.diff(np.append(run_start, len(a_s)))
        run_a, run_x = a_s[run_start], x_s[run_start]
        # get_chlen quirk (image_matrix.cpp:206-236): a run is only counted
        # when TERMINATED by a zero below it; runs reaching the raster's
        # bottom row never fold into maxChlen
        hr = cy.max(axis=1)           # bottom row index per angle
        run_end_y = y_s[run_start] + run_len - 1
        terminated = run_end_y != hr[run_a]
        run_a, run_x, run_len = (run_a[terminated], run_x[terminated],
                                 run_len[terminated])
        if len(run_a) == 0:
            continue
        # longest run per (angle, column) — columns in (angle, col) order,
        # matching the reference's angle-outer / column-inner append order
        newcol = np.empty(len(run_a), bool)
        newcol[0] = True
        newcol[1:] = (run_a[1:] != run_a[:-1]) | (run_x[1:] != run_x[:-1])
        col_start = np.nonzero(newcol)[0]
        AC = np.maximum.reduceat(run_len, col_start).astype(np.float64)
        col_a = run_a[col_start]
        ACang = angs[col_a]
        # per-angle max of the column bests
        newang = np.empty(len(col_start), bool)
        newang[0] = True
        newang[1:] = col_a[1:] != col_a[:-1]
        ang_start = np.nonzero(newang)[0]
        MC = np.maximum.reduceat(AC, ang_start)
        MCang = angs[col_a[ang_start]]
        if len(MC) == 0:
            continue
        # Faithful quirk: the reference reuses one TrivialHistogram without
        # clearing (initialize_uniques appends, histogram.h:199-203), so the
        # ALLCHORDS mode/median are computed over MC + AC concatenated
        # (chords.cpp:72-99)
        for pre, V, Aang, H in (("MAXCHORDS", MC, MCang, MC),
                                ("ALLCHORDS", AC, ACang,
                                 np.concatenate([MC, AC]))):
            mean = V.mean()
            std = math.sqrt(((V - mean) ** 2).sum() / (len(V) - 1)) if len(V) > 2 else 0.0
            sv = np.sort(H)
            half = len(sv) // 2
            median = sv[half] if len(sv) % 2 else (sv[half - 1] + sv[half]) / 2.0
            vals, counts = np.unique(H, return_counts=True)
            mode = vals[int(np.argmax(counts))]
            out[pre + "_MAX"][i] = V.max()
            out[pre + "_MIN"][i] = V.min()
            out[pre + "_MEAN"][i] = mean
            out[pre + "_STDDEV"][i] = std
            out[pre + "_MEDIAN"][i] = median
            out[pre + "_MODE"][i] = mode
            out[pre + "_MIN_ANG"][i] = Aang[int(np.argmin(V))]
            out[pre + "_MAX_ANG"][i] = Aang[int(np.argmax(V))]
    return out



# ---------------------------------------------------------------------------
# native dispatch: the C++ ports in native/src/geomfeats.cpp run these hot
# families threaded (the reference runs them on std::async CPU threads);
# the *_py numpy bodies above stay as the parity oracles / fallbacks

_FERET_MEMBERS = ("MIN_FERET_ANGLE", "MAX_FERET_ANGLE", "STAT_FERET_DIAM_MIN",
                  "STAT_FERET_DIAM_MAX", "STAT_FERET_DIAM_MEAN",
                  "STAT_FERET_DIAM_MEDIAN", "STAT_FERET_DIAM_STDDEV",
                  "STAT_FERET_DIAM_MODE")
_MARTIN_MEMBERS = ("STAT_MARTIN_DIAM_MIN", "STAT_MARTIN_DIAM_MAX",
                   "STAT_MARTIN_DIAM_MEAN", "STAT_MARTIN_DIAM_MEDIAN",
                   "STAT_MARTIN_DIAM_STDDEV", "STAT_MARTIN_DIAM_MODE")
_NASS_MEMBERS = ("STAT_NASSENSTEIN_DIAM_MIN", "STAT_NASSENSTEIN_DIAM_MAX",
                 "STAT_NASSENSTEIN_DIAM_MEAN", "STAT_NASSENSTEIN_DIAM_MEDIAN",
                 "STAT_NASSENSTEIN_DIAM_STDDEV", "STAT_NASSENSTEIN_DIAM_MODE")
# native column order: min, max, mean, median, stdev, mode (+ angles for
# feret: min_angle, max_angle first)
_FERET_COLS = (0, 1, 2, 3, 4, 5, 6, 7)
_STAT_PERM = {"MIN": 0, "MAX": 1, "MEAN": 2, "MEDIAN": 3, "STDDEV": 4,
              "MODE": 5}


def _caliper_native(kind, members, hc, cfg):
    from .. import native
    out_mat = native.caliper_batch(kind, hc.hulls, cfg.noval)
    out = {}
    if kind == "feret":
        for j, m in enumerate(members):
            out[m] = out_mat[:, j].copy()
    else:
        for m in members:
            out[m] = out_mat[:, _STAT_PERM[m.rsplit("_", 1)[1]]].copy()
    return out


def caliper_feret(hc, cfg):
    from .. import native
    g = _geom(hc)
    if g is not None:
        m = g[:, _GC_FERET:_GC_FERET + 8]
    elif not native.available():
        return caliper_feret_py(hc, cfg)
    else:
        m = native.caliper_batch("feret", hc.hulls, cfg.noval)
    # native order: min_ang, max_ang, min, max, mean, median, stdev, mode
    return {"MIN_FERET_ANGLE": m[:, 0].copy(),
            "MAX_FERET_ANGLE": m[:, 1].copy(),
            "STAT_FERET_DIAM_MIN": m[:, 2].copy(),
            "STAT_FERET_DIAM_MAX": m[:, 3].copy(),
            "STAT_FERET_DIAM_MEAN": m[:, 4].copy(),
            "STAT_FERET_DIAM_MEDIAN": m[:, 5].copy(),
            "STAT_FERET_DIAM_STDDEV": m[:, 6].copy(),
            "STAT_FERET_DIAM_MODE": m[:, 7].copy()}


def caliper_martin(hc, cfg):
    from .. import native
    g = _geom(hc)
    if g is not None:
        return {m: g[:, _GC_MARTIN + _STAT_PERM[m.rsplit("_", 1)[1]]].copy()
                for m in _MARTIN_MEMBERS}
    if not native.available():
        return caliper_martin_py(hc, cfg)
    return _caliper_native("martin", _MARTIN_MEMBERS, hc, cfg)


def caliper_nassenstein(hc, cfg):
    from .. import native
    g = _geom(hc)
    if g is not None:
        return {m: g[:, _GC_NASS + _STAT_PERM[m.rsplit("_", 1)[1]]].copy()
                for m in _NASS_MEMBERS}
    if not native.available():
        return caliper_nassenstein_py(hc, cfg)
    return _caliper_native("nassenstein", _NASS_MEMBERS, hc, cfg)


_CHORD_MEMBERS = ("MAX", "MAX_ANG", "MIN", "MIN_ANG", "MEDIAN", "MEAN",
                  "MODE", "STDDEV")


def chords(hc, cfg):
    from .. import native
    g = _geom(hc)
    if g is not None:
        out = {}
        for j, tag in enumerate(_CHORD_MEMBERS):
            out["MAXCHORDS_" + tag] = g[:, _GC_CHORDS + j].copy()
            out["ALLCHORDS_" + tag] = g[:, _GC_CHORDS + 8 + j].copy()
        return out
    if not native.available():
        return chords_py(hc, cfg)
    points = []
    aabbs = np.zeros((len(hc.recs), 4), np.int64)
    skipped = []
    for i, r in enumerate(hc.recs):
        if not hc.pixels_ok(i):     # oversized: full pixel sweep unavailable
            skipped.append(i)
            points.append((np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float64)))
            aabbs[i] = (r.x0, r.x1, r.y0, r.y1)
            continue
        ys, xs = hc.roi_points(i)
        ii_crop, _ = hc.pair_crop(i)
        points.append(((xs + r.x0).astype(np.int64),
                       (ys + r.y0).astype(np.int64),
                       ii_crop[ys, xs].astype(np.float64)))
        if r.report_bbox is not None:
            # anisotropy: the rotation center is the REPORTED (scaled) AABB
            # center (chords.cpp:14-15 reads r.aabb), which can be narrower
            # than the widened crop box
            ry0, ry1, rx0, rx1 = r.report_bbox
            aabbs[i] = (rx0, rx1, ry0, ry1)
        else:
            aabbs[i] = (r.x0, r.x1, r.y0, r.y1)
    m = native.chords_batch(points, aabbs)
    out = {}
    for j, tag in enumerate(_CHORD_MEMBERS):
        out["MAXCHORDS_" + tag] = m[:, j].copy()
        out["ALLCHORDS_" + tag] = m[:, 8 + j].copy()
    for i in skipped:
        for k in out:
            out[k][i] = -0.0
    return out


# ---------------------------------------------------------------------------
# circles (circle.cpp:28-245) -- the reference's deterministic float32
# min-enclosing-circle search (not a shuffled Welzl)

def _min_enclosing_circle_diam_py(px, py):
    """Python port of circle.cpp:145-216 (parity oracle for the native
    kernel).  All intermediate math in float32 like the reference."""
    f = np.float32
    EPS = f(1.0e-4)
    n = len(px)
    if n == 0:
        return 0.0
    if n == 1:
        return float(2.0 * EPS)
    def nl2(dx, dy):
        return f(math.sqrt(f(f(dx) * f(dx)) + f(f(dy) * f(dy))))
    if n == 2:
        return float(2.0 * (nl2(f(px[0]) - f(px[1]), f(py[0]) - f(py[1]))
                            / f(2) + EPS))

    def circle3(p):
        v1 = (f(p[1][0] - p[0][0]), f(p[1][1] - p[0][1]))
        v2 = (f(p[2][0] - p[0][0]), f(p[2][1] - p[0][1]))
        mid1 = (f((p[0][0] + p[1][0]) / 2), f((p[0][1] + p[1][1]) / 2))
        c1 = f(f(mid1[0] * v1[0]) + f(mid1[1] * v1[1]))
        mid2 = (f((p[0][0] + p[2][0]) / 2), f((p[0][1] + p[2][1]) / 2))
        c2 = f(f(mid2[0] * v2[0]) + f(mid2[1] * v2[1]))
        det = f(f(v1[0] * v2[1]) - f(v1[1] * v2[0]))
        if abs(det) <= EPS:
            d1 = nl2(p[0][0] - p[1][0], p[0][1] - p[1][1])
            d2 = nl2(p[0][0] - p[2][0], p[0][1] - p[2][1])
            d3 = nl2(p[1][0] - p[2][0], p[1][1] - p[2][1])
            radius = f(f(math.sqrt(max(d1, d2, d3))) * f(0.5) + EPS)
            if d1 >= d2 and d1 >= d3:
                ctr = (f((p[0][0] + p[1][0]) * 0.5), f((p[0][1] + p[1][1]) * 0.5))
            elif d2 >= d1 and d2 >= d3:
                ctr = (f((p[0][0] + p[2][0]) * 0.5), f((p[0][1] + p[2][1]) * 0.5))
            else:
                ctr = (f((p[1][0] + p[2][0]) * 0.5), f((p[1][1] + p[2][1]) * 0.5))
            return ctr, radius
        cx = f(f(f(c1 * v2[1]) - f(c2 * v1[1])) / det)
        cy = f(f(f(v1[0] * c2) - f(v2[0] * c1)) / det)
        ctr = (cx, cy)
        dx = f(cx - f(p[0][0]))
        dy = f(cy - f(p[0][1]))
        return ctr, f(f(math.sqrt(f(dx * dx) + f(dy * dy))) + EPS)

    def third_point(i, j):
        center = (f((px[j] + px[i]) / 2), f((py[j] + py[i]) / 2))
        radius = f(nl2(px[j] - px[i], py[j] - py[i]) / f(2) + EPS)
        for k in range(j):
            if nl2(center[0] - f(px[k]), center[1] - f(py[k])) < radius:
                continue
            pts = ((f(px[i]), f(py[i])), (f(px[j]), f(py[j])),
                   (f(px[k]), f(py[k])))
            nc, nr = circle3(pts)
            if nr > 0:
                radius, center = nr, nc
        return center, radius

    def second_point(i):
        center = (f((px[0] + px[i]) / 2), f((py[0] + py[i]) / 2))
        radius = f(nl2(px[0] - px[i], py[0] - py[i]) / f(2) + EPS)
        for j in range(1, i):
            if nl2(center[0] - f(px[j]), center[1] - f(py[j])) < radius:
                continue
            nc, nr = third_point(i, j)
            if nr > 0:
                radius, center = nr, nc
        return center, radius

    center = (f((px[0] + px[1]) / 2), f((py[0] + py[1]) / 2))
    radius = f(nl2(px[0] - px[1], py[0] - py[1]) / f(2) + EPS)
    for i in range(2, n):
        if nl2(f(px[i]) - center[0], f(py[i]) - center[1]) < radius:
            continue
        nc, nr = second_point(i)
        if nr > 0:
            radius, center = nr, nc
    return float(2.0 * radius)


def circle_features(hc, cfg):
    from .. import native
    n = len(hc.recs)
    out = {k: np.zeros(n) for k in ("DIAMETER_MIN_ENCLOSING_CIRCLE",
                                    "DIAMETER_INSCRIBING_CIRCLE",
                                    "DIAMETER_CIRCUMSCRIBING_CIRCLE")}
    cenx = hc.get_feature("CENTROID_X")
    ceny = hc.get_feature("CENTROID_Y")
    gpts = []
    counts = np.zeros(n, np.int64)
    for i, r in enumerate(hc.recs):
        K = hc.contours[i]
        if K is None or K.shape[0] == 0:
            gpts.append(None)
            continue
        # contour coords -> global (+1 shift retained, reference frame)
        pts = K[:, :2].astype(np.float64)
        pts[:, 0] += r.x0
        pts[:, 1] += r.y0
        gpts.append(pts)
        counts[i] = len(pts)
    rows = np.nonzero(counts)[0]
    if len(rows):
        # inscribing/circumscribing: distances to centroid-1
        # (circle.cpp:219-244), one flat reduceat instead of per-ROI loops
        flat = np.concatenate([gpts[i] for i in rows])
        rep = np.repeat(rows, counts[rows])
        dx = flat[:, 0] - (cenx[rep] - 1)
        dy = flat[:, 1] - (ceny[rep] - 1)
        d = dx * dx + dy * dy
        starts = np.concatenate([[0], np.cumsum(counts[rows])[:-1]])
        out["DIAMETER_INSCRIBING_CIRCLE"][rows] = \
            2 * np.sqrt(np.minimum.reduceat(d, starts))
        out["DIAMETER_CIRCUMSCRIBING_CIRCLE"][rows] = \
            2 * np.sqrt(np.maximum.reduceat(d, starts))
    if native.available():
        out["DIAMETER_MIN_ENCLOSING_CIRCLE"] = \
            native.min_enclosing_circles(gpts)
    else:
        for i, pts in enumerate(gpts):
            if pts is not None:
                out["DIAMETER_MIN_ENCLOSING_CIRCLE"][i] = \
                    _min_enclosing_circle_diam_py(pts[:, 0], pts[:, 1])
    return out


# ---------------------------------------------------------------------------
# geodetic length & thickness (geo_len_thickness.cpp)

def geodetic_features(hc, cfg):
    """GEODETIC_LENGTH / THICKNESS (geo_len_thickness.cpp:18-34).

    Faithful quirk: the reference reads the perimeter into a size_t, so the
    pq-formula runs on the TRUNCATED integer perimeter with INTEGER division
    (p/4, p*p/16, p/2)."""
    n = len(hc.recs)
    perim = hc.get_feature("PERIMETER")
    gl = np.zeros(n)
    th = np.zeros(n)
    for i, r in enumerate(hc.recs):
        p = int(perim[i])
        sq = max(p * p // 16 - float(r.area), 0.0)
        gl[i] = p // 4 + math.sqrt(sq)
        th[i] = p // 2 - gl[i]
    return {"GEODETIC_LENGTH": gl, "THICKNESS": th}


# ---------------------------------------------------------------------------
# neighbors + hexagonality (neighbors.cpp, hexagonality_polygonality.cpp)

_NEIGH_MEMBERS = ("NUM_NEIGHBORS", "PERCENT_TOUCHING",
                  "CLOSEST_NEIGHBOR1_DIST", "CLOSEST_NEIGHBOR1_ANG",
                  "CLOSEST_NEIGHBOR2_DIST", "CLOSEST_NEIGHBOR2_ANG",
                  "ANG_BW_NEIGHBORS_MEAN", "ANG_BW_NEIGHBORS_STDDEV",
                  "ANG_BW_NEIGHBORS_MODE")


def neighbors_features(hc, cfg):
    from .. import native
    if native.available():
        n = len(hc.recs)
        KG = []
        aabbs = np.zeros((n, 4), np.int64)
        for i, r in enumerate(hc.recs):
            K = hc.contours[i]
            if K is None or K.shape[0] == 0:
                KG.append(None)
            else:
                pts = K[:, :2].astype(np.float64)
                pts[:, 0] += r.x0
                pts[:, 1] += r.y0
                KG.append(pts)
            aabbs[i] = (r.x0, r.x1, r.y0, r.y1)
        m = native.neighbors_batch(KG, aabbs, hc.get_feature("CENTROID_X"),
                                   hc.get_feature("CENTROID_Y"),
                                   cfg.pixel_distance)
        return {name: m[:, j].copy() for j, name in enumerate(_NEIGH_MEMBERS)}
    return neighbors_features_py(hc, cfg)


def neighbors_features_py(hc, cfg):
    n = len(hc.recs)
    radius = cfg.pixel_distance
    radius2 = radius * radius
    out = {k: np.zeros(n) for k in _NEIGH_MEMBERS}

    # global contour point arrays
    KG = []
    for i, r in enumerate(hc.recs):
        K = hc.contours[i]
        if K is None or K.shape[0] == 0:
            KG.append(np.zeros((0, 2)))
            continue
        pts = K[:, :2].astype(np.float64)
        pts[:, 0] += r.x0
        pts[:, 1] += r.y0
        KG.append(pts)

    neigh_lists = [[] for _ in range(n)]
    touch_masks = [np.zeros(len(KG[i]), bool) for i in range(n)]

    # collision pairs by AABB-with-radius overlap, upper triangle
    for i1 in range(n):
        r1 = hc.recs[i1]
        for i2 in range(i1 + 1, n):
            r2 = hc.recs[i2]
            if (r1.x0 - radius > r2.x1 or r1.x1 + radius < r2.x0 or
                    r1.y0 - radius > r2.y1 or r1.y1 + radius < r2.y0):
                continue
            K1, K2 = KG[i1], KG[i2]
            if len(K1) == 0 or len(K2) == 0:
                continue
            d2 = ((K1[:, None, :] - K2[None, :, :]) ** 2).sum(-1)
            mind = d2.min()
            touch_masks[i1] |= d2.min(axis=1) <= 2.0
            touch_masks[i2] |= d2.min(axis=0) <= 2.0
            if mind > radius2:
                continue
            out["NUM_NEIGHBORS"][i1] += 1
            out["NUM_NEIGHBORS"][i2] += 1
            neigh_lists[i1].append(i2)
            neigh_lists[i2].append(i1)

    for i in range(n):
        if len(KG[i]):
            out["PERCENT_TOUCHING"][i] = 100.0 * touch_masks[i].sum() / len(KG[i])

    cenx = hc.get_feature("CENTROID_X")
    ceny = hc.get_feature("CENTROID_Y")

    def dir_ang(x1, y1, x2, y2):
        a = math.degrees(math.atan2(y2 - y1, x2 - x1))
        return a + 360.0 if a < 0 else a

    for i in range(n):
        lst = neigh_lists[i]
        if not lst:
            continue
        dists = [math.hypot(cenx[i] - cenx[j], ceny[i] - ceny[j]) for j in lst]
        k1 = int(np.argmin(dists))
        out["CLOSEST_NEIGHBOR1_DIST"][i] = dists[k1]
        out["CLOSEST_NEIGHBOR1_ANG"][i] = dir_ang(cenx[i], ceny[i],
                                                  cenx[lst[k1]], ceny[lst[k1]])
        if len(lst) > 1:
            d2_ = list(dists)
            d2_[k1] = float("inf")
            k2 = int(np.argmin(d2_))
            out["CLOSEST_NEIGHBOR2_DIST"][i] = dists[k2]
            out["CLOSEST_NEIGHBOR2_ANG"][i] = dir_ang(cenx[i], ceny[i],
                                                      cenx[lst[k2]], ceny[lst[k2]])
        angs = [dir_ang(cenx[i], ceny[i], cenx[j], ceny[j]) for j in lst]
        mean = float(np.mean(angs))
        std = (math.sqrt(((np.asarray(angs) - mean) ** 2).sum() / (len(angs) - 1))
               if len(angs) > 2 else 0.0)
        counts = np.zeros(361, np.int64)
        for a in angs:
            counts[max(0, min(360, int(round(a))))] += 1
        out["ANG_BW_NEIGHBORS_MEAN"][i] = mean
        out["ANG_BW_NEIGHBORS_STDDEV"][i] = std
        out["ANG_BW_NEIGHBORS_MODE"][i] = int(np.argmax(counts))
    return out


def hexagonality_features(hc, cfg):
    """HexagonalityPolygonalityFeature (hexagonality_polygonality.cpp:14-120)."""
    n = len(hc.recs)
    NOVAL = -1.0
    out = {k: np.full(n, NOVAL) for k in
           ("POLYGONALITY_AVE", "HEXAGONALITY_AVE", "HEXAGONALITY_STDDEV")}
    neighbors = hc.get_feature("NUM_NEIGHBORS")
    perim_a = hc.get_feature("PERIMETER")
    hull_a = hc.get_feature("CONVEX_HULL_AREA")
    fmin = hc.get_feature("STAT_FERET_DIAM_MIN")
    fmax = hc.get_feature("STAT_FERET_DIAM_MAX")
    for i, r in enumerate(hc.recs):
        nb = int(neighbors[i])
        if nb <= 2:
            continue
        area = float(r.area)
        perimeter = perim_a[i]
        area_hull = hull_a[i]
        perim_hull = 6 * math.sqrt(area_hull / (1.5 * math.sqrt(3)))
        pn = perimeter / nb
        poly_size = 1.0 - abs(1.0 - pn / math.sqrt(4 * area / (nb / math.tan(math.pi / nb))))
        poly_area = 1.0 - abs(1.0 - area / (0.25 * nb * pn * pn / math.tan(math.pi / nb)))
        out["POLYGONALITY_AVE"][i] = 10 * (poly_size + poly_area) / 2

        ap1 = math.sqrt(3) * perimeter / 12
        ap2 = math.sqrt(3) * fmax[i] / 4
        ap3 = fmin[i] / 2
        s1 = perimeter / 6
        s2 = fmax[i] / 2
        s3 = fmin[i] / math.sqrt(3)
        s4 = perim_hull / 6
        areas = [0.5 * 3 * math.sqrt(3) * s1 * s1,
                 0.5 * 3 * math.sqrt(3) * s2 * s2,
                 0.5 * 3 * math.sqrt(3) * s3 * s3,
                 3 * s1 * ap2, 3 * s1 * ap3, 3 * s2 * ap3,
                 3 * s4 * ap1, 3 * s4 * ap2, 3 * s4 * ap3,
                 area_hull, area]
        ratios = []
        for ib in range(len(areas)):
            for ic in range(ib + 1, len(areas)):
                rr = 1.0 - abs(1.0 - areas[ib] / areas[ic]) if areas[ic] else float("nan")
                if math.isfinite(rr):
                    ratios.append(rr)
        am = float(np.mean(ratios))
        asd = math.sqrt(float(np.mean((np.asarray(ratios) - am) ** 2)))

        ap4 = math.sqrt(3) * perim_hull / 12
        ap5 = math.sqrt(4 * area_hull / (4.5 * math.sqrt(3)))
        perims = [math.sqrt(24 * area / math.sqrt(3)),
                  math.sqrt(24 * area_hull / math.sqrt(3)),
                  perimeter, perim_hull, 3 * fmax[i],
                  6 * fmin[i] / math.sqrt(3),
                  2 * area / ap1, 2 * area / ap2, 2 * area / ap3,
                  2 * area / ap4, 2 * area / ap5,
                  2 * area_hull / ap1, 2 * area_hull / ap2, 2 * area_hull / ap3]
        pratios = []
        for ib in range(len(perims)):
            for ic in range(ib + 1, len(perims)):
                pratios.append(1.0 - abs(1.0 - perims[ib] / perims[ic]))
        pm = float(np.mean(pratios))
        psd = math.sqrt(float(np.mean((np.asarray(pratios) - pm) ** 2)))

        out["HEXAGONALITY_AVE"][i] = 10 * (am + pm) / 2
        out["HEXAGONALITY_STDDEV"][i] = math.sqrt((asd * asd + psd * psd) / 2)
    return out


# ---------------------------------------------------------------------------
# ROI radius + radial distribution (roi_radius.cpp, radial_distribution.cpp)
#
# Both consume the reference's APPROXIMATE coarse-to-fine min/max distance
# search over the ordered contour (pixel.cpp:36-143) -- part of the numeric
# contract; exact distances produce systematically different values.

def _approx_contour_dists(hc, i, want_max=False):
    from .. import native
    K = hc.contours[i]
    if K is None or K.shape[0] == 0 or not hc.pixels_ok(i):
        return None, None, None, None
    ys, xs = hc.roi_points(i)
    mind2, maxd2 = native.contour_sqdist_approx(
        xs.astype(np.float64), ys.astype(np.float64),
        K[:, 0].astype(np.float64), K[:, 1].astype(np.float64),
        want_min=True, want_max=want_max)
    return ys, xs, mind2, maxd2


def roi_radius(hc, cfg):
    """ROI_RADIUS_{MEAN,MAX,MEDIAN} (roi_radius.cpp:11-37): statistics of the
    per-pixel approximate min SQUARED distance to the merged contour; the
    median is over uint-truncated values (TrivialHistogram, histogram.h:352)."""
    g = _geom(hc)
    if g is not None:
        return {"ROI_RADIUS_MEAN": g[:, _GC_RRAD].copy(),
                "ROI_RADIUS_MAX": g[:, _GC_RRAD + 1].copy(),
                "ROI_RADIUS_MEDIAN": g[:, _GC_RRAD + 2].copy()}
    n = len(hc.recs)
    out = {k: np.zeros(n) for k in
           ("ROI_RADIUS_MEAN", "ROI_RADIUS_MAX", "ROI_RADIUS_MEDIAN")}
    for i in range(n):
        _, _, mind2, _ = _approx_contour_dists(hc, i)
        if mind2 is None or len(mind2) == 0:
            continue
        out["ROI_RADIUS_MEAN"][i] = mind2.mean()
        out["ROI_RADIUS_MAX"][i] = mind2.max()
        d = np.sort(mind2.astype(np.uint32))
        h = len(d) // 2
        out["ROI_RADIUS_MEDIAN"][i] = (float(d[h]) if len(d) % 2 else
                                       (float(d[h]) + float(d[h - 1])) / 2.0)
    return out


def radial_distribution(hc, cfg):
    """FRAC_AT_D / MEAN_FRAC / RADIAL_CV (radial_distribution.cpp:43-165).

    Center = cloud pixel minimizing (approx max d2 - approx min d2) to the
    contour; 8 radial bins scaled by sqrt(approx max d2 at the center);
    8 angular wedges for the CV."""
    g = _geom(hc)
    if g is not None:
        return {"FRAC_AT_D": g[:, _GC_FRAC_AT_D:_GC_FRAC_AT_D + 8].copy(),
                "MEAN_FRAC": g[:, _GC_MEAN_FRAC:_GC_MEAN_FRAC + 8].copy(),
                "RADIAL_CV": g[:, _GC_RADIAL_CV:_GC_RADIAL_CV + 8].copy()}
    n = len(hc.recs)
    nb = 8
    eps = 1e-9
    out = {k: np.full((n, nb), -0.0) for k in
           ("FRAC_AT_D", "MEAN_FRAC", "RADIAL_CV")}
    for i in range(n):
        ys, xs, mind2, maxd2 = _approx_contour_dists(hc, i, want_max=True)
        if mind2 is None or len(mind2) == 0:
            continue
        ii, _ = hc.pair_crop(i)
        inten = ii[ys, xs]
        idxO = int(np.argmin(maxd2 - mind2))
        cx, cy = int(xs[idxO]), int(ys[idxO])
        dstOC = math.sqrt(maxd2[idxO])
        dx = (xs - cx).astype(np.float64)
        dy = (ys - cy).astype(np.float64)
        dstOA = np.sqrt(dx * dx + dy * dy)
        with np.errstate(divide="ignore", invalid="ignore"):
            rat = dstOA / dstOC if dstOC > 0 else np.zeros_like(dstOA)
        bi = np.minimum((rat * (nb - 1)).astype(np.int64), nb - 1)
        ang = np.arctan2(dy, dx)
        ang = np.where(ang < 0, 2.0 * math.pi + ang, ang)
        wbin = np.minimum((ang / (2.0 * math.pi / nb)).astype(np.int64),
                          nb - 1)
        counts = np.bincount(bi, minlength=nb).astype(np.float64)
        intbins = np.bincount(bi, weights=inten, minlength=nb)
        wedges = np.zeros((nb, nb))
        np.add.at(wedges, (bi, wbin), inten)
        out["FRAC_AT_D"][i] = counts / (len(xs) + eps)
        out["MEAN_FRAC"][i] = intbins / (counts + eps)
        wmean = wedges.sum(axis=1) / nb
        wvar = ((wedges - wmean[:, None]) ** 2).sum(axis=1) / nb
        out["RADIAL_CV"][i] = np.sqrt(wvar) / (wmean + eps)
    return out
