"""Label discovery: per-ROI metrics from a labeled mask (phase-1 equivalent).

The reference streams tiles and updates per-label records pixel-by-pixel
(reference: src/nyx/phase1.cpp:24-124, pixel_feed.cpp).  Here a whole
in-memory pair is reduced at once with vectorized segment reductions; the
tiled/streamed variant reuses the same per-tile reduction and merges partial
records across tiles (and across devices via psum when sharded).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RoiRecord:
    """Per-ROI metrics gathered in phase 1 (reference: roi_cache.h:30-74)."""
    label: int
    area: int
    y0: int
    y1: int  # inclusive
    x0: int
    x1: int  # inclusive
    vmin: float
    vmax: float
    # anisotropy only: the apply_anisotropy-scaled AABB reported by BBOX_*
    # (may be SMALLER than y0..x1, which is widened to cover every virtual
    # member pixel -- the reference feeds those into raw_pixels even when
    # they fall outside its scaled AABB; see aniso_bbox)
    report_bbox: tuple | None = None

    @property
    def height(self):
        return self.y1 - self.y0 + 1

    @property
    def width(self):
        return self.x1 - self.x0 + 1


def aniso_bbox(rec: RoiRecord, ax: float, ay: float,
               natural=None) -> RoiRecord:
    """Scale a physical AABB onto the virtual (anisotropic) grid using the
    reference's exact truncation + max-edge fixup arithmetic
    (AABB::apply_anisotropy, features/aabb.h:115-134).  ``area``/``vmin``/
    ``vmax`` keep their PHYSICAL phase-1 values: the reference's aux_area /
    aux_min / aux_max are set during the physical prescan and are never
    recomputed on the virtual grid (slideprops.cpp:176-193).

    ``natural`` (y0, y1, x0, x1): the virtual-grid bounding box of the
    ROI's actual member pixels.  The one-step max-edge fixup can still leave
    the last virtual column/row of members OUTSIDE the scaled AABB (e.g.
    ax=1.4: physical xmax=5 maps to virtual {7, 8}, scaled xmax fixes up to
    only 7); the reference nevertheless feeds those pixels into raw_pixels
    (scanTrivialRois_anisotropic, phase2_2d.cpp:258-282 -- and writes them
    OUT OF BOUNDS in its image matrix).  The crop box is widened to the
    union so every fed pixel is present; BBOX_* report the scaled box via
    ``report_bbox``."""
    x0, y0 = int(rec.x0 * ax), int(rec.y0 * ay)
    x1 = int(rec.x1 * ax)
    if int((x1 + 1) / ax) == rec.x1:
        x1 += 1
    y1 = int(rec.y1 * ay)
    if int((y1 + 1) / ay) == rec.y1:
        y1 += 1
    report = (y0, y1, x0, x1)
    if natural is not None:
        ny0, ny1, nx0, nx1 = natural
        y0, x0 = min(y0, ny0), min(x0, nx0)
        y1, x1 = max(y1, ny1), max(x1, nx1)
    return RoiRecord(rec.label, rec.area, y0, y1, x0, x1, rec.vmin, rec.vmax,
                     report_bbox=report)


def _native_labels_ok(labels: np.ndarray) -> bool:
    """The native one-pass scan reads labels as int32; values >= 2**31
    (legal in uint32/uint64 label schemes, e.g. encoded raster indices)
    would wrap negative and silently mismatch every pixel.  Cheap dtypes
    pass by construction; wide dtypes pay one max() scan."""
    if labels.dtype.kind == "b":
        return True
    if labels.dtype.kind in "iu" and labels.dtype.itemsize <= 2:
        return True
    if labels.dtype == np.int32:
        return True
    return labels.size == 0 or int(labels.max()) < 2 ** 31


def discover_rois_clouds(intens: np.ndarray, labels: np.ndarray):
    """discover_rois + concatenated raster-order pixel clouds per label
    (native one-pass kernel; clouds is None on the numpy fallback).
    Returns (records, slide_min, slide_max, clouds)."""
    from .. import native
    if native.available() and _native_labels_ok(labels):
        rm, fmm, smin, smax, clouds = native.discover(
            labels, intens, want_clouds=True, labels_validated=True)
        recs = [RoiRecord(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                          int(r[4]), int(r[5]), float(fmm[i, 0]),
                          float(fmm[i, 1])) for i, r in enumerate(rm)]
        if not recs:
            return recs, float(np.asarray(intens).min(initial=0)), \
                float(np.asarray(intens).max(initial=0)), None
        return recs, smin, smax, clouds
    recs, smin, smax = discover_rois(intens, labels)
    return recs, smin, smax, None


def discover_rois(intens: np.ndarray, labels: np.ndarray):
    """Find all nonzero labels and their metrics. Returns (records, slide_min,
    slide_max) with records sorted by ascending label."""
    from .. import native
    if native.available() and _native_labels_ok(labels):
        rm, fmm, smin, smax, _ = native.discover(labels, intens,
                                                 labels_validated=True)
        recs = [RoiRecord(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                          int(r[4]), int(r[5]), float(fmm[i, 0]),
                          float(fmm[i, 1])) for i, r in enumerate(rm)]
        if not recs:
            return recs, float(np.asarray(intens).min(initial=0)), \
                float(np.asarray(intens).max(initial=0))
        return recs, smin, smax
    return _discover_rois_np(intens, labels)


def _discover_rois_np(intens: np.ndarray, labels: np.ndarray):
    """Vectorized numpy fallback (parity oracle for the native kernel)."""
    labels = np.asarray(labels)
    intens = np.asarray(intens)
    H, W = labels.shape
    flat_lab = labels.ravel()
    flat_int = intens.ravel().astype(np.float64)

    nz = flat_lab != 0
    labs = flat_lab[nz]
    vals = flat_int[nz]
    if labs.size == 0:
        return [], float(intens.min(initial=0)), float(intens.max(initial=0))

    uniq, inv = np.unique(labs, return_inverse=True)
    k = uniq.size
    area = np.bincount(inv, minlength=k)

    vmin = np.full(k, np.inf)
    vmax = np.full(k, -np.inf)
    np.minimum.at(vmin, inv, vals)
    np.maximum.at(vmax, inv, vals)

    yy, xx = np.divmod(np.nonzero(nz)[0], W)
    y0 = np.full(k, H, dtype=np.int64)
    y1 = np.full(k, -1, dtype=np.int64)
    x0 = np.full(k, W, dtype=np.int64)
    x1 = np.full(k, -1, dtype=np.int64)
    np.minimum.at(y0, inv, yy)
    np.maximum.at(y1, inv, yy)
    np.minimum.at(x0, inv, xx)
    np.maximum.at(x1, inv, xx)

    recs = [
        RoiRecord(int(uniq[i]), int(area[i]), int(y0[i]), int(y1[i]),
                  int(x0[i]), int(x1[i]), float(vmin[i]), float(vmax[i]))
        for i in range(k)
    ]
    # slide min/max over MASKED pixels only: the reference's prescan skips
    # non-mask pixels (slideprops.cpp:146-162 'if (!msk) continue')
    return recs, float(vals.min()), float(vals.max())


def discover_rois_streamed(source, tile: int = 2048):
    """Tile-streamed phase 1 over a pair source: per-tile segment reductions
    merged across tiles, so RAM stays O(tile^2) regardless of slide size.
    ROIs spanning tile boundaries accumulate into one record (the reference's
    cross-tile LR merge, phase1.cpp:64-88).

    Per-tile partials come from the native one-pass kernel when available
    (numpy unique/scatter fallback below).  A DEVICE-side variant (psum
    segment reduction over a tile-sharded mesh, as exercised by
    __graft_entry__.dryrun_multichip) only pays off when the tiles already
    live in device memory, so the host kernel is the production path
    (ROADMAP D2).

    Returns (records sorted by label, slide_min, slide_max)."""
    from .. import native
    use_native = native.available()
    H, W = source.shape
    parts = []                 # per-tile (uniq, area, y0, y1, x0, x1, mn, mx)
    smin, smax = np.inf, -np.inf
    for ty in range(0, H, tile):
        th = min(tile, H - ty)
        for tx in range(0, W, tile):
            tw = min(tile, W - tx)
            ii, ll = source.read_pair(ty, tx, th, tw)
            if use_native and _native_labels_ok(ll):
                rm, fmm, tmin, tmax, _ = native.discover(
                    ll, ii, labels_validated=True)
                if not len(rm):
                    continue
                smin = min(smin, tmin)
                smax = max(smax, tmax)
                parts.append((rm[:, 0], rm[:, 1], rm[:, 2] + ty,
                              rm[:, 3] + ty, rm[:, 4] + tx, rm[:, 5] + tx,
                              fmm[:, 0], fmm[:, 1]))
                continue
            flat_lab = ll.ravel()
            nz = flat_lab != 0
            if not nz.any():
                continue
            labs = flat_lab[nz]
            vals = ii.ravel()[nz]
            # masked-pixels-only slide extrema (slideprops.cpp:146-162)
            smin = min(smin, float(vals.min()))
            smax = max(smax, float(vals.max()))
            uniq, inv = np.unique(labs, return_inverse=True)
            k = uniq.size
            area = np.bincount(inv, minlength=k)
            vmin = np.full(k, np.inf)
            vmax = np.full(k, -np.inf)
            np.minimum.at(vmin, inv, vals)
            np.maximum.at(vmax, inv, vals)
            yy, xx = np.divmod(np.nonzero(nz)[0], tw)
            y0 = np.full(k, th, np.int64)
            y1 = np.full(k, -1, np.int64)
            x0 = np.full(k, tw, np.int64)
            x1 = np.full(k, -1, np.int64)
            np.minimum.at(y0, inv, yy)
            np.maximum.at(y1, inv, yy)
            np.minimum.at(x0, inv, xx)
            np.maximum.at(x1, inv, xx)
            parts.append((uniq, area, y0 + ty, y1 + ty, x0 + tx, x1 + tx,
                          vmin, vmax))
    if not parts:
        return ([], 0.0 if np.isinf(smin) else smin,
                0.0 if np.isinf(smax) else smax)

    # merge per-tile partials by label (second segment reduction)
    cat = [np.concatenate([p[j] for p in parts]) for j in range(8)]
    uniq, inv = np.unique(cat[0], return_inverse=True)
    k = uniq.size
    area = np.zeros(k, np.int64)
    np.add.at(area, inv, cat[1])
    y0 = np.full(k, H, np.int64)
    y1 = np.full(k, -1, np.int64)
    x0 = np.full(k, W, np.int64)
    x1 = np.full(k, -1, np.int64)
    vmin = np.full(k, np.inf)
    vmax = np.full(k, -np.inf)
    np.minimum.at(y0, inv, cat[2])
    np.maximum.at(y1, inv, cat[3])
    np.minimum.at(x0, inv, cat[4])
    np.maximum.at(x1, inv, cat[5])
    np.minimum.at(vmin, inv, cat[6])
    np.maximum.at(vmax, inv, cat[7])
    recs = [
        RoiRecord(int(uniq[i]), int(area[i]), int(y0[i]), int(y1[i]),
                  int(x0[i]), int(x1[i]), float(vmin[i]), float(vmax[i]))
        for i in range(k)
    ]
    return recs, smin, smax
