"""IMQ family tests: focus score vs direct numpy, saturation exactness."""

import numpy as np
import pytest
from scipy import signal

from nyxus_tpu import ImageQuality


@pytest.fixture(scope="module")
def imq_df():
    r = np.random.default_rng(11)
    img = r.integers(0, 4000, (48, 56)).astype(np.uint16)
    df = ImageQuality().featurize(img)
    return img, df.iloc[0]


def test_focus_score(imq_df):
    img, row = imq_df
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], float)
    lap = signal.convolve2d(img.astype(float), k, mode="same", boundary="fill")
    a = np.abs(lap)
    want = ((a - a.mean()) ** 2).mean()
    assert row.FOCUS_SCORE == pytest.approx(want, rel=1e-9)


def test_local_focus_score_quadrant(imq_df):
    """Even dims: the reference's tile loop visits only the top-left tile."""
    img, row = imq_df
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], float)
    tile = img[:24, :28].astype(float)
    lap = signal.convolve2d(tile, k, mode="same", boundary="fill")
    a = np.abs(lap)
    want = ((a - a.mean()) ** 2).mean() / 4
    assert row.LOCAL_FOCUS_SCORE == pytest.approx(want, rel=1e-9)


def test_saturation(imq_df):
    img, row = imq_df
    assert row.MIN_SATURATION == (img == img.min()).sum() / img.size
    assert row.MAX_SATURATION == (img == img.max()).sum() / img.size


def test_sharpness_finite(imq_df):
    img, row = imq_df
    assert np.isfinite(row.SHARPNESS) and row.SHARPNESS >= 0
    assert np.isfinite(row.POWER_SPECTRUM_SLOPE)


def test_imq_oversized_streamed_parity():
    """Forced-oversized (ram_limit=1) IMQ matches the in-memory trivial
    path for all four families -- the reference's phase-3 coverage is
    focus+saturation only (power_spectrum.h:28 / sharpness.h:32 are empty
    stubs), and its osized focus score even diverges from its own trivial
    algorithm; this build streams all four consistently
    (pipeline/imq_streamed.py)."""
    from nyxus_tpu.api import ImageQuality
    r = np.random.default_rng(5)
    img = r.integers(1, 4000, (300, 400)).astype(np.uint16)
    lab = np.zeros((300, 400), np.uint16)
    lab[20:280, 30:370] = 7
    mem = ImageQuality(precision="f64").featurize(img, lab)
    st = ImageQuality(precision="f64", ram_limit=1).featurize(img, lab)
    assert list(mem.ROI_label) == list(st.ROI_label)
    tol = {"SHARPNESS": 1e-6, "POWER_SPECTRUM_SLOPE": 1e-6}
    for c in ("FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "MIN_SATURATION",
              "MAX_SATURATION", "SHARPNESS", "POWER_SPECTRUM_SLOPE"):
        np.testing.assert_allclose(st[c].to_numpy(), mem[c].to_numpy(),
                                   rtol=tol.get(c, 1e-9), err_msg=c)


def test_imq_oversized_small_blocks():
    """Block-row streaming with tiny blocks (forces halo/boundary code)."""
    from nyxus_tpu.pipeline import imq_streamed as oimq
    from nyxus_tpu.pipeline.labels import RoiRecord
    from nyxus_tpu.pipeline.sources import ArrayPairSource
    from nyxus_tpu.ops import imq as trivial
    r = np.random.default_rng(9)
    img = r.integers(0, 900, (61, 47)).astype(np.uint16)
    lab = np.zeros((61, 47), np.uint16)
    lab[3:58, 2:45] = 3
    src = ArrayPairSource(img, lab)
    rec = RoiRecord(3, int((lab == 3).sum()), 3, 57, 2, 44, 0, 0)
    crop = np.where(lab[3:58, 2:45] == 3, img[3:58, 2:45], 0).astype(float)
    for block in (7, 16, 64):
        fs = oimq.focus_score_streamed(rec, src, block)
        tfs, tlfs = trivial.focus_score(crop)
        assert fs["FOCUS_SCORE"] == pytest.approx(tfs, rel=1e-9)
        assert fs["LOCAL_FOCUS_SCORE"] == pytest.approx(tlfs, rel=1e-9)
        sat = oimq.saturation_streamed(rec, src, block)
        tmn, tmx = trivial.saturation(crop)
        assert sat["MIN_SATURATION"] == tmn and sat["MAX_SATURATION"] == tmx
        sh = oimq.sharpness_streamed(rec, src, block)
        assert sh["SHARPNESS"] == pytest.approx(trivial.sharpness(crop),
                                                rel=1e-7)
        ps = oimq.power_spectrum_streamed(rec, src, np.float64, block)
        assert ps["POWER_SPECTRUM_SLOPE"] == pytest.approx(
            trivial.power_spectrum_slope(crop), rel=1e-6)


def test_imq_config_invariance_and_hu():
    """IMQ across engine configs: ibsi/radiomics binning modes do not
    touch the IMQ math (invariance pins that), whole-image mode (no label
    image) is the family's wholeslide form, and preserve_hu shifts the
    input domain by the floored slide min before the same math."""
    from nyxus_tpu.api import ImageQuality
    r = np.random.default_rng(12)
    img = r.integers(1, 3000, (96, 128)).astype(np.uint16)
    cols = ["FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "MIN_SATURATION",
            "MAX_SATURATION", "SHARPNESS", "POWER_SPECTRUM_SLOPE"]
    base = ImageQuality(precision="f64").featurize(img)       # wholeslide
    for kw in (dict(ibsi=True), dict(coarse_gray_depth=-32)):
        alt = ImageQuality(precision="f64", **kw).featurize(img)
        for c in cols:
            np.testing.assert_allclose(alt[c], base[c], rtol=0, atol=0,
                                       err_msg="%s under %r" % (c, kw))
    # preserve_hu on a signed HU-like image: u = round(x - floor(min));
    # the same offset applied by hand must reproduce every member
    hu = img.astype(np.int32) - 900
    got = ImageQuality(precision="f64", preserve_hu=True).featurize(hu)
    off = np.floor(hu.min())
    shifted = np.maximum(np.round(hu - off), 0).astype(np.uint32)
    exp = ImageQuality(precision="f64").featurize(shifted)
    for c in cols:
        np.testing.assert_allclose(got[c], exp[c], rtol=1e-12, err_msg=c)


def test_imagequality_file_surface(tmp_path):
    """ImageQuality now carries the full Nyxus file surface (reference:
    nyxus.py ImageQuality.featurize_directory/featurize_files): a
    directory run without masks = whole-image quality per slide."""
    from nyxus_tpu import native
    if not native.tiff_available():
        pytest.skip("native toolchain unavailable")
    from nyxus_tpu.api import ImageQuality
    r = np.random.default_rng(3)
    d = tmp_path / "imgs"
    d.mkdir()
    imgs = {}
    for k in range(2):
        img = r.integers(1, 2000, (64, 80)).astype(np.uint16)
        native.write_tiff(str(d / ("a%d.tif" % k)), img, tile_size=64)
        imgs["a%d.tif" % k] = img
    iq = ImageQuality(precision="f64")
    df = iq.featurize_directory(str(d), None)
    assert len(df) == 2
    import os
    for _, row in df.iterrows():
        img = imgs[os.path.basename(row.intensity_image)]
        # whole-slide virtual ROI: the reference's INCLUSIVE one-past AABB
        # (aabb.h:53-59) pads one empty row+col into the frame, so the
        # frame min is 0 and the counts divide by (H+1)*(W+1)
        H, W = img.shape
        frame = np.zeros((H + 1, W + 1))
        frame[:H, :W] = img
        assert row.MIN_SATURATION == \
            (frame == frame.min()).sum() / frame.size
        assert row.MAX_SATURATION == \
            (frame == frame.max()).sum() / frame.size
    # explicit file lists + params surface
    files = [str(d / "a0.tif"), str(d / "a1.tif")]
    df2 = iq.featurize_files(files, None, single_roi=True)
    assert len(df2) == 2
    assert iq.get_params()["features"] == ["*ALL_IMQ*"]


def test_imq_anisotropy_virtual_slide():
    """IMQ under --anisox/--anisoy: like every family, the IMQ features
    read the NN-resampled VIRTUAL slide (reference: the virtual-slide
    rescan applies to all families, phase2_2d.cpp:183-285; aniso map is
    truncation+clamp).  Oracle: resample the image with the engine's own
    index map and run the plain (non-aniso) engine on it -- the 6 IMQ
    columns must agree exactly."""
    r = np.random.default_rng(31)
    img = r.integers(0, 3000, (40, 52)).astype(np.uint16)

    # whole-image quality (the ImageQuality default: one ROI covering the
    # slide) so the scaled AABB and the natural virtual AABB coincide and
    # the oracle needs no AABB-rounding reproduction
    ax, ay = 2.0, 1.5
    got = ImageQuality(anisotropy_x=ax, anisotropy_y=ay).featurize(img)

    H, W = img.shape
    vH, vW = int(H * ay), int(W * ax)
    pr = np.minimum((np.arange(vH) / ay).astype(np.int64), H - 1)
    pc = np.minimum((np.arange(vW) / ax).astype(np.int64), W - 1)
    vimg = np.ascontiguousarray(img[pr][:, pc])
    want = ImageQuality().featurize(vimg)

    assert list(got.ROI_label) == list(want.ROI_label)
    for c in ("FOCUS_SCORE", "LOCAL_FOCUS_SCORE", "POWER_SPECTRUM_SLOPE",
              "MIN_SATURATION", "MAX_SATURATION", "SHARPNESS"):
        np.testing.assert_allclose(got[c].to_numpy(float),
                                   want[c].to_numpy(float),
                                   rtol=1e-12, atol=0, err_msg=c)
