"""Parity tests: batched intensity kernel vs the independent numpy oracle."""

import numpy as np
import pytest

from nyxus_tpu import Nyxus
from nyxus_tpu import taxonomy as tx
from nyxus_tpu.config import EngineConfig
from nyxus_tpu.pipeline.runner import PairRunner

import oracle_intensity as oracle

RTOL = 1e-9  # fp64 on CPU in tests


@pytest.fixture(scope="module")
def extracted(blob_pair):
    intens, labels = blob_pair
    cfg = EngineConfig(precision="f64")
    fset = tx.parse_feature_request(["*ALL_INTENSITY*", "HISTOGRAM"])
    runner = PairRunner(fset, cfg)
    labs, values = runner.run(intens, labels)
    from nyxus_tpu import columns as col
    cols, _ = col.build_header(fset, cfg)
    return intens, labels, labs, values, cols[4:], cfg


def test_all_members_match_oracle(extracted):
    intens, labels, labs, values, colnames, cfg = extracted
    assert len(labs) > 5
    # slide extrema over MASKED pixels only (slideprops.cpp:146-162)
    masked = intens[labels != 0]
    slide_range = float(masked.max() - masked.min())
    for i, lab in enumerate(labs):
        v = intens[labels == lab].astype(np.float64)
        ref = oracle.intensity_features(v, slide_range, cfg.coarse_gray_depth)
        row = dict(zip(colnames, values[i]))
        for key in oracle.ALL_KEYS:
            got = row[key]
            want = ref[key]
            assert got == pytest.approx(want, rel=RTOL, abs=1e-9), (
                "feature %s: lab=%d got=%r want=%r" % (key, lab, got, want))
        hist = np.array([row["HISTOGRAM_BIN_%d" % k]
                         for k in range(cfg.coarse_gray_depth)])
        np.testing.assert_allclose(hist, ref["HISTOGRAM"], rtol=0, atol=0)


def test_blank_roi_gets_softnan():
    intens = np.zeros((32, 32), np.uint16)
    labels = np.zeros((32, 32), np.int32)
    labels[4:10, 4:10] = 7  # all-zero intensity ROI
    intens[20, 20] = 55
    labels[20, 20] = 9      # single-pixel ROI (min == max, nonzero)
    nyx = Nyxus(["MEAN", "VARIANCE", "MIN", "RANGE"])
    df = nyx.featurize(intens, labels)
    r7 = df[df.ROI_label == 7].iloc[0]
    assert r7.MEAN == 0 and r7.MIN == 0 and r7.RANGE == 0
    assert r7.VARIANCE == -0.0
    r9 = df[df.ROI_label == 9].iloc[0]
    assert r9.MEAN == 55 and r9.MIN == 55 and r9.RANGE == 0


def test_montage_api_dataframe(blob_pair):
    intens, labels = blob_pair
    nyx = Nyxus(["MEAN", "MAX", "MIN"])
    stack_i = np.stack([intens, intens])
    stack_l = np.stack([labels, labels])
    df = nyx.featurize(stack_i, stack_l)
    n_roi = len(np.unique(labels)) - 1
    assert len(df) == 2 * n_roi
    assert list(df.columns[:4]) == ["intensity_image", "mask_image", "ROI_label", "t_index"]
    assert (df.intensity_image.iloc[0], df.intensity_image.iloc[-1]) == ("Intensity0", "Intensity1")
    # rows of the two identical images must agree
    a = df[df.intensity_image == "Intensity0"].MEAN.to_numpy()
    b = df[df.intensity_image == "Intensity1"].MEAN.to_numpy()
    np.testing.assert_array_equal(a, b)


def test_f32_precision_close(blob_pair):
    """The production f32 kernels agree with f64 within loose tolerance."""
    intens, labels = blob_pair
    fset = tx.parse_feature_request(["*ALL_INTENSITY*"])
    r64 = PairRunner(fset, EngineConfig(precision="f64"))
    r32 = PairRunner(fset, EngineConfig(precision="f32"))
    _, v64 = r64.run(intens, labels)
    _, v32 = r32.run(intens, labels)
    # percentile interpolation and entropy are the loosest in f32
    np.testing.assert_allclose(v32, v64, rtol=2e-2, atol=1e-4)
