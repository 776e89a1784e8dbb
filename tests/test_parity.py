"""nyxus_tpu.parity: the comparison rules shared by the tests and
chip_smoke.py."""

import numpy as np
import pandas as pd

from nyxus_tpu import parity


def _frame(**cols):
    return pd.DataFrame(cols, index=pd.Index([1, 2, 3], name="ROI_label"))


def test_allclose_rules():
    raw = [4e6, 1e8, 5e5]                   # IMOM_RM_01 of each ROI
    ref = _frame(MEAN=[1.0, 2.0, np.nan], SHARPNESS=[1.0, 1.0, 1.0],
                 IMOM_CM_01=[0.0, 0.0, 0.0], IMOM_RM_01=raw)
    # rounding-level differences, NaN against NaN, FP residue of a zero
    # (judged relative to the raw first moment it cancels from)
    dev = _frame(MEAN=[1.0 + 1e-12, 2.0, np.nan],
                 SHARPNESS=[1.0 + 5e-7, 1.0, 1.0],
                 IMOM_CM_01=[3e-10, -2e-8, 0.0], IMOM_RM_01=raw)
    res = parity.compare_allclose(dev, ref, ["MEAN", "SHARPNESS",
                                             "IMOM_CM_01"],
                                  rtol={"SHARPNESS": 1e-6})
    assert res.ok and res.checked == 3, res
    # beyond the column's rtol, a NaN against a number, a zero gone large
    # against its raw moment (1e-3 / 5e5 = 2e-9 > 1e-9)
    bad = _frame(MEAN=[1.0, 2.0, 3.0], SHARPNESS=[1.0 + 5e-6, 1.0, 1.0],
                 IMOM_CM_01=[0.0, 0.0, 1e-3], IMOM_RM_01=raw)
    res = parity.compare_allclose(bad, ref, ["MEAN", "SHARPNESS",
                                             "IMOM_CM_01"],
                                  rtol={"SHARPNESS": 1e-6})
    assert sorted(c for c, _, _ in res.failures) == [
        "IMOM_CM_01", "MEAN", "SHARPNESS"]


def test_f32_tiers_take_the_longest_prefix():
    assert parity.f32_tol("GLCM_CLUSHADE_AVE") == 2e-1
    assert parity.f32_tol("GLCM_ACOR_AVE") == 5e-3
    assert parity.f32_tol("PERIMETER") == parity.F32_TOL
    ref = _frame(GLCM_ACOR_AVE=[1.0, 1.0, 1.0], MEDIAN=[1.0, 2.0, 3.0])
    dev = _frame(GLCM_ACOR_AVE=[1.004, 1.0, 1.0], MEDIAN=[9.0, 9.0, 9.0])
    res = parity.compare_f32(dev, ref)      # MEDIAN is DISCRETE: exempt
    assert res.ok and res.checked == 1, res
