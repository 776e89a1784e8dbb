"""Matmul precision is pinned in the engine: every dot_general and
convolution the f32 programs lower to carries HIGHEST precision, so a GPU
runs them as full f32 products and never in TF32.

The programs are lowered (not compiled) on the CPU: the 2D universal slide
program (``*ALL*``), the 3D program (``*3D_ALL*``) and the streamed
phase-3 finish stages."""

import re

import numpy as np
import pytest

from conftest import make_blobs, make_blobs3d

_OPS = re.compile(r"stablehlo\.(?:dot_general|convolution)\b[^\n]*")


class _Lowered(Exception):
    """Raised in place of the first call of a jitted program once its
    StableHLO text is recorded."""


def _lower_first_call(monkeypatch, module, name, run):
    orig = getattr(module, name)
    texts = []

    def record(*args, **kwargs):
        texts.append(orig.lower(*args, **kwargs).as_text())
        raise _Lowered

    monkeypatch.setattr(module, name, record)
    with pytest.raises(_Lowered):
        run()
    return texts


def _slide_2d(monkeypatch):
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline import runner

    intens, labels = make_blobs(96, 96, n_blobs=5, seed=2)
    pr = runner.PairRunner(tx.parse_feature_request(["*ALL*"]),
                           EngineConfig(precision="f32"))
    return _lower_first_call(monkeypatch, runner, "_extract_slide_fused",
                             lambda: pr.run(intens, labels))


def _volume_3d(monkeypatch):
    from nyxus_tpu import taxonomy as tx
    from nyxus_tpu.config import EngineConfig
    from nyxus_tpu.pipeline import runner3d

    intens, labels = make_blobs3d()
    vr = runner3d.VolumeRunner(
        tx.parse_feature_request(["*3D_ALL*"], dim=3),
        EngineConfig(precision="f32"))
    return _lower_first_call(monkeypatch, runner3d, "_extract3d",
                             lambda: vr.run(intens, labels))


def _finish_stages(monkeypatch):
    from nyxus_tpu import Nyxus
    from nyxus_tpu.pipeline import oversized

    texts = []

    class Recording(dict):
        """_FINISH_JIT stand-in: each new finish jit records its lowering
        on every call, then runs."""

        def __setitem__(self, key, fn):
            def call(*args):
                texts.append(fn.lower(*args).as_text())
                return fn(*args)
            super().__setitem__(key, call)

    monkeypatch.setattr(oversized, "_FINISH_JIT", Recording())
    r = np.random.default_rng(4)
    intens = r.integers(1, 3000, (320, 320)).astype(np.uint16)
    yy, xx = np.mgrid[0:320, 0:320]
    labels = (((yy - 160) ** 2 + (xx - 160) ** 2) <= 140 ** 2).astype(
        np.int32) * 4                       # 512^2 bucket: oversized at 1 MB
    feats = ["*ALL_INTENSITY*", "*ALL_GLCM*", "*ALL_GLRLM*", "*ALL_GLSZM*",
             "*ALL_GLDZM*", "*ALL_GLDM*", "*ALL_NGLDM*", "*ALL_NGTDM*"]
    df = Nyxus(feats, ram_limit=1, precision="f32").featurize(intens, labels)
    assert list(df.ROI_label) == [4]
    return texts


@pytest.mark.parametrize("program", ["slide_2d", "volume_3d",
                                     "finish_stages"])
def test_dots_and_convolutions_run_at_highest(monkeypatch, program):
    build = {"slide_2d": _slide_2d, "volume_3d": _volume_3d,
             "finish_stages": _finish_stages}[program]
    texts = build(monkeypatch)
    ops = [m.group(0) for t in texts for m in _OPS.finditer(t)]
    assert ops, "no dot_general/convolution lowered for %s" % program
    loose = [op for op in ops if "HIGHEST" not in op]
    assert not loose, "%d of %d ops below HIGHEST, e.g. %s" % (
        len(loose), len(ops), loose[0][:300])
