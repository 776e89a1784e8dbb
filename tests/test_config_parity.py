"""Reference-binary parity for NON-default engine configurations: IBSI mode
and radiomics binning (the per-config vetting matrix's thin columns,
VERDICT r2 weak #5 follow-through).

Fixtures: tests/data/ref_{ibsi,radiomics}_320x320_seed11.csv.gz -- the
reference CLI's `*ALL*` CSV on the parity slide with intensities compressed
to 1..59 (IBSI raw mode sizes matrix axes by the max integer intensity) and
--ibsi=true / --coarseGrayDepth=-32 respectively.  Regenerate with
tools/gen_config_fixtures.py.
"""

import gzip
import os
import sys

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from nyxus_tpu import columns as col  # noqa: E402
from nyxus_tpu import parity  # noqa: E402
from nyxus_tpu import taxonomy as tx  # noqa: E402
from nyxus_tpu.config import EngineConfig  # noqa: E402
from nyxus_tpu.pipeline.runner import PairRunner  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

from nyxus_tpu.parity import LOOSE, REF_TOL, ZERO_BY_CONSTRUCTION  # noqa: E402

# full fixture sweeps: heavy; the quick per-commit tier deselects these
import pytest as _pt
pytestmark = _pt.mark.nightly

# Families whose radiomics-binning behavior in the reference binary is a
# DEFECT, not a semantic (verified in source):
# * GLDZM_*: the binary emits the fvals default 0.0 for every ROI under
#   --coarseGrayDepth<0 (internal failure; gldzm.cpp's matrix kit mishandles
#   the negative grey depth) -- this engine computes real zone statistics.
# * NGLDM_*: ngldm.cpp passes the negative grey depth into to_grayscale's
#   UNSIGNED n_levels parameter (helpers.h:337-345), wrapping -32 to
#   2^32-32: binning degenerates to per-raw-intensity levels with ~1e7-scale
#   grey values in the weighted members -- this engine bins to |n| levels.
RADIOMICS_REFERENCE_DEFECTS = ("GLDZM_", "NGLDM_")


def _run(cfg_kwargs, ibsi):
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    intens = (intens % 59 + 1).astype(np.uint16)
    cfg = EngineConfig(precision="f64", **cfg_kwargs)
    fset = tx.parse_feature_request(["*ALL*"], ibsi=ibsi)
    runner = PairRunner(fset, cfg)
    labs, values = runner.run(intens, labels)
    cols, _ = col.build_header(fset, cfg)
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    return ours.set_index("ROI_label")


def _compare(ref, ours, min_checked, skip_prefixes=()):
    assert list(ref.index) == list(ours.index)
    failures = []
    checked = 0
    for c in ours.columns:
        if c not in ref.columns or c in ZERO_BY_CONSTRUCTION:
            continue
        if c.startswith(skip_prefixes):
            continue
        a = ours[c].to_numpy(float)
        b = ref[c].to_numpy(float)
        both = np.isfinite(a) & np.isfinite(b)
        if both.sum() == 0:
            continue
        denom = np.maximum(np.abs(b[both]), 1e-6)
        rel = np.abs(a[both] - b[both]) / denom
        p90 = float(np.quantile(rel, 0.9))
        tol = LOOSE.get(c, REF_TOL)
        checked += 1
        if p90 > tol:
            failures.append((c, round(p90, 6)))
    assert checked >= min_checked, "too few comparable columns (%d)" % checked
    assert not failures, "beyond tolerance vs reference binary: %r" % \
        failures[:25]


def test_ibsi_mode_parity():
    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_ibsi_320x320_seed11.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    ours = _run(dict(ibsi=True), ibsi=True)
    _compare(ref, ours, 700)


def test_radiomics_binning_parity():
    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_radiomics_320x320_seed11.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    # radiomics mode has no IBSI IH_* family -> fewer columns
    ours = _run(dict(coarse_gray_depth=-32), ibsi=False)
    _compare(ref, ours, 600, skip_prefixes=RADIOMICS_REFERENCE_DEFECTS)


def test_3d_reference_binary_parity():
    """All *3D_ALL* columns against the reference BINARY's own 3D output
    (NIfTI volume pair, --dim=3) -- the first binary-pinned 3D config
    (previous 3D oracles: pyradiomics goldens + invariants).  Fixture via
    tools/gen_config_fixtures.gen_3d."""
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_3d_48x56x60_seed4.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_blob_volume(seed=4, shape=(48, 56, 60))
    intens = (intens % 59 + 1).astype(np.uint16)
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    runner = VolumeRunner(fset, EngineConfig(precision="f64"))
    labs, values = runner.run(intens, labels.astype(np.int32))
    cols, _ = col.build_header(fset, EngineConfig())
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    ours = ours.set_index("ROI_label")
    assert list(ref.index) == list(ours.index)
    # No exclusions: every comparable column is pinned.  Key semantics that
    # make this exact (all verified against the binary):
    # * env_features.cpp:712-736 zero-initializes the per-family 3D
    #   GLRLM/GLSZM/GLDM/NGTDM greydepth settings -> greyInfo=0 -> the
    #   no-binning path (raw-intensity levels, background excluded)
    # * NGTDM_RADIUS also defaults to 0 -> empty neighborhood -> the binary
    #   emits 0.0 for all five 3NGTDM members
    # * 3d_ngldm.cpp:12-40's shift table has only 24 neighbors (the axial
    #   (0,0,+-1) pair is absent, unlike 3d_gldm.cpp:16-48)
    res = parity.compare_reference(ours, ref, denom_floor=1e-6)
    assert res.checked > 200, res.checked
    assert res.ok, res.failures[:40]


def test_hu_mode_parity():
    """All *ALL* columns under --preserve-hu on a positive float HU-like
    slide vs the reference BINARY (fixture tools/gen_config_fixtures.
    gen_hu_2d) -- the vetting matrix's HU column for every 2D family.

    Load-map note (verified against the binary): the reference CLI's
    float-TIFF prescan computes the slide min over full tile buffers
    INCLUDING padding zeros, so its documented floored-slide-min offset
    never engages for file-based float slides -- the effective map is
    u = round(x) clamped at 0.  Parity is pinned at that effective map;
    the documented offset semantics (shared by the reference's own Python
    montage path) are pinned separately by the HU tests in test_ih.py."""
    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_hu_320x320_seed11.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_dsb_like(h=320, w=320, n_blobs=40, seed=11)
    hu = ((intens.astype(np.int64) % 59) * 30 + 100).astype(np.float32)
    cfg = EngineConfig(precision="f64", preserve_hu=True)
    fset = tx.parse_feature_request(["*ALL*"])
    runner = PairRunner(fset, cfg)
    I = np.round(hu).astype(np.uint32)        # the binary's effective map
    labs, values = runner.run(I, labels, hu_offset=0.0)
    cols, _ = col.build_header(fset, cfg)
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    ours = ours.set_index("ROI_label")
    _compare(ref, ours, 700)


def test_3d_aniso_reference_binary_parity():
    """*3D_ALL* with --anisox=1.4 --anisoy=1.2 --anisoz=1.5 vs the
    reference binary (fixture tools/gen_config_fixtures.gen_3d_aniso) --
    the vetting matrix's 3D aniso column."""
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_3d_aniso_48x56x60_seed4.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_blob_volume(seed=4, shape=(48, 56, 60))
    intens = (intens % 59 + 1).astype(np.uint16)
    cfg = EngineConfig(precision="f64",
                       aniso_x=float(np.float32(1.4)),
                       aniso_y=float(np.float32(1.2)),
                       aniso_z=float(np.float32(1.5)))
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    runner = VolumeRunner(fset, cfg)
    labs, values = runner.run(intens, labels.astype(np.int32))
    cols, _ = col.build_header(fset, cfg)
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    ours = ours.set_index("ROI_label")
    # 3MESH_VOLUME/3VOLUME_CONVEXHULL: the reference's "hull" is an
    # approximate complex built from PER-PLANE 2D contours
    # (3d_surface.cpp:435-482) -- this engine computes the true 3D convex
    # hull.  They agree to 0.07% on large ROIs but diverge on few-voxel
    # ROIs, which the anisotropic resampling amplifies; intentional
    # divergence (ours is the exact quantity).
    _compare(ref, ours, 150, skip_prefixes=("3MESH_VOLUME",
                                            "3VOLUME_CONVEXHULL"))


def test_3d_wholevolume_reference_binary_parity():
    """3D whole-volume (singleROI) morphology + ALL SEVEN texture families
    vs the reference binary (fixture tools/gen_config_fixtures.gen_3d_whole;
    the binary ABORTS on *3D_ALL* in this mode -- "illegal call of
    D3_VoxelIntensityFeatures" -- so the fixture holds every family its
    whole-volume reduce supports, reduce_trivial_rois.cpp:657-707).

    Whole-volume cube semantics (root-caused r5): the cube is the RAW
    intensity volume in a one-past box (init_from_whd, aabb.h:61-69), but
    texture grey-binning runs against the vROI's aux range aux_min=0,
    aux_max = slide_max - slide_min (featurize_wholevolume,
    workflow_3d_whole.cpp:102-106) rather than the cloud extrema -- and
    NGLDM's unclamped to_grayscale then produces levels beyond the nominal
    grey depth (helpers.h:337, 3d_ngldm.cpp:123-166), which the engine's
    matrices must keep as distinct rows."""
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_3d_whole_48x56x60_seed4.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, _ = bench.make_blob_volume(seed=4, shape=(48, 56, 60))
    intens = (intens % 59 + 1).astype(np.uint16)
    fset = tx.parse_feature_request(
        ["*3D_ALL_MORPHOLOGY*", "*3D_GLCM*", "*3D_GLDM*", "*3D_GLDZM*",
         "*3D_GLRLM*", "*3D_GLSZM*", "*3D_NGLDM*", "*3D_NGTDM*"], dim=3)
    runner = VolumeRunner(fset, EngineConfig(precision="f64"))
    labs, values = runner.run(intens, np.ones(intens.shape, np.int32),
                              wholeslide=True)
    cols, _ = col.build_header(fset, EngineConfig())
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    ours = ours.set_index("ROI_label")
    _compare(ref, ours, 170)


def test_3d_ibsi_reference_binary_parity():
    """*3D_ALL* under --ibsi=true vs the reference binary (fixture
    tools/gen_config_fixtures.gen_3d_ibsi) -- the vetting matrix's 3D ibsi
    column."""
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_3d_ibsi_48x56x60_seed4.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_blob_volume(seed=4, shape=(48, 56, 60))
    intens = (intens % 59 + 1).astype(np.uint16)
    cfg = EngineConfig(precision="f64", ibsi=True)
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3, ibsi=True)
    runner = VolumeRunner(fset, cfg)
    labs, values = runner.run(intens, labels.astype(np.int32))
    cols, _ = col.build_header(fset, cfg)
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    ours = ours.set_index("ROI_label")
    _compare(ref, ours, 150)


def test_3d_hu_reference_binary_parity():
    """*3D_ALL* under --preserve-hu on an int16 HU-like NIfTI volume vs the
    reference binary (fixture tools/gen_config_fixtures.gen_3d_hu) -- the
    3D hu column.  Unlike the CLI float-TIFF path (see test_hu_mode_parity),
    the NIfTI loader applies the documented floored-slide-min offset, which
    this engine's prep mirrors."""
    from nyxus_tpu.pipeline.runner3d import VolumeRunner

    ref = pd.read_csv(gzip.open(
        os.path.join(DATA, "ref_3d_hu_48x56x60_seed4.csv.gz"), "rt"))
    ref = ref.sort_values("ROI_label").set_index("ROI_label")
    intens, labels = bench.make_blob_volume(seed=4, shape=(48, 56, 60))
    hu = ((intens.astype(np.int64) % 59) * 30 - 900).astype(np.int16)
    off = np.floor(hu.min())
    I = np.maximum(np.round(hu - off), 0).astype(np.uint16)
    cfg = EngineConfig(precision="f64", preserve_hu=True)
    fset = tx.parse_feature_request(["*3D_ALL*"], dim=3)
    runner = VolumeRunner(fset, cfg)
    labs, values = runner.run(I, labels.astype(np.int32))
    cols, _ = col.build_header(fset, cfg)
    ours = pd.DataFrame(values, columns=cols[4:])
    ours["ROI_label"] = labs
    ours = ours.set_index("ROI_label")
    # hull members: reference's per-plane contour hull complex vs our true
    # 3D hull (see test_3d_aniso note) -- 0.045% apart here
    _compare(ref, ours, 150, skip_prefixes=("3MESH_VOLUME",
                                            "3VOLUME_CONVEXHULL"))
