"""3D pipeline: volume ROI discovery, bucketed [B, D, H, W] batching, and the
D3_* feature families.

Reference: src/nyx/workflow_3d_segmented.cpp, phase1.cpp:248 (3D metrics
gather), phase2_3d.cpp (SimpleCube build), reduce_trivial_rois.cpp (3D
families).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import columns as col
from .. import taxonomy as tx
from ..config import EngineConfig
from ..ops import common as ops_common
from ..ops import intensity as ops_intensity
from ..ops import quant
from ..ops import texture3d as t3
from . import batching


@dataclasses.dataclass
class Roi3D:
    label: int
    area: int
    z0: int; z1: int; y0: int; y1: int; x0: int; x1: int
    vmin: float
    vmax: float
    # fed-cloud voxel count when it differs from the physical aux area
    # (3D anisotropy: the virtual member count)
    cloud_area: int = None
    # texture grey-binning range override (whole-volume mode: the vROI's
    # aux_min/aux_max are 0 and slide_max - slide_min -- the Hounsfield-style
    # offset of featurize_wholevolume, workflow_3d_whole.cpp:102-106 -- while
    # the cube keeps RAW intensities, so binned levels can exceed the nominal
    # grey depth).  None -> bin with the cloud's vmin/vmax (segmented mode)
    bin_min: float = None
    bin_max: float = None

    @property
    def depth(self):
        return self.z1 - self.z0 + 1

    @property
    def height(self):
        return self.y1 - self.y0 + 1

    @property
    def width(self):
        return self.x1 - self.x0 + 1


def _aniso_bbox3(r: Roi3D, ax: float, ay: float, az: float) -> Roi3D:
    """3-axis AABB::apply_anisotropy (features/aabb.h:115-134): truncate the
    mins, truncate the maxes with the one-step round-trip fixup.  area/vmin/
    vmax keep their physical phase-1 values (aux_* quirk)."""
    def scale(lo, hi, a):
        lo2, hi2 = int(lo * a), int(hi * a)
        if int((hi2 + 1) / a) == hi:
            hi2 += 1
        return lo2, hi2
    x0, x1 = scale(r.x0, r.x1, ax)
    y0, y1 = scale(r.y0, r.y1, ay)
    z0, z1 = scale(r.z0, r.z1, az)
    return Roi3D(r.label, r.area, z0, z1, y0, y1, x0, x1, r.vmin, r.vmax)


def discover_rois_3d(intens: np.ndarray, labels: np.ndarray):
    D, H, W = labels.shape
    flat = labels.ravel()
    nz = flat != 0
    labs = flat[nz]
    if labs.size == 0:
        return [], float(intens.min(initial=0)), float(intens.max(initial=0))
    vals = intens.ravel()[nz].astype(np.float64)
    uniq, inv = np.unique(labs, return_inverse=True)
    k = uniq.size
    area = np.bincount(inv, minlength=k)
    vmin = np.full(k, np.inf); vmax = np.full(k, -np.inf)
    np.minimum.at(vmin, inv, vals)
    np.maximum.at(vmax, inv, vals)
    pos = np.nonzero(nz)[0]
    zz = pos // (H * W)
    yy = (pos // W) % H
    xx = pos % W
    lim = {}
    out = []
    for name, arr, red, init in (("z0", zz, np.minimum, D), ("z1", zz, np.maximum, -1),
                                 ("y0", yy, np.minimum, H), ("y1", yy, np.maximum, -1),
                                 ("x0", xx, np.minimum, W), ("x1", xx, np.maximum, -1)):
        acc = np.full(k, init, np.int64)
        red.at(acc, inv, arr)
        lim[name] = acc
    recs = [Roi3D(int(uniq[i]), int(area[i]),
                  int(lim["z0"][i]), int(lim["z1"][i]),
                  int(lim["y0"][i]), int(lim["y1"][i]),
                  int(lim["x0"][i]), int(lim["x1"][i]),
                  float(vmin[i]), float(vmax[i])) for i in range(k)]
    return recs, float(intens.min()), float(intens.max())


def discover_rois_3d_streamed(intens, labels):
    """Per-z-plane accumulation variant of discover_rois_3d for lazy
    (layout-A) stacks: one decoded plane in flight, identical results.
    Mirrors the reference's slice-streamed 2.5D phase 1
    (phase1.cpp:130 gatherRoisMetrics_25D)."""
    D, H, W = labels.shape
    agg = {}    # label -> [area, z0, z1, y0, y1, x0, x1, vmin, vmax]
    smin, smax = np.inf, -np.inf
    for z in range(D):
        lab2 = np.asarray(labels[z])
        int2 = np.asarray(intens[z])
        smin = min(smin, float(int2.min()))
        smax = max(smax, float(int2.max()))
        ys, xs = np.nonzero(lab2)
        if ys.size == 0:
            continue
        labs = lab2[ys, xs]
        vals = int2[ys, xs].astype(np.float64)
        uniq, inv = np.unique(labs, return_inverse=True)
        k = uniq.size
        area = np.bincount(inv, minlength=k)
        vmin = np.full(k, np.inf)
        vmax = np.full(k, -np.inf)
        np.minimum.at(vmin, inv, vals)
        np.maximum.at(vmax, inv, vals)
        y0 = np.full(k, H, np.int64)
        y1 = np.full(k, -1, np.int64)
        x0 = np.full(k, W, np.int64)
        x1 = np.full(k, -1, np.int64)
        np.minimum.at(y0, inv, ys)
        np.maximum.at(y1, inv, ys)
        np.minimum.at(x0, inv, xs)
        np.maximum.at(x1, inv, xs)
        for i in range(k):
            lb = int(uniq[i])
            a = agg.get(lb)
            if a is None:
                agg[lb] = [int(area[i]), z, z, int(y0[i]), int(y1[i]),
                           int(x0[i]), int(x1[i]), float(vmin[i]),
                           float(vmax[i])]
            else:
                a[0] += int(area[i])
                a[2] = z
                a[3] = min(a[3], int(y0[i]))
                a[4] = max(a[4], int(y1[i]))
                a[5] = min(a[5], int(x0[i]))
                a[6] = max(a[6], int(x1[i]))
                a[7] = min(a[7], float(vmin[i]))
                a[8] = max(a[8], float(vmax[i]))
    recs = [Roi3D(lb, a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8])
            for lb, a in sorted(agg.items())]
    return recs, float(smin), float(smax)


class Ctx3D:
    def __init__(self, intens, mask, area, vmin, vmax, dd, hh, ww, cfg,
                 static_meta=(), slide_range=None, cloud_area=None,
                 bvmin=None, bvmax=None):
        # slide intensity range (max - min over the volume's masked voxels):
        # COVERED_IMAGE_INTENSITY_RANGE divides the ROI range by it
        # (3d_intensity.cpp:57-65 uses the slide's pre-ROI extrema)
        self.slide_range = slide_range
        self.intens = intens
        self.mask = mask
        self.area = area
        # fed-cloud voxel count: == area normally; under 3D anisotropy the
        # VIRTUAL member count (run/zone Np denominators use
        # raw_pixels_3D.size() while intensity divides by the PHYSICAL
        # aux_area, 3d_intensity.cpp:67 -- both reference quirks)
        self.cloud_area = area if cloud_area is None else cloud_area
        self.vmin = vmin
        self.vmax = vmax
        # texture grey-binning range (the reference's aux_min/aux_max; equal
        # to the cloud extrema except in whole-volume mode)
        self.bvmin = vmin if bvmin is None else bvmin
        self.bvmax = vmax if bvmax is None else bvmax
        self.depths = dd
        self.heights = hh
        self.widths = ww
        self.cfg = cfg
        self.static_meta = dict(static_meta)
        self._cache = {}

    @property
    def B(self):
        return self.intens.shape[0]

    def cached(self, key, builder):
        if key not in self._cache:
            self._cache[key] = builder()
        return self._cache[key]

    @property
    def masked_intens(self):
        return self.cached("mi", lambda: jnp.where(self.mask, self.intens, 0))

    @property
    def aabb(self):
        return self.cached("aabb", lambda: t3._in_aabb3d(
            self.intens.shape[1:], self.depths, self.heights, self.widths))

    def levels(self, greyinfo):
        return self.cached(("lev", greyinfo), lambda: quant.bin_levels(
            self.masked_intens, self.bvmin[:, None, None, None],
            self.bvmax[:, None, None, None], greyinfo))


def _grey(ctx, cfg, family=None):
    if cfg.ibsi:
        return 0, int(ctx.static_meta.get("max_int", 256))
    g = cfg.texture_greydepth3(family) if family else cfg.coarse_gray_depth
    if g == 0:
        # per-family zero default -> no binning: raw intensity levels
        # (texture_feature.h:71-75), matrix sized by the slide max
        return 0, int(ctx.static_meta.get("max_int", 256))
    return g, g


def _f_intensity(ctx, cfg):
    sv = ops_common.sort_masked_values(ctx.intens, ctx.mask)
    rng = (ctx.slide_range if ctx.slide_range is not None
           else jnp.ones_like(ctx.vmin))
    return ops_intensity.pixel_intensity_features(
        sv, ctx.area, ctx.vmin, ctx.vmax,
        rng, cfg.coarse_gray_depth, cfg.noval)


def _f_glcm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "glcm")
    # in IBSI mode Ng for the IDN/IDMN normalizations is each ROI's own max
    # intensity, not the (padded) static matrix size
    ng_val = ctx.bvmax if gi == 0 else None
    return t3.glcm3d_all(ctx.levels(gi), ctx.aabb, ctx.bvmin, ctx.bvmax,
                         cfg.glcm3_offset, ng, gi == 0, gi, cfg.noval,
                         ctx.intens.dtype, ng_val)


def _f_glrlm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "glrlm")
    lev = ctx.levels(gi)
    valid = ctx.aabb if gi > 0 else (ctx.aabb & (lev > 0))
    # Np = fed-cloud voxel count (3d_glrlm.cpp:196 raw_pixels_3D.size())
    n_pixels = ctx.cloud_area
    nr = max(ctx.intens.shape[1:])
    return t3.glrlm3d_all(lev, valid, n_pixels, ctx.bvmin, ctx.bvmax, ng, nr,
                          cfg.noval, ctx.intens.dtype)


def _f_glszm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "glszm")
    lev = ctx.levels(gi)
    zero_i = 1 if gi > 0 else 0
    valid = ctx.aabb & (lev != zero_i)
    # Np = fed-cloud voxel count (3d_glszm.cpp:529 raw_pixels_3D.size())
    np_pixels = ctx.cloud_area
    return t3.glszm3d_all(jnp.where(valid, lev, -1), valid, np_pixels,
                          ctx.bvmin, ctx.bvmax, cfg.noval, ctx.intens.dtype)


def _f_gldzm(ctx, cfg):
    gi, ng = _grey(ctx, cfg)   # no 3gldzm metaparam path exists in the reference
    lev = ctx.levels(gi)
    valid = ctx.aabb if gi > 0 else (ctx.aabb & (lev > 0))
    # GLDZM's Np stays the PHYSICAL aux_area even under anisotropy
    # (3d_gldzm.cpp:547 calc_features(..., r.aux_area))
    return t3.gldzm3d_all(jnp.where(ctx.aabb, lev, 0), valid, ctx.heights,
                          ctx.widths, ctx.area, ctx.bvmin, ctx.bvmax,
                          cfg.noval, ctx.intens.dtype)


def _f_gldm(ctx, cfg):
    gi, ng = _grey(ctx, cfg, "gldm")
    lev = ctx.levels(gi)
    zero_i = 1 if gi > 0 else 0
    return t3.gldm3d_all(jnp.where(ctx.aabb, lev, -9), ctx.aabb, zero_i, ng,
                         ctx.bvmin, ctx.bvmax, cfg.noval, ctx.intens.dtype)


def _f_ngldm(ctx, cfg):
    gi, ng = _grey(ctx, cfg)
    D = ctx.intens.shape[1]
    aabb = ctx.aabb
    zs = jnp.arange(ctx.intens.shape[1], dtype=jnp.int32)[None, :, None, None]
    ys = jnp.arange(ctx.intens.shape[2], dtype=jnp.int32)[None, None, :, None]
    xs = jnp.arange(ctx.intens.shape[3], dtype=jnp.int32)[None, None, None, :]
    interior = ((zs >= 1) & (zs < ctx.depths[:, None, None, None] - 1) &
                (ys >= 1) & (ys < ctx.heights[:, None, None, None] - 1) &
                (xs >= 1) & (xs < ctx.widths[:, None, None, None] - 1))
    n_levels = 0 if cfg.ibsi else cfg.coarse_gray_depth
    # to_grayscale is UNCLAMPED (helpers.h:337): when the binning range
    # (aux_max) is below the cloud max -- whole-volume mode -- levels exceed
    # the nominal grey depth; "ngldm_nmax" carries the host-computed ceiling
    nmax = (int(ctx.static_meta.get("max_int", 256)) if cfg.ibsi
            else int(ctx.static_meta.get("ngldm_nmax", ng)))
    return t3.ngldm3d_all(ctx.masked_intens,
                          {"interior": interior, "inbounds": aabb},
                          ctx.bvmax, n_levels, nmax, cfg.ibsi, ctx.bvmin,
                          cfg.noval, ctx.intens.dtype)


def _f_ngtdm(ctx, cfg):
    if cfg.d3_ngtdm_radius <= 0:
        # reference default: NGTDM_RADIUS is zero-initialized
        # (env_features.cpp:712-736), so 3d_ngtdm.cpp:92-110's Chebyshev
        # neighborhood is empty, no zone is ever pushed, and the binary
        # emits 0.0 for all five members
        z = jnp.zeros((ctx.B,), ctx.intens.dtype)
        return {m: z for m in ("NGTDM_COARSENESS", "NGTDM_CONTRAST",
                               "NGTDM_BUSYNESS", "NGTDM_COMPLEXITY",
                               "NGTDM_STRENGTH")}
    gi, ng = _grey(ctx, cfg, "ngtdm")
    lev = ctx.levels(gi)
    zero_i = 1 if gi > 0 else 0
    return t3.ngtdm3d_all(jnp.where(ctx.aabb, lev, 0), ctx.aabb, zero_i, ng,
                          cfg.d3_ngtdm_radius, ctx.bvmin, ctx.bvmax,
                          cfg.noval, ctx.intens.dtype, ibsi=gi == 0)


FAMILIES3D = {
    "D3_VoxelIntensityFeatures": _f_intensity,
    "D3_GLCM_feature": _f_glcm,
    "D3_GLRLM_feature": _f_glrlm,
    "D3_GLSZM_feature": _f_glszm,
    "D3_GLDZM_feature": _f_gldzm,
    "D3_GLDM_feature": _f_gldm,
    "D3_NGLDM_feature": _f_ngldm,
    "D3_NGTDM_feature": _f_ngtdm,
}


@functools.partial(jax.jit, static_argnames=("families", "cfg", "static_meta"))
def _extract3d(intens, mask, area, vmin, vmax, dd, hh, ww, families, cfg,
               static_meta=(), slide_range=None, cloud_area=None,
               bvmin=None, bvmax=None):
    ctx = Ctx3D(intens, mask, area, vmin, vmax, dd, hh, ww, cfg, static_meta,
                slide_range=slide_range, cloud_area=cloud_area,
                bvmin=bvmin, bvmax=bvmax)
    return {name: FAMILIES3D[name](ctx, cfg) for name in families}


class VolumeRunner:
    """Featurizes one (intensity, labels) 3D volume pair.

    ``mesh``: optional 1-D ("roi",) device mesh; voxel ROI batches are
    sharded over it exactly like the 2D runner's (see nyxus_tpu.parallel)."""

    def __init__(self, fset: tx.FeatureSet, cfg: EngineConfig, mesh=None):
        self.fset = fset
        self.cfg = cfg
        self.mesh = None
        if mesh is not None and int(np.prod(mesh.devices.shape)) > 1:
            self.mesh = mesh
        self.families = tuple(
            n for n in FAMILIES3D
            if fset.any_enabled(tx.CLASS_FEATURES[n]))
        self.need_surface = fset.any_enabled(
            tx.CLASS_FEATURES["D3_SurfaceFeature"])
        _, self.slots = col.build_header(fset, cfg)
        self.n_values = sum(w for _, w in self.slots)
        self.member_slots = {}
        off = 0
        for code, width in self.slots:
            self.member_slots[code] = (off, width)
            off += width

    def run(self, intens: np.ndarray, label_img: np.ndarray,
            wholeslide: bool = False):
        # lazy (layout-A streamed) stacks: per-plane discovery, host-side
        # crop assembly, per-z oversized pass -- the stack never fully
        # materializes (reference: phase1.cpp:130, phase2_25d.cpp)
        lazy = not isinstance(intens, np.ndarray)
        if lazy and (self.cfg.mergerois or self.cfg.aniso_customized
                     or abs(self.cfg.aniso_z - 1.0) > 1.2e-07):
            raise ValueError("streamed 2.5D stacks do not support "
                             "mergerois/anisotropy; raise ram_limit to "
                             "materialize the stack")
        if self.cfg.mergerois:
            # --mergerois: whole nonzero foreground is one ROI
            label_img = (label_img != 0).astype(label_img.dtype)
        recs, smin, smax = (discover_rois_3d_streamed(intens, label_img)
                            if lazy else
                            discover_rois_3d(intens, label_img))
        if wholeslide and len(recs) == 1:
            # whole-volume vROI: INCLUSIVE one-past AABB 0..D,0..H,0..W
            # (init_from_whd, aabb.h:61-69) -- the last plane/row/col of
            # the cube stay empty and participate as grey 0, like the 2D
            # whole-slide quirk.  Texture families bin against the vROI's
            # aux range aux_min=0, aux_max=slide_max - slide_min
            # (workflow_3d_whole.cpp:102-106; bin_intensities_3d reads
            # r.aux_min/aux_max) rather than the cloud extrema
            D, H, W = intens.shape
            r0 = recs[0]
            recs[0] = Roi3D(r0.label, r0.area, 0, D, 0, H, 0, W,
                            r0.vmin, r0.vmax,
                            bin_min=0.0, bin_max=float(int(smax - smin)))
        eps = 1.1920929e-07
        if self.cfg.aniso_customized or abs(self.cfg.aniso_z - 1.0) > eps:
            # 3D anisotropy: physical phase-1 metrics + NN-resampled virtual
            # volume (reference: phase1.cpp:220-344 make_anisotropic_aabb,
            # phase2_3d anisotropic rescan)
            ax, ay, az = self.cfg.aniso_x, self.cfg.aniso_y, self.cfg.aniso_z
            recs = [_aniso_bbox3(r, ax, ay, az) for r in recs]
            D, H, W = intens.shape
            # the 3D virtual->physical map ROUNDS (+0.5) and SKIPS
            # positions beyond the physical bounds, leaving those virtual
            # voxels empty -- unlike the 2D path's truncation+clamp
            # (scanTrivialRois_3D_anisotropic, phase2_3d.cpp:385-400)
            ps = (np.arange(int(D * az)) / az + 0.5).astype(np.int64)
            pr = (np.arange(int(H * ay)) / ay + 0.5).astype(np.int64)
            pc = (np.arange(int(W * ax)) / ax + 0.5).astype(np.int64)
            vi = np.zeros((len(ps), len(pr), len(pc)), intens.dtype)
            vl = np.zeros(vi.shape, label_img.dtype)
            okz, oky, okx = ps < D, pr < H, pc < W
            sub = np.ix_(okz, oky, okx)
            vi[sub] = intens[ps[okz]][:, pr[oky]][:, :, pc[okx]]
            vl[sub] = label_img[ps[okz]][:, pr[oky]][:, :, pc[okx]]
            intens, label_img = vi, vl
            # after the virtual rescan the reference REPLACES each AABB
            # with the natural bbox of the fed virtual voxels
            # (aabb.update_from_voxelcloud, phase2_3d.cpp:695-699); the
            # scaled AABB above only seeded the batch packing.  aux
            # area/vmin/vmax stay physical (phase-1 values).
            # the voxel COUNT becomes the virtual cloud's size too (run/
            # zone "percentage" denominators divide by the fed cloud size,
            # not the physical aux_area); vmin/vmax stay physical
            vrecs, _, _ = discover_rois_3d(intens, label_img)
            nat = {r.label: r for r in vrecs}
            recs = [Roi3D(r.label, r.area,
                          nat[r.label].z0, nat[r.label].z1,
                          nat[r.label].y0, nat[r.label].y1,
                          nat[r.label].x0, nat[r.label].x1,
                          r.vmin, r.vmax,
                          cloud_area=nat[r.label].area)
                    for r in recs if r.label in nat]
        n = len(recs)
        values = np.full((n, self.n_values), -0.0, np.float64)
        if n == 0:
            return np.zeros(0, np.int64), values

        # trivial/oversized triage (reference RAM gate; 3D phase 3 runs
        # every family's osized_calculate, phase3.cpp:94-114)
        from . import oversized3d as ov3
        budget = self.cfg.ram_limit_mb << 20
        over_rows = [i for i, r in enumerate(recs)
                     if ov3.is_oversized3d(r, budget)]
        over_set = set(over_rows)
        if over_rows:
            fams = list(self.families)
            if self.need_surface:
                fams.append("D3_SurfaceFeature")
            if self.fset.any_enabled(
                    tx.CLASS_FEATURES["D3_VoxelIntensityFeatures"]):
                fams.append("D3_VoxelIntensityFeatures")
            for i in over_rows:
                res = ov3.process3d(recs[i], intens, label_img, self.cfg,
                                    set(fams), smin, smax)
                for members in res.values():
                    for member, v in members.items():
                        code = tx.F3D.get(member)
                        if code is None or code not in self.member_slots:
                            continue
                        off, width = self.member_slots[code]
                        arr = np.atleast_1d(np.asarray(v, np.float64))
                        w = min(width, arr.size)
                        values[i, off:off + w] = arr[:w]

        dtype = jnp.float64 if self.cfg.precision == "f64" else jnp.float32
        # bucket by padded (D, H, W)
        import collections
        buckets = collections.defaultdict(list)
        for i, r in enumerate(recs):
            if i in over_set:
                continue
            shape = (batching.pad_dim(r.depth), batching.pad_dim(r.height),
                     batching.pad_dim(r.width))
            buckets[shape].append(i)
        if not buckets:
            labs = np.asarray([r.label for r in recs], np.int64)
            return labs, values

        maxd = max(s[0] for s in buckets)
        maxh = max(s[1] for s in buckets)
        maxw = max(s[2] for s in buckets)
        if not lazy:
            pi = np.zeros((intens.shape[0] + maxd, intens.shape[1] + maxh,
                           intens.shape[2] + maxw),
                          np.float32 if dtype == jnp.float32 else np.float64)
            pl = np.zeros(pi.shape, np.int32)
            pi[:intens.shape[0], :intens.shape[1], :intens.shape[2]] = intens
            pl[:intens.shape[0], :intens.shape[1],
               :intens.shape[2]] = label_img
            d_int = jnp.asarray(pi)
            d_lab = jnp.asarray(pl)

        dispatched = []
        for shape, idxs in sorted(buckets.items()):
            brecs = [recs[i] for i in idxs]
            # quantize small-cube batch axes (pad rows replicate ROI 0 and
            # are dropped at scatter time) so executable signatures recur
            # across volumes -- the 2D runner's compile-reuse treatment
            if self.mesh is None and max(shape) <= 64:
                B = len(brecs)
                bq = max(4, 1 << (B - 1).bit_length())
                brecs = brecs + [brecs[0]] * (bq - B)
            if lazy:
                # host-side crop assembly: decode planes through the
                # stack's LRU; only the ROI crops ship to the device
                np_dt = np.float32 if dtype == jnp.float32 else np.float64
                B_all = len(brecs)
                B_real = len(idxs)
                ci_h = np.zeros((B_all,) + shape, np_dt)
                cm_h = np.zeros((B_all,) + shape, bool)
                D_, H_, W_ = intens.shape
                order = sorted(range(B_real), key=lambda b: brecs[b].z0)
                for bi in order:
                    r = brecs[bi]
                    yend = min(r.y0 + shape[1], H_)
                    xend = min(r.x0 + shape[2], W_)
                    for zz in range(r.z0, min(r.z0 + shape[0], D_)):
                        pi2 = np.asarray(intens[zz])
                        pl2 = np.asarray(label_img[zz])
                        sl = (slice(r.y0, yend), slice(r.x0, xend))
                        ci_h[bi, zz - r.z0, :yend - r.y0,
                             :xend - r.x0] = pi2[sl]
                        cm_h[bi, zz - r.z0, :yend - r.y0,
                             :xend - r.x0] = pl2[sl] == r.label
                if B_all > B_real:          # pad rows replicate ROI 0
                    ci_h[B_real:] = ci_h[0]
                    cm_h[B_real:] = cm_h[0]
                ci = jnp.asarray(ci_h)
                cm = jnp.asarray(cm_h)
            else:
                z0 = jnp.asarray([r.z0 for r in brecs], jnp.int32)
                y0 = jnp.asarray([r.y0 for r in brecs], jnp.int32)
                x0 = jnp.asarray([r.x0 for r in brecs], jnp.int32)
                labsv = jnp.asarray([r.label for r in brecs], jnp.int32)

                def one(z, y, x, lab):
                    ci = jax.lax.dynamic_slice(d_int, (z, y, x), shape)
                    cl = jax.lax.dynamic_slice(d_lab, (z, y, x), shape)
                    return ci.astype(dtype), cl == lab

                ci, cm = jax.vmap(one)(z0, y0, x0, labsv)
            area = jnp.asarray([r.area for r in brecs], jnp.int32)
            carea = jnp.asarray([r.cloud_area if r.cloud_area is not None
                                 else r.area for r in brecs], jnp.int32)
            vmin = jnp.asarray([r.vmin for r in brecs], dtype)
            vmax = jnp.asarray([r.vmax for r in brecs], dtype)
            bvmin = jnp.asarray([r.vmin if r.bin_min is None else r.bin_min
                                 for r in brecs], dtype)
            bvmax = jnp.asarray([r.vmax if r.bin_max is None else r.bin_max
                                 for r in brecs], dtype)
            dd = jnp.asarray([r.depth for r in brecs], jnp.int32)
            hh = jnp.asarray([r.height for r in brecs], jnp.int32)
            ww = jnp.asarray([r.width for r in brecs], jnp.int32)
            # volume-level power-of-two ceiling bounds recompiles (per-batch
            # maxes churned one compile each; see runner.py).  Needed beyond
            # IBSI: the per-family zero-default greydepths
            # (GLRLM/GLSZM/GLDM/NGTDM, env_features.cpp:712-736) select raw
            # intensity levels, whose matrices are sized by the slide max.
            ceil = max(int(smax), 2)
            ceil = 1 << (ceil - 1).bit_length()
            # NGLDM level ceiling: to_grayscale is unclamped, so when a
            # rec bins against a range below its cloud max (whole-volume
            # aux convention) levels reach floor(cloud_max*n/range);
            # overshoot is harmless (empty rows carry zero mass)
            g_ngldm = (0 if self.cfg.ibsi else self.cfg.coarse_gray_depth)
            ngldm_nmax = max(abs(g_ngldm), 2)
            for r in brecs:
                if r.bin_max is not None and r.bin_max < r.vmax and \
                        r.bin_max > 0 and g_ngldm > 0:
                    ngldm_nmax = max(ngldm_nmax,
                                     int(r.vmax * g_ngldm / r.bin_max) + 1)
            static_meta = (("max_int", ceil), ("ngldm_nmax", ngldm_nmax))
            srange = jnp.full((len(brecs),), smax - smin, dtype)
            batch_args = (ci, cm, area, vmin, vmax, dd, hh, ww, srange, carea,
                          bvmin, bvmax)
            if self.mesh is not None:
                from ..parallel import shard_batch
                batch_args, _ = shard_batch(self.mesh, batch_args)
            out = _extract3d(*batch_args[:8],
                             self.families, self.cfg, static_meta,
                             slide_range=batch_args[8],
                             cloud_area=batch_args[9],
                             bvmin=batch_args[10], bvmax=batch_args[11])
            # dispatch every bucket before collecting any: executions
            # queue back-to-back on the device and the D2H pulls overlap
            # later buckets' compute
            for members in out.values():
                for arr in members.values():
                    try:
                        arr.copy_to_host_async()
                    except Exception:
                        pass
            dispatched.append((idxs, out))

        for idxs, out in dispatched:
            out = jax.device_get(out)
            rows = np.asarray(idxs)
            for members in out.values():
                for member, arr in members.items():
                    code = tx.F3D.get(member)
                    if code is None or code not in self.member_slots:
                        continue
                    off, width = self.member_slots[code]
                    arr = np.asarray(arr, np.float64)[:len(idxs)]
                    if arr.ndim == 1:
                        arr = arr[:, None]
                    w = min(width, arr.shape[1])
                    values[rows, off:off + w] = arr[:, :w]

        if self.need_surface:
            if wholeslide and len(recs) == 1:
                self._surface_wholevolume(values, recs[0])
            else:
                self._surface(values, recs, label_img, skip=over_set)

        labs = np.asarray([r.label for r in recs], np.int64)
        return labs, values

    def _surface_wholevolume(self, values, r):
        """singleROI surface members: analytic box quantities from the
        one-past AABB dims; axis features zeroed
        (3d_surface.cpp:330-352)."""
        import math
        w, h, d = float(r.width), float(r.height), float(r.depth)
        area = 2.0 * (w * h + h * d + w * d)
        vol = w * h * d
        out = {
            "AREA": area, "VOLUME_CONVEXHULL": vol, "VOXEL_VOLUME": vol,
            "MESH_VOLUME": vol, "AREA_2_VOLUME": area / vol,
            "COMPACTNESS1": vol / math.sqrt(math.pi * area ** 3),
            "COMPACTNESS2": 36.0 * math.pi * vol * vol / area ** 3,
            "SPHERICAL_DISPROPORTION":
                area / (36.0 * math.pi * vol * vol) ** (1.0 / 3.0),
            "SPHERICITY":
                (36.0 * math.pi * vol * vol) ** (1.0 / 3.0) / area,
            "MAJOR_AXIS_LEN": 0.0, "MINOR_AXIS_LEN": 0.0,
            "LEAST_AXIS_LEN": 0.0, "ELONGATION": 0.0, "FLATNESS": 0.0,
        }
        for member, v in out.items():
            code = tx.F3D.get(member)
            if code is not None and code in self.member_slots:
                off, _ = self.member_slots[code]
                values[0, off] = v

    def _surface(self, values, recs, label_img, skip=frozenset()):
        """D3_SurfaceFeature host computation (3d_surface.cpp:?)."""
        import math
        from scipy.spatial import ConvexHull, QhullError

        for i, r in enumerate(recs):
            if i in skip:   # oversized rows: streamed in oversized3d
                continue
            m = label_img[r.z0:r.z1 + 1, r.y0:r.y1 + 1, r.x0:r.x1 + 1] == r.label
            zz, yy, xx = np.nonzero(m)
            n = len(zz)
            if n == 0:
                continue
            out = {}
            ball_r3 = 1.0 / 8.0
            out["VOXEL_VOLUME"] = n * (4.0 / 3.0 * math.pi * ball_r3) / 0.5236
            # exposed faces (6-neighborhood)
            pm = np.pad(m, 1)
            area = 0
            for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                               (0, 0, 1), (0, 0, -1)):
                nb = pm[1 + dz:1 + dz + m.shape[0], 1 + dy:1 + dy + m.shape[1],
                        1 + dx:1 + dx + m.shape[2]]
                area += int((m & ~nb).sum())
            out["AREA"] = float(area)
            pts = np.stack([xx + r.x0, yy + r.y0, zz + r.z0], 1).astype(float)
            try:
                hull = ConvexHull(pts)
                out["VOLUME_CONVEXHULL"] = hull.volume
            except Exception:
                out["VOLUME_CONVEXHULL"] = 0.0
            out["MESH_VOLUME"] = out["VOLUME_CONVEXHULL"]
            vv = out["VOXEL_VOLUME"]
            a = out["AREA"]
            out["AREA_2_VOLUME"] = a / vv
            out["COMPACTNESS1"] = vv / math.sqrt(math.pi * a ** 3) if a else 0.0
            out["COMPACTNESS2"] = 36 * math.pi * vv * vv / a ** 3 if a else 0.0
            out["SPHERICAL_DISPROPORTION"] = a / (36 * math.pi * vv * vv) ** (1 / 3)
            out["SPHERICITY"] = (36 * math.pi * vv * vv) ** (1 / 3) / a if a else 0.0
            C = np.cov(pts.T, bias=False) if n > 1 else np.zeros((3, 3))
            try:
                L = np.sort(np.linalg.eigvalsh(C))[::-1]
                if np.all(np.isfinite(L)) and L[0] > 0:
                    out["MAJOR_AXIS_LEN"] = 4 * math.sqrt(max(L[0], 0))
                    out["MINOR_AXIS_LEN"] = 4 * math.sqrt(max(L[1], 0))
                    out["LEAST_AXIS_LEN"] = 4 * math.sqrt(max(L[2], 0))
                    out["ELONGATION"] = math.sqrt(max(L[1], 0) / L[0])
                    out["FLATNESS"] = math.sqrt(max(L[2], 0) / L[0])
                else:
                    raise ValueError
            except Exception:
                for k in ("MAJOR_AXIS_LEN", "MINOR_AXIS_LEN", "LEAST_AXIS_LEN",
                          "ELONGATION", "FLATNESS"):
                    out[k] = 0.0
            for member, v in out.items():
                code = tx.F3D.get(member)
                if code in self.member_slots:
                    off, _ = self.member_slots[code]
                    values[i, off] = v
