"""Batched feature-extraction runner for image pairs.

Orchestrates: label discovery -> bucketed batching -> one jitted multi-family
kernel per bucket shape -> row assembly.  This is this engine's equivalent
of the reference's 3-phase per-pair loop (reference:
workflow_2d_segmented.cpp:35-159) collapsed into a single device pass.

Two crop paths share the same core:
* in-memory pairs: the slide lives in HBM once; per-ROI AABB crops are
  device-side vmapped dynamic_slices (zero host traffic per batch)
* file-backed pairs (``run_streamed``): per-ROI padded crops are gathered on
  host through the native TIFF region server, so slides of arbitrary size
  never materialize fully (the reference's tile re-scan, phase2_2d.cpp:89)
"""

from __future__ import annotations

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from .. import columns as col
from ..timing import stopwatch, vlog
from .. import registry
from .. import taxonomy as tx
from ..config import EngineConfig
from . import batching, labels


def _compute_dtype(cfg: EngineConfig):
    return jnp.float64 if cfg.precision == "f64" else jnp.float32


# tight per-slide transfer buffer (one H2D put per slide); disable to fall
# back to dense padded-crop transfers (A/B testing, debugging)
_FLAT_TRANSFER = True

# layout side-channel: populated at trace time (once per process per
# signature); maps each (family, member) to its column span in the packed
# output.  Keyed by the packed function's static signature.
_BUCKET_LAYOUTS: dict = {}

# single host-geometry worker: the native geom_batch calls release the GIL,
# so they run truly concurrently with the main thread's crop assembly /
# next-slide host stages on a second core.  ONE worker on purpose: the
# logw phase must complete before the rest phase of the same pair (queue
# order is the dependency).
_HOST_EX = None
_HOST_EX_LOCK = threading.Lock()


def _host_executor():
    global _HOST_EX
    with _HOST_EX_LOCK:     # runners on several threads share ONE worker
        if _HOST_EX is None:
            from concurrent.futures import ThreadPoolExecutor
            _HOST_EX = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="nyx-hostgeom")
    return _HOST_EX


def _bucket_key(families, cfg, static_meta, shape, has_contour):
    return (families, cfg, static_meta, shape, has_contour)


@functools.partial(jax.jit, static_argnames=("families", "cfg", "static_meta",
                                             "layout_key"))
def _extract_bucket_packed(intens, mask, area, vmin, vmax, y0, x0, heights,
                           widths, slide_min, slide_max, families, cfg,
                           static_meta=(), logw=None, hu_offset=None,
                           layout_key=None):
    """Run all requested feature families over one padded ROI batch.

    Outputs are packed into ONE [B, total_width] device array so collection
    costs a single device->host transfer instead of one per member array
    (~700 per slide)."""
    ctx = registry.BatchContext(intens, mask, area, vmin, vmax, y0, x0,
                                slide_min, slide_max, cfg, static_meta,
                                heights=heights, widths=widths, logw=logw,
                                hu_offset=hu_offset)
    out = {name: registry.FAMILIES[name].fn(ctx, cfg) for name in families}
    parts = []
    layout = {}
    off = 0
    dt = intens.dtype
    for fam in sorted(out):
        for member in sorted(out[fam]):
            arr = out[fam][member]
            a2 = arr[:, None] if arr.ndim == 1 else arr
            w = a2.shape[1]
            layout[(fam, member)] = (off, w)
            parts.append(a2.astype(dt))
            off += w
    # trace-time side channel; a key collision with a DIFFERENT layout would
    # silently mis-unpack packed columns (VERDICT r1 weak #9) -- assert it
    prev = _BUCKET_LAYOUTS.setdefault(layout_key, layout)
    assert prev == layout, "bucket layout collision for key %r" % (layout_key,)
    if not parts:   # all requested families are host-only
        return jnp.zeros((intens.shape[0], 0), dt)
    return jnp.concatenate(parts, axis=1)


@functools.partial(jax.jit, static_argnames=("families", "cfg", "static_meta",
                                             "layout_key"))
def _extract_pair_packed(bucket_args, families, cfg, static_meta=(),
                         layout_key=None):
    """Run all feature families over EVERY bucket of a pair in ONE device
    dispatch, returning one concatenated [sum(B_real), total_width] array.

    Fusing the whole pair into a single executable + a single fetch bounds
    per-execution launch overhead (whether the GPU needs it is ROADMAP
    D1/D2).  Each bucket entry is
    (ci [B,h,w], cm, meta_i [B,5] int32 (area, y0, x0, h, w),
    meta_f [B,5] (vmin, vmax, slide_min, slide_max, hu_off), lw | None).

    Inputs arrive compressed and are expanded on device (built for a slow
    host link; ROADMAP D2): ci may be uint16/uint32 (cast to
    the compute dtype, identical IEEE rounding to the host cast); cm may be
    bit-packed uint8 [B,h,ceil(w/8)] (np.packbits big-endian); lw may be
    raw integer squared contour distances (log(sqrt(d2)+eps) taken here).
    Quantization pad rows stay in the output (static-shape requirement:
    making the real row count static would compile per distinct ROI count);
    collection slices them off host-side."""
    outs = []
    for j, (ci, cm, meta_i, meta_f, lw) in enumerate(bucket_args):
        dt = meta_f.dtype
        w = ci.shape[2]
        if ci.dtype != dt:
            ci = ci.astype(dt)
        if cm.dtype == jnp.uint8:        # bit-packed mask
            shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
            bits = (cm[..., None] >> shifts) & jnp.uint8(1)
            cm = bits.reshape(cm.shape[0], cm.shape[1], -1)[:, :, :w] != 0
        if lw is not None and lw.dtype in (jnp.uint16, jnp.uint32):
            from ..ops.moments import WEIGHTING_EPSILON
            lw = jnp.log(jnp.sqrt(lw.astype(dt))
                         + jnp.asarray(WEIGHTING_EPSILON, dt))
        ctx = registry.BatchContext(
            ci, cm, meta_i[:, 0], meta_f[:, 0], meta_f[:, 1],
            meta_i[:, 1], meta_i[:, 2], meta_f[:, 2], meta_f[:, 3],
            cfg, static_meta, heights=meta_i[:, 3], widths=meta_i[:, 4],
            logw=lw, hu_offset=meta_f[:, 4])
        out = {name: registry.FAMILIES[name].fn(ctx, cfg) for name in families}
        parts = []
        layout = {}
        off = 0
        for fam in sorted(out):
            for member in sorted(out[fam]):
                arr = out[fam][member]
                a2 = arr[:, None] if arr.ndim == 1 else arr
                layout[(fam, member)] = (off, a2.shape[1])
                parts.append(a2.astype(dt))
                off += a2.shape[1]
        prev = _BUCKET_LAYOUTS.setdefault(layout_key, layout)
        assert prev == layout, \
            "bucket layout collision for key %r" % (layout_key,)
        outs.append(jnp.concatenate(parts, axis=1) if parts
                    else jnp.zeros((ci.shape[0], 0), dt))
    return jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]


@functools.partial(jax.jit, static_argnames=("families", "cfg", "static_meta",
                                             "shape", "has_lw", "ci_u32",
                                             "lw_u32", "layout_key"))
def _extract_bucket_flat(buf, meta_i, meta_f, families, cfg, static_meta=(),
                         shape=None, has_lw=False, ci_u32=False,
                         lw_u32=False, layout_key=None):
    """One bucket's feature extraction from the TIGHT per-slide transfer
    buffer.

    The padded dense crops (bucket AABB + batch-axis quantization, ~2.7x
    the real bytes on a nucleus slide) are replaced by ONE uint8 buffer per
    slide holding each ROI's exact (h x w) crop back-to-back: intensity
    (u16/u32 little-endian), raw squared contour distances (u16/u32), and
    a per-ROI bit-packed mask.  This kernel gathers the bucket's padded
    [Bq, hb, wb] crop planes back out of the buffer on device.  The scheme
    was built for a slow host link; dense vs tight on the GPU is ROADMAP
    D1.

    ``meta_i`` is [Bq, 8] int32: (area, y0, x0, h, w, ci_off_bytes,
    lw_off_bytes, mask_off_bytes).  Batch-pad rows replicate row 0's meta
    INCLUDING offsets, so they gather row 0's content without shipping a
    single pad byte.  ``meta_f`` is [Bq, 5] as in the dense path."""
    return _flat_block(buf, meta_i, meta_f, families, cfg, static_meta,
                       shape, has_lw, ci_u32, lw_u32, layout_key)


# universal slide program: fixed per-shape capacities (in chunk-cap units)
# so EVERY nucleus-scale slide dispatches the SAME executable, and the
# whole slide fuses into ONE execution; unused capacity is pad rows that
# ship zero bytes (the flat gather replicates row 0) and the output
# row-gather keeps the D2H slab at the real row count.  The caps answer a
# per-execution launch cost of the previous accelerator; their GPU A/B is
# ROADMAP D2.
_UNIVERSAL_CAPS = ((16, 16, 256), (32, 32, 256), (64, 64, 64))


@functools.partial(jax.jit, static_argnames=("families", "cfg", "static_meta",
                                             "caps", "has_lw", "ci_u32",
                                             "layout_key"))
def _extract_slide_fused(buf, metas_i, metas_f, row_idx, families, cfg,
                         static_meta=(), caps=_UNIVERSAL_CAPS, has_lw=False,
                         ci_u32=False, layout_key=None):
    """ONE execution per slide: every per-shape block of the universal
    capacity ladder runs the full family set over the tight transfer
    buffer, the blocks concatenate, and ``row_idx`` gathers the real rows
    (quantized count) into the output slab."""
    outs = []
    for (hb, wb, cap), mi, mf in zip(caps, metas_i, metas_f):
        outs.append(_flat_block(buf, mi, mf, families, cfg, static_meta,
                                (hb, wb), has_lw, ci_u32,
                                (hb - 1) ** 2 + (wb - 1) ** 2 >= 65536,
                                layout_key))
    allrows = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    return allrows[row_idx]


_AOT_SLIDE = None     # lazily-built aot_cache.AotSite for the universal call


def _call_slide_fused(buf, metas_i, metas_f, ridx, families, cfg,
                      static_meta, has_lw, ci_u32, layout_key):
    """Dispatch the universal slide program, through the opt-in AOT
    artifact cache (aot_cache.py) when NYXUS_TPU_AOT_CACHE is set: a warm
    fresh process then skips the ~18 s megakernel re-trace and reaches its
    first row from the serialized program."""
    from . import aot_cache

    def jit_call():
        return _extract_slide_fused(
            buf, metas_i, metas_f, ridx, families, cfg, static_meta,
            caps=_UNIVERSAL_CAPS, has_lw=has_lw, ci_u32=ci_u32,
            layout_key=layout_key)

    if not aot_cache.enabled():
        return jit_call()
    global _AOT_SLIDE
    if _AOT_SLIDE is None:
        _AOT_SLIDE = aot_cache.AotSite("slide_fused")
    n = len(metas_i)

    def flat_fn(buf_a, *rest):
        return _extract_slide_fused(
            buf_a, tuple(rest[:n]), tuple(rest[n:2 * n]), rest[2 * n],
            families, cfg, static_meta, caps=_UNIVERSAL_CAPS,
            has_lw=has_lw, ci_u32=ci_u32, layout_key=layout_key)

    statics = (families, repr(cfg), static_meta, _UNIVERSAL_CAPS,
               has_lw, ci_u32)
    arrays = (buf,) + tuple(metas_i) + tuple(metas_f) + (ridx,)
    return _AOT_SLIDE.call(statics, arrays, jit_call, flat_fn)


def _flat_block(buf, meta_i, meta_f, families, cfg, static_meta, shape,
                has_lw, ci_u32, lw_u32, layout_key):
    """Shared trace body: unpack one padded [Bq, hb, wb] block from the
    tight buffer and run all families over it (see _extract_bucket_flat)."""
    dt = meta_f.dtype
    hb, wb = shape
    u16 = jax.lax.bitcast_convert_type(buf.reshape(-1, 2), jnp.uint16)
    h = meta_i[:, 3][:, None, None]
    w = meta_i[:, 4][:, None, None]
    yy = jnp.arange(hb, dtype=jnp.int32)[None, :, None]
    xx = jnp.arange(wb, dtype=jnp.int32)[None, None, :]
    valid = (yy < h) & (xx < w)
    p = jnp.where(valid, yy * w + xx, 0)

    def gather16(off_bytes, wide):
        base = off_bytes[:, None, None] >> 1
        if wide:
            lo = u16[base + 2 * p].astype(jnp.uint32)
            hi = u16[base + 2 * p + 1].astype(jnp.uint32)
            return lo | (hi << 16)
        return u16[base + p]

    ci = jnp.where(valid, gather16(meta_i[:, 5], ci_u32), 0).astype(dt)
    mb = buf[meta_i[:, 7][:, None, None] + (p >> 3)].astype(jnp.int32)
    cm = ((mb >> (7 - (p & 7))) & 1) != 0
    cm = cm & valid
    lw = None
    if has_lw:
        from ..ops.moments import WEIGHTING_EPSILON
        d2 = jnp.where(valid, gather16(meta_i[:, 6], lw_u32), 0)
        lw = jnp.log(jnp.sqrt(d2.astype(dt)) + jnp.asarray(
            WEIGHTING_EPSILON, dt))
    ctx = registry.BatchContext(
        ci, cm, meta_i[:, 0], meta_f[:, 0], meta_f[:, 1],
        meta_i[:, 1], meta_i[:, 2], meta_f[:, 2], meta_f[:, 3],
        cfg, static_meta, heights=meta_i[:, 3], widths=meta_i[:, 4],
        logw=lw, hu_offset=meta_f[:, 4])
    out = {name: registry.FAMILIES[name].fn(ctx, cfg) for name in families}
    parts = []
    layout = {}
    off = 0
    for fam in sorted(out):
        for member in sorted(out[fam]):
            arr = out[fam][member]
            a2 = arr[:, None] if arr.ndim == 1 else arr
            layout[(fam, member)] = (off, a2.shape[1])
            parts.append(a2.astype(dt))
            off += a2.shape[1]
    prev = _BUCKET_LAYOUTS.setdefault(layout_key, layout)
    assert prev == layout, \
        "bucket layout collision for key %r" % (layout_key,)
    return (jnp.concatenate(parts, axis=1) if parts
            else jnp.zeros((ci.shape[0], 0), dt))


def _unpack_bucket(packed: np.ndarray, layout) -> dict:
    out: dict = {}
    for (fam, member), (off, w) in layout.items():
        arr = packed[:, off:off + w]
        out.setdefault(fam, {})[member] = arr[:, 0] if w == 1 else arr
    return out


class HostContext:
    """Inputs for host-side (sequential/contour) families.

    Host families run after device families and after earlier host families,
    so they may read previously computed features via ``get_feature``
    (the reference's fvals-mediated dependencies, e.g. hexagonality reading
    NUM_NEIGHBORS and STAT_FERET_DIAM_*).

    Per-ROI pixel access goes through ``pair_crop``/``roi_points`` so the
    same families work for in-memory pairs and streamed file pairs."""

    def __init__(self, recs, contours, source, get_feature,
                 oversized=frozenset(), hull_points=None):
        self.recs = recs            # all RoiRecords of the pair
        self.contours = contours    # merged contour per ROI, local +1 coords
        # oversized rows: (xs, ys) global hull candidates (None elsewhere)
        self.hull_points = hull_points or [None] * len(recs)
        self.source = source        # ArrayPairSource | TiffPairSource
        self.get_feature = get_feature   # display/member name -> np [N]
        self.hulls = [None] * len(recs)  # filled by the convex-hull family
        self.oversized = oversized  # local indices with NO dense pixel access
        self._points = {}
        self._crops = {}

    def pixels_ok(self, i):
        """False for oversized rows: pair_crop/roi_points would materialize
        the whole AABB; pixel-sweep families skip those rows."""
        return i not in self.oversized

    def pair_crop(self, i):
        """(intens [h, w] float64, mask [h, w] bool) over ROI i's exact AABB."""
        if i not in self._crops:
            r = self.recs[i]
            ii, ll = self.source.read_pair(r.y0, r.x0, r.height, r.width)
            self._crops[i] = (ii, ll == r.label)
        return self._crops[i]

    def roi_points(self, i):
        """(ys, xs) LOCAL pixel coordinates of ROI i."""
        if i not in self._points:
            _, m = self.pair_crop(i)
            self._points[i] = np.nonzero(m)
        return self._points[i]


def _build_clouds(recs, host_rows, over_set, resident, padded_crop,
                  pre=None):
    """Concatenated per-ROI pixel clouds (global raster order) for the
    batched native geometry pass: (gx, gy, inten, offsets) aligned with
    ``host_rows``.  ``pre`` = (gx, gy, inten, offsets, label->idx) from the
    native discovery pass (one image scan, no numpy sort); otherwise
    resident pairs use one whole-slide nonzero + stable label sort, and
    streamed pairs read per-ROI crops.  Oversized rows get empty clouds."""
    from . import batching
    n = len(host_rows)
    off = np.zeros(n + 1, np.int64)
    gx_p, gy_p, it_p = [], [], []
    if pre is not None:
        gx0, gy0, gi0, off0, lab2k = pre
        if (not over_set and n == len(lab2k)
                and host_rows == list(range(len(recs)))
                and all(lab2k.get(recs[i].label) == i for i in host_rows)):
            return gx0, gy0, gi0, off0   # zero-copy: full set in order
        for j, i in enumerate(host_rows):
            r = recs[i]
            k = lab2k.get(r.label)
            if i in over_set or k is None:
                off[j + 1] = off[j]
                continue
            a, b = int(off0[k]), int(off0[k + 1])
            off[j + 1] = off[j] + (b - a)
            gx_p.append(gx0[a:b])
            gy_p.append(gy0[a:b])
            it_p.append(gi0[a:b])
    elif resident is not None:
        intens, label_img = resident
        ys, xs = np.nonzero(label_img)
        labs = label_img[ys, xs]
        order = np.argsort(labs, kind="stable")
        ys, xs, labs = ys[order], xs[order], labs[order]
        vals = intens[ys, xs].astype(np.float64)
        uniq, starts = np.unique(labs, return_index=True)
        bounds = np.append(starts, len(labs))
        seg = {int(l): (int(bounds[k]), int(bounds[k + 1]))
               for k, l in enumerate(uniq)}
        for j, i in enumerate(host_rows):
            r = recs[i]
            if i in over_set or r.label not in seg:
                off[j + 1] = off[j]
                continue
            a, b = seg[r.label]
            off[j + 1] = off[j] + (b - a)
            gx_p.append(xs[a:b])
            gy_p.append(ys[a:b])
            it_p.append(vals[a:b])
    else:
        for j, i in enumerate(host_rows):
            r = recs[i]
            if i in over_set:
                off[j + 1] = off[j]
                continue
            hb, wb = batching.bucket_shape(r.height, r.width)
            ii, ll = padded_crop(i, hb, wb)
            cys, cxs = np.nonzero(ll[:r.height, :r.width] == r.label)
            off[j + 1] = off[j] + len(cys)
            gx_p.append(cxs + r.x0)
            gy_p.append(cys + r.y0)
            it_p.append(ii[cys, cxs].astype(np.float64))
    cat = lambda parts, dt: (np.concatenate(parts).astype(dt) if parts
                             else np.zeros(0, dt))
    return (cat(gx_p, np.int64), cat(gy_p, np.int64),
            cat(it_p, np.float64), off)


def _crop_batch_device(padded_intens, padded_labels, recs, shape, dtype):
    """Device-side batched AABB crops via vmapped dynamic_slice."""
    hb, wb = shape
    y0 = jnp.asarray([r.y0 for r in recs], jnp.int32)
    x0 = jnp.asarray([r.x0 for r in recs], jnp.int32)
    labs = jnp.asarray([r.label for r in recs], jnp.int32)

    def one(y, x, lab):
        ci = jax.lax.dynamic_slice(padded_intens, (y, x), (hb, wb))
        cl = jax.lax.dynamic_slice(padded_labels, (y, x), (hb, wb))
        return ci.astype(dtype), cl == lab

    return jax.vmap(one)(y0, x0, labs)


class PairRunner:
    """Extracts features for all ROIs of one (intensity, labels) pair.

    With ``mesh`` (a 1-D ``("roi",)`` jax.sharding.Mesh, see
    nyxus_tpu.parallel.roi_mesh) every padded ROI batch is sharded over the
    mesh's devices — the feature megakernel compiles SPMD and each device
    extracts its slice of the batch (net-new vs the reference's per-thread
    label ranges, parallel.h:36-40)."""

    def __init__(self, fset: tx.FeatureSet, cfg: EngineConfig, mesh=None):
        self.fset = fset
        self.cfg = cfg
        self.mesh = None
        if mesh is not None and int(np.prod(mesh.devices.shape)) > 1:
            self.mesh = mesh
        self.families = registry.families_for(fset)
        self._needs_logw = any(
            registry.FAMILIES[f].needs_logw for f in self.families)

        # internal feature set: user features + everything computed by the
        # dependency-closed family set (the reference computes whole dependent
        # methods into fvals; only user features reach the output)
        internal = tx.FeatureSet()
        internal.enabled |= fset.enabled
        for name in registry.activated_families(fset):
            for c in registry.FAMILIES[name].codes:
                internal.enabled[c] = True
        _, self.slots = col.build_header(internal, cfg)
        self.n_values = sum(w for _, w in self.slots)
        self.member_slots = {}
        off = 0
        for code, width in self.slots:
            self.member_slots[code] = (off, width)
            off += width

        # user-facing output column selection
        _, user_slots = col.build_header(fset, cfg)
        self._out_cols = []
        for code, width in user_slots:
            o, _ = self.member_slots[code]
            self._out_cols.extend(range(o, o + width))
        self._out_cols = np.asarray(self._out_cols, np.int64)
        self._colmaps = {}

    # ------------------------------------------------------------------
    # public entry points

    def run(self, intens: np.ndarray, label_img: np.ndarray,
            blacklist=None, fname: str = "", wholeslide: bool = False,
            async_collect: bool = False, hu_offset: float = 0.0,
            pre_discovery=None):
        """In-memory pair. Returns (labels[int], values[N, n_out]) for all
        ROIs, ascending label order. Unassigned features hold -0.0
        (reference: roi_cache.h:17). Blacklisted ROIs keep their row with
        unassigned values (reference: workflow_2d_segmented.cpp:116-121).

        ``pre_discovery``: optional (recs, smin, smax, clouds) from
        labels.discover_rois_clouds computed on a prefetch thread (the
        pipelined file path runs the NEXT slide's discovery while this one
        computes); ignored under mergerois."""
        from .sources import ArrayPairSource
        if self.cfg.mergerois:
            label_img = (label_img != 0).astype(np.int64)
            pre_discovery = None
        if pre_discovery is not None:
            all_recs, smin, smax, pre_clouds = pre_discovery
        else:
            with stopwatch("Pipeline/Phase1_discovery/#cca33a"):
                all_recs, smin, smax, pre_clouds = \
                    labels.discover_rois_clouds(intens, label_img)
        cloud_src = all_recs
        if wholeslide and len(all_recs) == 1:
            # the reference's virtual whole-slide ROI uses an INCLUSIVE
            # 0..W, 0..H AABB (init_from_wh, aabb.h:53-59): a (W+1)x(H+1)
            # matrix whose last row/column stay empty
            all_recs[0].y1 = intens.shape[0]
            all_recs[0].x1 = intens.shape[1]
        if self.cfg.aniso_customized:
            # phase 1 stays physical (aux_* metrics); every later pixel read
            # sees the NN-resampled virtual slide (phase2_2d.cpp:183-285)
            ax, ay = self.cfg.aniso_x, self.cfg.aniso_y
            vH, vW = int(intens.shape[0] * ay), int(intens.shape[1] * ax)
            pr = np.minimum((np.arange(vH) / ay).astype(np.int64),
                            intens.shape[0] - 1)
            pc = np.minimum((np.arange(vW) / ax).astype(np.int64),
                            intens.shape[1] - 1)
            intens = np.ascontiguousarray(intens[pr][:, pc])
            label_img = np.ascontiguousarray(label_img[pr][:, pc])
            # clouds come from the VIRTUAL slide (every later pixel read is
            # virtual); the physical clouds above are discarded
            vrecs, _, _, pre_clouds = \
                labels.discover_rois_clouds(intens, label_img)
            cloud_src = vrecs
            nat = {r.label: (r.y0, r.y1, r.x0, r.x1) for r in vrecs}
            all_recs = [labels.aniso_bbox(r, ax, ay, nat.get(r.label))
                        for r in all_recs]
        if pre_clouds is not None:
            pre_clouds = pre_clouds + (
                {r.label: k for k, r in enumerate(cloud_src)},)
        source = ArrayPairSource(intens, label_img)
        return self._run_core(all_recs, smin, smax, source, blacklist, fname,
                              resident=(intens, label_img),
                              wholeslide=wholeslide, pre_clouds=pre_clouds,
                              async_collect=async_collect,
                              hu_offset=hu_offset)

    def run_streamed(self, source, blacklist=None, fname: str = "",
                     tile: int = 2048, wholeslide: bool = False,
                     async_collect: bool = False, hu_offset: float = 0.0):
        """File-backed pair: tile-streamed discovery + per-batch region
        reads; the slide never fully materializes in host or device RAM."""
        if self.cfg.mergerois:
            from .sources import MergedLabelSource
            source = MergedLabelSource(source)
        with stopwatch("Pipeline/Phase1_discovery/#cca33a"):
            all_recs, smin, smax = labels.discover_rois_streamed(source, tile)
        if wholeslide and len(all_recs) == 1:
            # inclusive one-past AABB (init_from_wh, aabb.h:53-59)
            all_recs[0].y1, all_recs[0].x1 = source.shape
        if self.cfg.aniso_customized:
            from .sources import AnisoResampledSource
            ax, ay = self.cfg.aniso_x, self.cfg.aniso_y
            source = AnisoResampledSource(source, ax, ay)
            vrecs, _, _ = labels.discover_rois_streamed(source, tile)
            nat = {r.label: (r.y0, r.y1, r.x0, r.x1) for r in vrecs}
            all_recs = [labels.aniso_bbox(r, ax, ay, nat.get(r.label))
                        for r in all_recs]
        return self._run_core(all_recs, smin, smax, source, blacklist, fname,
                              resident=None, wholeslide=wholeslide,
                              async_collect=async_collect,
                              hu_offset=hu_offset)

    # ------------------------------------------------------------------

    def _run_core(self, all_recs, smin, smax, source, blacklist, fname,
                  resident, wholeslide: bool = False, pre_clouds=None,
                  async_collect: bool = False, hu_offset: float = 0.0):
        if blacklist is not None and blacklist.defined:
            recs = [r for r in all_recs
                    if not blacklist.check(fname, r.label)]
        else:
            recs = all_recs
        labs_all = np.asarray([r.label for r in all_recs], np.int64)
        n = len(recs)
        values = np.full((n, self.n_values), -0.0, dtype=np.float64)
        if n == 0:
            out = np.full((len(all_recs), len(self._out_cols)), -0.0)
            return (labs_all, (lambda: out)) if async_collect \
                else (labs_all, out)

        # trivial/oversized split (reference RAM gate,
        # workflow_2d_segmented.cpp:124-139): oversized ROIs take the
        # streamed-accumulation path and never materialize a dense crop
        from . import oversized as ovs
        budget = self.cfg.ram_limit_mb << 20
        over_rows = [i for i, r in enumerate(recs)
                     if ovs.is_oversized(r, budget)]
        over_set = set(over_rows)
        triv_rows = [i for i in range(n) if i not in over_set]

        # chunk caps bound the quantized-batch signature space per bucket
        # shape: dense slides of any ROI count then reuse the SAME
        # per-bucket executables (time-to-first-row), and texture
        # intermediates (~B x ng^2 x angles) stay memory-bounded.  Nucleus
        # shapes (<=64 px) pad the batch axis straight to the cap -- ONE
        # signature per shape -- trading pad-row compute for fewer
        # executables (ROADMAP D2 re-decides this on the GPU)
        _CHUNK_CAP = {8: 64, 16: 64, 32: 64, 64: 64, 128: 64, 256: 16}
        dtype = _compute_dtype(self.cfg)

        # decide the transfer scheme BEFORE batching: the tight flat-buffer
        # path packs nucleus shapes at the universal program's block
        # capacities (one EXECUTION per slide; ROADMAP D1)
        lw_raw_pre = self.mesh is None and dtype == jnp.float32
        int_tr = None
        if self.mesh is None:
            if resident is not None:
                idt = resident[0].dtype
                if idt.kind == "u":
                    int_tr = np.uint16 if idt.itemsize <= 2 else np.uint32
            elif getattr(source, "int_transfer_u32_ok", False):
                int_tr = np.uint32
        want_lw_pre = (registry.contour_needed(self.fset)
                       and self._needs_logw)
        flat_ok = (_FLAT_TRANSFER and self.mesh is None
                   and int_tr is not None
                   and (not want_lw_pre or lw_raw_pre))
        _uni_cap = ({hb: cap for hb, _, cap in _UNIVERSAL_CAPS}
                    if flat_ok else {})

        batches = []
        for shape, sub in batching.group_rois(
                [recs[i] for i in triv_rows], hbm_budget_bytes=budget):
            rows_b = [triv_rows[j] for j in sub]
            # shape-8 buckets ride the universal 16-block (same meta h/w,
            # just more padding)
            if flat_ok and max(shape) == 8 and 16 in _uni_cap:
                shape = (16, 16)
            cap = (_uni_cap.get(max(shape))
                   if flat_ok and max(shape) in _uni_cap
                   else (_CHUNK_CAP.get(max(shape))
                         if self.mesh is None else None))
            if cap:
                for c0 in range(0, len(rows_b), cap):
                    batches.append((shape, rows_b[c0:c0 + cap]))
            else:
                batches.append((shape, rows_b))

        # streamed mode gathers padded crops per batch on host; cache them
        # for the contour pass so regions are read once
        crop_cache = {}

        def padded_crop(i, hb, wb):
            key = (i, hb, wb)
            if key not in crop_cache:
                r = recs[i]
                crop_cache[key] = source.read_pair(r.y0, r.x0, hb, wb)
            return crop_cache[key]

        # host contour phase (reference: ContourFeature::buildRegularContour)
        contours = None
        hull_points = [None] * len(recs)   # oversized rows' hull candidates
        if registry.contour_needed(self.fset):
            sw_contour = stopwatch("Pipeline/Contours/#777799")
            sw_contour.__enter__()
            from . import contour as contour_mod
            from .. import native
            if wholeslide:
                # the reference synthesizes the whole-slide contour: the 4
                # corners of the inclusive AABB at the slide max intensity
                # (buildWholeSlideContour, contour.cpp:917-933).  Unlike
                # traced contours these carry NO +1 shift -- they are raw
                # AABB coordinates
                contours = []
                for r in recs:
                    vx = int(r.vmax)
                    xr = r.x1 - r.x0
                    yb = r.y1 - r.y0
                    contours.append(np.array(
                        [[0, 0, vx], [xr, 0, vx], [xr, yb, vx], [0, yb, vx]],
                        np.int64))
            elif resident is not None and native.available() \
                    and labels._native_labels_ok(resident[1]):
                # all ROIs traced in one threaded native call
                triv = [i for i in range(len(recs)) if i not in over_set]
                traced = native.contours_batch(resident[1], resident[0],
                                               [recs[i] for i in triv])
                contours = [None] * len(recs)
                for i, K in zip(triv, traced):
                    contours[i] = K
            else:
                contours = []
                for i, r in enumerate(recs):
                    if i in over_set:   # no dense crop for oversized ROIs
                        contours.append(None)
                        continue
                    if resident is not None:
                        sl = (slice(r.y0, r.y1 + 1), slice(r.x0, r.x1 + 1))
                        cm = resident[1][sl] == r.label
                        ci = resident[0][sl]
                    else:
                        hb, wb = batching.bucket_shape(r.height, r.width)
                        ii, ll = padded_crop(i, hb, wb)
                        cm = ll[:r.height, :r.width] == r.label
                        ci = ii[:r.height, :r.width]
                    contours.append(contour_mod.merged_contour(cm, ci))
            # oversized ROIs: streamed byte-mask trace (no dense crop;
            # reference phase-3 analog buildRegularContour_nontriv)
            if not wholeslide:
                for i in over_rows:
                    contours[i], hull_points[i] = \
                        contour_mod.oversized_contour(recs[i], source)
            sw_contour.__exit__()

        # host families split by dependency: families that never read
        # device-computed members run while the (async) device batches
        # execute; the device-dependent remainder runs after collection
        pre_host, post_host = registry.split_host_families(self.fset)
        host_rows = list(triv_rows)
        if contours is not None:
            host_rows += [i for i in over_rows
                          if contours[i] is not None
                          and contours[i].shape[0] > 0]
            host_rows.sort()
        hc = None
        hrow_pos = {}
        fut_logw = None
        # lw ships as raw integer squared contour distances on the f32 lane
        # (u16/u32, log(sqrt(d2)+eps) taken on device); the f64 lane keeps
        # the host-computed log values bit-for-bit (parity pins)
        lw_raw = lw_raw_pre
        if (pre_host or post_host or self._needs_logw) and host_rows:
            rows = np.asarray(host_rows)
            over_local = frozenset(j for j, i in enumerate(host_rows)
                                   if i in over_set)

            def get_feature(member):
                code = tx.NAME2CODE_2D.get(member)
                if code is None or code not in self.member_slots:
                    return np.zeros(len(rows))
                off, _ = self.member_slots[code]
                return values[rows, off]

            sub_contours = (None if contours is None else
                            [contours[i] for i in host_rows])
            hc = HostContext([recs[i] for i in host_rows], sub_contours,
                             source, get_feature, oversized=over_local,
                             hull_points=[hull_points[i] for i in host_rows])
            hrow_pos = {i: j for j, i in enumerate(host_rows)}
            if contours is not None:
                # phase "logw" of the native geometry pass: only the
                # per-pixel log distances the device batches consume; the
                # heavy feature groups run later, overlapping device exec.
                # On the fused path this runs on the host worker thread
                # (native, GIL-free) CONCURRENTLY with the main thread's
                # crop assembly; the lw build joins it before dispatch.
                def logw_work():
                    with stopwatch("Pipeline/Host/geom_batch/#99bb55"):
                        hc.clouds = _build_clouds(recs, host_rows, over_set,
                                                  resident, padded_crop,
                                                  pre=pre_clouds)
                        from . import hostfeats
                        from ..ops.moments import WEIGHTING_EPSILON
                        act_fams = registry.activated_families(self.fset)
                        # the ROI-radius / radial families share the
                        # per-pixel contour-distance search with logw:
                        # one native call
                        hostfeats.compute_geom(
                            hc, self.cfg,
                            tuple(f for f in hostfeats.DIST_FAMILIES
                                  if f in act_fams),
                            want_logw=self._needs_logw,
                            logw_eps=WEIGHTING_EPSILON, phase="logw",
                            logw_raw=lw_raw)

                if self.mesh is None:
                    fut_logw = _host_executor().submit(logw_work)
                else:
                    logw_work()

        static_meta = ()
        if self.cfg.ibsi:
            # IBSI no-binning mode sizes level axes by the max integer
            # intensity.  Using the per-batch max forced a recompile for
            # every distinct batch max (VERDICT r1 weak #5); instead use
            # the SLIDE max rounded up to the next power of two, so at
            # most one compile per slide magnitude.  Level rows above a
            # ROI's max stay empty and do not change any feature (Ng_p
            # terms count PRESENT levels).
            ceil = max(int(smax), 2)
            ceil = 1 << (ceil - 1).bit_length()
            static_meta = (("max_int", ceil),)
        np_dt = np.float32 if dtype == jnp.float32 else np.float64
        want_lw = contours is not None and self._needs_logw
        # transfer compression (fused path): intensity crops ship in the
        # narrowest EXACT dtype (uint16/uint32 -> compute-dtype cast on
        # device, identical IEEE rounding to the host cast), masks ship
        # bit-packed; int_tr/flat_ok were decided before batching

        vlog(2, "\t%d ROI batches over %d trivial + %d oversized ROIs"
             % (len(batches), len(triv_rows), len(over_rows)))
        def build_lw(idxs=None, hb=None, wb=None, B=None, pad_b=None):
            """Padded per-batch weighted-moment factor: log(sqrt(d2)+eps)
            with d2 the reference's APPROXIMATE min distance to the
            ordered contour (pixel.cpp:36-71; exact distances diverge).
            lw_raw mode ships the raw integer d2 (u16 when the crop
            diagonal fits, else u32) and the kernel takes the log.
            Requires the logw worker joined (fut_logw)."""
            have_flat = (hc is not None
                         and getattr(hc, "logw_flat", None) is not None)
            raw = lw_raw and (not have_flat
                              or getattr(hc, "logw_flat_is_d2", False))
            if raw:
                d2max = (hb - 1) ** 2 + (wb - 1) ** 2
                lw_dt = np.uint16 if d2max < 65536 else np.uint32
            else:
                lw_dt = np_dt
            lw_h = np.zeros((B + pad_b, hb, wb), lw_dt)
            if have_flat:
                # flat per-pixel log distances from the batched native
                # geometry pass, scattered into the padded crop frame
                # with ONE fancy-index per batch
                gx, gy, _, coff = hc.clouds
                lwf = hc.logw_flat
                segs = []
                for bi, i in enumerate(idxs):
                    j = hrow_pos[i]
                    a, b = int(coff[j]), int(coff[j + 1])
                    if b <= a:
                        continue
                    r = recs[i]
                    segs.append((bi, a, b, r.y0, r.x0))
                if segs:
                    bi_f = np.concatenate(
                        [np.full(b - a, bi, np.int64)
                         for bi, a, b, _, _ in segs])
                    gy_f = np.concatenate(
                        [gy[a:b] - y0_ for _, a, b, y0_, _ in segs])
                    gx_f = np.concatenate(
                        [gx[a:b] - x0_ for _, a, b, _, x0_ in segs])
                    lw_f = np.concatenate(
                        [lwf[a:b] for _, a, b, _, _ in segs])
                    lw_h[bi_f, gy_f, gx_f] = lw_f
            else:
                from .. import native
                from ..ops.moments import WEIGHTING_EPSILON
                for bi, i in enumerate(idxs):
                    K = contours[i]
                    if K is None or K.shape[0] == 0:
                        continue
                    r = recs[i]
                    if resident is not None:
                        sl = (slice(r.y0, r.y1 + 1),
                              slice(r.x0, r.x1 + 1))
                        cm_i = resident[1][sl] == r.label
                    else:
                        ii_c, ll_c = padded_crop(i, hb, wb)
                        cm_i = ll_c[:r.height, :r.width] == r.label
                    ys_i, xs_i = np.nonzero(cm_i)
                    mind2, _ = native.contour_sqdist_approx(
                        xs_i.astype(np.float64), ys_i.astype(np.float64),
                        K[:, 0].astype(np.float64),
                        K[:, 1].astype(np.float64))
                    lw_h[bi, ys_i, xs_i] = mind2 if raw else \
                        np.log(np.sqrt(mind2) + WEIGHTING_EPSILON)
            if pad_b:
                lw_h[B:] = lw_h[0]
            return lw_h

        if fut_logw is not None and resident is None:
            # streamed slides: the logw worker reads regions through the
            # shared crop_cache the batch loop below also populates/pops --
            # join here so cache access stays single-threaded (resident
            # slides keep the overlap; their cloud build never touches
            # the cache)
            fut_logw.result()
            fut_logw = None

        pending = []        # mesh path: (idxs, lkey, out)
        fused = []          # single-dispatch path: (idxs, device bucket args)
        # tight-transfer path: the fresh-content H2D link is ~30 MB/s, so
        # dense padded crops (bucket AABB + batch padding ~2.7x the real
        # bytes) are replaced by ONE per-slide uint8 buffer of exact
        # per-ROI crops; the universal slide program (or, for >64 px
        # shapes, _extract_bucket_flat) gathers the padded planes back out
        # on device.  flat_ok was decided before batching.
        flat = []           # (idxs, shape, B, pad_b, meta_i9, meta_f)
        flat_writes = []    # (byte_offset, uint8 bytes) into the buffer
        flat_lw = []        # (idxs, shape, B, lw_off_bytes[B], lw_dt)
        flat_cursor = [0]

        def _flat_alloc(nbytes):
            off = flat_cursor[0]
            flat_cursor[0] = off + ((nbytes + 3) & ~3)   # 4-byte align
            return off
        for shape, idxs in batches:
            sw_batch = stopwatch("Pipeline/Phase2_device_batches/#33cc77")
            sw_batch.__enter__()
            batch_recs = [recs[i] for i in idxs]
            hb, wb = shape
            # crops are assembled HOST-side and shipped once: the device-side
            # vmapped dynamic_slice gather from a resident slide compiled to
            # a far slower program than a plain H2D of the packed crops, and
            # the whole padded slide no longer needs transferring
            B = len(idxs)
            pad_b = 0
            if flat_ok and max(hb, wb) in _uni_cap:
                # universal-program block: pad straight to the block
                # capacity (pad rows replicate row 0 and ship ZERO bytes
                # on the tight path)
                pad_b = _uni_cap[max(hb, wb)] - B
            elif self.mesh is None and max(hb, wb) <= 64:
                # nucleus-scale buckets: pad the batch axis straight to the
                # chunk cap -- ONE executable signature per bucket shape
                # (pad rows replicate row 0, cheap on the wire and dropped
                # at unpack time)
                bq = _CHUNK_CAP[max(hb, wb)]
                pad_b = bq - B
            elif self.mesh is None and max(hb, wb) <= 256:
                # big-ROI buckets: pow2-quantized batch axis (signature
                # space {8,16,...,cap}); their texture intermediates scale
                # ~ng x the crop, so cap-padding would be HBM-expensive
                bq = max(8, 1 << (B - 1).bit_length())
                pad_b = bq - B
            tr_dt = int_tr if int_tr is not None else np_dt
            pad_recs = batch_recs + [batch_recs[0]] * pad_b
            meta_i = np.asarray([[r.area, r.y0, r.x0, r.height, r.width]
                                 for r in pad_recs], np.int32)
            meta_f = np.asarray([[r.vmin, r.vmax, smin, smax, hu_offset]
                                 for r in pad_recs], np_dt)
            if flat_ok:
                # tight sections: each ROI ships its exact (h x w) crop.
                # Pixels the dense path shipped OUTSIDE the ROI's AABB
                # (other slide content inside the bucket window) are
                # masked off by every kernel anyway -- the reference's
                # ImageMatrix is AABB-sized too (image_matrix.h)
                lw_isz = 2 if (hb - 1) ** 2 + (wb - 1) ** 2 < 65536 else 4
                ci_isz = np.dtype(int_tr).itemsize
                offs = np.zeros((B + pad_b, 3), np.int32)
                lw_offs = np.zeros(B, np.int32)
                for bi, i in enumerate(idxs):
                    r = recs[i]
                    h_t, w_t = r.height, r.width
                    npx = h_t * w_t
                    if resident is not None:
                        intens_r, label_r = resident
                        H, W = label_r.shape
                        h_av = max(0, min(h_t, H - r.y0))
                        w_av = max(0, min(w_t, W - r.x0))
                        sl = (slice(r.y0, r.y0 + h_av),
                              slice(r.x0, r.x0 + w_av))
                        if (h_av, w_av) == (h_t, w_t):
                            ci_t = intens_r[sl]
                            cm_t = label_r[sl] == r.label
                        else:
                            ci_t = np.zeros((h_t, w_t), tr_dt)
                            cm_t = np.zeros((h_t, w_t), bool)
                            ci_t[:h_av, :w_av] = intens_r[sl]
                            cm_t[:h_av, :w_av] = label_r[sl] == r.label
                    else:
                        ii, ll = padded_crop(i, hb, wb)
                        ci_t = ii[:h_t, :w_t]
                        cm_t = ll[:h_t, :w_t] == r.label
                    o_ci = _flat_alloc(npx * ci_isz)
                    flat_writes.append((o_ci, np.ascontiguousarray(
                        ci_t, dtype=tr_dt).view(np.uint8).ravel()))
                    mbits = np.packbits(np.ascontiguousarray(cm_t).ravel())
                    o_m = _flat_alloc(mbits.nbytes)
                    flat_writes.append((o_m, mbits))
                    o_lw = _flat_alloc(npx * lw_isz) if want_lw else 0
                    offs[bi] = (o_ci, o_lw, o_m)
                    lw_offs[bi] = o_lw
                if pad_b:
                    offs[B:] = offs[0]
                flat.append((idxs, shape, B, pad_b,
                             np.hstack([meta_i, offs]).astype(np.int32),
                             meta_f))
                if want_lw:
                    flat_lw.append((idxs, shape, B, lw_offs,
                                    np.uint16 if lw_isz == 2 else np.uint32))
                for i in idxs:
                    crop_cache.pop((i,) + shape, None)
                sw_batch.__exit__()
                vlog(3, "\t\tbatch %dx%dx%d packed tight" % (B, *shape))
                continue
            ci_h = np.zeros((B + pad_b, hb, wb), tr_dt)
            cm_h = np.zeros((B + pad_b, hb, wb), bool)
            if resident is not None:
                intens_r, label_r = resident
                H, W = label_r.shape
                for bi, i in enumerate(idxs):
                    r = recs[i]
                    h_av = max(0, min(hb, H - r.y0))
                    w_av = max(0, min(wb, W - r.x0))
                    sl = (slice(r.y0, r.y0 + h_av), slice(r.x0, r.x0 + w_av))
                    ci_h[bi, :h_av, :w_av] = intens_r[sl]
                    cm_h[bi, :h_av, :w_av] = label_r[sl] == r.label
            else:
                for bi, i in enumerate(idxs):
                    ii, ll = padded_crop(i, hb, wb)
                    ci_h[bi] = ii
                    cm_h[bi] = ll == recs[i].label
            if pad_b:
                ci_h[B:] = ci_h[0]
                cm_h[B:] = cm_h[0]

            lw_h = None
            if want_lw and self.mesh is not None:
                lw_h = build_lw(idxs, hb, wb, B, pad_b)

            if self.mesh is not None:
                ci = jnp.asarray(ci_h)
                cm = jnp.asarray(cm_h)
                lw = jnp.asarray(lw_h) if lw_h is not None else None
                batch_args = (ci, cm, jnp.asarray(meta_i[:, 0]),
                              jnp.asarray(meta_f[:, 0]),
                              jnp.asarray(meta_f[:, 1]),
                              jnp.asarray(meta_i[:, 1]),
                              jnp.asarray(meta_i[:, 2]),
                              jnp.asarray(meta_i[:, 3]),
                              jnp.asarray(meta_i[:, 4]),
                              jnp.asarray(meta_f[:, 2]),
                              jnp.asarray(meta_f[:, 3]),
                              jnp.asarray(meta_f[:, 4]))
                # shard the ROI axis over the device mesh; padded rows
                # (copies of row 0) are dropped at collection time
                from ..parallel import shard_batch
                sharded, _ = shard_batch(self.mesh, batch_args + (lw,))
                batch_args = sharded[:11]
                hu_arr = sharded[11]
                lw = sharded[12]
                bsz = int(batch_args[0].shape[0])
                lkey = _bucket_key(self.families, self.cfg, static_meta,
                                   (bsz,) + shape, lw is not None)
                out = _extract_bucket_packed(*batch_args,
                                             self.families, self.cfg,
                                             static_meta, lw, hu_arr,
                                             layout_key=lkey)
                pending.append((idxs, lkey, out))
            else:
                # bit-pack the mask for transfer (8x fewer bytes; the kernel
                # unpacks on device).  The lw plane is attached AFTER the
                # loop (once the logw worker joins) so crop assembly and
                # the native distance pass run concurrently; ci/cm start
                # their async H2D transfers here.
                cm_p = np.packbits(cm_h, axis=2)
                fused.append((idxs, [jnp.asarray(ci_h), jnp.asarray(cm_p),
                                     jnp.asarray(meta_i),
                                     jnp.asarray(meta_f), None],
                              (shape, B, pad_b)))
            # drop only THIS batch's crops: crops read once during the
            # contour pass stay cached until their own batch consumes them
            # (a blanket clear re-read every later batch's regions from disk)
            for i in idxs:
                crop_cache.pop((i,) + shape, None)
            sw_batch.__exit__()
            vlog(3, "\t\tbatch %dx%dx%d dispatched" % (len(idxs), *shape))

        fused_outs = []      # (idxs, lkey, out) one dispatched exec per bucket
        if fused:
            with stopwatch("Pipeline/Phase2_device_batches/#33cc77"):
                if want_lw:
                    # join the logw worker and attach the lw planes
                    if fut_logw is not None:
                        fut_logw.result()
                    for idxs_b, args_b, (shape_b, B_b, pad_b_b) in fused:
                        lwb = build_lw(idxs_b, shape_b[0], shape_b[1],
                                       B_b, pad_b_b)
                        args_b[4] = jnp.asarray(lwb)
                # ONE executable PER BUCKET, all dispatched asynchronously
                # before any result is touched: executions queue
                # back-to-back on the device, so per-bucket dispatch costs
                # the same wall as one whole-pair fusion (measured: 39.5 vs
                # 38.8 ms on the bench slide) -- while the compile
                # signature shrinks from the TUPLE of all bucket shapes to
                # a single (Bq, h, w), which RECURS across slides with
                # different ROI populations (time-to-first-row: only
                # never-seen bucket signatures compile)
                def dispatch(entry):
                    idxs_b, args_b, _ = entry
                    a = tuple(args_b)
                    lkey = _bucket_key(self.families, self.cfg, static_meta,
                                       tuple(a[0].shape), want_lw)
                    out = _extract_pair_packed((a,), self.families, self.cfg,
                                               static_meta, layout_key=lkey)
                    # D2H happens once per slide via the concatenated slab
                    # below (copy_to_host_async there)
                    return idxs_b, lkey, out

                if len(fused) > 1:
                    # dispatch buckets from threads: when several
                    # signatures compile for the first time, the XLA
                    # compiles (GIL-free) run in parallel; on warm caches
                    # the handoff costs microseconds
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(len(fused)) as dex:
                        fused_outs = list(dex.map(dispatch, fused))
                else:
                    fused_outs = [dispatch(fused[0])]

        if flat:
            with stopwatch("Pipeline/Phase2_device_batches/#33cc77"):
                if want_lw:
                    if fut_logw is not None:
                        fut_logw.result()
                        fut_logw = None
                total = flat_cursor[0]
                # 2 MB floor: the buffer length is part of every flat
                # kernel's compile signature, so one shared size serves
                # every dense slide and the signature set stays ONE per
                # (shape-set, Nq); the floor's cost on the GPU is ROADMAP D2
                Lq = 1 << max(21, (max(total, 2) - 1).bit_length())
                buf_np = np.zeros(Lq, np.uint8)
                for off, bts in flat_writes:
                    buf_np[off:off + bts.nbytes] = bts
                if flat_lw:
                    self._fill_lw_tight(buf_np, flat_lw, recs, hc, hrow_pos,
                                        contours, source, lw_raw)
                # ONE H2D put per slide: every bucket kernel gathers its
                # padded planes from this buffer on device
                buf_dev = jnp.asarray(buf_np)
                ci_u32 = np.dtype(int_tr).itemsize == 4

                # pack universal-block entries into as few executions of
                # the ONE universal slide program as possible; leftover
                # shapes (>64 px) dispatch per-bucket
                uni_shapes = [(hb2, wb2) for hb2, wb2, _ in _UNIVERSAL_CAPS]
                uni_lists = {s: [] for s in uni_shapes}
                others = []
                for e in flat:
                    s = tuple(e[1])
                    if s in uni_lists:
                        uni_lists[s].append(e)
                    else:
                        others.append(e)
                n_exec = max((len(v) for v in uni_lists.values()),
                             default=0)
                lkey_uni = ("uni", _UNIVERSAL_CAPS, self.families,
                            self.cfg, static_meta, want_lw)
                dtf = np.float32 if dtype == jnp.float32 else np.float64
                for k in range(n_exec):
                    metas_i, metas_f, ridx_parts, idx_list = [], [], [], []
                    base = 0
                    for (hb2, wb2, cap) in _UNIVERSAL_CAPS:
                        lst = uni_lists[(hb2, wb2)]
                        if k < len(lst):
                            idxs_b, _s, B_b, _p, mi9, mf = lst[k]
                            metas_i.append(mi9)
                            metas_f.append(mf)
                            ridx_parts.append(base + np.arange(B_b,
                                                               dtype=np.int32))
                            idx_list.extend(idxs_b)
                        else:
                            dummy = np.zeros((cap, 8), np.int32)
                            dummy[:, 3] = 1     # h=w=1 -> gathers byte 0
                            dummy[:, 4] = 1
                            metas_i.append(dummy)
                            metas_f.append(np.zeros((cap, 5), dtf))
                        base += cap
                    ridx = np.concatenate(ridx_parts)
                    nq = next(q for q in (128, 320, 576)
                              if q >= len(ridx))
                    ridx = np.concatenate(
                        [ridx, np.full(nq - len(ridx), ridx[0], np.int32)])
                    out = _call_slide_fused(
                        buf_dev,
                        tuple(jnp.asarray(m) for m in metas_i),
                        tuple(jnp.asarray(m) for m in metas_f),
                        jnp.asarray(ridx), self.families, self.cfg,
                        static_meta, want_lw, ci_u32, lkey_uni)
                    fused_outs.append((idx_list, lkey_uni, out))

                def dispatch_flat(entry):
                    idxs_b, shape_b, B_b, pad_b_b, mi9, mf = entry
                    Bq = mi9.shape[0]
                    lkey = _bucket_key(self.families, self.cfg, static_meta,
                                       (Bq,) + tuple(shape_b), want_lw)
                    hb2, wb2 = shape_b
                    out = _extract_bucket_flat(
                        buf_dev, jnp.asarray(mi9), jnp.asarray(mf),
                        self.families, self.cfg, static_meta,
                        shape=tuple(shape_b), has_lw=want_lw,
                        ci_u32=ci_u32,
                        lw_u32=(hb2 - 1) ** 2 + (wb2 - 1) ** 2 >= 65536,
                        layout_key=lkey)
                    return idxs_b, lkey, out

                if len(others) > 1:
                    from concurrent.futures import ThreadPoolExecutor
                    with ThreadPoolExecutor(len(others)) as dex:
                        fused_outs.extend(dex.map(dispatch_flat, others))
                elif others:
                    fused_outs.append(dispatch_flat(others[0]))

        fused_slab = None
        if fused_outs:
            # ONE D2H per slide: concatenate the per-bucket packed outputs
            # device-side (every bucket shares the same layout width) and
            # start a single async host copy; finish() slices rows back out
            outs_ = [o for _, _, o in fused_outs]
            fused_slab = (jnp.concatenate(outs_, axis=0)
                          if len(outs_) > 1 else outs_[0])
            try:
                fused_slab.copy_to_host_async()
            except Exception:
                pass

        # pre-collect host families: their declared deps avoid any
        # device-computed member, so they run while the dispatched device
        # batches execute.  Oversized rows join the host pass when they have
        # a streamed contour: contour/hull/caliper/circle/geodetic families
        # need only the contour + already-computed scalars; pixel-sweep
        # families (chords, radius, radial distribution, IMQ) check
        # hc.pixels_ok(i) and leave those rows unassigned.
        def run_host(names):
            for name in names:
                fam = registry.FAMILIES[name]
                with stopwatch("Pipeline/Host/%s/#bbbbbb" % name):
                    members = fam.host_fn(hc, self.cfg)
                self._scatter(values, host_rows, {name: members})

        fut_rest = None
        if hc is not None:
            # heavy half of the native geometry pass (chords, hull,
            # calipers, contour stats, fractal, radius, radial): native and
            # GIL-free, so on the fused path it runs on the host worker
            # thread concurrently with the device execution AND the main
            # thread's next-slide host stages; finish() joins it
            def rest_work():
                if contours is not None:
                    with stopwatch("Pipeline/Host/geom_batch/#99bb55"):
                        from . import hostfeats
                        hostfeats.compute_geom(
                            hc, self.cfg,
                            registry.activated_families(self.fset),
                            phase="rest", exclude=hostfeats.DIST_FAMILIES)

            if self.mesh is None:
                fut_rest = _host_executor().submit(rest_work)
            else:
                rest_work()
                run_host(pre_host)

        def finish():
            """Collect device results and run the device-dependent tail.
            Split out so a caller can overlap the NEXT pair's host stages
            with THIS pair's (asynchronous) device execution."""
            # oversized ROIs COMPUTE first: the streamed phase-3 pass is
            # pure host work (reference phase 3, phase3.cpp:24-127) and
            # overlaps THIS slide's still-executing device batches + async
            # D2H.  Host-only families (chords, radius, radial, IMQ) are
            # included: their streamed variants consume the streamed
            # contour.  The SCATTER happens after run_host(pre_host) below
            # -- the host-geometry pass writes unassigned sentinels for
            # oversized rows and must not clobber these results.
            over_fams = registry.activated_families(self.fset)
            over_res = []
            for i in over_rows:
                with stopwatch("Pipeline/Phase3_oversized/#cc7733"):
                    res = ovs.process(recs[i], source, self.cfg, over_fams,
                                      smin, smax,
                                      contour=(contours[i]
                                               if contours is not None
                                               else None),
                                      hu_offset=hu_offset)
                over_res.append(
                    (i, {fam: {m: np.asarray(v)[None]
                               for m, v in mem.items()}
                         for fam, mem in res.items()}))

            with stopwatch("Pipeline/Phase2_collect/#33aa99"):
                if fused_outs:
                    packed_all = np.asarray(fused_slab)
                    row = 0
                    for idxs, lkey, o in fused_outs:
                        packed = packed_all[row:row + o.shape[0]]
                        row += o.shape[0]
                        src, dst = self._colmap(lkey)
                        # one fancy-index instead of ~750 per-member scatters
                        values[np.ix_(np.asarray(idxs), dst)] = \
                            packed[:len(idxs)][:, src]
                if pending:
                    fetched = jax.device_get([out for _, _, out in pending])
                    for (idxs, lkey, _), packed in zip(pending, fetched):
                        self._scatter(values, idxs,
                                      _unpack_bucket(packed[:len(idxs)],
                                                     _BUCKET_LAYOUTS[lkey]))

            # join the host-geometry worker (fused path) and run the
            # pre-collect host families it feeds
            if fut_logw is not None:
                fut_logw.result()
            if fut_rest is not None:
                fut_rest.result()
                run_host(pre_host)

            # phase-3 results land AFTER the host-geometry scatters
            for i, res in over_res:
                self._scatter(values, [i], res)

            # device-dependent host families (circles, geodetic, neighbors,
            # hexagonality read centroids/areas computed device-side).
            # Oversized ROIs are excluded (no contour/dense crop); their
            # host members stay unassigned.
            if hc is not None:
                run_host(post_host)

            # anisotropy: BBOX_* report the apply_anisotropy-scaled AABB
            # even though the crop box was widened to cover out-of-AABB
            # member pixels (basic_morphology.cpp:33-37 reads r.aabb)
            for j, r in enumerate(recs):
                if r.report_bbox is None:
                    continue
                ry0, ry1, rx0, rx1 = r.report_bbox
                w, h = float(rx1 - rx0 + 1), float(ry1 - ry0 + 1)
                for member, v in (("BBOX_XMIN", float(rx0)),
                                  ("BBOX_YMIN", float(ry0)),
                                  ("BBOX_WIDTH", w), ("BBOX_HEIGHT", h),
                                  ("EXTENT", r.area / (w * h)),
                                  ("ASPECT_RATIO", w / h)):
                    code = tx.NAME2CODE_2D.get(member)
                    if code in self.member_slots:
                        off, _ = self.member_slots[code]
                        values[j, off] = v

            if len(recs) != len(all_recs):
                # reinsert blacklisted rows with unassigned values
                out = np.full((len(all_recs), len(self._out_cols)), -0.0)
                kept_idx = {r.label: i for i, r in enumerate(recs)}
                for j, r in enumerate(all_recs):
                    if r.label in kept_idx:
                        out[j] = values[kept_idx[r.label], self._out_cols]
                return out
            return values[:, self._out_cols]

        if async_collect:
            return labs_all, finish
        return labs_all, finish()

    @staticmethod
    def _fill_lw_tight(buf_np, flat_lw, recs, hc, hrow_pos, contours,
                       source, lw_raw):
        """Write raw squared contour distances (pixel.cpp:36-71 approximate
        min over the ordered contour) into the tight transfer buffer's
        per-ROI lw sections.  Values only at mask pixels; the rest stays 0
        and becomes log(eps) on device, matching the dense path."""
        from .. import native
        u16v = buf_np.view(np.uint16)
        u32v = buf_np.view(np.uint32)
        have_flat = (hc is not None
                     and getattr(hc, "logw_flat", None) is not None
                     and getattr(hc, "logw_flat_is_d2", False))
        for idxs_b, _shape_b, B_b, lw_offs, lw_dt in flat_lw:
            view, esz = (u16v, 2) if lw_dt == np.uint16 else (u32v, 4)
            if have_flat:
                gx, gy, _, coff = hc.clouds
                lwf = hc.logw_flat
                idx_parts, val_parts = [], []
                for bi in range(B_b):
                    i = idxs_b[bi]
                    j = hrow_pos.get(i)
                    if j is None:
                        continue
                    a, b = int(coff[j]), int(coff[j + 1])
                    if b <= a:
                        continue
                    r = recs[i]
                    base = lw_offs[bi] // esz
                    idx_parts.append(base + (gy[a:b] - r.y0) * r.width
                                     + (gx[a:b] - r.x0))
                    val_parts.append(lwf[a:b])
                if idx_parts:
                    view[np.concatenate(idx_parts)] = \
                        np.concatenate(val_parts).astype(lw_dt)
            else:
                from ..ops.moments import WEIGHTING_EPSILON  # noqa: F401
                for bi in range(B_b):
                    i = idxs_b[bi]
                    K = contours[i] if contours is not None else None
                    if K is None or K.shape[0] == 0:
                        continue
                    r = recs[i]
                    ii_c, ll_c = source.read_pair(r.y0, r.x0,
                                                  r.height, r.width)
                    ys_i, xs_i = np.nonzero(ll_c == r.label)
                    if len(ys_i) == 0:
                        continue
                    mind2, _ = native.contour_sqdist_approx(
                        xs_i.astype(np.float64), ys_i.astype(np.float64),
                        K[:, 0].astype(np.float64),
                        K[:, 1].astype(np.float64))
                    base = lw_offs[bi] // esz
                    view[base + ys_i * r.width + xs_i] = \
                        mind2.astype(lw_dt)

    def _colmap(self, lkey):
        """(src cols in the packed layout, dst cols in the value matrix)
        as index arrays, cached per packed-layout key."""
        if lkey not in self._colmaps:
            layout = _BUCKET_LAYOUTS[lkey]
            src, dst = [], []
            for (fam, member), (off, w) in layout.items():
                code = registry.FAMILIES[fam].member_code(member)
                if code is None or code not in self.member_slots:
                    continue
                doff, dwidth = self.member_slots[code]
                k = min(w, dwidth)
                src.extend(range(off, off + k))
                dst.extend(range(doff, doff + k))
            self._colmaps[lkey] = (np.asarray(src, np.int64),
                                   np.asarray(dst, np.int64))
        return self._colmaps[lkey]

    def _scatter(self, values, idxs, out):
        """Place family outputs into the row value matrix."""
        rows = np.asarray(idxs)
        for fam_name, members in out.items():
            fam = registry.FAMILIES[fam_name]
            for member, arr in members.items():
                code = fam.member_code(member)
                if code is None or code not in self.member_slots:
                    continue
                off, width = self.member_slots[code]
                arr = np.asarray(arr, np.float64)
                if arr.ndim == 1:
                    arr = arr[:, None]
                w = min(width, arr.shape[1])
                values[rows, off:off + w] = arr[:, :w]
