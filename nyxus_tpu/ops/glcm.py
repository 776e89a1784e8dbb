"""GLCM (grey-level co-occurrence matrix) features, batched over ROIs.

Implements the reference's GLCMFeature semantics
(reference: src/nyx/features/glcm.cpp:227-1213) as batched tensor algebra:

* co-occurrence counting is a one-hot contraction
  ``M[b,i,j] = sum_p onehot(neighbor)_i * onehot(center)_j * valid_p``
  -- an [Ng, A] x [A, Ng] matmul per (ROI, angle); one-hot vs scatter on
  the GPU is ROADMAP S4
* pairs where either pixel's ORIGINAL intensity is 0 are skipped
  (glcm.cpp:443-449): background exclusion
* angles {0,45,90,135} with displacement (dx,dy) per glcm.cpp:235-255;
  the matrix is asymmetric in MATLAB-binning mode, symmetrized in IBSI mode
  (glcm.cpp:474-477)
* marginal conventions kept faithfully: ``by_row_mean`` is the
  neighbor-axis marginal mean and drives CLUPROM/CLUSHADE/CLUTEND for both
  mu_x and mu_y (glcm.cpp:516-538, 986-1040); JVAR deviates by matrix INDEX
  while JAVE is level-valued (glcm.cpp:1146-1195)
* entropies use fast_log10(p + 1e-9)/LOG10_2 -- the reference's float32
  quadratic log approximation (helpers.h:283-327), mirrored by
  ops.common.fast_log2; an exact log diverges ~1e-3
  where the reference uses a float32 polynomial approximation (~1e-3 rel) --
  our values are closer to the mathematical definition and well inside the
  reference's own oracle tolerances

Degenerate cases (glcm.cpp:26-100, 259-296): bin(min)==bin(max) or an empty
co-occurrence matrix emit the soft-NAN placeholder for every member.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
from jax import lax
import numpy as np

from . import quant

EPS = 1e-9  # reference: glcm.h:262

# angle -> (dx, dy), reference: glcm.cpp:235-255
ANGLE_OFFSETS = {0: (1, 0), 45: (1, 1), 90: (0, 1), 135: (-1, 1)}

# member base names in the order used throughout
MEMBERS = [
    "GLCM_ACOR", "GLCM_ASM", "GLCM_CLUPROM", "GLCM_CLUSHADE", "GLCM_CLUTEND",
    "GLCM_CONTRAST", "GLCM_CORRELATION", "GLCM_DIFAVE", "GLCM_DIFENTRO",
    "GLCM_DIFVAR", "GLCM_DIS", "GLCM_ENERGY", "GLCM_ENTROPY", "GLCM_HOM1",
    "GLCM_HOM2", "GLCM_ID", "GLCM_IDN", "GLCM_IDM", "GLCM_IDMN",
    "GLCM_INFOMEAS1", "GLCM_INFOMEAS2", "GLCM_IV", "GLCM_JAVE", "GLCM_JE",
    "GLCM_JMAX", "GLCM_JVAR", "GLCM_SUMAVERAGE", "GLCM_SUMENTROPY",
    "GLCM_SUMVARIANCE", "GLCM_VARIANCE",
]
# members that have no _AVE counterpart in the featureset: HOM2 (glcm.h lists
# GLCM_HOM2 angled only)
AVE_MEMBERS = [m for m in MEMBERS if m != "GLCM_HOM2"]


from .common import shifted2d as _shifted, fast_log2


def cooc_matrices(orig, levels, angles, offset: int, ng: int, symmetric: bool):
    """Co-occurrence count matrices for all angles.

    orig:   [B, H, W] masked original intensities (0 = background/off-ROI)
    levels: [B, H, W] int32 binned levels (1-based)
    -> [B, n_angles, ng, ng] float32/float64 counts; axis 2 indexes the
    NEIGHBOR level - 1 ('a'), axis 3 the CENTER level - 1 ('b').
    """
    B, H, W = orig.shape
    dt = orig.dtype
    mats = []
    lev_idx = levels.astype(jnp.int32) - 1
    center_valid = orig > 0
    arange = jnp.arange(ng, dtype=jnp.int32)
    for ang in angles:
        dx, dy = ANGLE_OFFSETS[ang]
        dx, dy = dx * offset, dy * offset
        nb_orig = _shifted(orig, dx, dy)
        nb_lev = _shifted(lev_idx, dx, dy)
        valid = (center_valid & (nb_orig > 0)).reshape(B, -1).astype(dt)
        a = nb_lev.reshape(B, -1)
        b = lev_idx.reshape(B, -1)
        from .common import pair_hist
        mats.append(pair_hist(a, b, valid, ng, ng))
    M = jnp.stack(mats, axis=1)
    if symmetric:
        M = M + jnp.swapaxes(M, -1, -2)
    return M


def glcm_features_from_matrix(M, ng: int, noval: float, ng_val=None,
                              val=None, kvs=None, kvd=None):
    """All 30 angled GLCM features from count matrices.

    M: [B, A, ng, ng] counts (axis -2 = neighbor 'x', axis -1 = center 'y').
    Level values default to I[i] = i + 1 (MATLAB/IBSI uniform-level
    convention).  Radiomics binning indexes the matrix by the RANK of each
    present level and passes the per-ROI arrays the reference derives from
    its unique-level vector I (glcm.cpp:389-398, 503-513):
      val [B, ng]      I[rank] (level value at each rank; 0 beyond Ng)
      kvs [B, 2ng-1]   kValuesSum (last-writer pair, glcm.cpp:511)
      kvd [B, ng]      kValuesDiff
      ng_val [B]       Ng = |I|
    Returns dict member -> [B, A]; caller handles degenerate masking of the
    whole family, this handles per-angle empty matrices.
    """
    dt = M.dtype
    sum_p = jnp.sum(M, axis=(-1, -2))                       # [B, A]
    empty = sum_p == 0
    p = M / jnp.where(empty, 1, sum_p)[..., None, None]     # joint probability

    idx = jnp.arange(ng, dtype=dt)                          # 0-based index
    if val is None:
        valB = (idx + 1.0)[None, None, :]                   # level value I
    else:
        valB = val.astype(dt)[:, None, :]
    valr = valB[..., :, None]
    valc = valB[..., None, :]

    px_n = jnp.sum(p, axis=-1)   # [B, A, ng] neighbor-axis marginal (sum over center)
    px_c = jnp.sum(p, axis=-2)   # [B, A, ng] center-axis marginal

    mr = jnp.sum(px_c * valB, axis=-1)       # center-marginal mean (f_corr mr)
    mc = jnp.sum(px_n * valB, axis=-1)       # neighbor-marginal mean (= by_row_mean)

    # Pxpy / Pxmy via constant one-hot matmuls over the ng*ng cells
    ii = np.arange(ng)
    diff_oh = jnp.asarray(
        (np.abs(ii[:, None] - ii[None, :]).reshape(-1)[:, None]
         == np.arange(ng)[None, :]).astype(np.float64), dt)      # [ng*ng, ng]
    sum_oh = jnp.asarray(
        ((ii[:, None] + ii[None, :]).reshape(-1)[:, None]
         == np.arange(2 * ng - 1)[None, :]).astype(np.float64), dt)
    pflat = p.reshape(p.shape[:-2] + (ng * ng,))
    pxmy = jnp.einsum("bak,kd->bad", pflat, diff_oh,         # [B, A, ng]
                      preferred_element_type=dt,
                      precision=lax.Precision.HIGHEST)
    pxpy = jnp.einsum("bak,ks->bas", pflat, sum_oh,          # [B, A, 2ng-1]
                      preferred_element_type=dt,
                      precision=lax.Precision.HIGHEST)

    k = idx                                                  # diff index values
    if kvs is None:
        s2 = (jnp.arange(2 * ng - 1, dtype=dt) + 2.0)[None, None, :]
    else:
        s2 = kvs.astype(dt)[:, None, :]
    if kvd is None:
        kvdB = k[None, None, :]
    else:
        kvdB = kvd.astype(dt)[:, None, :]

    out = {}
    out["GLCM_ASM"] = jnp.sum(p * p, axis=(-1, -2))
    out["GLCM_ENERGY"] = out["GLCM_ASM"]

    dval = valr - valc
    out["GLCM_CONTRAST"] = jnp.sum(p * dval * dval, axis=(-1, -2))

    # correlation (glcm.cpp:593-644)
    s2r = jnp.sum(px_c * (valB - mr[..., None]) ** 2, axis=-1)
    s2c = jnp.sum(px_n * (valB - mc[..., None]) ** 2, axis=-1)
    cov = jnp.einsum("baij,bai,baj->ba", p,
                     jnp.broadcast_to(valB, p.shape[:2] + (ng,))
                     - mc[..., None],
                     jnp.broadcast_to(valB, p.shape[:2] + (ng,))
                     - mr[..., None], preferred_element_type=dt,
                     precision=lax.Precision.HIGHEST)
    denom = jnp.sqrt(s2r) * jnp.sqrt(s2c)
    out["GLCM_CORRELATION"] = jnp.where(denom > 0, cov / jnp.where(denom > 0, denom, 1),
                                        jnp.asarray(noval, dt))

    out["GLCM_VARIANCE"] = jnp.sum(px_c * (valB - mr[..., None]) ** 2,
                                   axis=-1)

    out["GLCM_IDM"] = jnp.sum(pxmy / (1 + k * k), axis=-1)
    out["GLCM_SUMAVERAGE"] = jnp.sum(pxpy * s2, axis=-1)
    out["GLCM_SUMENTROPY"] = -jnp.sum(pxpy * fast_log2(pxpy + EPS), axis=-1)
    out["GLCM_ENTROPY"] = -jnp.sum(p * fast_log2(p + EPS), axis=(-1, -2))

    # DIFAVE weights by kValuesDiff (LEVEL differences, glcm.cpp:771-780);
    # DIFVAR then deviates the INDEX k from that value (f_dvar)
    difavg = jnp.sum(pxmy * kvdB, axis=-1)
    out["GLCM_DIFAVE"] = difavg
    out["GLCM_DIFVAR"] = jnp.sum((k - difavg[..., None]) ** 2 * pxmy, axis=-1)
    out["GLCM_DIFENTRO"] = -jnp.sum(pxmy * fast_log2(pxmy + EPS), axis=-1)

    # information measures (glcm.cpp:795-915); all "entropies" carry the
    # reference's sign convention (not negated)
    hxy = jnp.sum(p * fast_log2(p + EPS), axis=(-1, -2))
    pxpyij = px_n[..., :, None] * px_c[..., None, :]
    hxy1 = jnp.sum(p * fast_log2(pxpyij + EPS), axis=(-1, -2))
    hxy2 = jnp.sum(pxpyij * fast_log2(pxpyij + EPS), axis=(-1, -2))
    hx = jnp.sum(px_n * fast_log2(px_n + EPS), axis=-1)
    im1 = (hxy - hxy1) / hx
    out["GLCM_INFOMEAS1"] = jnp.where(jnp.isfinite(im1), im1, jnp.asarray(noval, dt))
    out["GLCM_INFOMEAS2"] = jnp.sqrt(jnp.abs(1.0 - jnp.exp(-2.0 * (hxy - hxy2))))

    valbc = jnp.broadcast_to(valB, p.shape[:2] + (ng,))
    out["GLCM_ACOR"] = jnp.einsum("baij,bai,baj->ba", p, valbc, valbc,
                                  preferred_element_type=dt,
                                  precision=lax.Precision.HIGHEST)

    m_clu = valr + valc - 2.0 * mc[..., None, None]
    out["GLCM_CLUTEND"] = jnp.sum(m_clu ** 2 * p, axis=(-1, -2))
    out["GLCM_CLUSHADE"] = jnp.sum(m_clu ** 3 * p, axis=(-1, -2))
    out["GLCM_CLUPROM"] = jnp.sum(m_clu ** 4 * p, axis=(-1, -2))
    out["GLCM_SUMVARIANCE"] = out["GLCM_CLUTEND"]

    absdiff = jnp.abs(idx[:, None] - idx[None, :])
    out["GLCM_DIS"] = jnp.sum(absdiff * p, axis=(-1, -2))
    out["GLCM_HOM1"] = jnp.sum(p / (1.0 + absdiff), axis=(-1, -2))
    out["GLCM_HOM2"] = jnp.sum(p / (1.0 + absdiff * absdiff), axis=(-1, -2))

    # Ng used for the IDN/IDMN normalizations: in IBSI mode the reference
    # sizes Ng by each ROI's own max intensity, which may be smaller than
    # the (power-of-two padded) static matrix size
    if ng_val is None:
        ng_f = jnp.asarray(float(ng), dt)
    else:
        # [B] -> [B, 1, 1]: broadcasts against pxmy's [B, A, K] (a [B, 1]
        # shape silently mis-broadcast whenever B == A and errored otherwise)
        ng_f = ng_val.astype(dt).reshape(ng_val.shape + (1,) * (M.ndim - 2))
    out["GLCM_IDMN"] = jnp.sum(pxmy / (1.0 + (k * k) / (ng_f * ng_f)), axis=-1)
    out["GLCM_ID"] = jnp.sum(pxmy / (1.0 + k), axis=-1)
    out["GLCM_IDN"] = jnp.sum(pxmy / (1.0 + k / ng_f), axis=-1)
    # IV weights by kValuesDiff (glcm.cpp:1116-1131)
    kk = jnp.where(kvdB > 0, kvdB * kvdB, 1)
    out["GLCM_IV"] = jnp.sum(jnp.where(k > 0, pxmy / kk, 0), axis=-1)

    out["GLCM_JAVE"] = mr
    out["GLCM_JE"] = out["GLCM_ENTROPY"]
    out["GLCM_JMAX"] = jnp.max(p, axis=(-1, -2))
    # JVAR deviates the matrix INDEX x+1 from the LEVEL-VALUED joint
    # average (f_GLCM_JVAR, glcm.cpp:1185-1202 -- a faithful mixed-units
    # quirk that only shows under gapped radiomics level sets)
    out["GLCM_JVAR"] = jnp.sum(px_n * ((idx + 1.0)[None, None, :]
                                       - mr[..., None]) ** 2, axis=-1)

    # per-angle empty matrix -> soft NAN (glcm.cpp:259-296)
    nv = jnp.asarray(noval, dt)
    for m in MEMBERS:
        out[m] = jnp.where(empty, nv, out[m])
    return out


def radiomics_rank_info(levels, participate, ng: int, dtype):
    """Per-ROI rank compaction for radiomics binning (glcm.cpp:389-398):
    the reference's unique-level vector I indexes the matrix by RANK.

    levels: [B, ...] radiomics-binned (0 = excluded); participate: same-shape
    bool (original intensity > 0).  Returns (rank [B, ng] (level-1 -> rank),
    val [B, ng] (I, 0-padded), kvs [B, 2ng-1], kvd [B, ng], ngp [B])."""
    from .common import masked_bincount
    B = levels.shape[0]
    lev0 = (levels.astype(jnp.int32) - 1).reshape(B, -1)
    w = participate.reshape(B, -1).astype(dtype)
    present = masked_bincount(lev0, w, ng) > 0                  # [B, ng]
    rank = jnp.cumsum(present.astype(jnp.int32), axis=1) - 1    # [B, ng]
    ngp = jnp.sum(present.astype(dtype), axis=1)
    rr = jnp.arange(ng, dtype=jnp.int32)
    # val[b, r] = level value whose rank is r (one-hot scatter)
    oh = ((rank[:, :, None] == rr[None, None, :]) &
          present[:, :, None]).astype(dtype)
    val = jnp.einsum("blr,l->br", oh, jnp.arange(1, ng + 1, dtype=dtype),
                     preferred_element_type=dtype,
                     precision=lax.Precision.HIGHEST)

    def take(v, idx):
        """v[b, idx[b, k]] via one-hot matmul (tiny)."""
        ohi = (idx[..., None] == rr[None, None, :]).astype(dtype)
        return jnp.einsum("bkl,bl->bk", ohi, v,
                          preferred_element_type=dtype,
                          precision=lax.Precision.HIGHEST)

    ngp_i = ngp.astype(jnp.int32)
    ks = jnp.arange(2 * ng - 1, dtype=jnp.int32)
    # kValuesSum[k]: last writer of the (x outer, y inner) loop is
    # x* = min(k, Ng-1), y* = k - x* (glcm.cpp:503-513)
    xs = jnp.minimum(ks[None, :], jnp.maximum(ngp_i - 1, 0)[:, None])
    ys = jnp.clip(ks[None, :] - xs, 0, ng - 1)
    kvs = take(val, xs) + take(val, ys)
    # kValuesDiff[d]: last writer x = Ng-1, y = Ng-1-d
    kd = jnp.arange(ng, dtype=jnp.int32)
    top = take(val, jnp.maximum(ngp_i - 1, 0)[:, None])          # [B, 1]
    low = take(val, jnp.clip(jnp.maximum(ngp_i - 1, 0)[:, None]
                             - kd[None, :], 0, ng - 1))
    kvd = jnp.abs(top - low)
    return rank, val, kvs, kvd, ngp


def _rank_per_pixel(levels, rank, ng: int, dtype):
    """rank of each pixel's level (garbage where level == 0; callers mask)."""
    B = levels.shape[0]
    lev0 = jnp.clip(levels.astype(jnp.int32) - 1, 0, ng - 1)
    oh = (lev0[..., None] == jnp.arange(ng, dtype=jnp.int32)).astype(dtype)
    rk = jnp.einsum("b...l,bl->b...", oh, rank.astype(dtype),
                    preferred_element_type=dtype,
                    precision=lax.Precision.HIGHEST)
    return rk.astype(jnp.int32)


def glcm_all(orig, levels, vmin, vmax, angles, offset: int, ng: int,
             symmetric: bool, greyinfo: int, noval: float, ng_val=None):
    """Full GLCM family: angled features + _AVE averages + degenerate gating.

    orig: [B, H, W] masked intensities; levels: binned; vmin/vmax: [B].
    Returns dict member -> [B, n_angles] and member_AVE -> [B].
    """
    if greyinfo < 0:
        # radiomics binning: rank-compacted SYMMETRIC matrix over the
        # per-ROI present-level set (glcm.cpp:389-398, 474-477)
        dt = orig.dtype
        rank, val, kvs, kvd, ngp = radiomics_rank_info(levels, orig > 0,
                                                       ng, dt)
        rank_pix = _rank_per_pixel(levels, rank, ng, dt)
        M = cooc_matrices(orig, rank_pix + 1, angles, offset, ng,
                          symmetric=True)
        return glcm_finalize(M, vmin, vmax, greyinfo, noval, ng_val=ngp,
                             val=val, kvs=kvs, kvd=kvd)
    M = cooc_matrices(orig, levels, angles, offset, ng, symmetric)
    return glcm_finalize(M, vmin, vmax, greyinfo, noval, ng_val)


def glcm_finalize(M, vmin, vmax, greyinfo: int, noval: float, ng_val=None,
                  val=None, kvs=None, kvd=None):
    """Features + _AVE means + degenerate gating from count matrices
    M: [B, A, ng, ng].  Shared by the dense path above and the
    tile-streamed oversized path (pipeline/oversized_tex.py)."""
    ng = M.shape[-1]
    out = glcm_features_from_matrix(M, ng, noval, ng_val, val=val, kvs=kvs,
                                    kvd=kvd)

    degen = quant.binned_range_degenerate(vmin, vmax, greyinfo)   # [B]
    nv = jnp.asarray(noval, M.dtype)
    final = {}
    for m in MEMBERS:
        v = jnp.where(degen[:, None], nv, out[m])
        final[m] = v
    for m in AVE_MEMBERS:
        ave = jnp.mean(final[m], axis=-1)
        final[m + "_AVE"] = jnp.where(degen, nv, ave)
    return final
