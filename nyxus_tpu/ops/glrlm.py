"""GLRLM (grey-level run-length matrix) features, batched over ROIs.

Reproduces the reference's GLRLMFeature (reference:
src/nyx/features/glrlm.cpp:40-760): maximal same-level runs along the four
rotation angles {0, 45, 90, 135}, counted into a (level, run-length) matrix
per angle, then 16 scalar statistics per angle + _AVE means.

Faithful behavior notes:
* MATLAB binning (default) maps original intensity 0 -> level 1
  (texture_feature.h:96-117), so AABB background pixels participate in runs;
  run percentage RP = sum_p / Np with Np counting only original-nonzero
  pixels can therefore exceed 1 (glrlm.cpp:298-304, 540-552).
* blank ROI (raw min == max) -> every member soft-NAN (glrlm.cpp:49-72)
* empty matrix at an angle -> that angle's features are 0.0 (not NAN)
  (glrlm.cpp calc_*: `if (sum_p[ai] == 0) af.push_back(0.0)`)

Design: run detection is vectorized — run ends located with a reverse
cumulative min over "level changes here" flags, run lengths read at run
starts, then the (level, length) histogram is a one-hot matmul.  Diagonal
directions are handled by shearing rows so diagonals become columns.
"""

from __future__ import annotations

import jax.numpy as jnp

from .common import fast_log2
import jax.lax as lax
import numpy as np

EPS = 2.2e-16  # reference: glrlm.h:169 / glszm.h:138 / gldm.h:105

MEMBERS = [
    "GLRLM_SRE", "GLRLM_LRE", "GLRLM_GLN", "GLRLM_GLNN", "GLRLM_RLN",
    "GLRLM_RLNN", "GLRLM_RP", "GLRLM_GLV", "GLRLM_RV", "GLRLM_RE",
    "GLRLM_LGLRE", "GLRLM_HGLRE", "GLRLM_SRLGLE", "GLRLM_SRHGLE",
    "GLRLM_LRLGLE", "GLRLM_LRHGLE",
]


def _runs_matrix_along_x(lev, valid, ng: int, nr: int):
    """Run-length histogram for left-to-right runs.

    lev: [B, H, W] int32 levels (1-based); valid: [B, H, W] participation.
    -> [B, ng, nr] counts: entry (l, j) = number of maximal runs of level
    l+1 with length j+1 (lengths > nr are clamped into the last column).
    """
    B, H, W = lev.shape
    same_next = valid[:, :, :-1] & valid[:, :, 1:] & (lev[:, :, :-1] == lev[:, :, 1:])
    same_next = jnp.concatenate([same_next, jnp.zeros((B, H, 1), bool)], axis=2)
    xs = jnp.arange(W, dtype=jnp.int32)
    stop = lax.cummin(jnp.where(~same_next, xs, W), axis=2, reverse=True)
    same_prev = jnp.concatenate([jnp.zeros((B, H, 1), bool), same_next[:, :, :-1]], axis=2)
    is_start = valid & ~same_prev
    runlen = stop - xs + 1                        # valid only at starts

    lev_idx = (lev - 1).reshape(B, -1)
    len_idx = jnp.clip(runlen - 1, 0, nr - 1).reshape(B, -1)
    w = is_start.reshape(B, -1).astype(jnp.float32 if lev.dtype == jnp.int32 else lev.dtype)
    from .common import pair_hist
    return pair_hist(lev_idx, len_idx, w, ng, nr)


def _shear(arr, fill, anti: bool):
    """Shear rows so that diagonals become columns.

    anti=False: 45-deg direction (dy=1, dx=1) -> column x - y + (H-1)
    anti=True:  135-deg direction (dy=1, dx=-1) -> column x + y
    Returns [B, H, W + H - 1].

    Implemented as pad + flat re-view (row y of a width-(K-1) view of a
    width-K buffer starts one column later per row): pure layout ops that
    replaced a take_along_axis gather; whether the gather is cheaper on the
    GPU is ROADMAP S4.  Only fill == 0 is supported (the pad supplies the
    zeros)."""
    assert fill == 0
    B, H, W = arr.shape
    if not anti:
        return _shear(arr[:, ::-1, :], fill, True)[:, ::-1, :]
    K = W + H
    p = jnp.pad(arr, ((0, 0), (0, 0), (0, K - W)))
    return p.reshape(B, H * K)[:, :H * (K - 1)].reshape(B, H, K - 1)


def run_matrices(lev, valid, ng: int, nr: int):
    """[B, 4, ng, nr] run-length matrices for angles 0, 45, 90, 135."""
    mats = [
        _runs_matrix_along_x(lev, valid, ng, nr),                       # 0 deg
        _runs_matrix_along_x(
            jnp.swapaxes(_shear(lev, 0, anti=False), 1, 2),
            jnp.swapaxes(_shear(valid.astype(jnp.int32), 0, anti=False), 1, 2) > 0,
            ng, nr),                                                    # 45 deg
        _runs_matrix_along_x(jnp.swapaxes(lev, 1, 2),
                             jnp.swapaxes(valid, 1, 2), ng, nr),        # 90 deg
        _runs_matrix_along_x(
            jnp.swapaxes(_shear(lev, 0, anti=True), 1, 2),
            jnp.swapaxes(_shear(valid.astype(jnp.int32), 0, anti=True), 1, 2) > 0,
            ng, nr),                                                    # 135 deg
    ]
    return jnp.stack(mats, axis=1)


def glrlm_features(P, n_pixels, vmin, vmax, noval: float, dtype):
    """All 16 GLRLM members from run matrices.

    P: [B, 4, ng, nr] counts; n_pixels: [B] original-nonzero pixel count (Np);
    vmin/vmax: [B] raw intensity extrema for the blank-ROI intercept.
    Returns dict member -> [B, 4] plus member_AVE -> [B].
    """
    P = P.astype(dtype)
    B, A, ng, nr = P.shape
    sum_p = jnp.sum(P, axis=(-1, -2))                    # [B, 4]
    empty = sum_p == 0
    s = jnp.where(empty, 1, sum_p)

    ival = jnp.arange(1, ng + 1, dtype=dtype)            # level values I
    jval = jnp.arange(1, nr + 1, dtype=dtype)            # run lengths

    ri = jnp.sum(P, axis=-1)                             # [B, 4, ng] row sums
    rj = jnp.sum(P, axis=-2)                             # [B, 4, nr] col sums

    out = {}
    out["GLRLM_SRE"] = jnp.sum(rj / (jval * jval), axis=-1) / s
    out["GLRLM_LRE"] = jnp.sum(rj * (jval * jval), axis=-1) / s
    out["GLRLM_GLN"] = jnp.sum(ri * ri, axis=-1) / s
    out["GLRLM_GLNN"] = jnp.sum(ri * ri, axis=-1) / (s * s)
    out["GLRLM_RLN"] = jnp.sum(rj * rj, axis=-1) / s
    out["GLRLM_RLNN"] = jnp.sum(rj * rj, axis=-1) / (s * s)
    out["GLRLM_RP"] = sum_p / jnp.maximum(n_pixels[:, None].astype(dtype), 1)

    mu_g = jnp.sum(ri * ival, axis=-1) / s
    out["GLRLM_GLV"] = jnp.sum(ri * (ival - mu_g[..., None]) ** 2, axis=-1) / s
    mu_r = jnp.sum(rj * jval, axis=-1) / s
    out["GLRLM_RV"] = jnp.sum(rj * (jval - mu_r[..., None]) ** 2, axis=-1) / s

    p = P / s[..., None, None]
    out["GLRLM_RE"] = -jnp.sum(p * fast_log2(p + EPS), axis=(-1, -2))

    inv_i2 = 1.0 / (ival * ival)
    i2 = ival * ival
    inv_j2 = 1.0 / (jval * jval)
    j2 = jval * jval
    out["GLRLM_LGLRE"] = jnp.sum(ri * inv_i2, axis=-1) / s
    out["GLRLM_HGLRE"] = jnp.sum(ri * i2, axis=-1) / s
    out["GLRLM_SRLGLE"] = jnp.einsum("baij,i,j->ba", P, inv_i2, inv_j2,
                                     precision=lax.Precision.HIGHEST) / s
    out["GLRLM_SRHGLE"] = jnp.einsum("baij,i,j->ba", P, i2, inv_j2,
                                     precision=lax.Precision.HIGHEST) / s
    out["GLRLM_LRLGLE"] = jnp.einsum("baij,i,j->ba", P, inv_i2, j2,
                                     precision=lax.Precision.HIGHEST) / s
    out["GLRLM_LRHGLE"] = jnp.einsum("baij,i,j->ba", P, i2, j2,
                                     precision=lax.Precision.HIGHEST) / s

    zero = jnp.asarray(0.0, dtype)
    for m in MEMBERS:
        out[m] = jnp.where(empty, zero, out[m])

    # blank-ROI intercept: raw min == max -> soft NAN everywhere
    blank = (vmin == vmax)[:, None]
    nv = jnp.asarray(noval, dtype)
    final = {}
    for m in MEMBERS:
        v = jnp.where(blank, nv, out[m])
        final[m] = v
        final[m + "_AVE"] = jnp.mean(v, axis=-1)
    return final
