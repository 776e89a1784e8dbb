"""GLDM (grey-level dependence matrix) features, batched.

Reference: src/nyx/features/gldm.cpp:53-700.  Each ROI pixel (original
intensity != 0) contributes one entry at (level, nd) where nd = 1 + number of
8-neighbors that are ROI pixels with the same binned level.  14 scalar
statistics over P[level, nd].

Background is excluded by ORIGINAL intensity for both center and neighbors
(gldm.cpp:116-124), unlike GLRLM/NGTDM.  Blank ROI (min == max) -> soft-NAN.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .common import NEIGHBORS8, shifted2d, fast_log2

EPS = 2.2e-16  # reference: glrlm.h:169 / glszm.h:138 / gldm.h:105
ND = 9  # dependencies 1..9

MEMBERS = [
    "GLDM_SDE", "GLDM_LDE", "GLDM_GLN", "GLDM_DN", "GLDM_DNN", "GLDM_GLV",
    "GLDM_DV", "GLDM_DE", "GLDM_LGLE", "GLDM_HGLE", "GLDM_SDLGLE",
    "GLDM_SDHGLE", "GLDM_LDLGLE", "GLDM_LDHGLE",
]


def gldm_matrix(orig, levels, ng: int, dtype):
    """P: [B, ng, ND] dependence counts.  orig: masked original intensities
    (0 = background); levels: binned levels (1-based)."""
    B = orig.shape[0]
    roi = orig > 0
    nd = jnp.ones_like(levels)
    for dx, dy in NEIGHBORS8:
        n_roi = shifted2d(roi.astype(jnp.int32), dx, dy) > 0
        n_lev = shifted2d(levels, dx, dy)
        nd = nd + (n_roi & (n_lev == levels)).astype(levels.dtype)

    lev_idx = (levels - 1).reshape(B, -1)
    nd_idx = (nd - 1).reshape(B, -1)
    w = roi.reshape(B, -1).astype(dtype)
    from .common import pair_hist
    return pair_hist(lev_idx, nd_idx, w, ng, ND)


def gldm_features(P, vmin, vmax, noval: float):
    """14 members from P: [B, ng, ND]."""
    dtype = P.dtype
    B, ng, nd = P.shape
    nz = jnp.sum(P, axis=(1, 2))
    s = jnp.maximum(nz, 1)

    ival = jnp.arange(1, ng + 1, dtype=dtype)
    jval = jnp.arange(1, nd + 1, dtype=dtype)
    si = jnp.sum(P, axis=2)          # [B, ng]
    sj = jnp.sum(P, axis=1)          # [B, nd]

    out = {}
    out["GLDM_SDE"] = jnp.sum(sj / (jval * jval), axis=1) / s
    out["GLDM_LDE"] = jnp.sum(sj * (jval * jval), axis=1) / s
    out["GLDM_GLN"] = jnp.sum(si * si, axis=1) / s
    out["GLDM_DN"] = jnp.sum(sj * sj, axis=1) / s
    out["GLDM_DNN"] = jnp.sum(sj * sj, axis=1) / (s * s)
    mu = jnp.sum(si * ival, axis=1) / s
    out["GLDM_GLV"] = jnp.sum(si * (ival - mu[:, None]) ** 2, axis=1) / s
    mud = jnp.sum(sj * jval, axis=1) / s
    out["GLDM_DV"] = jnp.sum(sj * (jval - mud[:, None]) ** 2, axis=1) / s
    p = P / s[:, None, None]
    out["GLDM_DE"] = -jnp.sum(p * fast_log2(p + EPS), axis=(1, 2))
    i2 = ival * ival
    j2 = jval * jval
    out["GLDM_LGLE"] = jnp.sum(si / i2, axis=1) / s
    out["GLDM_HGLE"] = jnp.sum(si * i2, axis=1) / s
    out["GLDM_SDLGLE"] = jnp.einsum("bij,i,j->b", P, 1 / i2, 1 / j2,
                                    precision=lax.Precision.HIGHEST) / s
    out["GLDM_SDHGLE"] = jnp.einsum("bij,i,j->b", P, i2, 1 / j2,
                                    precision=lax.Precision.HIGHEST) / s
    out["GLDM_LDLGLE"] = jnp.einsum("bij,i,j->b", P, 1 / i2, j2,
                                    precision=lax.Precision.HIGHEST) / s
    out["GLDM_LDHGLE"] = jnp.einsum("bij,i,j->b", P, i2, j2,
                                    precision=lax.Precision.HIGHEST) / s

    bad = (vmin == vmax) | (nz == 0)
    nv = jnp.asarray(noval, dtype)
    return {k: jnp.where(bad, nv, v) for k, v in out.items()}
