"""NGLDM (neighbouring grey level dependence matrix) features, batched.

Reference: src/nyx/features/ngldm.cpp:81-350.  Uses ROI-membership masking
(in-ROI zero-intensity pixels participate) and ``to_grayscale`` binning
(level = floor(v * n / max), 0-based -- NOT the MATLAB texture binning).
Each ROI pixel contributes at (level, n_matches) with n_matches = number of
ROI 8-neighbors with the same binned level (column j = matches, dependence
count = j + 1).  19 scalar statistics; DCP == 1 by IBSI definition.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from .common import NEIGHBORS8, shifted2d

NR = 9  # dependencies 0..8 matches

MEMBERS = [
    "NGLDM_LDE", "NGLDM_HDE", "NGLDM_LGLCE", "NGLDM_HGLCE", "NGLDM_LDLGLE",
    "NGLDM_LDHGLE", "NGLDM_HDLGLE", "NGLDM_HDHGLE", "NGLDM_GLNU",
    "NGLDM_GLNUN", "NGLDM_DCNU", "NGLDM_DCNUN", "NGLDM_DCP", "NGLDM_GLM",
    "NGLDM_GLV", "NGLDM_DCM", "NGLDM_DCV", "NGLDM_DCENT", "NGLDM_DCENE",
]


def to_grayscale_levels(intens, vmax, n_levels: int, ibsi: bool):
    """Nyxus::to_grayscale(i, 0, max, n) = floor(i * n / max) (helpers.h:337)."""
    if ibsi:
        return intens.astype(jnp.int32)
    return (intens * n_levels / jnp.maximum(vmax, 1e-30)).astype(jnp.int32)


def ngldm_features(intens, mask, vmin, vmax, n_levels: int, nmax: int,
                   ibsi: bool, noval: float, dtype):
    """intens: [B, H, W] raw crop; mask: ROI membership; nmax: static level cap.
    Returns dict member -> [B]."""
    B = intens.shape[0]
    lev = to_grayscale_levels(intens.astype(dtype), vmax[:, None, None],
                              n_levels, ibsi)
    lev = jnp.where(mask, lev, -1)     # -1 = outside ROI

    matches = jnp.zeros(lev.shape, jnp.int32)
    for dx, dy in NEIGHBORS8:
        n_lev = shifted2d(lev, dx, dy, fill=-1)
        matches = matches + ((n_lev >= 0) & (n_lev == lev)).astype(jnp.int32)

    nb = nmax + 1
    lev_idx = jnp.where(mask, lev, 0).reshape(B, -1)
    m_idx = matches.reshape(B, -1)
    w = mask.reshape(B, -1).astype(dtype)
    from .common import pair_hist
    P = pair_hist(lev_idx, m_idx, w, nb, NR)
    return ngldm_features_from_matrix(P, vmin, vmax, noval, dtype)


def ngldm_features_from_matrix(P, vmin, vmax, noval: float, dtype):
    """The 19 statistics from P: [B, nb, 9].  Shared by the dense kernel
    above and the tile-streamed oversized path."""
    ns = jnp.sum(P, axis=(1, 2))
    s = jnp.maximum(ns, 1)
    nb = P.shape[1]
    gval = jnp.arange(nb, dtype=dtype)          # grey level VALUES (0-based bins)
    dval = jnp.arange(1, NR + 1, dtype=dtype)   # dependence counts j+1

    sg = jnp.sum(P, axis=2)   # [B, nb]
    sr = jnp.sum(P, axis=1)   # [B, NR]
    p = P / s[:, None, None]

    out = {}
    out["NGLDM_LDE"] = jnp.sum(sr / (dval * dval), axis=1) / s
    out["NGLDM_HDE"] = jnp.sum(sr * dval * dval, axis=1) / s
    g2 = jnp.where(gval > 0, gval * gval, 1)
    gnz = gval > 0
    out["NGLDM_LGLCE"] = jnp.sum(jnp.where(gnz, sg / g2, 0), axis=1) / s
    out["NGLDM_HGLCE"] = jnp.sum(sg * gval * gval, axis=1) / s
    out["NGLDM_LDLGLE"] = jnp.einsum("bij,i,j->b", P, jnp.where(gnz, 1 / g2, 0),
                                     1 / (dval * dval),
                                     precision=lax.Precision.HIGHEST) / s
    out["NGLDM_LDHGLE"] = jnp.einsum("bij,i,j->b", P, gval * gval,
                                     1 / (dval * dval),
                                     precision=lax.Precision.HIGHEST) / s
    out["NGLDM_HDLGLE"] = jnp.einsum("bij,i,j->b", P, jnp.where(gnz, 1 / g2, 0),
                                     dval * dval,
                                     precision=lax.Precision.HIGHEST) / s
    out["NGLDM_HDHGLE"] = jnp.einsum("bij,i,j->b", P, gval * gval,
                                     dval * dval,
                                     precision=lax.Precision.HIGHEST) / s
    out["NGLDM_GLNU"] = jnp.sum(sg * sg, axis=1) / s
    out["NGLDM_GLNUN"] = jnp.sum(sg * sg, axis=1) / (s * s)
    out["NGLDM_DCNU"] = jnp.sum(sr * sr, axis=1) / s
    out["NGLDM_DCNUN"] = jnp.sum(sr * sr, axis=1) / (s * s)
    out["NGLDM_DCP"] = jnp.ones_like(ns)
    glm = jnp.einsum("bij,i->b", p, gval,
                     precision=lax.Precision.HIGHEST)
    out["NGLDM_GLM"] = glm
    dcm = jnp.einsum("bij,j->b", p, dval,
                     precision=lax.Precision.HIGHEST)
    out["NGLDM_DCM"] = dcm
    out["NGLDM_GLV"] = jnp.einsum("bij,bi->b", p,
                                  (gval[None] - glm[:, None]) ** 2,
                                  precision=lax.Precision.HIGHEST)
    out["NGLDM_DCV"] = jnp.einsum("bij,bj->b", p,
                                  (dval[None] - dcm[:, None]) ** 2,
                                  precision=lax.Precision.HIGHEST)
    out["NGLDM_DCENT"] = -jnp.sum(jnp.where(p > 0, p * jnp.log2(jnp.where(p > 0, p, 1)), 0),
                                  axis=(1, 2))
    out["NGLDM_DCENE"] = jnp.sum(p * p, axis=(1, 2))

    bad = vmin == vmax
    nv = jnp.asarray(noval, dtype)
    return {k: jnp.where(bad, nv, v) for k, v in out.items()}
