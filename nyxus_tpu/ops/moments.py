"""2D geometric moments (intensity + shape): raw/central/normalized/Hu and
their distance-to-contour weighted variants.  Batched; the moment sums are
separable polynomial contractions.

Reference: src/nyx/features/2d_geomoments_basic.cpp:69-380, 2d_geomoments.h.
Coordinates are AABB-local (x - xmin, y - ymin); weighted intensities are
I * log(dist_to_contour + 0.001) with dist the min Euclidean distance to the
(+1,+1)-shifted merged contour (see pipeline/contour.py).

Member naming: IMOM_* (intensity) / SMOM_* (shape) x {RM_pq raw, CM_pq
central, NRM_pq normalized raw, NCM_pq normalized central, HU1-7,
weighted W* variants}.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import safe_div

RAW_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
          (2, 0), (2, 1), (2, 2), (2, 3), (3, 0)]
CENTRAL_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
              (2, 0), (2, 1), (2, 2), (2, 3), (3, 0), (3, 1), (3, 2), (3, 3)]
NORM_RAW_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2), (1, 3),
               (2, 0), (2, 1), (2, 2), (2, 3), (3, 0), (3, 1), (3, 2), (3, 3)]
NORM_CENTRAL_PQ = [(0, 2), (0, 3), (1, 1), (1, 2), (2, 0), (2, 1), (3, 0)]
W_RAW_PQ = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 0), (1, 1), (1, 2),
            (2, 0), (2, 1), (3, 0)]
W_CENTRAL_PQ = [(0, 2), (0, 3), (1, 1), (1, 2), (2, 0), (2, 1), (3, 0)]

WEIGHTING_EPSILON = 0.001


def _power_sums(w, xs, ys, max_p=3):
    """S[p][q] = sum w * x^p * y^q for p, q in 0..3.  w: [B, H, W] weights;
    xs/ys: local coordinate grids."""
    xp = [jnp.ones_like(xs), xs, xs * xs, xs * xs * xs]
    yq = [jnp.ones_like(ys), ys, ys * ys, ys * ys * ys]
    S = {}
    for p in range(max_p + 1):
        wx = w * xp[p]
        for q in range(max_p + 1):
            S[(p, q)] = jnp.sum(wx * yq[q], axis=(1, 2))
    return S


def moments_all(ctx, weights, prefix: str, logw=None):
    """All moment outputs for one weighting mode.

    weights: [B, H, W] INTEN(value) * mask (intensity or ones).
    logw: [B, H, W] host-precomputed log(sqrt(approx_min_d2) + eps) factor
    (0 outside the mask), using the reference's APPROXIMATE ordered-contour
    distance search (pixel.cpp:36-71) -- exact distances diverge from the
    reference's weighted moments.  If None the weighted (W*) members
    emit -0.0.
    Returns {member_name: [B]}.
    """
    dt = weights.dtype
    H, W = ctx.shape
    xs = jnp.arange(W, dtype=dt)[None, None, :] * jnp.ones((1, H, 1), dt)
    ys = jnp.arange(H, dtype=dt)[None, :, None] * jnp.ones((1, 1, W), dt)

    out = {}

    # ---- plain moments
    S = _power_sums(weights, xs, ys)
    m00 = S[(0, 0)]
    ox = safe_div(S[(1, 0)], m00)
    oy = safe_div(S[(0, 1)], m00)
    for p, q in RAW_PQ:
        out["%s_RM_%d%d" % (prefix, p, q)] = S[(p, q)]

    xc = xs - ox[:, None, None]
    yc = ys - oy[:, None, None]
    C = _power_sums(weights, xc, yc)
    for p, q in CENTRAL_PQ:
        out["%s_CM_%d%d" % (prefix, p, q)] = C[(p, q)]

    for p, q in NORM_RAW_PQ:
        k = (p + q) / 2.0 + 1.0
        out["%s_NRM_%d%d" % (prefix, p, q)] = safe_div(
            S[(p, q)], jnp.where(m00 > 0, m00, 1) ** k)

    nu = {}
    for p, q in NORM_CENTRAL_PQ:
        k = (p + q) / 2.0 + 1.0
        nu[(p, q)] = safe_div(C[(p, q)], jnp.where(m00 > 0, m00, 1) ** k)
        out["%s_NCM_%d%d" % (prefix, p, q)] = nu[(p, q)]

    hu = _hu(nu)
    for i in range(7):
        out["%s_HU%d" % (prefix, i + 1)] = hu[i]

    # ---- weighted moments (distance-to-contour weighting)
    if logw is not None:
        wweights = weights * logw.astype(dt)

        WS = _power_sums(wweights, xs, ys)
        wm00 = WS[(0, 0)]
        wox = safe_div(WS[(1, 0)], wm00)
        woy = safe_div(WS[(0, 1)], wm00)
        for p, q in W_RAW_PQ:
            out["%s_WRM_%d%d" % (prefix, p, q)] = WS[(p, q)]

        wxc = xs - wox[:, None, None]
        wyc = ys - woy[:, None, None]
        WC = _power_sums(wweights, wxc, wyc)
        for p, q in W_CENTRAL_PQ:
            out["%s_WCM_%d%d" % (prefix, p, q)] = WC[(p, q)]

        wnu = {}
        for p, q in W_CENTRAL_PQ:
            k = (p + q) / 2.0 + 1.0
            # std::pow(negative, fractional) is NaN -- reproduced by
            # _signed_pow; NaN flows to the soft-NAN substitute at output
            wnu[(p, q)] = WC[(p, q)] / _signed_pow(wm00, k)
            out["%s_WNCM_%d%d" % (prefix, p, q)] = wnu[(p, q)]

        whu = _hu(wnu)
        for i in range(7):
            out["%s_WHU%d" % (prefix, i + 1)] = whu[i]

    return out


def _signed_pow(base, k: float):
    """std::pow semantics: negative base with non-integer exponent -> NaN;
    integer exponent -> exact sign."""
    frac = k != float(int(k))
    ab = jnp.abs(base) ** k
    neg = base < 0
    if frac:
        return jnp.where(neg, jnp.nan, ab)
    odd = int(k) % 2 == 1
    return jnp.where(neg & odd, -ab, ab)


def _hu(nu):
    """Hu invariants 1-7 from normalized central moments
    (2d_geomoments_basic.cpp calcHu_imp)."""
    _02, _03, _11, _12 = nu[(0, 2)], nu[(0, 3)], nu[(1, 1)], nu[(1, 2)]
    _20, _21, _30 = nu[(2, 0)], nu[(2, 1)], nu[(3, 0)]
    h1 = _20 + _02
    h2 = (_20 - _02) ** 2 + 4 * _11 ** 2
    h3 = (_30 - 3 * _12) ** 2 + (3 * _21 - _03) ** 2
    h4 = (_30 + _12) ** 2 + (_21 + _03) ** 2
    h5 = ((_30 - 3 * _12) * (_30 + _12) *
          ((_30 + _12) ** 2 - 3 * (_21 + _03) ** 2) +
          (3 * _21 - _03) * (_21 + _03) *
          (3 * (_30 + _12) ** 2 - (_21 + _03) ** 2))
    h6 = ((_20 - _02) * ((_30 + _12) ** 2 - (_21 + _03) ** 2) +
          4 * _11 * (_30 + _12) * (_21 + _03))
    h7 = ((3 * _21 - _03) * (_30 + _12) * ((_30 + _12) ** 2 -
          3 * (_21 + _03) ** 2) - (_30 - 3 * _12) * (_21 + _03) *
          (3 * (_30 + _12) ** 2 - (_21 + _03) ** 2))
    return h1, h2, h3, h4, h5, h6, h7
