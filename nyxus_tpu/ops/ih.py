"""IBSI Intensity Histogram (IH) family -- 46 features from one N-bin
histogram per ROI.

Batched implementation of the reference's ``IntensityHistogramFeatures``
(reference: src/nyx/features/intensity_histogram.cpp:31-305).

Semantics reproduced exactly:
* N equal-width bins over the per-ROI [min, max]; bin index
  floor((v-min)/binW) clamped to [0, N-1] (v==max folds into the last bin)
* median = CENTER of the bin where the running count first exceeds
  floor(count/2) (bin-center median, not an interpolated quantile)
* p10/p25/p75/p90 = histogram quantiles interpolated inside the landing bin,
  with distinct lower-tail (p < 0.5) and upper-tail scans
  (intensity_histogram.cpp:69-103)
* "..._IDX" features are 1-based bin indices of the corresponding values
* robust statistics restricted to bins in [p10Index, p90Index]
* gradient g[0]=f[1]-f[0], g[N-1]=f[N-1]-f[N-2], else (f[i+1]-f[i-1])/2;
  extrema seeded from DBL_MIN / DBL_MAX with first-strict-win indices
  (1-based), mirroring intensity_histogram.cpp:160-226
* pixel intensities are affinely mapped (poffset + pscale*inten) before
  binning so float/HU images report in the original intensity domain
  (float_domain_map, intensity_histogram.cpp:318-372); bin INDICES are
  invariant under that map, so the frequency table is built from raw values
"""

from __future__ import annotations

import jax.numpy as jnp

from .common import masked_bincount, safe_div

_DBL_MIN = 2.2250738585072014e-308
_DBL_MAX = 1.7976931348623157e+308

# emission order = IntensityHistogramFeatures::featureset
# (intensity_histogram.h:27-80)
MEMBERS = (
    "IH_MEAN_VAL", "IH_VARIANCE_VAL", "IH_SKEWNESS_VAL",
    "IH_EXCESS_KURTOSIS_VAL", "IH_MEDIAN_VAL", "IH_MINIMUM_VAL",
    "IH_P10_VAL", "IH_P90_VAL", "IH_MAXIMUM_VAL", "IH_MODE_VAL",
    "IH_INTERQUANTILE_RANGE_VAL", "IH_RANGE_VAL",
    "IH_MEAN_ABSOLUTE_DEVIATION_VAL",
    "IH_ROBUST_MEAN_ABSOLUTE_DEVIATION_VAL",
    "IH_MEDIAN_ABSOLUTE_DEVIATION_VAL", "IH_COEFFICIENT_OF_VARIATION_VAL",
    "IH_QUANTILE_COEFFICIENT_OF_DISPERSION_VAL", "IH_ENTROPY_VAL",
    "IH_UNIFORMITY_VAL", "IH_ROBUST_MEAN_VAL",
    "IH_MEAN_IDX", "IH_VARIANCE_IDX", "IH_SKEWNESS_IDX",
    "IH_EXCESS_KURTOSIS_IDX", "IH_MEDIAN_IDX", "IH_MINIMUM_IDX",
    "IH_P10_IDX", "IH_P90_IDX", "IH_MAXIMUM_IDX", "IH_MODE_IDX",
    "IH_INTERQUANTILE_RANGE_IDX", "IH_RANGE_IDX",
    "IH_MEAN_ABSOLUTE_DEVIATION_IDX",
    "IH_ROBUST_MEAN_ABSOLUTE_DEVIATION_IDX",
    "IH_MEDIAN_ABSOLUTE_DEVIATION_IDX", "IH_COEFFICIENT_OF_VARIATION_IDX",
    "IH_QUANTILE_COEFFICIENT_OF_DISPERSION_IDX", "IH_ENTROPY_IDX",
    "IH_UNIFORMITY_IDX",
    "IH_MAX_GRADIENT", "IH_MAX_GRADIENT_IDX", "IH_MIN_GRADIENT",
    "IH_MIN_GRADIENT_IDX", "IH_ROBUST_MEAN_IDX", "IH_NUM_BINS",
    "IH_BIN_SIZE",
)


def _quantile_low(freq, cumsum, total, p, bin_min, binw):
    """Lower-tail interpolated histogram quantile (p < 0.5).

    Scans bins upward until cum/total >= p (intensity_histogram.cpp:72-88)."""
    target = total * p
    cond = cumsum >= target[:, None]          # p_n >= p at this bin
    found = jnp.any(cond, axis=1)
    N = freq.shape[1]
    s = jnp.where(found, jnp.argmax(cond, axis=1), N - 1)
    c_prev = jnp.where(s > 0, jnp.take_along_axis(
        cumsum, jnp.maximum(s - 1, 0)[:, None], axis=1)[:, 0], 0.0)
    f_s = jnp.take_along_axis(freq, s[:, None], axis=1)[:, 0]
    p_prev = c_prev / total
    prop = f_s / total
    mn = bin_min + s.astype(freq.dtype) * binw
    return mn + safe_div(p - p_prev, prop) * binw, s


def _quantile_high(freq, cumsum, total, p, bin_min, binw):
    """Upper-tail quantile (p >= 0.5): scans bins downward until
    1 - cumFromTop/total <= p (intensity_histogram.cpp:89-103).

    Stopping bin s = largest i with C[i-1] <= p*total (C[-1] = 0)."""
    target = total * p
    N = freq.shape[1]
    c_m1 = jnp.concatenate(
        [jnp.zeros((freq.shape[0], 1), freq.dtype), cumsum[:, :-1]], axis=1)
    cond = c_m1 <= target[:, None]
    # largest satisfying index (cond[:,0] is always True)
    s = (N - 1) - jnp.argmax(cond[:, ::-1], axis=1)
    c_s = jnp.take_along_axis(cumsum, s[:, None], axis=1)[:, 0]
    f_s = jnp.take_along_axis(freq, s[:, None], axis=1)[:, 0]
    p_prev = c_s / total            # p_n before processing bin s (from top)
    prop = f_s / total
    mx = bin_min + (s.astype(freq.dtype) + 1.0) * binw
    return mx - safe_div(p_prev - p, prop) * binw, s


def ih_features(values, counts, vmin, vmax, nbins: int, noval: float,
                pscale=None, poffset=None):
    """All 46 IH features.

    values: [B, A] raw stored pixel intensities, +inf padding (any order);
    counts: [B] pixel counts; vmin/vmax: [B] raw per-ROI min/max;
    pscale/poffset: [B] affine map into the reporting intensity domain
    (1.0 / 0.0 for integer images). Returns {member: [B]}.
    Degenerate ROIs (max <= min or empty) emit ``noval`` for every member.
    """
    dt = values.dtype
    B, A = values.shape
    N = int(nbins)
    if N < 2:
        nv = jnp.full((B,), noval, dt)
        return {m: nv for m in MEMBERS}
    if pscale is None:
        pscale = jnp.ones((B,), dt)
    if poffset is None:
        poffset = jnp.zeros((B,), dt)

    valid = jnp.isfinite(values)

    # frequency table: indices computed from RAW values (affine-invariant)
    raw_rng = jnp.where(vmax > vmin, vmax - vmin, 1.0)
    idx = jnp.floor((values - vmin[:, None]) * (N / raw_rng)[:, None])
    idx = jnp.clip(idx, 0, N - 1).astype(jnp.int32)
    freq = masked_bincount(idx, valid.astype(dt), N)     # [B, N]
    return ih_features_from_freq(freq, counts, vmin, vmax, nbins, noval,
                                 pscale, poffset)


def ih_features_from_freq(freq, counts, vmin, vmax, nbins: int, noval: float,
                          pscale=None, poffset=None):
    """IH stats from a precomputed N-bin frequency table (the oversized-ROI
    streaming path accumulates ``freq`` tile-by-tile; reference analog:
    IntensityHistogramFeatures::osized_calculate)."""
    dt = freq.dtype
    B, N = freq.shape
    if pscale is None:
        pscale = jnp.ones((B,), dt)
    if poffset is None:
        poffset = jnp.zeros((B,), dt)
    total = counts.astype(dt)
    bad = (vmax <= vmin) | (counts == 0)
    # guard against division by zero inside the math; 'bad' rows are replaced
    safe_total = jnp.maximum(total, 1.0)

    # reporting-domain bin geometry
    min_val = poffset + pscale * vmin
    max_val = poffset + pscale * vmax
    binw = (max_val - min_val) / N
    cum = jnp.cumsum(freq, axis=1)
    prob = freq / safe_total[:, None]

    ii = jnp.arange(N, dtype=dt)
    centers = min_val[:, None] + (ii[None, :] + 0.5) * binw[:, None]

    def index_of(v):
        k = jnp.floor(safe_div(v - min_val, binw))
        return jnp.clip(k, 0, N - 1).astype(jnp.int32)

    # median: center of the bin where running count first exceeds count//2
    half = jnp.floor(counts.astype(dt) / 2.0)
    med_cond = cum > half[:, None]
    med_bin = jnp.argmax(med_cond, axis=1)
    median_v = jnp.take_along_axis(centers, med_bin[:, None], axis=1)[:, 0]
    median_i = index_of(median_v)

    p10_v, _ = _quantile_low(freq, cum, safe_total, 0.10, min_val, binw)
    p25_v, _ = _quantile_low(freq, cum, safe_total, 0.25, min_val, binw)
    p75_v, _ = _quantile_high(freq, cum, safe_total, 0.75, min_val, binw)
    p90_v, _ = _quantile_high(freq, cum, safe_total, 0.90, min_val, binw)
    p10_i = index_of(p10_v)
    p25_i = index_of(p25_v)
    p75_i = index_of(p75_v)
    p90_i = index_of(p90_v)
    min_i = index_of(min_val)
    max_i = index_of(max_val)

    # pass 1: means + robust means over [p10Index, p90Index]
    mean_v = jnp.sum(prob * centers, axis=1)
    mean_i = jnp.sum(prob * ii[None, :], axis=1)
    in_rob = ((ii[None, :] >= p10_i[:, None].astype(dt)) &
              (ii[None, :] <= p90_i[:, None].astype(dt)))
    robw = jnp.where(in_rob, freq, 0.0)
    rob_cnt = jnp.sum(robw, axis=1)
    rmean_v = safe_div(jnp.sum(robw * centers, axis=1), rob_cnt)
    rmean_i = safe_div(jnp.sum(robw * ii[None, :], axis=1), rob_cnt)

    # pass 2: centered moments + deviations + entropy/uniformity
    dv = centers - mean_v[:, None]
    di = ii[None, :] - mean_i[:, None]
    var_v = jnp.sum(prob * dv * dv, axis=1)
    var_i = jnp.sum(prob * di * di, axis=1)
    skew_v = safe_div(jnp.sum(prob * dv ** 3, axis=1), var_v * jnp.sqrt(var_v))
    skew_i = safe_div(jnp.sum(prob * di ** 3, axis=1), var_i * jnp.sqrt(var_i))
    kurt_v = safe_div(jnp.sum(prob * dv ** 4, axis=1), var_v * var_v) - 3.0
    kurt_i = safe_div(jnp.sum(prob * di ** 4, axis=1), var_i * var_i) - 3.0

    # mode: first bin with maximal frequency (strict-greater update)
    mode_bin = jnp.argmax(freq, axis=1)
    mode_v = jnp.take_along_axis(centers, mode_bin[:, None], axis=1)[:, 0]

    mad_v = jnp.sum(prob * jnp.abs(dv), axis=1)
    mad_i = jnp.sum(prob * jnp.abs(di), axis=1)
    rmad_v = safe_div(
        jnp.sum(robw * jnp.abs(centers - rmean_v[:, None]), axis=1), rob_cnt)
    rmad_i = safe_div(
        jnp.sum(robw * jnp.abs(ii[None, :] - rmean_i[:, None]), axis=1),
        rob_cnt)
    medad_v = jnp.sum(prob * jnp.abs(centers - median_v[:, None]), axis=1)
    medad_i = jnp.sum(
        prob * jnp.abs(ii[None, :] - median_i[:, None].astype(dt)), axis=1)

    pg = prob > 1e-7            # guard at intensity_histogram.cpp:201
    entropy = -jnp.sum(
        jnp.where(pg, prob * jnp.log2(jnp.where(pg, prob, 1.0)), 0.0), axis=1)
    uniformity = jnp.sum(prob * prob, axis=1)

    cov_v = safe_div(jnp.sqrt(var_v), mean_v)
    cov_i = safe_div(jnp.sqrt(var_i), mean_i + 1.0)
    qcd_v = safe_div(p75_v - p25_v, p75_v + p25_v)
    qcd_i = safe_div(p75_i.astype(dt) - p25_i.astype(dt),
                     p75_i.astype(dt) + p25_i.astype(dt) + 2.0)

    # histogram gradient + seeded extrema (intensity_histogram.cpp:160-226)
    g_left = freq[:, 1] - freq[:, 0]
    g_right = freq[:, -1] - freq[:, -2]
    if N > 2:
        g_mid = (freq[:, 2:] - freq[:, :-2]) / 2.0
        grad = jnp.concatenate(
            [g_left[:, None], g_mid, g_right[:, None]], axis=1)
    else:
        grad = jnp.stack([g_left, g_right], axis=1)
    # seed values: DBL_MIN/DBL_MAX in fp64, tiny/huge finite in fp32
    seed_min = float(_DBL_MIN) if dt == jnp.float64 else float(
        jnp.finfo(dt).tiny)
    seed_max = float(_DBL_MAX) if dt == jnp.float64 else float(
        jnp.finfo(dt).max)
    gmax = jnp.max(grad, axis=1)
    gmax_i = jnp.argmax(grad, axis=1).astype(dt) + 1.0
    maxgrad_v = jnp.where(gmax > seed_min, gmax, seed_min)
    maxgrad_i = jnp.where(gmax > seed_min, gmax_i, 0.0)
    gmin = jnp.min(grad, axis=1)
    gmin_i = jnp.argmin(grad, axis=1).astype(dt) + 1.0
    mingrad_v = jnp.where(gmin < seed_max, gmin, seed_max)
    mingrad_i = jnp.where(gmin < seed_max, gmin_i, 0.0)

    out_vals = (
        mean_v, var_v, skew_v, kurt_v, median_v, min_val, p10_v, p90_v,
        max_val, mode_v, p75_v - p25_v, max_val - min_val, mad_v, rmad_v,
        medad_v, cov_v, qcd_v, entropy, uniformity, rmean_v,
        mean_i + 1.0, var_i, skew_i, kurt_i,
        median_i.astype(dt) + 1.0, min_i.astype(dt) + 1.0,
        p10_i.astype(dt) + 1.0, p90_i.astype(dt) + 1.0,
        max_i.astype(dt) + 1.0, mode_bin.astype(dt) + 1.0,
        p75_i.astype(dt) - p25_i.astype(dt),
        max_i.astype(dt) - min_i.astype(dt),
        mad_i, rmad_i, medad_i, cov_i, qcd_i, entropy, uniformity,
        maxgrad_v, maxgrad_i, mingrad_v, mingrad_i,
        rmean_i, jnp.full((B,), float(N), dt), binw,
    )
    nv = jnp.asarray(noval, dt)
    return {m: jnp.where(bad, nv, v) for m, v in zip(MEMBERS, out_vals)}
