"""First-order pixel-intensity features + per-ROI intensity histogram.

Batched implementation of the reference's ``PixelIntensityFeatures``
(reference: src/nyx/features/intensity.cpp:57-233) and its histogram engine
``TrivialHistogram`` (src/nyx/features/histogram.h:23-205,300-327).

Semantics reproduced:
* blank-ROI intercept (max == min): MEAN/MEDIAN/MIN/MAX = min, RANGE = 0, all
  other family members = the soft-NAN placeholder (intensity.cpp:60-98)
* percentiles via a 100-bin histogram with linear interpolation inside the
  landing bin, last matching bin winning (histogram.h:300-327)
* MEDIAN is the exact sorted-sample median, MODE is the smallest
  most-frequent value (histogram.h:353-395)
* ENTROPY/UNIFORMITY over an n-bin "custom" histogram, n = grey depth,
  entropy = -sum p*log2(p + 2.2e-16) (histogram.h:230-238)
* SKEWNESS = sqrt(n) m3 / m2^1.5 (n>3), KURTOSIS = n m4 / m2^2 (n>4),
  EXCESS = KURTOSIS - 3; 0 when m2 == 0 (moments.h:83-118)
* HYPERSKEWNESS = sum d^5 / (n sigma^5), HYPERFLATNESS = sum d^6 / (n sigma^6)
  with sigma the unbiased SD (intensity.cpp:210-224)
* ROBUST_MEAN / ROBUST_MAD over values in [P10, P90] (intensity.cpp:171-185)
"""

from __future__ import annotations

import jax.numpy as jnp

from .common import masked_bincount, safe_div, take_per_row, last_true_value

# Output keys are the Feature2D enum member names (taxonomy codes).
PERCENTS = (0.01, 0.10, 0.25, 0.75, 0.90, 0.99)


def histogram_stats(values, n, vmin, vmax, nbins: int, weights=None):
    """Shared histogram statistics over sorted padded values.

    values: [B, A] ascending, padding = +inf; n: [B] areas;
    vmin, vmax: [B] per-ROI min/max.
    weights: optional [B, A] per-sample multiplicities (the oversized-ROI
    streaming path passes sorted UNIQUE values with their tile-accumulated
    counts; None = every finite sample counts once).
    Returns dict with p01..p99, median, mode, entropy, uniformity, iqr, rmad,
    robust_mean, hist ([B, nbins] custom-bin frequencies).
    """
    B, A = values.shape
    valid = jnp.isfinite(values)
    if weights is None:
        w = valid.astype(values.dtype)
    else:
        w = jnp.where(valid, weights.astype(values.dtype), 0.0)
    rng = vmax - vmin
    # TrivialHistogram statistics run on its OWN population count (the
    # raw_pixels sample size, histogram.h:64-80), NOT aux_area.  They only
    # differ under anisotropy, where raw_pixels hold the resampled virtual
    # grid but aux_area stays physical (slideprops.cpp:176-193).
    k = jnp.sum(w, axis=1)
    ki = k.astype(jnp.int64)

    # --- 100-bin percentile histogram (histogram.h:50-62)
    binw = rng / 100.0
    ridx = safe_div(values - vmin[:, None], binw[:, None])
    idx100 = jnp.clip(ridx.astype(jnp.int32), 0, 99)  # bin 100 folds into 99
    bins100 = masked_bincount(idx100, w, 100)          # [B, 100]

    # --- interpolated percentiles (histogram.h:300-327)
    run = jnp.cumsum(bins100, axis=1) - bins100        # runSum before bin i
    iarr = jnp.arange(100, dtype=values.dtype)
    left_edge = vmin[:, None] + binw[:, None] * iarr[None, :]
    pcts = {}
    for p in PERCENTS:
        cnt = k * p
        cond = (run <= cnt[:, None]) & (cnt[:, None] <= run + bins100)
        cand = (cnt[:, None] - run) * binw[:, None] / bins100 + left_edge
        pcts[p] = last_true_value(cond, cand, 0.0)

    # --- custom n-bin histogram (to_grayscale, helpers.h:337-345)
    pi = safe_div((values - vmin[:, None]) * nbins, rng[:, None])
    idxc = jnp.clip(pi.astype(jnp.int32), 0, nbins - 1)  # fold top bin
    hist = masked_bincount(idxc, w, nbins)               # [B, nbins]

    p_ = hist / jnp.maximum(k[:, None], 1)
    entropy = -jnp.sum(p_ * jnp.log2(p_ + 2.2e-16), axis=1)
    uniformity = jnp.sum(p_ * p_, axis=1)

    # --- exact median over the sorted sample (histogram.h:353-373)
    half = ki // 2
    if weights is None:
        v_hi = take_per_row(values, jnp.clip(half, 0, A - 1).astype(jnp.int32))
        v_lo = take_per_row(values,
                            jnp.clip(half - 1, 0, A - 1).astype(jnp.int32))
    else:
        # expanded-sample order statistic: element k = first value whose
        # cumulative multiplicity exceeds k
        cumw = jnp.cumsum(w, axis=1)

        def v_at(k):
            pos = jnp.sum((cumw <= k[:, None].astype(values.dtype)).astype(
                jnp.int32), axis=1)
            return take_per_row(values, jnp.clip(pos, 0, A - 1))

        v_hi = v_at(half)
        v_lo = v_at(half - 1)
    median = jnp.where(ki % 2 != 0, v_hi, (v_lo + v_hi) / 2.0)

    # --- mode: smallest most-frequent value (histogram.h:375-395)
    if weights is None:
        # run-length encode the sorted row in O(A): each element's run length
        # is (index of run end) - (index of run start) + 1
        import jax.lax as lax
        idx = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32), (B, A))
        same_prev = jnp.concatenate(
            [jnp.zeros((B, 1), bool), values[:, 1:] == values[:, :-1]], axis=1)
        is_start = ~same_prev
        is_end = jnp.concatenate(
            [values[:, 1:] != values[:, :-1], jnp.ones((B, 1), bool)], axis=1)
        run_start = lax.cummax(jnp.where(is_start, idx, -1), axis=1)
        run_end = lax.cummin(jnp.where(is_end, idx, A), axis=1, reverse=True)
        per_elem_count = jnp.where(valid, run_end - run_start + 1, -1)
    else:
        # values are unique per row: multiplicity IS the weight
        per_elem_count = jnp.where(valid, w, -1.0)
    first_max = jnp.argmax(per_elem_count, axis=1)   # first idx of max count
    mode = take_per_row(values, first_max.astype(jnp.int32))

    # --- robust [p10, p90] statistics (intensity.cpp:171-185, histogram.h:86-106)
    in_1090 = valid & (values >= pcts[0.10][:, None]) & (values <= pcts[0.90][:, None])
    w1090 = jnp.where(in_1090, w, 0.0)
    pop1090 = jnp.sum(w1090, axis=1)
    mean1090 = safe_div(jnp.sum(w1090 * jnp.where(in_1090, values, 0), axis=1),
                        pop1090)
    rmad = safe_div(
        jnp.sum(w1090 * jnp.where(in_1090,
                                  jnp.abs(values - mean1090[:, None]), 0),
                axis=1),
        pop1090)
    robust_mean = mean1090  # 0 when pop1090 == 0 via safe_div

    return dict(
        p01=pcts[0.01], p10=pcts[0.10], p25=pcts[0.25], p75=pcts[0.75],
        p90=pcts[0.90], p99=pcts[0.99], median=median, mode=mode,
        entropy=entropy, uniformity=uniformity,
        iqr=pcts[0.75] - pcts[0.25], rmad=rmad, robust_mean=robust_mean,
        hist=hist,
    )


def pixel_intensity_features(values, n, vmin, vmax, slide_range, nbins: int,
                             noval: float, weights=None):
    """All PixelIntensityFeatures outputs.

    values: [B, A] sorted ascending (+inf padding); n: [B] int areas;
    vmin/vmax: [B]; slide_range: [B] slide-level intensity range
    (max_preroi - min_preroi) for COVERED_IMAGE_INTENSITY_RANGE.
    weights: optional [B, A] sample multiplicities (sorted-unique-value form
    used by the oversized-ROI streaming path); None = each sample once.
    Returns dict member-name -> [B] (HISTOGRAM -> [B, nbins]).
    """
    dt = values.dtype
    valid = jnp.isfinite(values)
    if weights is None:
        wts = valid.astype(dt)
    else:
        wts = jnp.where(valid, weights.astype(dt), 0.0)
    nf = n.astype(dt)

    sum_v = jnp.sum(wts * jnp.where(valid, values, 0), axis=1)
    energy = jnp.sum(wts * jnp.where(valid, values * values, 0), axis=1)
    mean = safe_div(sum_v, nf)
    d = jnp.where(valid, values - mean[:, None], 0)
    mad = jnp.sum(wts * jnp.abs(d), axis=1) / jnp.maximum(nf, 1)
    m2 = jnp.sum(wts * d * d, axis=1)
    d2 = d * d
    m5 = jnp.sum(wts * d2 * d2 * d, axis=1)
    m6 = jnp.sum(wts * d2 * d2 * d2, axis=1)

    var_u = jnp.where(n > 1, m2 / jnp.maximum(nf - 1, 1), 0.0)
    var_b = jnp.where(n > 1, m2 / jnp.maximum(nf, 1), 0.0)
    sd = jnp.sqrt(var_u)
    sd_b = jnp.sqrt(var_b)

    # powers via multiplies + sqrt (exactly-rounded ops; XLA pow = exp*log
    # would cost ~1e-8 relative error)
    sd2 = sd * sd
    sd5 = sd2 * sd2 * sd
    sd6 = sd2 * sd2 * sd2
    # SKEWNESS/KURTOSIS: Moments4 accumulates over raw_pixels with its OWN
    # count and mean (intensity.cpp:199-208, moments.h:83-118) -- under
    # anisotropy that is the virtual sample (k), not aux_area (n)
    kf = jnp.sum(wts, axis=1)
    mean_k = safe_div(sum_v, kf)
    dk = jnp.where(valid, values - mean_k[:, None], 0)
    m2k = jnp.sum(wts * dk * dk, axis=1)
    m3k = jnp.sum(wts * dk * dk * dk, axis=1)
    m4k = jnp.sum(wts * (dk * dk) * (dk * dk), axis=1)
    m2k_15 = m2k * jnp.sqrt(m2k)
    skew = jnp.where((kf > 3) & (m2k != 0),
                     jnp.sqrt(kf) * m3k / jnp.where(m2k != 0, m2k_15, 1), 0.0)
    kurt = jnp.where((kf > 4) & (m2k != 0),
                     kf * m4k / jnp.where(m2k != 0, m2k * m2k, 1), 0.0)
    exkurt = jnp.where((kf > 4) & (m2k != 0), kurt - 3.0, 0.0)
    hskew = safe_div(m5, nf * sd5)
    hflat = safe_div(m6, nf * sd6)

    hs = histogram_stats(values, n, vmin, vmax, nbins, weights)

    piu = (1.0 - safe_div(vmax - vmin, vmax + vmin)) * 100.0
    qcod = safe_div(hs["p75"] - hs["p25"], hs["p75"] + hs["p25"])
    medad = jnp.sum(wts * jnp.abs(jnp.where(valid, values, 0) - jnp.where(valid, hs["median"][:, None], 0)), axis=1) / jnp.maximum(nf, 1)

    out = {
        "INTEGRATED_INTENSITY": sum_v,
        "MEAN": mean,
        "MEDIAN": hs["median"],
        "MIN": vmin,
        "MAX": vmax,
        "RANGE": vmax - vmin,
        "COVERED_IMAGE_INTENSITY_RANGE": safe_div(vmax - vmin, slide_range),
        "STANDARD_DEVIATION": sd,
        "STANDARD_DEVIATION_BIASED": sd_b,
        "VARIANCE": var_u,
        "VARIANCE_BIASED": var_b,
        "COV": safe_div(sd, mean),
        "STANDARD_ERROR": safe_div(sd, jnp.sqrt(nf)),
        "SKEWNESS": skew,
        "KURTOSIS": kurt,
        "EXCESS_KURTOSIS": exkurt,
        "HYPERSKEWNESS": hskew,
        "HYPERFLATNESS": hflat,
        "MEAN_ABSOLUTE_DEVIATION": mad,
        "MEDIAN_ABSOLUTE_DEVIATION": medad,
        "ENERGY": energy,
        "ROOT_MEAN_SQUARED": jnp.sqrt(safe_div(energy, nf)),
        "ENTROPY": hs["entropy"],
        "MODE": hs["mode"],
        "UNIFORMITY": hs["uniformity"],
        "UNIFORMITY_PIU": piu,
        "P01": hs["p01"], "P10": hs["p10"], "P25": hs["p25"],
        "P75": hs["p75"], "P90": hs["p90"], "P99": hs["p99"],
        "QCOD": qcod,
        "INTERQUARTILE_RANGE": hs["iqr"],
        "ROBUST_MEAN": hs["robust_mean"],
        "ROBUST_MEAN_ABSOLUTE_DEVIATION": hs["rmad"],
    }

    # blank-ROI intercept (intensity.cpp:60-98)
    blank = vmax == vmin
    keep_min = {"MEAN", "MEDIAN", "MIN", "MAX"}
    for k in list(out):
        if k in keep_min:
            out[k] = jnp.where(blank, vmin, out[k])
        elif k == "RANGE":
            out[k] = jnp.where(blank, 0.0, out[k])
        else:
            out[k] = jnp.where(blank, jnp.asarray(noval, dt), out[k])

    out["HISTOGRAM"] = jnp.where(blank[:, None], 0.0, hs["hist"])
    return out
