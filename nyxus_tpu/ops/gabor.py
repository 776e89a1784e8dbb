"""Gabor texture features, batched.

Reference: src/nyx/features/gabor.cpp:46-120 (calculate), :?-Gabor kernel,
conv_dud full convolution.  GABOR_i = fraction of pixels whose filtered
magnitude exceeds ``thold * max(baseline magnitude)``, normalized by the
count of baseline pixels above the baseline minimum.

Kernel magnitudes are truncated to unsigned int after the convolution
(the reference stores them in a PixIntens matrix) -- reproduced, since the
thresholds operate on the truncated values.

The 2D complex convolution is expressed as a 2-channel lax conv over the
ROI batch, at HIGHEST precision (the threshold counts flip under TF32).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np


def gabor_kernel(f0, sig2lam, gamma, theta, n: int):
    """Complex Gabor kernel [n, n] (real, imag), magnitude-normalized.

    f0 == 0 (possible under the reference's swapped pair unpacking, see
    gabor_features) degenerates lambda/sigma to infinity: a flat unit
    envelope with zero phase."""
    lam = 2 * math.pi / f0 if f0 != 0 else math.inf
    sig = sig2lam * lam
    t = np.arange(n) - (n // 2 if n % 2 == 0 else (n - 1) // 2)
    txv = t[None, :].astype(np.float64)
    tyv = t[:, None].astype(np.float64)
    ct, st = math.cos(theta), math.sin(theta)
    xte = txv * ct + tyv * st
    yte = tyv * ct - txv * st
    rte = xte * xte + gamma * gamma * yte * yte
    ge = (np.exp(-rte / (2 * sig * sig)) if math.isfinite(sig)
          else np.ones_like(rte))
    argm = xte * f0
    kr = ge * np.cos(argm)
    ki = ge * np.sin(argm)
    s = np.sqrt(kr * kr + ki * ki).sum()
    return kr / s, ki / s


def _gabor_magnitude(img, kr, ki, n: int):
    """Full convolution cropped at offset ceil(n/2), truncated to uint.

    img: [B, H, W] float; returns [B, H, W] magnitudes (floor-truncated)."""
    B, H, W = img.shape
    x = img[:, None]  # NCHW
    k = jnp.stack([jnp.asarray(kr, img.dtype), jnp.asarray(ki, img.dtype)])[:, None]
    # full conv = pad (n-1) both sides; C[p] = sum A[q] B[p-q] -> flip kernel
    kf = k[:, :, ::-1, ::-1]
    out = jax.lax.conv_general_dilated(
        x, kf, window_strides=(1, 1),
        padding=[(n - 1, n - 1), (n - 1, n - 1)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=img.dtype,
        precision=jax.lax.Precision.HIGHEST)
    off = int(math.ceil(n / 2))
    out = out[:, :, off:off + H, off:off + W]
    mag = jnp.sqrt(out[:, 0] ** 2 + out[:, 1] ** 2)
    return jnp.floor(mag)  # PixIntens truncation


def gabor_features(intens_masked, aabb_mask, vmin, vmax, cfg, dtype):
    """GABOR: [B, n_pairs].  All statistics/counts are restricted to the
    per-ROI AABB region (the reference's matrix extent); bucket padding is
    excluded."""
    n = cfg.gabor_kersize
    img = intens_masked.astype(dtype)
    B, H, W = img.shape
    in_aabb = aabb_mask

    # baseline low-pass filter at theta = pi/2
    kr, ki = gabor_kernel(cfg.gabor_f0, cfg.gabor_sig2lam, cfg.gabor_gamma,
                          math.pi / 2, n)
    base = _gabor_magnitude(img, kr, ki, n)
    maxval = jnp.max(jnp.where(in_aabb, base, -jnp.inf).reshape(B, -1), axis=1)
    cmpval = jnp.min(jnp.where(in_aabb, base, jnp.inf).reshape(B, -1), axis=1)
    baseline = jnp.sum((in_aabb & (base > cmpval[:, None, None])).astype(dtype),
                       axis=(1, 2))

    outs = []
    # Faithful quirk: the reference stores (theta, f0) pairs but unpacks
    # them as ``f0 = pair.first; theta = pair.second`` (gabor.cpp:19-25,
    # 107-111), so the ANGLE (radians) acts as the frequency and the
    # FREQUENCY acts as the rotation angle.  Filter 0 (theta=0) is thus a
    # zero-frequency flat-envelope filter.  Verified against the reference
    # binary output on the bench corpus.
    for theta_deg, freq in zip(cfg.gabor_thetas, cfg.gabor_freqs):
        kr, ki = gabor_kernel(math.radians(theta_deg), cfg.gabor_sig2lam,
                              cfg.gabor_gamma, float(freq), n)
        mag = _gabor_magnitude(img, kr, ki, n)
        hit = in_aabb & (mag / jnp.maximum(maxval[:, None, None], 1e-30)
                         > cfg.gabor_thold)
        score = jnp.sum(hit.astype(dtype), axis=(1, 2))
        outs.append(score / jnp.maximum(baseline, 1))

    vals = jnp.stack(outs, axis=1)
    nv = jnp.asarray(cfg.noval, dtype)
    blank = (vmax == vmin)[:, None]
    degen = (maxval == cmpval)[:, None]
    vals = jnp.where(degen, nv, vals)
    return {"GABOR": jnp.where(blank, 0.0, vals)}
