"""Shared batched primitives for feature kernels.

Building blocks: histogram/bincount as fused one-hot matmuls (at HIGHEST
precision: no TF32), masked reductions, sorted-value statistics.  Everything is batched over a
leading ROI axis ``B`` and works on padded, masked tensors with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


# one-hot tensors up to this many elements take the matmul builders;
# beyond it (large 3D cubes) the scatter fallback keeps memory O(A).  The
# one-hot-vs-scatter choice on the GPU is ROADMAP S4.
_ONEHOT_ELEM_CAP = 1 << 27


def masked_bincount(idx, weights, nbins: int):
    """Batched bincount: out[b, k] = sum_a weights[b, a] * (idx[b, a] == k).

    Matmul path: one-hot(idx) contracted with the weights -- one
    [A, nbins] matvec per batch row.  Falls back to segment_sum when the
    one-hot would exceed the element cap (the only O(A)-memory option for
    giant inputs).  idx entries outside [0, nbins) contribute nothing.

    idx:     [B, A] int32
    weights: [B, A] float (0 for padding)
    -> [B, nbins] float of weights.dtype
    """
    B, A = idx.shape
    in_range = (idx >= 0) & (idx < nbins)
    w = jnp.where(in_range, weights, 0)
    if B * A * nbins <= _ONEHOT_ELEM_CAP:
        oh = (jnp.clip(idx, 0, nbins - 1)[..., None]
              == jnp.arange(nbins, dtype=idx.dtype)).astype(weights.dtype)
        return jnp.einsum("bak,ba->bk", oh, w,
                          preferred_element_type=weights.dtype,
                          precision=lax.Precision.HIGHEST)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    flat_idx = (rows * nbins + jnp.clip(idx, 0, nbins - 1)).reshape(-1)
    out = jax.ops.segment_sum(w.reshape(-1), flat_idx, num_segments=B * nbins)
    return out.reshape(B, nbins)


def bincount2d(i_idx, j_idx, weights, ni: int, nj: int):
    """Batched 2D histogram: out[b, i, j] = sum_a w[b,a] * (i_idx==i) * (j_idx==j).

    Implemented as one-hot(i)^T @ (one-hot(j) * w): an [ni, A] x [A, nj]
    batched matmul -- the matmul form of the co-occurrence builder.
    The weights fold into ONE of the one-hots so XLA emits a plain
    dot_general (the 3-operand einsum form materialized the full
    [B, A, ni, nj] outer product).  Memory is O(A * (ni + nj)): fine for 2D
    bucket crops, prohibitive for large 3D cubes -- use pair_hist there.
    """
    oi = (i_idx[..., None] == jnp.arange(ni, dtype=i_idx.dtype)).astype(weights.dtype)
    oj = (j_idx[..., None] == jnp.arange(nj, dtype=j_idx.dtype)).astype(weights.dtype)
    return jnp.einsum("bai,baj->bij", oi, oj * weights[..., None],
                      preferred_element_type=weights.dtype,
                      precision=lax.Precision.HIGHEST)


def pair_hist(i_idx, j_idx, weights, ni: int, nj: int):
    """2D histogram with a size-adaptive builder.

    Small crops take the one-hot matmul (bincount2d), where the one-hots
    stay tiny.  Large 3D cubes take the composite-index scatter-add:
    O(A) memory where the one-hot form would materialize [B, A, ni]
    (VERDICT r1 weak #6 -- 4 GB per direction at 256-cube, 64 levels).
    Entries with either index out of range contribute nothing."""
    B, A = i_idx.shape
    if B * A * (ni + nj) <= _ONEHOT_ELEM_CAP:
        w = jnp.where((i_idx >= 0) & (i_idx < ni) &
                      (j_idx >= 0) & (j_idx < nj), weights, 0)
        return bincount2d(jnp.clip(i_idx, 0, ni - 1),
                          jnp.clip(j_idx, 0, nj - 1), w, ni, nj)
    return pair_hist_scatter(i_idx, j_idx, weights, ni, nj)


def pair_hist_scatter(i_idx, j_idx, weights, ni: int, nj: int):
    ok = (i_idx >= 0) & (i_idx < ni) & (j_idx >= 0) & (j_idx < nj)
    comp = jnp.where(ok, i_idx * nj + j_idx, -1)
    return masked_bincount(comp, weights, ni * nj).reshape(
        weights.shape[0], ni, nj)


def shifted2d(arr, dx: int, dy: int, fill=0):
    """arr[b, y + dy, x + dx] with constant fill outside."""
    B, H, W = arr.shape
    ylo, yhi = max(-dy, 0), max(dy, 0)
    xlo, xhi = max(-dx, 0), max(dx, 0)
    padded = jnp.pad(arr, ((0, 0), (ylo, yhi), (xlo, xhi)),
                     constant_values=fill)
    return padded[:, yhi:yhi + H, xhi:xhi + W]


NEIGHBORS8 = ((0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1), (-1, 0), (-1, -1))


def masked_sum(x, mask, axis=None):
    return jnp.sum(jnp.where(mask, x, 0), axis=axis)


def safe_div(a, b, default=0.0):
    """a / b with ``default`` where b == 0."""
    ok = b != 0
    return jnp.where(ok, a / jnp.where(ok, b, 1), default)


def sort_masked_values(intens, mask, pad=jnp.inf):
    """Flatten an [B, H, W] crop to sorted [B, A] values with +inf padding."""
    B = intens.shape[0]
    v = jnp.where(mask, intens, pad).reshape(B, -1)
    return jnp.sort(v, axis=1)


def take_per_row(values, idx):
    """values: [B, A], idx: [B] -> [B] gather of values[b, idx[b]]."""
    return jnp.take_along_axis(values, idx[:, None], axis=1)[:, 0]


def last_true_value(cond, cand, default=0.0):
    """Per batch row: cand at the LAST index where cond is True, else default.

    cond, cand: [B, K] -> [B].  Mirrors C++ loops that keep overwriting a
    result on every matching iteration.
    """
    K = cond.shape[-1]
    rev = cond[:, ::-1]
    has = jnp.any(cond, axis=-1)
    last = (K - 1) - jnp.argmax(rev, axis=-1)
    picked = take_per_row(cand, last.astype(jnp.int32))
    return jnp.where(has, picked, default)


def fast_log2(x):
    """The reference's fast_log10 approximation, as log2 (helpers.h:283-327).

    A float32 quadratic fit of log2 on the reduced significand — every
    texture-family entropy in the reference (GLCM/GLRLM/GLSZM/GLDM, 2D and
    3D) flows through it, with ~1e-3 relative error vs an exact log.  Exact
    logs therefore DIVERGE from the reference's outputs; this mirrors the
    bit-level algorithm (the reference scales to log10 and divides back by
    the same constant, a no-op up to 1-ulp rounding)."""
    import jax.lax as _lax
    dt = x.dtype
    xf = x.astype(jnp.float32)
    ui = _lax.bitcast_convert_type(xf, jnp.uint32)
    exp = ((ui >> 23) & jnp.uint32(0xFF)).astype(jnp.float32)
    frac = ui & jnp.uint32(0x007FFFFF)
    greater = (ui & jnp.uint32(0x00400000)) != 0
    sig_g = _lax.bitcast_convert_type(frac | jnp.uint32(0x3f000000),
                                      jnp.float32)
    sig_l = _lax.bitcast_convert_type(frac | jnp.uint32(0x3f800000),
                                      jnp.float32)
    fexp = jnp.where(greater, exp - jnp.float32(126.0),
                     exp - jnp.float32(127.0))
    signif = jnp.where(greater, sig_g, sig_l) - jnp.float32(1.0)
    a = jnp.float32(-0.6296735)
    b = jnp.float32(1.466967)
    lg2 = fexp + a * signif * signif + b * signif
    return lg2.astype(dt)
