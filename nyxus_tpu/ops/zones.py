"""Zone labeling for GLSZM/GLDZM: vectorized equivalent of the reference's
backtracking zone scan (reference: src/nyx/features/glszm.cpp:89-160,
gldzm.cpp:92-240).

The reference grows zones by DFS restricted to the E, SE, S, SW moves with
backtracking, claiming pixels in raster order.  That procedure is exactly:

    zone(v) = argmin_{raster order} { u : v is reachable from u in the DAG
              whose edges are E/SE/S/SW steps between same-level pixels }

(the DAG is acyclic because every edge increases (row, col) lexicographically,
and the earliest-raster ancestor of a pixel is precisely the DFS seed that
claims it first -- see docstring proof sketch in the repo docs).

We compute min-ancestor labels by iterating:
  * a vertical relaxation pulling labels from the NW/N/NE predecessors
  * a segmented horizontal prefix-min along same-level runs (W predecessor
    chains collapse in one associative scan)
until fixpoint (lax.while_loop).  Zone sizes follow by a segment-sum over
labels; per-zone reductions use sorted-run counting.
"""

from __future__ import annotations

import jax
import jax.lax as lax
import jax.numpy as jnp

from .common import shifted2d


def zone_labels(lev, valid):
    """Min-ancestor zone labels.

    lev: [B, H, W] int32 levels; valid: [B, H, W] participation mask.
    Returns anc: [B, H, W] int32 raster index of each pixel's zone seed
    (BIG = H*W for non-participating pixels).
    """
    B, H, W = lev.shape
    BIG = jnp.int32(H * W)
    ridx = (jnp.arange(H, dtype=jnp.int32)[:, None] * W
            + jnp.arange(W, dtype=jnp.int32)[None, :])
    ridx = jnp.broadcast_to(ridx[None], (B, H, W))
    anc0 = jnp.where(valid, ridx, BIG)

    # horizontal same-level continuity (predecessor = W neighbor)
    same_w = valid & shifted2d(valid, -1, 0, fill=False) & \
        (lev == shifted2d(lev, -1, 0))

    def seg_prefix_min(a):
        """Prefix-min along x, restarting where same_w is False."""
        def op(l, r):
            lv, lc = l
            rv, rc = r
            # rc = right block connects to the left -> min flows through
            v = jnp.where(rc, jnp.minimum(lv, rv), rv)
            return (v, lc & rc)
        v, _ = lax.associative_scan(op, (a, same_w), axis=2)
        return v

    diag_preds = ((-1, -1), (0, -1), (1, -1))   # NW, N, NE (dx, dy)

    def step(anc):
        for dx, dy in diag_preds:
            n_anc = shifted2d(anc, dx, dy, fill=BIG)
            n_val = shifted2d(valid, dx, dy, fill=False)
            n_lev = shifted2d(lev, dx, dy)
            ok = valid & n_val & (n_lev == lev)
            anc = jnp.where(ok, jnp.minimum(anc, n_anc), anc)
        return seg_prefix_min(anc)

    def cond(state):
        anc, changed = state
        return changed

    def body(state):
        anc, _ = state
        new = step(anc)
        return new, jnp.any(new != anc)

    anc, _ = lax.while_loop(cond, body, (step(anc0), jnp.bool_(True)))
    return jnp.where(valid, anc, BIG)


def zone_labels_cc4(lev, valid):
    """Min-raster-index labels of FULL 4-connected components.

    GLDZM's zone DFS explores E, S, W and N moves with backtracking
    (gldzm.cpp:121-210) -- a complete 4-connected flood fill, unlike GLSZM's
    forward E/SE/S/SW scan -- so a GLDZM zone is the standard 4-connected
    same-level component, labeled by its first pixel in raster order.

    Computed by min-label relaxation: vertical pulls from N and S plus
    segmented prefix-min sweeps in both horizontal directions, iterated to
    fixpoint."""
    B, H, W = lev.shape
    BIG = jnp.int32(H * W)
    ridx = (jnp.arange(H, dtype=jnp.int32)[:, None] * W
            + jnp.arange(W, dtype=jnp.int32)[None, :])
    ridx = jnp.broadcast_to(ridx[None], (B, H, W))
    anc0 = jnp.where(valid, ridx, BIG)

    same_w = valid & shifted2d(valid, -1, 0, fill=False) & \
        (lev == shifted2d(lev, -1, 0))
    same_e = valid & shifted2d(valid, 1, 0, fill=False) & \
        (lev == shifted2d(lev, 1, 0))

    def seg_min(a, conn, reverse):
        def op(l, r):
            lv, lc = l
            rv, rc = r
            v = jnp.where(rc, jnp.minimum(lv, rv), rv)
            return (v, lc & rc)
        v, _ = lax.associative_scan(op, (a, conn), axis=2, reverse=reverse)
        return v

    def step(anc):
        for dx, dy in ((0, -1), (0, 1)):        # N and S pulls
            n_anc = shifted2d(anc, dx, dy, fill=BIG)
            n_val = shifted2d(valid, dx, dy, fill=False)
            n_lev = shifted2d(lev, dx, dy)
            ok = valid & n_val & (n_lev == lev)
            anc = jnp.where(ok, jnp.minimum(anc, n_anc), anc)
        anc = seg_min(anc, same_w, reverse=False)   # W chains (left-to-right)
        return seg_min(anc, same_e, reverse=True)   # E chains (right-to-left)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        anc, _ = state
        new = step(anc)
        return new, jnp.any(new != anc)

    anc, _ = lax.while_loop(cond, body, (step(anc0), jnp.bool_(True)))
    return jnp.where(valid, anc, BIG)


def zone_list(anc, lev, valid, dist=None):
    """Per-zone (level, size[, min dist]) lists via ONE sort -- no segment
    ops or gathers (a [B, A] sort plus scans replaced scatter/gather group
    sums; which is cheaper on the GPU is ROADMAP S4).

    anc: [B, ...] zone labels (seed raster index; >= prod(spatial) invalid);
    lev: [B, ...] levels; valid: participation mask; dist (optional):
    per-pixel int distance whose ZONE MINIMUM is wanted.

    Returns (zlev, zsize, zdist | None, ok): [B, A] arrays in sorted-zone
    order; ok is True exactly once per zone."""
    B = anc.shape[0]
    A = 1
    for d in anc.shape[1:]:
        A *= d
    BIG = jnp.int32(A)
    af = jnp.where(valid, anc, BIG).reshape(B, -1)
    lev_f = jnp.where(valid, lev, 0).reshape(B, -1)
    if dist is not None:
        # two-key lexicographic sort: the head of each anc run carries the
        # zone-min distance (a composite int key overflows at 1024^2 crops)
        df = jnp.where(valid, dist, jnp.int32(1 << 30)).reshape(B, -1)
        anc_s, dist_s, lev_s = lax.sort((af, df, lev_f), dimension=1,
                                        num_keys=2)
    else:
        anc_s, lev_s = lax.sort((af, lev_f), dimension=1, num_keys=1)
        dist_s = None
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), bool), anc_s[:, 1:] != anc_s[:, :-1]], axis=1)
    is_end = jnp.concatenate(
        [anc_s[:, 1:] != anc_s[:, :-1], jnp.ones((B, 1), bool)], axis=1)
    idx = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32), (B, A))
    run_start = lax.cummax(jnp.where(is_start, idx, -1), axis=1)
    run_end = lax.cummin(jnp.where(is_end, idx, A), axis=1, reverse=True)
    ok = is_start & (anc_s < BIG)
    zsize = jnp.where(ok, run_end - run_start + 1, 0)
    zlev = jnp.where(ok, lev_s, 0)
    zdist = jnp.where(ok, dist_s, 0) if dist is not None else None
    return zlev, zsize, zdist, ok


def zone_seeds_and_sizes(anc, valid):
    """(seed mask, zone size at seed) from zone labels.

    anc: [B, H, W] labels; returns seed: [B, H, W] bool and
    size: [B, H, W] int32 (zone pixel count, meaningful at seeds)."""
    B, H, W = anc.shape
    A = H * W
    flat = anc.reshape(B, -1)
    ridx = jnp.arange(A, dtype=jnp.int32)[None]
    ones = valid.reshape(B, -1).astype(jnp.int32)
    rows = jnp.arange(B, dtype=jnp.int32)[:, None]
    seg = (rows * (A + 1) + jnp.minimum(flat, A)).reshape(-1)
    counts = jax.ops.segment_sum(ones.reshape(-1), seg,
                                 num_segments=B * (A + 1))
    counts = counts.reshape(B, A + 1)[:, :A]
    seed = valid & (flat == ridx).reshape(B, H, W)
    size = jnp.take_along_axis(counts, jnp.minimum(flat, A - 1), axis=1)
    return seed, size.reshape(B, H, W)


def grouped_weight_sums(keys, w):
    """For each element (in sorted-key order), the SUM of ``w`` over the
    elements sharing its key.

    The weighted generalization of grouped_run_counts: with w == 1 the sums
    are the group cardinalities.  Lets callers ship pre-aggregated zone
    lists (unique (level, value) pairs with multiplicities) instead of one
    row per zone.  keys: [B, A] float (+inf invalid); w: [B, A], w >= 0.
    Returns (sorted_keys, sorted_w, group_sums, valid) aligned with the
    sorted order.

    Gather-free on purpose: the former argsort + take_along_axis
    formulation was the hottest device cost of the *ALL* slide program on
    the previous accelerator; the GPU's trade-off is ROADMAP S4.  lax.sort
    carries the payload through the sort, and the group sums come from
    segmented scans: a within-segment
    cumsum followed by a reverse segmented max (valid because w >= 0
    makes the segment cumsum nondecreasing)."""
    B, A = keys.shape
    ks, ws = lax.sort((keys, w), dimension=1, num_keys=1)
    v = jnp.isfinite(ks)
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), bool), ks[:, 1:] != ks[:, :-1]], axis=1)
    conn_prev = ~is_start           # element i joins i-1's segment
    conn_next = jnp.concatenate(    # element i joins i+1's segment
        [conn_prev[:, 1:], jnp.zeros((B, 1), bool)], axis=1)

    def seg_sum_op(l, r):
        lv, lc = l
        rv, rc = r
        return (jnp.where(rc, lv + rv, rv), lc & rc)

    cum, _ = lax.associative_scan(seg_sum_op, (ws, conn_prev), axis=1)

    def seg_max_op(l, r):
        lv, lc = l
        rv, rc = r
        return (jnp.where(rc, jnp.maximum(lv, rv), rv), lc & rc)

    sums, _ = lax.associative_scan(seg_max_op, (cum, conn_next), axis=1,
                                   reverse=True)
    return ks, ws, jnp.where(v, sums, 0), v


def grouped_run_counts(keys):
    """For each valid element, the number of valid elements sharing its key.

    keys: [B, A] float (+inf for invalid). Returns [B, A] counts aligned with
    the SORTED order plus the sorted validity mask -- callers reduce over the
    sorted arrays directly."""
    B, A = keys.shape
    ks = jnp.sort(keys, axis=1)
    v = jnp.isfinite(ks)
    idx = jnp.broadcast_to(jnp.arange(A, dtype=jnp.int32), (B, A))
    is_start = jnp.concatenate(
        [jnp.ones((B, 1), bool), ks[:, 1:] != ks[:, :-1]], axis=1)
    is_end = jnp.concatenate(
        [ks[:, 1:] != ks[:, :-1], jnp.ones((B, 1), bool)], axis=1)
    run_start = lax.cummax(jnp.where(is_start, idx, -1), axis=1)
    run_end = lax.cummin(jnp.where(is_end, idx, A), axis=1, reverse=True)
    counts = jnp.where(v, run_end - run_start + 1, 0)
    return ks, counts, v
