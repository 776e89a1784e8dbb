"""ROI bucketing: group ragged ROIs into a bounded set of padded batch shapes.

The reference packs ROIs into RAM-budget batches and processes each ROI alone
inside a thread (reference: phase2_2d.cpp:501-633).  This design instead
pads each ROI's AABB up to a small set of bucket shapes so every feature
family runs as one batched kernel per bucket -- few distinct compiled shapes,
bounded padding waste (<= ~4x area in the worst case, typically ~1.6x).
"""

from __future__ import annotations

import collections

# Pow-2 ladder: each (H, W) bucket is a power of two per dim, so the number
# of distinct compiled shapes stays small (compilations are the scarce
# resource; XLA pads to tiles anyway and padding waste is capped at 2x/dim).
_LADDER = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]


def pad_dim(n: int) -> int:
    for v in _LADDER:
        if n <= v:
            return v
    raise ValueError("ROI dimension %d exceeds max supported %d" % (n, _LADDER[-1]))


def bucket_shape(h: int, w: int):
    """Square buckets for small ROIs (max dim <= 256): halves the number of
    distinct compiled shapes and device dispatches for nucleus-scale
    workloads, at a padding cost that ROADMAP D2 puts to a GPU A/B.
    Elongated large ROIs keep rectangular buckets."""
    if max(h, w) <= 256:
        d = pad_dim(max(h, w))
        return (d, d)
    return (pad_dim(h), pad_dim(w))


def group_rois(records, hbm_budget_bytes: int = 1 << 30, bytes_per_px: int = 16):
    """Group RoiRecords into batches of identical padded shape.

    Returns a list of (shape (Hb, Wb), [roi indices]) with each batch's
    B * Hb * Wb * bytes_per_px below the budget.
    """
    buckets = collections.defaultdict(list)
    for i, r in enumerate(records):
        buckets[bucket_shape(r.height, r.width)].append(i)

    batches = []
    for shape, idxs in sorted(buckets.items()):
        hb, wb = shape
        max_b = max(1, int(hbm_budget_bytes // (hb * wb * bytes_per_px)))
        for s in range(0, len(idxs), max_b):
            batches.append((shape, idxs[s:s + max_b]))
    return batches
