"""Literal context-map clustering: data-adaptive 64 -> K prior sharing.

The reference's encoder ships real context maps computed by brotli's
metablock analysis (callback payload PredictionModeContextMap,
the reference's src/brotli_ir_gen.rs:133-167) and codes them through a
13-entry-LRU sub-FSM (the reference's src/codec/context_map.rs:264-384).
This build's wire + decode side has always handled arbitrary maps; this
module supplies the GENERATION side: cluster the 64 utf8 literal
contexts by the similarity of their byte histograms (brotli's
BrotliClusterHistograms idea: greedy pairwise merge minimizing the
entropy-cost increase), so sparse contexts share one adaptive prior
instead of each paying cold-start adaptation.

Cluster ids are renumbered in first-appearance order, which the map
coder's "max+1" mnemonic turns into near-free wire bytes.

A copy of divans_tpu/ir/cmaps.py
(the port imports nothing of that package).
"""
from __future__ import annotations

import numpy as np

from .. import constants

_LUT0 = None
_LUT1 = None


def _luts():
    global _LUT0, _LUT1
    if _LUT0 is None:
        _LUT0 = np.asarray(constants.literal_lut0(
            constants.LITERAL_PREDICTION_MODE_UTF8), np.int32)
        _LUT1 = np.asarray(constants.literal_lut1(
            constants.LITERAL_PREDICTION_MODE_UTF8), np.int32)
    return _LUT0, _LUT1


def context_histograms(data: bytes) -> np.ndarray:
    """[64, 256] counts of byte values per utf8 literal context.

    Contexts are computed over the whole block (prev/prev2 chain), the
    same approximation brotli's metablock analysis uses before the
    final command split — literal positions dominate the distribution
    and the cluster structure is what matters, not exact counts."""
    lut0, lut1 = _luts()
    a = np.frombuffer(data, np.uint8).astype(np.int32)
    if a.shape[0] < 3:
        return np.zeros((64, 256), np.int64)
    ctx = lut0[a[1:-1]] | lut1[a[:-2]]
    pairs = ctx * 256 + a[2:]
    return np.bincount(pairs, minlength=64 * 256).reshape(64, 256)


def _hist_cost(h: np.ndarray) -> float:
    """Bits to code a histogram's mass at its own empirical entropy."""
    tot = h.sum()
    if tot == 0:
        return 0.0
    nz = h[h > 0].astype(np.float64)
    return float((nz * -np.log2(nz / tot)).sum())


def cluster_contexts(counts: np.ndarray, max_clusters: int = 16,
                     min_gain_bits: float = 512.0) -> bytes:
    """Greedy agglomerative merge of the 64 context histograms.

    Merges the pair with the smallest cost increase while more than
    `max_clusters` remain, then keeps merging while the increase stays
    under `min_gain_bits` (separate clusters must pay for themselves —
    each extra cluster costs adaptation warm-up that the static
    entropy model here can't see, so a small threshold biases toward
    fewer clusters).  Returns the 64-byte map, ids in
    first-appearance order."""
    k = counts.shape[0]
    hists = [counts[i].astype(np.int64) for i in range(k)]
    costs = [_hist_cost(h) for h in hists]
    groups = [[i] for i in range(k)]
    # pairwise merge-cost cache (upper triangle)
    inc = np.full((k, k), np.inf)
    for i in range(k):
        for j in range(i + 1, k):
            inc[i, j] = _hist_cost(hists[i] + hists[j]) \
                - costs[i] - costs[j]
    alive = [True] * k
    n_alive = k
    while n_alive > 1:
        idx = np.unravel_index(np.argmin(inc), inc.shape)
        i, j = int(idx[0]), int(idx[1])
        best = inc[i, j]
        if not np.isfinite(best):
            break
        if n_alive <= max_clusters and best > min_gain_bits:
            break
        hists[i] = hists[i] + hists[j]
        costs[i] = _hist_cost(hists[i])
        groups[i].extend(groups[j])
        alive[j] = False
        n_alive -= 1
        inc[j, :] = np.inf
        inc[:, j] = np.inf
        for m in range(k):
            if alive[m] and m != i:
                a, b = (m, i) if m < i else (i, m)
                inc[a, b] = _hist_cost(hists[i] + hists[m]) \
                    - costs[i] - costs[m]
    # first-appearance renumbering (map coder's max+1 mnemonic)
    assign = {}
    for gi in range(k):
        if alive[gi]:
            for c in groups[gi]:
                assign[c] = gi
    lcm = np.zeros(k, np.int32)
    seen: dict[int, int] = {}
    next_id = 0
    for c in range(k):
        gi = assign[c]
        if gi not in seen:
            seen[gi] = next_id
            next_id += 1
        lcm[c] = seen[gi]
    return bytes(int(v) for v in lcm)


def cluster_lcm(data: bytes, max_clusters: int = 16,
                min_gain_bits: float = 512.0) -> bytes:
    """64-byte clustered literal context map for one metablock."""
    return cluster_contexts(context_histograms(data), max_clusters,
                            min_gain_bits)
