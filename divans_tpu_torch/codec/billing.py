"""Per-substate bit accounting: the port of divans_tpu/codec/billing.py
(the reference codec's `billing` feature, its BillingDesignation
buckets).

The trace says which model row coded every nibble, the model pass gives
each nibble's freq, and the layout maps rows back to their table
families, so billing is a reduction over the model pass's outputs on
the host: api.compress(billing_out=) brings the freqs back from the
card's passes and calls these functions.
"""
from __future__ import annotations

import math

import numpy as np

from .layout import ModelLayout

# segment -> reporting bucket (the reference's BillingDesignation granularity)
_BUCKETS = {
    "cc": "CrossCommand",
    "ll_cs": "LiteralCommand(length)", "ll_beg": "LiteralCommand(length)",
    "ll_last": "LiteralCommand(length)", "ll_mant": "LiteralCommand(length)",
    "c_ccs": "CopyCommand(length)", "c_cbeg": "CopyCommand(length)",
    "c_clast": "CopyCommand(length)", "c_cmant": "CopyCommand(length)",
    "c_dmn": "CopyCommand(distance)", "c_dbeg": "CopyCommand(distance)",
    "c_dlast": "CopyCommand(distance)", "c_dmant": "CopyCommand(distance)",
    "d_sbeg": "DictCommand", "d_slast": "DictCommand",
    "d_idx": "DictCommand", "d_tr": "DictCommand",
    "bt_mn": "BlockType", "bt_f": "BlockType", "bt_s": "BlockType",
    "bt_stride": "BlockType",
    "pm_only": "PredModeCtxMap", "pm_dcm": "PredModeCtxMap",
    "pm_pd": "PredModeCtxMap", "pm_palette": "PredModeCtxMap",
    "pm_mvmode": "PredModeCtxMap", "pm_mix": "PredModeCtxMap",
    "pm_cmn": "PredModeCtxMap", "pm_cf": "PredModeCtxMap",
    "pm_cs": "PredModeCtxMap",
    "lit_hi": "LiteralCommand(data)", "lit_lo": "LiteralCommand(data)",
    "cm_first": "LiteralCommand(data)", "cm_second": "LiteralCommand(data)",
    "lit_hi_s": "LiteralCommand(data)", "lit_lo_s": "LiteralCommand(data)",
}


def bill(traces: list[np.ndarray], freqs: np.ndarray,
         layout: ModelLayout) -> dict[str, float]:
    """Bits per designation across all metablocks.

    traces: per-metablock int32[n,10]; freqs: [B, N] from model_pass.
    Mix steps are billed to the *mixed* CDF actually used (same as the
    reference, which bills at the coder call site)."""
    row_bucket = np.empty(layout.num_rows, dtype=object)
    row_bucket[0] = "CrossCommand"
    for name, (off, shape) in layout.segments.items():
        row_bucket[off:off + int(np.prod(shape))] = _BUCKETS[name]
    out: dict[str, float] = {}
    for i, t in enumerate(traces):
        n = t.shape[0]
        f = freqs[i, :n].astype(np.float64)
        bits = -np.log2(np.maximum(f, 1) / 32768.0)
        for bucket in np.unique(row_bucket[t[:, 0]]):
            sel = row_bucket[t[:, 0]] == bucket
            out[bucket] = out.get(bucket, 0.0) + float(bits[sel].sum())
    return out


def entropy_report(traces: list[np.ndarray], freqs: np.ndarray,
                   layout: ModelLayout, top: int = 6) -> str:
    """debug_entropy analog (reference `debug_entropy` feature,
    src/probability/interface.rs:446-541: per-CDF counts, coded cost,
    rolling entropy).  Derived from the encode trace instead of a CDF
    wrapper: for every model row — one adaptive CDF — the number of
    nibbles it coded, its total coded cost, the mean cost/nibble, and
    the empirical (order-0 Shannon) entropy of the symbols it saw.  The
    cost−entropy gap per row is the model's adaptation overhead, which
    is what the reference's rolling-entropy instrumentation localizes.
    Prints each segment's totals plus its `top` most expensive rows."""
    r = layout.num_rows
    cnt = np.zeros(r, np.int64)
    bits_row = np.zeros(r, np.float64)
    hist = np.zeros((r, 16), np.int64)
    for i, t in enumerate(traces):
        n = t.shape[0]
        f = freqs[i, :n].astype(np.float64)
        b = -np.log2(np.maximum(f, 1) / 32768.0)
        rows = t[:, 0]
        np.add.at(cnt, rows, 1)
        np.add.at(bits_row, rows, b)
        np.add.at(hist, (rows, t[:, 1]), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = hist / np.maximum(cnt[:, None], 1)
        ent = -np.nansum(np.where(p > 0, p * np.log2(p), 0.0), axis=1)
    lines = ["per-CDF entropy debug (count / bits / bits-per / H0 / overhead)"]
    seg_order = sorted(layout.segments,
                       key=lambda s: -bits_row[layout.segments[s][0]:
                                               layout.segments[s][0]
                                               + int(np.prod(
                                                   layout.segments[s][1]))]
                       .sum())
    for name in seg_order:
        off, shape = layout.segments[name]
        size = int(np.prod(shape))
        sl = slice(off, off + size)
        seg_bits = bits_row[sl].sum()
        seg_cnt = cnt[sl].sum()
        if seg_cnt == 0:
            continue
        lines.append(f"[{name}] rows={size} coded={seg_cnt} "
                     f"bits={seg_bits:.0f} ({seg_bits / 8:.0f} B)")
        order = np.argsort(-bits_row[sl])[:top]
        for j in order:
            if cnt[off + j] == 0:
                break
            coords = np.unravel_index(j, shape)
            per = bits_row[off + j] / cnt[off + j]
            lines.append(
                f"    {name}{tuple(int(c) for c in coords)}: "
                f"n={cnt[off + j]} bits={bits_row[off + j]:.0f} "
                f"per={per:.3f} H0={ent[off + j]:.3f} "
                f"ovh={per - ent[off + j]:+.3f}")
    return "\n".join(lines)


def format_table(bits: dict[str, float], raw_len: int,
                 compressed_len: int) -> str:
    bits = {k: v for k, v in bits.items() if not k.startswith("__")}
    lines = ["  bits       bytes    designation"]
    for k in sorted(bits, key=lambda k: -bits[k]):
        lines.append(f"{bits[k]:12.1f} {bits[k] / 8:10.1f}    {k}")
    total = sum(bits.values())
    lines.append(f"{total:12.1f} {total / 8:10.1f}    TOTAL (model)")
    lines.append(f"actual compressed: {compressed_len} bytes; "
                 f"ratio {compressed_len / max(1, raw_len):.4f}")
    return "\n".join(lines)
