"""The deferred literal model of a lane batch, in plain PyTorch: its
state, its count histograms and its lagged commit.

Shared by the decode's lane loop (codec/decode.decode_lanes) and the
encode's literal model pass (codec/lit_pass.lit_pass_plain), as the
reference shares one commit between its decode scan and its lit pass
(divans_tpu/codec/jax_engine.py: model_pass_deferred_lit "mirrors the
decode scan's commit").

Per lane the model is 385 rebased literal rows x 16 CDF entries
([B, R_LIT, 16], row 0 unused) in layout order: lit_hi 1..65 (ctx),
lit_lo 65..193 ((ctx>>3)*16 + hi), cm_first 193..257 (ctx), cm_second
257..385 (stored (hi, c3)), plus the two-model mixer weights [B, 2, 3]
= (w0, w1, norm weight) for which 0 (lo nibble) and which 1 (hi
nibble).  A chunk's pend is (add [B,R,16], limsum [B,R], cnt [B,R],
wadj [B,2,2]); it commits at the end of the next chunk (lag 1).
"""
from __future__ import annotations

import numpy as np
import torch

from ..probability import cdf16
from ..probability.weights import (NORM_WEIGHT_INIT, WEIGHT_MAX,
                                   fix_weights, floor_div, norm_weight)
from .deferred import MAX_RENORM_PASSES

N_HI = 64
N_LO = 128
N_PLANES = 2 * N_HI + 2 * N_LO   # 384 kernel-order planes of the snapshot
R_LIT = 385                      # rebased literal rows (row 0 unused)
OFFSETS = (1, 65, 193, 257)      # rebased lit_hi, lit_lo, cm_first, cm_second


def kernel_perm(layout):
    """Static permutation: the 384 kernel-order planes -> rebased literal
    rows ([lit_hi | cm_first | lit_lo | cm_second permuted to
    (c3, hi)]), plus the rebased segment offsets."""
    seg_ = layout.segments
    lit_base = seg_["lit_hi"][0]

    def reb(name):
        return seg_[name][0] - (lit_base - 1)

    hi_off, lo_off = reb("lit_hi"), reb("lit_lo")
    cm1_off, cm2_off = reb("cm_first"), reb("cm_second")
    perm = np.zeros(N_PLANES, np.int32)
    perm[0:64] = hi_off + np.arange(64)
    perm[64:128] = cm1_off + np.arange(64)
    perm[128:256] = lo_off + np.arange(128)
    for c3 in range(8):
        for hi in range(16):
            perm[256 + c3 * 16 + hi] = cm2_off + hi * 8 + c3
    return perm, (hi_off, lo_off, cm1_off, cm2_off)


def planes(layout) -> np.ndarray:
    """kernel_perm's permutation, for a layout whose rebased literal
    segments lie at OFFSETS in R_LIT rows: chunk_pend concatenates its
    classes in that order."""
    perm, offs = kernel_perm(layout)
    assert offs == OFFSETS, offs
    assert layout.num_rows - layout.segments["lit_hi"][0] + 1 == R_LIT
    return perm


def renorm_bound_q(spd_all, s_bytes: int) -> int | None:
    """Worst-case renorm passes of the commit from the per-stream speeds
    [..., 6] = (inc, lim) x 3: a row's max is < lim + inc * s_bytes at
    apply time and each pass maps m -> (m+16) - ((m+16) >> 2).  None when
    a pair would need more than MAX_RENORM_PASSES."""
    sp = np.asarray(spd_all).reshape(-1, 6)
    pairs = {(int(i), int(l)) for r in sp
             for i, l in (r[0:2], r[2:4], r[4:6]) if i}
    p_max = 0
    for inc, lim in pairs:
        m = max(lim - 1, 64) + inc * s_bytes
        p = 0
        while m >= lim and p <= MAX_RENORM_PASSES:
            m = (m + 16) - ((m + 16) >> 2)
            p += 1
        if p > MAX_RENORM_PASSES:
            return None
        p_max = max(p_max, p)
    return p_max


def renorm_passes(spd_all, s_bytes: int) -> int:
    """Masked renorm passes each commit runs: the speeds' bound when it
    is at most 3 (at least 1), else MAX_RENORM_PASSES.  A masked pass
    leaves a row under its limit as it is, so either count equals the
    reference's loop, which stops once no row is over."""
    n = renorm_bound_q(spd_all, s_bytes)
    return max(1, n) if n is not None and n <= 3 else MAX_RENORM_PASSES


def perm_cm2(device) -> torch.Tensor:
    """pend row hi*8+c3 (cm_second) <- count row c3*16+hi (lo index)."""
    return torch.tensor([(i % 8) * 16 + i // 8 for i in range(N_LO)],
                        device=device)


def init_state(b: int, device):
    """(committed, weights, pend) of B fresh lanes: CDF_INIT rows, unit
    weights with norm weight 2^14, an empty pend."""
    i32 = dict(dtype=torch.int32, device=device)
    committed = cdf16.cdf_init((b, R_LIT), device)
    weights = torch.cat([torch.ones((b, 2, 2), **i32),
                         torch.full((b, 2, 1), NORM_WEIGHT_INIT, **i32)],
                        dim=2)
    pend = (torch.zeros((b, R_LIT, 16), **i32), torch.zeros((b, R_LIT), **i32),
            torch.zeros((b, R_LIT), **i32), torch.zeros((b, 2, 2), **i32))
    return committed, weights, pend


def count_hists(ctx, hi, lo, active):
    """Integer count histograms of a chunk's bytes: cnt_hi [B, 64, 16]
    (ctx, hi) and cnt_lo [B, 128, 16] ((ctx>>3)*16 + hi, lo) over the
    active bytes.  ctx, hi, lo: int64 [B, S]; active: bool [B, S]."""
    b = ctx.shape[0]
    dev = ctx.device
    lanes = torch.arange(b, device=dev)[:, None]
    ones = torch.ones(ctx.numel(), dtype=torch.int32, device=dev)
    idx_hi = torch.where(active, lanes * 1024 + ctx * 16 + hi, b * 1024)
    cnt_hi = torch.zeros(b * 1024 + 1, dtype=torch.int32, device=dev
                         ).index_add_(0, idx_hi.reshape(-1), ones
                                      )[:-1].view(b, N_HI, 16)
    idx_lo = torch.where(
        active, lanes * 2048 + ((ctx >> 3) * 16 + hi) * 16 + lo, b * 2048)
    cnt_lo = torch.zeros(b * 2048 + 1, dtype=torch.int32, device=dev
                         ).index_add_(0, idx_lo.reshape(-1), ones
                                      )[:-1].view(b, N_LO, 16)
    return cnt_hi, cnt_lo


def seg(cnt, spd, inc_col, lim_col):
    """(add, limsum, cnt) of one row class from its [B, P, 16] counts;
    a speed with inc == 0 records nothing."""
    inc = spd[:, inc_col, None]
    tot = torch.sum(cnt, dim=-1, dtype=torch.int32) * (inc != 0)
    add = inc[:, :, None] * torch.cumsum(cnt, dim=-1, dtype=torch.int32)
    return add, spd[:, lim_col, None] * tot, tot


def chunk_pend(cnt_hi, cnt_lo, spd, wadj, perm2):
    """A chunk's pend in layout order from its class histograms and the
    per-lane speeds spd [B, 6] = (inc, lim) of speeds 0, 2, 3.  perm2:
    perm_cm2 on the same device."""
    segs = [seg(cnt_hi, spd, 0, 1),            # lit_hi    <- speed 0
            seg(cnt_lo, spd, 0, 1),            # lit_lo    <- speed 0
            seg(cnt_hi, spd, 4, 5),            # cm_first  <- speed 3
            seg(cnt_lo[:, perm2], spd, 2, 3)]  # cm_second <- speed 2
    zrow = torch.zeros((cnt_hi.shape[0], 1, 16), dtype=torch.int32,
                       device=cnt_hi.device)
    return (torch.cat([zrow] + [x[0] for x in segs], dim=1),
            torch.cat([zrow[:, :, 0]] + [x[1] for x in segs], dim=1),
            torch.cat([zrow[:, :, 0]] + [x[2] for x in segs], dim=1),
            wadj)


def apply_pend(committed, weights, pend, n_pass: int):
    """The boundary CDF rule and mixer rule of the deferred profile
    (codec/deferred.py), for a whole lane batch."""
    add, limsum, cnt, wadj = pend
    committed = committed + add
    lim_eff = torch.where(cnt > 0, floor_div(limsum, torch.clamp(cnt, min=1)),
                          0x8000)
    bias = torch.arange(1, 17, dtype=torch.int32, device=committed.device)
    # masked passes: a row under its limit is left as it is, so n_pass
    # passes equal the reference's loop (which stops once no row is over)
    for _ in range(n_pass):
        over = committed[..., 15] >= lim_eff
        cb = committed + bias
        committed = torch.where(over[..., None], cb - (cb >> 2), committed)
    w01 = torch.clamp(weights[..., :2] + wadj, 1, WEIGHT_MAX)
    w0, w1 = fix_weights(w01[..., 0], w01[..., 1])
    return committed, torch.stack([w0, w1, norm_weight(w0, w1)], dim=-1)
