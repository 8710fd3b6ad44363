"""Compression options — mirrors the reference's DivansCompressorOptions
(src/interface.rs:444-484) plus the batch/metablock knobs.  A copy of
divans_tpu/options.py: both packages read and write the same containers.

Only the window size and per-metablock geometry are persisted in the
container header; all model configuration travels inside the compressed
stream via the PredictionMode command, so the decoder is configuration-free
(reference: src/codec/context_map.rs:31-42).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .probability.speed import Speed


@dataclasses.dataclass(frozen=True)
class DivansOptions:
    # --- reference-parity options (interface.rs:444-484) ---
    quality: int = 10                     # 1..11 (brotli-style effort for the matcher)
    window_size: int = 22                 # log2 LZ window, 10..24
    lgblock: Optional[int] = None         # log2 metablock size; None = keep
                                          # metablock_size (reference option,
                                          # interface.rs; resolved in
                                          # __post_init__)
    dynamic_context_mixing: int = 1       # 0=off, 1..14 mixer level
    prior_depth: int = 0                  # FORMALLY DROPPED (must be 0).
                                          # The reference keys literal priors
                                          # by depth (src/interface.rs:444-484);
                                          # here every engine's literal model
                                          # is depth-free (the PM header still
                                          # round-trips the nibble for wire
                                          # parity). Measured on the reference
                                          # corpus the option never paid for
                                          # its 3x table growth on the device
                                          # layouts, so it errors loudly
                                          # rather than silently coding a
                                          # no-op (DESIGN.md "dropped
                                          # options")
    literal_adaptation: Optional[tuple[Speed, Speed, Speed, Speed]] = None
    use_context_map: bool = True
    force_stride_value: int = 0           # 0 = stride detection off (stride 1)
    stride_detection_quality: int = 0
    speed_detection_quality: int = 0
    prior_bitmask_detection: int = 0      # 0 = mixing mask all-zero profile
    divans_ir_optimizer: int = 0
    block_split: bool = False             # literal block-type segmentation
                                          # (ir/blocks.py; the reference gets
                                          # splits from brotli's splitter).
                                          # nb<=4 split streams run the
                                          # native fast path both directions
                                          # (split profile, flag 3); see the
                                          # decode-path matrix in DESIGN.md
    cmap_clustering: int = 0              # 0 = identity literal context map;
                                          # else cluster the 64 utf8 contexts
                                          # to <= N shared priors per
                                          # metablock (ir/cmaps.py — the
                                          # generation side of the reference's
                                          # brotli-computed maps,
                                          # brotli_ir_gen.rs:133-167).
                                          # MEASURED ratio-neutral (+-0.1%)
                                          # on this engine's always-adaptive
                                          # CDFs (research/probe_cmap_cluster:
                                          # adaptive models self-cluster);
                                          # shipped opt-in for map-coding
                                          # parity + heterogeneous corpora.
                                          # Golden-engine encode path.
    external_probs: Optional[bytes] = None  # per-bit literal probabilities
                                          # (8 bytes per raw byte, reference
                                          # feature external-literal-probability;
                                          # decoder must supply the same bytes)
    streaming_chunk_bytes: int = 0        # 0 = frame-granular container;
                                          # else emit STREAMED frames with a
                                          # sub-frame chunk table so a reader
                                          # produces output after ~this many
                                          # input bytes regardless of
                                          # metablock size (reference
                                          # mux.rs:23,445-478 bounded-latency
                                          # interleave).  Golden per-nibble
                                          # encode path; any engine decodes
    # --- TPU-native knobs ---
    metablock_size: int = 1 << 18         # bytes per independent model domain
    num_streams: int = 2                  # cmd + literal ANS streams per metablock
    chunk_nibbles: int = 0                # 0 = per-nibble adaptation; else a
                                          # power of two in [16, 1024]: the
                                          # deferred-adaptation chunk size
                                          # (codec/deferred.py; ~+0.8% ratio
                                          # at 256, unlocks device-speed paths)

    def __post_init__(self):
        assert 10 <= self.window_size <= 24
        assert 0 <= self.dynamic_context_mixing <= 14
        assert 1 <= self.quality <= 11
        if self.prior_depth:
            raise ValueError(
                "prior_depth is formally dropped: the literal model is "
                "depth-free in every engine (golden/native/device), so a "
                "nonzero depth would code a no-op header nibble and "
                "silently change nothing — see options.py field comment "
                "and DESIGN.md")
        if self.lgblock is not None:
            assert 12 <= self.lgblock <= 24, self.lgblock
            object.__setattr__(self, "metablock_size", 1 << self.lgblock)
        assert 4096 <= self.metablock_size <= (1 << 24)
        c = self.chunk_nibbles
        assert c == 0 or (c & (c - 1) == 0 and 16 <= c <= 1024), c

    @property
    def mb_log2(self) -> int:
        n = self.metablock_size
        assert n & (n - 1) == 0, "metablock_size must be a power of two"
        return n.bit_length() - 1
