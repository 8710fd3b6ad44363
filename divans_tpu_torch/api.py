"""One-shot API of the port: compress() and decompress().

Both run on a device: "cuda" unless the caller passes another
("cuda:N", which the pipelines make the current device while they
launch and record, and which raises if it is not there) or "cpu",
where every kernel runs its plain PyTorch version; with neither and no
CUDA they raise.  compress is byte-identical to divans_tpu.api.compress
under every option, and routes each option as the reference does:
  * to the card (as divans_tpu/codec/jax_engine.compress runs them):
    the default options, stride and speed detection, the IR optimizer
    and quality 11, with or without the context map.  Detection is
    resolved first (ir/detect.apply_detection) into a stride and
    speeds, which the mechanical trace takes.  The adaptive profile
    (chunk_nibbles=0) is codec/adaptive.compress_frames: host traces,
    the per-nibble model pass and the rANS encode on the card.  The
    deferred profile (chunk_nibbles > 0) is codec/encode.compress_frames:
    the hybrid path for the mechanical trace's options, detected ones
    included (host C++ for the trace and the cmd stream, the card for
    the literals), else the uniform device lanes (host command lists
    and traces, the card codes both streams);
  * to the host (as jax_engine.compress sends them to its golden engine):
    block split, prior-bitmask masks, context-map clustering, external
    probabilities (ECDF) and streamed frames.  native.compress codes
    what its FSM covers, codec/engine_np.compress (the golden engine)
    the rest.
compress(billing_out=) bills the bits of each substate as
jax_engine.compress does: no hybrid (every deferred frame takes the
uniform lanes), each frame's freqs copied back from the card's model
passes in trace order, then codec/billing; host options bill nothing.
decompress takes the profile from the container's flags: adaptive
containers decode through codec/adaptive.decompress_frames (the scan on
the card, flagged frames on the host), deferred ones through
codec/decode.decompress_frames (the literal kernel, frames outside it on
the host); a frame that native code refuses decodes on the golden
engine.  A container whose flags name no adaptive profile, and an ECDF
container (options= with external_probs, which the decoder must be
given), decode on the golden engine whole, as in the reference.

Without the native library (native.load() is None) every entry point
still runs, as the reference's does: the host stages take its Python
routes (the greedy parse, the Python trace FSM and dictionary scan, the
golden structure pass and script executor, the golden engine for the
host options and for frames outside the kernels, the CRC in Python)
and the device stages stay on the card's kernels, so the containers are
the reference's lib-less ones (its golden engine's bytes).
"""
from __future__ import annotations

import numpy as np
import torch

from . import native, tracelog
from .codec import adaptive, billing, decode, encode, engine_np
from .codec.deferred import chunk_to_flags, flags_to_chunk
from .codec.layout import (FLAG_PROFILES, PROFILE_FLAGS, ModelLayout,
                           PROFILES, profile_for_options)
from .container import format as fmt
from .ir.detect import apply_detection
from .options import DivansOptions


def _device(device, entry: str) -> torch.device:
    """The device a call runs on: CUDA by default, or as given; a CUDA
    device that is not there raises (the pipelines make it current)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"divans_tpu_torch.{entry} runs on CUDA by "
                           "default and no CUDA device is available; "
                           "pass device='cpu' to run the plain versions")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise ValueError(f"divans_tpu_torch.{entry}: no device {dev}, "
                         f"{torch.cuda.device_count()} visible")
    return dev


def host_only(options: DivansOptions) -> bool:
    """Options whose encode the reference keeps on the host (its device
    engine sends them to the golden engine): block split, masks,
    clustering, ECDF, streaming."""
    return bool(options.external_probs is not None or options.block_split
                or options.prior_bitmask_detection or options.cmap_clustering
                or options.streaming_chunk_bytes)


def host_compress(data: bytes, options: DivansOptions) -> bytes:
    """The host-only encode: native.compress where its FSM covers the
    options, else (or without the library) the golden engine."""
    out = native.compress(data, options)
    return out if out is not None else engine_np.compress(data, options)


def compress(data: bytes, options: DivansOptions | None = None,
             device=None, billing_out: dict | None = None) -> bytes:
    """The container of `data` under `options`.  With `billing_out` (a
    dict) it also gets the bits each substate coded (codec/billing.bill)
    and, under "__detail__", the per-CDF report (entropy_report); the
    container is the same.  The call is one tracelog request, its root
    span api/compress."""
    with tracelog.span("api/compress", bytes=len(data)):
        options = options or DivansOptions()
        dev = _device(device, "compress")
        if host_only(options):
            return host_compress(data, options)
        if (options.stride_detection_quality
                or options.speed_detection_quality
                or options.force_stride_value):
            options = apply_detection(data, options)
        chunk = options.chunk_nibbles
        profile = profile_for_options(options)
        flags = PROFILE_FLAGS[profile] | chunk_to_flags(chunk)
        frames = []
        bills = None if billing_out is None else []
        if data:
            layout = ModelLayout(PROFILES[profile], lo_bucketed=chunk > 0)
            mb = options.metablock_size
            blocks = [data[off:off + mb] for off in range(0, len(data), mb)]
            if chunk:
                frames = encode.compress_frames(blocks, options, layout,
                                                chunk, dev, billing=bills)
            else:
                frames = adaptive.compress_frames(blocks, options, layout,
                                                  dev, billing=bills)
        if bills:
            traces = [t for t, _f in bills]
            fpad = np.ones((len(bills), max(t.shape[0] for t in traces)),
                           np.int32)
            for i, (_t, f) in enumerate(bills):
                fpad[i, :f.shape[0]] = f
            billing_out.update(billing.bill(traces, fpad, layout))
            billing_out["__detail__"] = billing.entropy_report(traces, fpad,
                                                               layout)
        with tracelog.span("encode/assemble", frames=len(frames)):
            return fmt.serialize(frames, options.window_size,
                                 options.mb_log2, native.crc32c(data),
                                 flags=flags)


def decompress(blob: bytes, device=None,
               options: DivansOptions | None = None) -> bytes:
    """The bytes of a container; one tracelog request, its root span
    api/decompress."""
    with tracelog.span("api/decompress", bytes=len(blob)):
        dev = _device(device, "decompress")
        with tracelog.span("decode/parse"):
            _w, _mb, frames, stored_crc, flags = fmt.deserialize(blob)
        chunk = flags_to_chunk(flags)
        stats = decode.STATS if chunk else adaptive.STATS
        if options is not None and options.external_probs is not None:
            # ECDF streams need the caller's probabilities: the golden
            # engine
            raw = engine_np.decompress(blob, options)
            stats["golden_frames"] += len(frames)
            return raw
        if not frames:
            fmt.check_crc(b"", stored_crc)
            return b""
        if chunk:
            layout = ModelLayout(PROFILES[FLAG_PROFILES[flags & 0b11]],
                                 lo_bucketed=True)
            raw = decode.decompress_frames(frames, chunk, layout, dev)
        else:
            profile = FLAG_PROFILES.get(flags)
            if profile is None:
                # flags the scan has no profile for: the golden engine
                raw = engine_np.decompress(blob)
                stats["golden_frames"] += len(frames)
                return raw
            raw = adaptive.decompress_frames(frames, profile, dev)
        with tracelog.span("decode/crc", bytes=len(raw)):
            fmt.check_crc(raw, stored_crc)
        return raw
