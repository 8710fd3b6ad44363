"""One-shot API of the port: compress() and decompress().

Both run on a device: "cuda" unless the caller passes device="cpu",
where every kernel runs its plain PyTorch version; with neither and no
CUDA they raise.  compress is byte-identical to
divans_tpu.native.compress on the options native.supports or
native.supports_cmds take (native.compress is the host-only path):
  * the adaptive profile (chunk_nibbles=0, the default) is
    codec/adaptive.compress_frames: host traces, the per-nibble model
    pass and the rANS encode on the card;
  * the deferred profile (chunk_nibbles > 0) is
    codec/encode.compress_frames: up to quality 10 the hybrid path (host
    C++ for the trace and the cmd stream, the card for the literals), at
    quality 11 the uniform device lanes (the card codes both streams).
decompress takes the profile from the container's flags: adaptive
containers decode through codec/adaptive.decompress_frames (the scan on
the card, flagged frames on the host), deferred ones through
codec/decode.decompress_frames.
"""
from __future__ import annotations

import torch

from . import native
from .codec import adaptive, decode, encode
from .codec.deferred import chunk_to_flags, flags_to_chunk
from .codec.layout import (FLAG_PROFILES, PROFILE_FLAGS, ModelLayout,
                           PROFILES, profile_for_options)
from .container import format as fmt
from .options import DivansOptions


def _device(device, entry: str) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"divans_tpu_torch.{entry} runs on CUDA by "
                               "default and no CUDA device is available; "
                               "pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def compress(data: bytes, options: DivansOptions | None = None,
             device=None) -> bytes:
    options = options or DivansOptions()
    if not (native.supports(options) or native.supports_cmds(options)):
        raise NotImplementedError(
            "port compress covers the mechanical trace (quality <= 10) and "
            "quality 11 with the context map; detection, block split, "
            "context-map clustering, streaming and the IR optimizer are "
            "not ported")
    chunk = options.chunk_nibbles
    dev = _device(device, "compress")
    profile = profile_for_options(options)
    flags = PROFILE_FLAGS[profile] | chunk_to_flags(chunk)
    frames = []
    if data:
        layout = ModelLayout(PROFILES[profile], lo_bucketed=chunk > 0)
        mb = options.metablock_size
        blocks = [data[off:off + mb] for off in range(0, len(data), mb)]
        if chunk:
            frames = encode.compress_frames(blocks, options, layout, chunk,
                                            dev)
        else:
            frames = adaptive.compress_frames(blocks, options, layout, dev)
    return fmt.serialize(frames, options.window_size, options.mb_log2,
                         native.crc32c(data), flags=flags)


def decompress(blob: bytes, device=None) -> bytes:
    dev = _device(device, "decompress")
    _w, _mb, frames, stored_crc, flags = fmt.deserialize(blob)
    if not frames:
        fmt.check_crc(b"", stored_crc)
        return b""
    chunk = flags_to_chunk(flags)
    if chunk:
        layout = ModelLayout(PROFILES[FLAG_PROFILES[flags & 0b11]],
                             lo_bucketed=True)
        raw = decode.decompress_frames(frames, chunk, layout, dev)
    else:
        profile = FLAG_PROFILES.get(flags)
        if profile is None:
            raise NotImplementedError(
                f"container flags {flags:#x} name no adaptive profile: the "
                "reference decodes them on its golden engine, which is not "
                "ported")
        raw = adaptive.decompress_frames(frames, profile, dev)
    fmt.check_crc(raw, stored_crc)
    return raw
