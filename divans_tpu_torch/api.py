"""One-shot API of the port: compress() and decompress().

Both run the deferred profile (chunk_nibbles > 0) on a device: "cuda"
unless the caller passes device="cpu", where every kernel runs its
plain PyTorch version; with neither and no CUDA they raise.  compress
is codec/encode.compress_frames, byte-identical to
divans_tpu.native.compress: up to quality 10 the hybrid path (host C++
for the trace and the cmd stream, the card for the literals), at
quality 11 the uniform device lanes (the card codes both streams);
native.compress is the host-only path.  decompress is
codec/decode.decompress_frames.
"""
from __future__ import annotations

import torch

from . import native
from .codec import decode, encode
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
    if not chunk:
        raise NotImplementedError(
            "the adaptive profile (chunk_nibbles=0) encodes through the "
            "scan model pass, which is not ported yet (ROADMAP.md, "
            "adaptive profile on device); native.compress covers it on "
            "the host")
    dev = _device(device, "compress")
    profile = profile_for_options(options)
    flags = PROFILE_FLAGS[profile] | chunk_to_flags(chunk)
    frames = []
    if data:
        layout = ModelLayout(PROFILES[profile], lo_bucketed=True)
        mb = options.metablock_size
        blocks = [data[off:off + mb] for off in range(0, len(data), mb)]
        frames = encode.compress_frames(blocks, options, layout, chunk, dev)
    return fmt.serialize(frames, options.window_size, options.mb_log2,
                         native.crc32c(data), flags=flags)


def decompress(blob: bytes, device=None) -> bytes:
    dev = _device(device, "decompress")
    _w, _mb, frames, stored_crc, flags = fmt.deserialize(blob)
    if not frames:
        fmt.check_crc(b"", stored_crc)
        return b""
    chunk = flags_to_chunk(flags)
    if not chunk:
        raise NotImplementedError(
            "adaptive-profile containers (chunk_nibbles=0) decode through "
            "the scan decoder, which is not ported yet (ROADMAP.md, "
            "adaptive profile on device)")
    layout = ModelLayout(PROFILES[FLAG_PROFILES[flags & 0b11]],
                         lo_bucketed=True)
    raw = decode.decompress_frames(frames, chunk, layout, dev)
    fmt.check_crc(raw, stored_crc)
    return raw
