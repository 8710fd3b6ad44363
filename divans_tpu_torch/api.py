"""One-shot API of the port: compress() and decompress().

compress runs on the host (native C++, byte-identical to
divans_tpu.native.compress on the options it covers).  decompress
decodes deferred containers (chunk_nibbles > 0) through
codec/decode.decompress_frames on a device: "cuda" unless the caller
passes device="cpu", where every kernel runs its plain PyTorch version.
"""
from __future__ import annotations

import torch

from . import native
from .codec import decode
from .codec.deferred import flags_to_chunk
from .codec.layout import FLAG_PROFILES, ModelLayout, PROFILES
from .container import format as fmt
from .options import DivansOptions


def compress(data: bytes, options: DivansOptions | None = None) -> bytes:
    return native.compress(data, options)


def _device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("divans_tpu_torch.decompress runs on CUDA by "
                               "default and no CUDA device is available; "
                               "pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)


def decompress(blob: bytes, device=None) -> bytes:
    dev = _device(device)
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
