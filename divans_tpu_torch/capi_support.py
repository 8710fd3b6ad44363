"""Helpers for a C API shim that drives the codec through an embedded
interpreter: the port of divans_tpu/capi_support.py over the port's
streaming adapters and options.  The C side only builds dicts and bytes
and calls these two constructors.

The repository's C shim (c/divans_capi.c) calls the reference's module,
divans_tpu.capi_support, and stays so; a shim built against the port
calls these the same way.  Both run on the host, as the adapters do."""
from __future__ import annotations

import io

from .io_adapters import CompressorWriter, DecompressorReader
from .options import DivansOptions

# C option values arrive as plain ints; coerce fields with other types.
_BOOL_FIELDS = {"use_context_map"}


def new_writer(opt_dict):
    """(CompressorWriter over a BytesIO sink, the sink) for an option
    dict of DivansOptions field names."""
    kwargs = {k: bool(v) if k in _BOOL_FIELDS else v
              for k, v in dict(opt_dict).items()}
    sink = io.BytesIO()
    return CompressorWriter(sink, DivansOptions(**kwargs)), sink


class _PushSource:
    """read()-able over a C-fed bytearray (push-style streaming)."""

    def __init__(self):
        self.buf = bytearray()

    def read(self, n: int) -> bytes:
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


def new_reader():
    """(the push source, a partial DecompressorReader over it): the caller
    appends container bytes to source.buf as they arrive and reads what
    the frames completed so far decode to."""
    src = _PushSource()
    return src, DecompressorReader(src, partial=True)
