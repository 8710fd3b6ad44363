"""The control and the faults that `correct` has to catch, planted in
the timed path for control.py and the tests; the benchmark's own runs
plant none.

  control  reads: the reference (the stored bytes) in the program's
           place with one guarantee broken: one byte of each read
           altered.  Writes: the program at quality 9, the cheaper
           greedy parse, in place of the configuration's quality 10.
  stale    each call returns the previous call's answer (a step that
           leaves its state unchanged).
  half     half of the batch left out: the second half of each read's
           bytes zeroed; the second half of each container's frames
           dropped where the encode produces them.
  altered  an answer altered where it is produced: one byte of each
           decode flipped as the entry point returns it; one byte of
           every frame's literal stream flipped as the encode assembles
           it.
"""
from __future__ import annotations

import contextlib
import dataclasses

KINDS = ("control", "stale", "half", "altered")


def _flip(b: bytes, i: int) -> bytes:
    if not b:
        return b"\x01"
    i %= len(b)
    return b[:i] + bytes([b[i] ^ 0x01]) + b[i + 1:]


@contextlib.contextmanager
def _patched(obj, name, make):
    orig = getattr(obj, name)
    setattr(obj, name, make(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def plant(kind: str, op: str, blocks: list, containers: list = ()):
    """A context in which the port's entry point for `op` ("read" or
    "write") carries the fault `kind`.  blocks: the seed's inputs;
    containers: their containers (the read control answers a container
    with its block)."""
    from divans_tpu_torch import api
    from divans_tpu_torch.codec import adaptive
    last = {}
    by_blob = {blob: i for i, blob in enumerate(containers)}

    if op == "read":
        if kind == "control":
            def make(orig):
                def control(blob, *a, **kw):
                    return _flip(blocks[by_blob[blob]], 0)
                return control
        elif kind == "stale":
            def make(orig):
                def stale(blob, *a, **kw):
                    out = orig(blob, *a, **kw)
                    prev, last["out"] = last.get("out", out), out
                    return prev
                return stale
        elif kind == "half":
            def make(orig):
                def half(blob, *a, **kw):
                    out = orig(blob, *a, **kw)
                    h = len(out) // 2
                    return out[:h] + bytes(len(out) - h)
                return half
        elif kind == "altered":
            def make(orig):
                def altered(blob, *a, **kw):
                    out = orig(blob, *a, **kw)
                    return _flip(out, len(out) // 3)
                return altered
        else:
            raise ValueError(kind)
        return _patched(api, "decompress", make)

    if kind == "control":
        def make(orig):
            def control(data, options=None, *a, **kw):
                return orig(data, dataclasses.replace(options, quality=9),
                            *a, **kw)
            return control
        return _patched(api, "compress", make)
    if kind == "stale":
        def make(orig):
            def stale(data, *a, **kw):
                out = orig(data, *a, **kw)
                prev, last["out"] = last.get("out", out), out
                return prev
            return stale
        return _patched(api, "compress", make)
    if kind == "half":
        def make(orig):
            def half(*a, **kw):
                frames = orig(*a, **kw)
                return frames[:max(1, len(frames) // 2)] \
                    if len(frames) > 1 else []
            return half
        return _patched(adaptive, "compress_frames", make)
    if kind == "altered":
        def make(orig):
            def altered(*a, **kw):
                return [dataclasses.replace(f, lit=_flip(f.lit, 7))
                        for f in orig(*a, **kw)]
            return altered
        return _patched(adaptive, "compress_frames", make)
    raise ValueError(kind)

