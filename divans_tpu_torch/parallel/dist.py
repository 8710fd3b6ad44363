"""Metablock data parallelism over a list of devices, in one process: the
port of divans_tpu/parallel/dist.py.

Each metablock is an independent model domain (and so is each of its
literal sub-streams), so the batch axis of every step below splits
cleanly over a 1-D mesh of devices.  As in the reference, one controller
drives every device: each shard takes the contiguous block of the batch
that NamedSharding(mesh, P("data")) gives it, runs its kernels on its
own device with no collective, and the host gathers the shards' ragged
outputs in batch order (file order), the analog of the reference's
mux interleave with frame order carrying the ordering.  There is no
process group: the reference names multi-process JAX in its docstring,
and no code of it runs that way.

A mesh may name a device more than once (make_mesh(["cuda:0"] * 4)):
its shards then run on CUDA streams of their own, as the reference's
tests run on virtual CPU devices.  make_mesh(["cpu"] * 8) runs every
shard's plain versions on the host.

One thread issues every shard's work, shard after shard (the uploads
through pinned memory, the launches, the copies back into pinned memory
and an event), then waits on each shard's event in batch order; no
other thread touches the kernels' LAUNCHES counters.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import cuda_build, tracelog
from ..ans import rans_encode
from ..codec import decode, deferred_pass, encode, lit_decode, model_pass
from ..codec.deferred import cmd_chunk
from ..codec.deferred_pass import NCOLS   # column 2 is the stream id


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: its devices in shard order (repeats allowed) and the
    name of the axis the batch splits along."""
    devices: tuple[torch.device, ...]
    axis: str = "data"

    def __len__(self) -> int:
        return len(self.devices)


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"a mesh takes cuda and cpu devices, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{dev}: no CUDA device is available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"no device {dev}: "
                         f"{torch.cuda.device_count()} visible")
    return torch.device("cuda", index)


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    """A mesh over `devices` (torch.device or its name, in order), by
    default every visible CUDA device; with none visible it raises
    (there is no CPU fallback: name the CPU, make_mesh(["cpu"] * 8))."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if not n:
            raise RuntimeError("make_mesh: no CUDA device is visible; name "
                               "the devices, e.g. make_mesh(['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devs = tuple(_mesh_device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(devs, axis)


def _blocks(mesh: Mesh, b: int):
    """(device, lo, hi) of each shard: contiguous blocks of the batch axis
    as NamedSharding(mesh, P("data")) cuts it.  A batch the mesh size
    does not divide raises, as jax.jit raises for it."""
    n = len(mesh)
    if b % n:
        raise ValueError(f"a batch of {b} rows does not divide over the "
                         f"{n} devices of the mesh's {mesh.axis!r} axis")
    per = b // n
    return [(dev, k * per, (k + 1) * per)
            for k, dev in enumerate(mesh.devices)]


@contextlib.contextmanager
def _shard_context(dev: torch.device):
    """A shard's device made current and, on the card, a stream of the
    shard's own made current on it (yielded; None on the CPU)."""
    if dev.type != "cuda":
        yield None
        return
    with cuda_build.on_device(dev):
        stream = torch.cuda.Stream(dev)
        with torch.cuda.stream(stream):
            yield stream


def _issue(mesh: Mesh, b: int, work, timing: list | None) -> list:
    """Issue work(device, lo, hi) -> tuple of tensors for every shard,
    from this thread, each in its _shard_context; on the card each output
    starts its copy into pinned host memory, and an event marks the
    shard's end.  `timing` (a list) gets each card shard's (device, CUDA
    event at its start, at its end).  Returns [(outputs, event or None)]
    in batch order."""
    pending = []
    for dev, lo, hi in _blocks(mesh, b):
        with tracelog.span("dist/issue", device=str(dev), rows=hi - lo), \
                _shard_context(dev) as stream:
            if stream is not None and timing is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            outs = work(dev, lo, hi)
            if stream is None:
                pending.append((outs, None))
                continue
            host = []
            for t in outs:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            event = torch.cuda.Event(enable_timing=timing is not None)
            event.record(stream)
            if timing is not None:
                timing.append((dev, start, event))
            pending.append((tuple(host), event))
    return pending


def _gather(pending: list) -> tuple:
    """The shards' outputs of _issue, each waited for in batch order and
    joined along the batch axis, on the host."""
    with tracelog.span("dist/gather", shards=len(pending)):
        for _outs, event in pending:
            if event is not None:
                event.synchronize()
        return tuple(torch.cat(parts)
                     for parts in zip(*(o for o, _e in pending)))


def pad_batch(traces: np.ndarray, multiple: int) -> np.ndarray:
    """A padded sub-trace batch int32 [B, N, 10] grown to a multiple of
    `multiple` lanes (a mesh's size) with empty lanes: every row padding
    (stream -1, lims deferred_pass.NOOP_LIM), so each codes nothing."""
    empty = np.zeros((-traces.shape[0] % multiple,) + traces.shape[1:],
                     np.int32)
    empty[:, :, 2] = -1
    empty[:, :, 4] = empty[:, :, 9] = deferred_pass.NOOP_LIM
    return np.concatenate([traces, empty])


def split_lanes(trace, starts, freqs):
    """Compact each metablock's (start, freq) rows by stream id into dense
    rANS lanes, on the tensors' device (cumsum + scatter; stream -1 is
    padding, and a dropped slot holds start 0 and freq 1).  trace int32
    [B, N, 10], starts and freqs int32 [B, N] -> [(starts, freqs,
    counts)] for stream 0, then stream 1."""
    b, n = starts.shape
    stream = trace[:, :, 2]
    lanes = []
    for sid in (0, 1):
        m = stream == sid
        m32 = m.to(torch.int32)
        pos = torch.cumsum(m32, dim=1, dtype=torch.int32) - 1
        tgt = torch.where(m, pos, n).long()              # n: dropped
        ls = torch.zeros((b, n + 1), dtype=starts.dtype, device=starts.device)
        lf = torch.ones((b, n + 1), dtype=freqs.dtype, device=freqs.device)
        ls.scatter_(1, tgt, starts)
        lf.scatter_(1, tgt, freqs)
        lanes.append((ls[:, :n], lf[:, :n],
                      torch.sum(m32, dim=1, dtype=torch.int32)))
    return lanes


def _lane_counts(x: torch.Tensor, num_rows: int, sid: int) -> torch.Tensor:
    """Each lane's count (its rows of stream >= 0) of one stream's padded
    sub-traces int32 [B, N, 10] on the host, after checking that they
    are in the kernels' contract: a lane's rows of stream `sid`, then its
    padding (stream -1); every row's flat and cm_idx in [0, num_rows),
    value in [0, 16) and which in {0, 1} (a padding row has zeros
    there).  Vector passes over the batch (torch's threads), no copy."""
    stream = x[:, :, 2]
    counts = torch.sum(stream >= 0, dim=1, dtype=torch.int32)
    live = torch.arange(x.shape[1])[None, :] < counts[:, None]
    if not torch.equal(stream, live.to(torch.int32) * (sid + 1) - 1):
        raise ValueError(f"a lane of stream {sid}'s sub-traces is not its "
                         "rows of that stream, then padding (stream -1)")
    if x.numel():
        lo, hi = torch.aminmax(x.view(-1, NCOLS), dim=0)
        for col, top in ((0, num_rows), (7, num_rows), (1, 16), (6, 2)):
            if lo[col] < 0 or hi[col] >= top:
                raise ValueError(f"trace column {col} outside [0, {top})")
    return counts


def _live_index(counts: torch.Tensor, n: int, total: int) -> torch.Tensor:
    """The rows of a padded [B, N] batch that lanes of these counts code,
    as indices into its flat [B * N] rows, in lane order, on the counts'
    device (`total` their sum: no wait for the device)."""
    dev = counts.device
    c = counts.long()
    lane = torch.repeat_interleave(torch.arange(c.shape[0], device=dev), c,
                                   output_size=total)
    first = torch.cumsum(c, 0) - c
    return lane * n + torch.arange(total, device=dev) - first[lane]


def _staged(mesh: Mesh, trace, num_rows: int, sid: int):
    """One stream's sub-traces as an int32 [B, N, 10] host tensor and its
    lanes' counts, checked (_lane_counts) before any shard is issued."""
    x = torch.as_tensor(np.ascontiguousarray(np.asarray(trace,
                                                        dtype=np.int32)))
    if x.ndim != 3 or x.shape[2] != NCOLS:
        raise ValueError(f"trace of shape {tuple(x.shape)}, expected "
                         f"[B, N, {NCOLS}]")
    _blocks(mesh, x.shape[0])              # a batch that does not divide
    with tracelog.span("dist/check", stream=sid, lanes=x.shape[0]):
        return x, _lane_counts(x, num_rows, sid)


def _encode_work(x, counts, num_rows: int, chunk: int, sid: int):
    """A shard's encode of one stream's lanes [lo, hi) (for _issue): the
    model pass (kernel 5 at chunk > 0, else A1), the rANS encode (kernel
    2) and the per-lane compaction, giving (words, nwords, state)."""
    n = x.shape[1]

    def work(dev, lo, hi):
        cnt = encode.upload(counts[lo:hi].numpy(), dev)
        t = encode.upload(x[lo:hi].numpy(), dev)
        if chunk:
            starts, freqs = deferred_pass.deferred_pass(t, cnt, num_rows,
                                                        chunk, checked=True)
        else:
            # each lane's sub-trace as one frame of A1 (its live rows back
            # to back), whose lane 2i + sid holds its (start, freq) steps
            rows = t.view(-1, NCOLS)[_live_index(
                cnt, n, int(counts[lo:hi].sum()))]
            starts, freqs, _n = model_pass.model_pass(rows, cnt, num_rows,
                                                      max(n, 1))
            starts = starts[sid::2, :n].contiguous()
            freqs = freqs[sid::2, :n].contiguous()
        words, flags, states = rans_encode.encode_lanes(starts, freqs, cnt)
        return (*rans_encode.compact_lanes(words, flags, cnt), states)

    return work


def sharded_encode_step(mesh: Mesh, r_cmd: int, r_lit: int, chunk: int = 0):
    """The multi-device encode step: per-stream trace batches -> lane
    words.

    Takes the cmd and lit sub-traces (encode.split_stream_traces; at
    chunk > 0 the lit ones cut into sub-streams by
    encode.split_lit_sub_traces, a row each), int32 [B, N, 10] padded
    as deferred_pass.pad_traces pads (stream -1; N a multiple of the
    stream's chunk): the model row sets are stream-disjoint, so each
    stream's model pass runs on its own.  Both batches split along the
    mesh; chunk > 0 takes the generic deferred pass (kernel 5: cmd at
    cmd_chunk(chunk), lit at chunk), chunk 0 the per-nibble adaptive
    pass (A1).  step(cmd_trace, lit_trace, timing=None) returns
    ((words, nwords, state) of the cmd lanes, the same of the lit lanes),
    host tensors in batch order: words int32 [B, N] in wire order at the
    front of each row (ans/kernels.py `_encode_lane`'s form;
    rans_encode.lanes_to_bytes gives the wire bytes), nwords and state
    int32 [B].  Both batches are checked on the host before any shard is
    issued.  `timing` (a list) gets each card shard's (device, start
    event, end event), the cmd stream's shards first."""

    def step(cmd_trace, lit_trace, timing: list | None = None):
        streams = ((cmd_trace, r_cmd, cmd_chunk(chunk) if chunk else 0),
                   (lit_trace, r_lit, chunk))
        staged = [_staged(mesh, t, r, sid)
                  for sid, (t, r, _s) in enumerate(streams)]
        pending = [_issue(mesh, x.shape[0],
                          _encode_work(x, counts, r, s, sid), timing)
                   for sid, ((x, counts), (_t, r, s)) in enumerate(
                       zip(staged, streams))]
        return _gather(pending[0]), _gather(pending[1])

    return step


def sharded_decode_step(mesh: Mesh, layout, chunk: int, n_chunks: int):
    """The multi-device decode stage 2: each shard runs its own 128-lane
    tile of the literal decode (kernel 1, lit_decode.decode_group: one
    launch a shard on the card, the plain chunk loop on the CPU), with
    no collective.

    step(queues, timing=None) takes a decode.LaneQueues of len(mesh) *
    128 lanes (the reference's pack_lit_lanes arrays, one stream a lane,
    through decode.from_tpu_lit_lanes; or decode.pack_lane_queues at
    that width) and returns (the decoded bytes uint8 [lanes, n_chunks *
    chunk // 2], each lane's final halfword cursor int32 [lanes]: its
    first stream's word offset times 2 plus the words its decode
    pulled), host tensors; `timing` as in sharded_encode_step."""
    s = chunk // 2

    def step(queues: decode.LaneQueues, timing: list | None = None):
        lanes = queues.words.shape[0]
        if lanes != len(mesh) * decode.LANES:
            raise ValueError(f"{lanes} lanes: the step takes "
                             f"{decode.LANES} a device of the mesh")

        def work(dev, lo, hi):
            q, perm, n_pass = decode.group_inputs(
                decode.lane_slice(queues, lo, hi), chunk, layout, dev)
            out, carry = lit_decode.decode_group(q, perm, n_pass, n_chunks,
                                                 s)
            return out, carry["cursor"]

        return _gather(_issue(mesh, lanes, work, timing))

    return step
