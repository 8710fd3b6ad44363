"""The port's metablock data parallelism (divans_tpu_torch.parallel.dist)
on the CPU, against the JAX package's parallel/dist.py on the conftest's
8-device CPU mesh and against its unsharded functions: the same seeded
inputs (numpy) go to both, and every output must be equal.  A CPU mesh
(make_mesh(["cpu"] * n)) runs each shard's plain versions; the kernels'
device guard is a no-op for a CPU tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divans_tpu.ans import kernels as jkernels
from divans_tpu.codec import deferred as jdeferred
from divans_tpu.codec import engine_np as jengine_np
from divans_tpu.codec import jax_engine, pallas_decode
from divans_tpu.codec import trace as jtrace
from divans_tpu.codec.layout import ModelLayout as JLayout
from divans_tpu.codec.layout import PROFILES as JPROFILES
from divans_tpu.ir.matcher import build_commands as jbuild_commands
from divans_tpu.options import DivansOptions as JOptions
from divans_tpu.parallel import dist as jdist

import divans_tpu_torch as port
from divans_tpu_torch import cuda_build, native
from divans_tpu_torch.ans import rans_encode
from divans_tpu_torch.ans.coder_np import ENC_START_STATE
from divans_tpu_torch.codec import (decode, deferred_pass, encode,
                                    lit_decode)
from divans_tpu_torch.codec.deferred import (chunk_to_flags, cmd_chunk,
                                             lit_subs_join)
from divans_tpu_torch.codec.layout import PROFILE_FLAGS, PROFILES, ModelLayout
from divans_tpu_torch.container import format as fmt
from divans_tpu_torch.parallel import dist

WORDS = [b"the", b"of", b"and", b"data", b"model", b"stream", b"lane",
         b"device", b"shard", b"frame", b"literal", b"copy", b"mesh",
         b"compress", b"a", b"in", b"to", b"rANS", b"chunk", b"batch"]


def _text(n: int, seed: int) -> bytes:
    """Seeded text-like bytes: words of a small vocabulary, spaces,
    punctuation, newlines and a few digits."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    while len(out) < n:
        out += WORDS[int(rng.integers(len(WORDS)))]
        r = int(rng.integers(20))
        out += b".\n" if r == 0 else b", " if r == 1 else \
            str(int(rng.integers(1000))).encode() + b" " if r == 2 else b" "
    return bytes(out[:n])


def _blocks(data: bytes, mb: int) -> list[bytes]:
    return [data[o:o + mb] for o in range(0, len(data), mb)]


def _jax_sub_traces(chunk: int, n_blocks: int = 8, size: int = 100,
                    seed: int = 0):
    """Padded per-stream sub-traces of seeded blocks, built and padded by
    the JAX package (as its test_dist.py builds them): (cmd, lit, r_cmd,
    r_lit)."""
    layout = JLayout(JPROFILES["cm"], lo_bucketed=chunk > 0)
    opts = JOptions(metablock_size=4096, chunk_nibbles=chunk)
    rng = np.random.RandomState(seed)
    blocks = [bytes(rng.randint(97, 105, size=size).astype(np.uint8))
              for _ in range(n_blocks)]
    traces = [jtrace.build_trace(b, jbuild_commands(b, opts), opts, layout)
              for b in blocks]
    cmd_ts, lit_ts, _m, r_cmd, r_lit = jax_engine.split_stream_traces(
        traces, layout)
    ct = jax_engine._pad_traces(
        cmd_ts, multiple=max(jdeferred.cmd_chunk(chunk), 1) if chunk else 1)
    lt = jax_engine._pad_traces(lit_ts, multiple=max(chunk, 1))
    return ct, lt, r_cmd, r_lit


def _jax_unsharded(trace, r: int, chunk: int):
    """The reference's unsharded lanes of one stream's padded sub-traces:
    its model pass, then jax.vmap(_encode_lane)."""
    t = jnp.asarray(trace)
    if chunk:
        starts, freqs = jax_engine.model_pass_deferred(t, r, chunk)
    else:
        starts, freqs = jax_engine.model_pass(t, r)
    cnt = jnp.sum((t[:, :, 2] >= 0).astype(jnp.int32), axis=1)
    return [np.asarray(a) for a in
            jax.vmap(jkernels._encode_lane)(starts, freqs, cnt)]


@pytest.fixture(scope="module")
def unsharded():
    """Per chunk setting: the JAX sub-traces and the reference's
    unsharded ((words, nwords, state) of the cmd lanes, of the lit
    lanes)."""
    out = {}
    for chunk in (0, 64):
        ct, lt, r_cmd, r_lit = _jax_sub_traces(chunk)
        out[chunk] = ((ct, lt, r_cmd, r_lit),
                      (_jax_unsharded(ct, r_cmd, cmd_chunk(chunk)
                                      if chunk else 0),
                       _jax_unsharded(lt, r_lit, chunk)))
    return out


def _assert_lanes_equal(got, want):
    for stream, g, w in zip(("cmd", "lit"), got, want):
        for name, a, b in zip(("words", "nwords", "state"), g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"{stream} {name}")


def test_split_lanes_matches_jax():
    rng = np.random.default_rng(1)
    b, n = 6, 96
    trace = np.zeros((b, n, 10), np.int32)
    trace[:, :, 2] = rng.integers(-1, 2, (b, n))
    trace[:, 70:, 2] = -1
    trace[2, :, 2] = -1                       # an all-padding lane
    starts = rng.integers(0, 1 << 15, (b, n)).astype(np.int32)
    freqs = rng.integers(1, 1 << 15, (b, n)).astype(np.int32)
    want = jdist.split_lanes(jnp.asarray(trace), jnp.asarray(starts),
                             jnp.asarray(freqs))
    got = dist.split_lanes(torch.from_numpy(trace), torch.from_numpy(starts),
                           torch.from_numpy(freqs))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, e in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def test_sharded_encode_matches_jax_mesh(unsharded):
    """chunk 64 (the deferred pass) on 8 CPU shards against the JAX step
    on the 8 virtual CPU devices: words, nwords and state of both
    streams equal; and both equal the unsharded reference."""
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    (ct, lt, r_cmd, r_lit), want = unsharded[64]
    jstep = jdist.sharded_encode_step(jdist.make_mesh(devs[:8]), r_cmd,
                                      r_lit, chunk=64)
    jout = jstep(jnp.asarray(ct), jnp.asarray(lt))
    step = dist.sharded_encode_step(dist.make_mesh(["cpu"] * 8), r_cmd,
                                    r_lit, chunk=64)
    got = step(ct, lt)
    _assert_lanes_equal(got, jout)
    _assert_lanes_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("chunk", [0, 64])
def test_sharded_encode_any_mesh_matches_unsharded(unsharded, chunk, n):
    """Meshes of 1, 2, 4 and 8 entries give the unsharded reference's
    lanes (at chunk 0 the per-nibble pass, A1's plain version, on each
    stream's sub-traces; at chunk 64 the deferred pass)."""
    (ct, lt, r_cmd, r_lit), want = unsharded[chunk]
    step = dist.sharded_encode_step(dist.make_mesh(["cpu"] * n), r_cmd,
                                    r_lit, chunk=chunk)
    _assert_lanes_equal(step(ct, lt), want)


@pytest.mark.parametrize("chunk", [0, 64])
def test_empty_lanes_code_nothing(unsharded, chunk):
    """Lanes of padding alone (stream -1), as a caller adds them to fill
    the mesh, give no word and the start state; the others are
    unchanged."""
    (ct, lt, r_cmd, r_lit), want = unsharded[chunk]
    step = dist.sharded_encode_step(dist.make_mesh(["cpu"] * 5), r_cmd,
                                    r_lit, chunk=chunk)
    got = step(dist.pad_batch(ct, 10), dist.pad_batch(lt, 10))
    b = ct.shape[0]
    _assert_lanes_equal([[a[:b] for a in g] for g in got], want)
    for words, nwords, state in got:
        assert not words[b:].any() and not nwords[b:].any()
        assert (state[b:] == ENC_START_STATE).all()


@pytest.mark.parametrize("chunk", [0, 64])
def test_sub_traces_outside_the_contract_raise(unsharded, chunk):
    """A live row after a lane's padding, a row of the other stream and a
    row index out of range are refused on the host, before any pass."""
    (ct, lt, r_cmd, r_lit), _want = unsharded[chunk]
    step = dist.sharded_encode_step(dist.make_mesh(["cpu"] * 2), r_cmd,
                                    r_lit, chunk=chunk)
    gap, other, wide = ct.copy(), ct.copy(), lt.copy()
    gap[0, -1, 2] = 0
    other[1, 0, 2] = 1
    wide[2, 0, 0] = r_lit
    with pytest.raises(ValueError, match="then padding"):
        step(gap, lt)
    with pytest.raises(ValueError, match="then padding"):
        step(other, lt)
    with pytest.raises(ValueError, match="column 0"):
        step(ct, wide)


def test_batch_the_mesh_does_not_divide_raises_as_in_jax(unsharded):
    (ct, lt, r_cmd, r_lit), _want = unsharded[64]
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    jstep = jdist.sharded_encode_step(jdist.make_mesh(devs[:8]), r_cmd,
                                      r_lit, chunk=64)
    with pytest.raises(ValueError, match="divisible"):
        jstep(jnp.asarray(ct[:6]), jnp.asarray(lt[:6]))
    step = dist.sharded_encode_step(dist.make_mesh(["cpu"] * 8), r_cmd,
                                    r_lit, chunk=64)
    with pytest.raises(ValueError, match="does not divide"):
        step(ct[:6], lt[:6])
    # a batch of 12 on 4 shards is 3 rows each
    got = dist.sharded_encode_step(dist.make_mesh(["cpu"] * 4), r_cmd,
                                   r_lit, chunk=64)(
        np.concatenate([ct, ct[:4]]), np.concatenate([lt, lt[:4]]))
    assert [g.shape[0] for s in got for g in s] == [12] * 6


def test_sharded_e2e_container_roundtrip():
    """The port's sharded deferred encode of 32 KiB (metablock 4096,
    chunk 64, cm lo_bucketed) on 8 CPU shards, the frames assembled in
    file order: the container equals the JAX golden engine's and the
    port's compress, and the port's decompress returns the data."""
    chunk = 64
    data = _text(32768, seed=5)
    opts = port.DivansOptions(metablock_size=4096, chunk_nibbles=chunk)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    blocks = _blocks(data, opts.metablock_size)
    traces = [encode.frame_trace(b, opts, layout) for b in blocks]
    cmd_ts, lit_ts, _m, r_cmd, r_lit = encode.split_stream_traces(traces,
                                                                  layout)
    subs, spans = encode.split_lit_sub_traces(lit_ts)
    ct = dist.pad_batch(
        deferred_pass.pad_traces(cmd_ts, cmd_chunk(chunk)), 8)
    lt = dist.pad_batch(deferred_pass.pad_traces(subs, chunk), 8)
    step = dist.sharded_encode_step(dist.make_mesh(["cpu"] * 8), r_cmd,
                                    r_lit, chunk=chunk)
    (cw, cn, cs), (lw, ln, ls) = step(ct, lt)
    cmd = rans_encode.lanes_to_bytes(cw, cn, cs)
    lit = rans_encode.lanes_to_bytes(lw, ln, ls)
    frames = [fmt.MetablockFrame(len(b), cmd[i],
                                 lit_subs_join(lit[o:o + k]))
              for i, (b, (o, k)) in enumerate(zip(blocks, spans))]
    blob = fmt.serialize(frames, opts.window_size, opts.mb_log2,
                         native.crc32c(data),
                         flags=PROFILE_FLAGS["cm"] | chunk_to_flags(chunk))
    assert blob == jengine_np.compress(
        data, JOptions(metablock_size=4096, chunk_nibbles=chunk))
    assert blob == port.compress(data, opts, device="cpu")
    assert port.decompress(blob, device="cpu") == data


def test_sharded_decode_matches_oracle():
    """Decode stage 2 on a 2-entry CPU mesh (256 lanes, a few live), fed
    the JAX package's pack_lit_lanes arrays through the converter: each
    live lane equals decode_literals_np, the whole output and the
    cursors equal the port's unsharded plain decode, and each lane's
    cursor counts its stream's words."""
    chunk = 64
    data = _text(8192, seed=7)
    opts = JOptions(metablock_size=4096, chunk_nibbles=chunk)
    jlayout = JLayout(JPROFILES["cm"], lo_bucketed=True)
    rows = []
    for raw in _blocks(data, 4096):
        cb, lb_field = jdeferred.encode_metablock(
            raw, jbuild_commands(raw, opts), opts, chunk)
        (lb,) = jdeferred.lit_subs_split(lb_field)
        sc = jdeferred.decode_cmd_structure(cb, len(raw), opts, chunk)
        assert sc.supported
        rows.append((lb, sc))
    reps = [rows[i % len(rows)] for i in range(6)]
    lanes = 2 * decode.LANES
    arrays = pallas_decode.pack_lit_lanes(
        [r[0] for r in reps], [r[1].lit_total for r in reps],
        [r[1].lcmap for r in reps], [r[1].speeds for r in reps],
        lanes=lanes)
    queues = decode.from_tpu_lit_lanes(arrays)
    n_chunks = max(1, -(-int(arrays[2].max()) // (chunk // 2)))
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    step = dist.sharded_decode_step(dist.make_mesh(["cpu"] * 2), layout,
                                    chunk, n_chunks)
    out, cursor = step(queues)
    assert out.shape == (lanes, n_chunks * chunk // 2)
    assert out.dtype == torch.uint8 and cursor.dtype == torch.int32
    for i, (lb, sc) in enumerate(reps):
        want = pallas_decode.decode_literals_np(lb, sc.lit_total, sc.lcmap,
                                                sc.speeds, chunk)
        assert out[i, :sc.lit_total].numpy().tobytes() == want
        assert int(cursor[i]) == (len(lb) - 4) // 2
    assert not cursor[len(reps):].any()
    q, perm, n_pass = decode.group_inputs(queues, chunk, layout, "cpu")
    whole, carry = lit_decode.decode_group_plain(q, perm, n_pass, n_chunks,
                                                 chunk // 2)
    assert torch.equal(out, whole)
    assert torch.equal(cursor, carry["cursor"])


def test_decode_step_takes_128_lanes_a_device():
    step = dist.sharded_decode_step(dist.make_mesh(["cpu"] * 2),
                                    ModelLayout(PROFILES["cm"],
                                                lo_bucketed=True), 64, 1)
    queues = decode.pack_lane_queues([], [], [], [], 64, lanes=128)[0]
    with pytest.raises(ValueError, match="128 a device"):
        step(queues)


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh(["cuda:0"])


def test_mesh_keeps_devices_in_order_with_repeats():
    mesh = dist.make_mesh(["cpu", torch.device("cpu"), "cpu"], axis="rows")
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert len(mesh) == 3 and mesh.axis == "rows"
    assert dist.make_mesh(["cpu"] * 8).axis == "data"
    with pytest.raises(ValueError):
        dist.make_mesh([])
    with pytest.raises(ValueError, match="cuda and cpu"):
        dist.make_mesh(["meta"])


def test_device_guard_is_a_noop_for_cpu(monkeypatch):
    """The guard every wrapper launches in touches no CUDA state for a
    CPU tensor."""
    def no_cuda(*_a, **_k):
        raise AssertionError("the guard reached torch.cuda")

    monkeypatch.setattr(torch.cuda, "device", no_cuda)
    monkeypatch.setattr(torch.cuda, "set_device", no_cuda)
    t = torch.zeros(3)
    with cuda_build.on_device(t.device) as ctx:
        assert ctx is None
    with cuda_build.on_device("cpu"):
        pass


def test_entry_points_raise_for_a_missing_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="no device cuda:3"):
        port.compress(b"abc", device="cuda:3")
    with pytest.raises(ValueError, match="no device cuda:1"):
        port.decompress(b"", device="cuda:1")

