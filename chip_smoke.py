#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing its line; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi) and CUDA;
  2. build: the three kernels (csrc/lit_decode.cu, lit_pass.cu,
     rans_encode.cu), one nvcc each, all started together, and the host
     C++ library;
  3. a 48 MiB corpus, and its host-only container (native.compress,
     metablock 2^18, chunk_nibbles 256): the reference bytes;
  4. encode kernels against their plain versions: the main path's first
     batch (the corpus's first HYBRID_BATCH frames, packed its way) goes
     through the literal model pass twice on the card, kernel and plain
     PyTorch version (equal starts and freqs), then through the rANS
     encode twice (equal flags, flagged words, word counts and states);
  5. encode main path: after one warm encode, the corpus is compressed
     on the card through divans_tpu_torch.compress three times; the
     container must equal the reference bytes, both encode kernels must
     have launched and no frame may have left the device path;
  6. decode kernel against its plain version: the main path's first
     lane group of that container, taken on until every lane has a job
     (so every thread block of the kernel decodes), runs twice on the
     card, once launching the kernel and once with the plain PyTorch
     version, on the same tensors; every chunk's bytes, ctx, state, p1,
     p2 and pulls must be equal;
  7. decode main path: after one warm decode, the container is
     decompressed on the card through divans_tpu_torch.decompress three
     times; the output must equal the corpus, the kernel must have
     launched and no frame may have left the device path.
Then one JSON line with the kernels' numbers, and as the last line
{"ok": true, "device": {...}}.  Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import glob
import hashlib
import json
import os
import subprocess
import sys
import sysconfig
import time
from concurrent.futures import ThreadPoolExecutor

import torch

import divans_tpu_torch as dt
from divans_tpu_torch import cuda_build, native
from divans_tpu_torch.ans import rans_encode
from divans_tpu_torch.codec import decode, encode, lit_decode, lit_pass
from divans_tpu_torch.codec.deferred import SUB_LIT, flags_to_chunk
from divans_tpu_torch.codec.layout import ModelLayout, PROFILES
from divans_tpu_torch.container import format as fmt

CORPUS_BYTES = 48 << 20
MB_SIZE = 1 << 18
CHUNK = 256
# peaks of one H100 SXM at 700 W (NVIDIA's data sheet and Hopper
# whitepaper): HBM at 3.35 TB/s; INT32 at 132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock, one op per lane per clock (the same clock gives
# the sheet's 67 TFLOP/s fp32 from 128 fp32 lanes and 2 flops an FMA)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations, counted from the kernels' code (a 32-bit integer
# division is a sequence of ~25 instructions on this card): the literal
# model pass does ~250 a nibble (six row-entry loads, three averages at
# one entry each, five exact floor divisions, the adjustment, two
# histogram atomics) and ~4 a model entry in each chunk's commit (384
# rows x 16 entries); the rANS encode ~40 a symbol (a compare, a shift,
# one floor division, the update, the loads and stores)
LIT_PASS_OPS_PER_NIBBLE = 250
LIT_PASS_OPS_PER_ENTRY = 4
RANS_OPS_PER_SYMBOL = 40
KERNEL_MODULES = (lit_decode, lit_pass, rans_encode)


def build_corpus(target: int) -> bytes:
    """Deterministic mixed corpus from local files, the way
    research/large_file_study.build_corpus builds it: this interpreter's
    stdlib Python sources (half), C headers (a quarter), then a
    shared-library tail (binary).  Sorted paths, symlinks skipped (no
    repeated content)."""
    def from_glob(patterns, cap):
        got, tot = [], 0
        for pattern in patterns:
            for p in sorted(glob.glob(pattern, recursive=True)):
                if tot >= cap:
                    return got
                if os.path.islink(p) or not os.path.isfile(p):
                    continue
                try:
                    with open(p, "rb") as f:
                        b = f.read()
                except OSError:
                    continue
                got.append(b)
                tot += len(b)
        return got

    stdlib = sysconfig.get_paths()["stdlib"]
    parts = from_glob([os.path.join(stdlib, "**", "*.py")], target // 2)
    parts += from_glob(["/usr/include/**/*.h"], target // 4)
    total = sum(len(p) for p in parts)
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    parts += from_glob(["/usr/lib/x86_64-linux-gnu/*.so*",
                        os.path.join(torch_lib, "*.so*")], target - total)
    data = b"".join(parts)[:target]
    assert len(data) == target, (len(data), target)
    return data


def _cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of `fn` over n runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def phase_device() -> tuple[str, str]:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__}"
          f" cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    native.load()
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_MODULES)) as ex:
        list(ex.map(lambda m: m.build(), KERNEL_MODULES))
    t_all = time.perf_counter() - t0
    for m in KERNEL_MODULES:
        print(f"[build] {m.NAME}.cu (nvcc sm_90a) "
              f"{cuda_build.BUILD_SECONDS[m.NAME]:.2f} s | ptxas: "
              f"{cuda_build.ptxas_usage(m.NAME)}")
    print(f"[build] all kernels {t_all:.2f} s wall, native library "
          f"{t_native:.2f} s")


def _cuda_ms_once(fn):
    """(fn's result, its milliseconds by CUDA events), one run."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = fn()
    e1.record()
    torch.cuda.synchronize()
    return res, e0.elapsed_time(e1)


def _max_err(pairs) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in pairs)


def _entry(ms, plain_ms, n_bytes, n_ops, max_err) -> dict:
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "n_bytes": n_bytes, "n_ops": n_ops}


def phase_encode_compare(corpus: bytes, device, smi: str) -> dict:
    """Both encode kernels against their plain versions on the main
    path's first batch; returns their entries (max_abs_err, ms, plain_ms,
    bound)."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    blocks = [corpus[o:o + MB_SIZE]
              for o in range(0, encode.HYBRID_BATCH * MB_SIZE, MB_SIZE)]
    with ThreadPoolExecutor(8) as ex:
        got = list(ex.map(lambda b: encode.host_frame(b, opts, layout, CHUNK),
                          blocks))
    assert all(g[1] is not None for g in got), "a frame left the envelope"
    rows, spds, _spans = encode.batch_lanes(got)
    packed, spd, n_nib = (torch.from_numpy(a).to(device)
                          for a in encode.batch_inputs(rows, spds, CHUNK))
    b, n = packed.shape[0], 2 * packed.shape[1]
    live = int((n_nib > 0).sum())
    n_sym = int(n_nib.sum())

    # ---- literal model pass: kernel vs plain on the same tensors
    (st_p, fr_p), plain_ms = _cuda_ms_once(
        lambda: lit_pass.lit_pass_plain(packed, spd, n_nib, CHUNK))
    st_k, fr_k = lit_pass.lit_pass(packed, spd, n_nib, CHUNK)
    torch.cuda.synchronize()
    err = _max_err([(st_k, st_p), (fr_k, fr_p)])
    assert err == 0, f"lit_pass kernel differs from its plain version by {err}"
    ms = _cuda_ms(lambda: lit_pass.lit_pass(packed, spd, n_nib, CHUNK), 20)
    lane_chunks = int(((n_nib + CHUNK - 1) // CHUNK).sum())
    # bytes: each live literal byte read once (2 B), speeds and counts,
    # starts and freqs written once; operations per nibble and per commit
    lp = _entry(ms, plain_ms, n_sym + b * 28 + 8 * b * n,
                LIT_PASS_OPS_PER_NIBBLE * n_sym
                + LIT_PASS_OPS_PER_ENTRY * 384 * 16 * lane_chunks, err)

    # ---- rANS encode of the kernel's (start, freq): kernel vs plain
    (w_p, f_p, s_p), plain_ms_r = _cuda_ms_once(
        lambda: rans_encode.encode_lanes_plain(st_k, fr_k, n_nib))
    w_k, f_k, s_k = rans_encode.encode_lanes(st_k, fr_k, n_nib)
    h_p = rans_encode.compact_global(w_p, f_p, n_nib, s_p)[1]
    h_k = rans_encode.compact_global(w_k, f_k, n_nib, s_k)[1]
    torch.cuda.synchronize()
    flagged = f_k != 0
    err_r = _max_err([(f_k, f_p), (s_k, s_p), (h_k, h_p),
                      (w_k[flagged], w_p[flagged])])
    assert err_r == 0, f"encode_lanes kernel differs from its plain version " \
        f"by {err_r}"
    ms_r = _cuda_ms(lambda: rans_encode.encode_lanes(st_k, fr_k, n_nib), 20)
    n_words = int(h_k[0].sum())
    # bytes: starts and freqs of each coded symbol read once, counts,
    # words and flags written once over [B, N], states
    re_ = _entry(ms_r, plain_ms_r, 8 * n_sym + 4 * b + 3 * b * n + 4 * b,
                 RANS_OPS_PER_SYMBOL * n_sym, err_r)
    print(f"[enc-compare] first batch ({len(blocks)} frames of {MB_SIZE} B):"
          f" {b} lanes, {live} live, {n_sym} nibbles, N {n}, chunk {CHUNK}")
    print(f"[enc-compare] lit_pass kernel == plain on starts, freqs "
          f"(max_abs_err {err}): kernel {ms:.4f} ms, plain {plain_ms:.2f} "
          f"ms, bound {lp['bound_ms']:.6f} ms by {lp['bound_by']} "
          f"({lp['n_bytes']} B, {lp['n_ops']} ops) | {smi}")
    print(f"[enc-compare] encode_lanes kernel == plain on flags, flagged "
          f"words, nw, states (max_abs_err {err_r}, {n_words} words): "
          f"kernel {ms_r:.4f} ms, plain {plain_ms_r:.2f} ms, bound "
          f"{re_['bound_ms']:.6f} ms by {re_['bound_by']} ({re_['n_bytes']}"
          f" B, {re_['n_ops']} ops); its real limit is the serial chain "
          f"per lane | {smi}")
    return {"lit_pass": lp, "encode_lanes": re_}


def phase_encode_main(corpus: bytes, ref: bytes, smi: str) -> dict:
    """The port's encode at full size on the card; returns the kernel
    launches of one encode."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK)
    n_frames = len(fmt.deserialize(ref)[2])
    assert dt.compress(corpus, opts) == ref, "warm encode differs"
    times = []
    for run in range(3):
        if run == 0:
            lit_pass.LAUNCHES = rans_encode.LAUNCHES = 0
            encode.STATS.update(device_frames=0, host_frames=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = dt.compress(corpus, opts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if run == 0:
            launches = {"lit_pass": lit_pass.LAUNCHES,
                        "encode_lanes": rans_encode.LAUNCHES}
            stats = dict(encode.STATS)
        assert blob == ref, "device encode differs from native.compress"
    assert all(launches.values()), f"an encode kernel never ran: {launches}"
    assert stats == {"device_frames": n_frames, "host_frames": 0}, stats
    mbps = len(corpus) / min(times) / 1e6
    print(f"[enc-main] encode e2e {mbps:.2f} MB/s best of 3 after a warm one "
          f"({', '.join(f'{t:.3f}' for t in times)} s), output == "
          f"native.compress | launches {launches} per encode, frames "
          f"{stats} | {smi}")

    # one more encode with CUDA events around each batch's device stages
    blocks = [corpus[o:o + MB_SIZE] for o in range(0, len(corpus), MB_SIZE)]
    timing: list = []
    t0 = time.perf_counter()
    frames = encode.compress_frames(
        blocks, opts, ModelLayout(PROFILES["cm"], lo_bucketed=True), CHUNK,
        torch.device("cuda"), timing=timing)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert [f.lit for f in frames] == [f.lit for f in fmt.deserialize(ref)[2]]
    stage_ms = [sum(e[k].elapsed_time(e[k + 1]) for e, _w in timing)
                for k in range(3)]
    wait_s = sum(w for _e, w in timing)
    print(f"[enc-main] timed encode ({len(timing)} batches, {wall:.3f} s "
          f"wall): lit_pass {stage_ms[0]:.1f} ms, encode_lanes "
          f"{stage_ms[1]:.1f} ms, compaction and copy {stage_ms[2]:.1f} ms "
          f"(device timeline); the issuing thread waited {wait_s:.3f} s "
          f"for the host C++ stages | {smi}")
    return launches


def _first_group(blob: bytes):
    """The main path's first lane group, built its way (decode_structure,
    lane_jobs, pack_lane_queues) from the container's leading frames:
    frames are taken until the group holds decompress_frames' chunk
    target, and on until every lane has a job.  Returns (LaneQueues,
    n_steps, layout, chunk, n_frames)."""
    _w, _mb, frames, _crc, flags = fmt.deserialize(blob)
    chunk = flags_to_chunk(flags)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    ready, need, n_jobs = [], 0, 0
    for i, f in enumerate(frames):
        sc = decode.decode_structure(f, chunk, layout)
        assert sc is not None, f"frame {i} outside the device envelope"
        ready.append((i, sc))
        need += -(-sc.lit_total // (chunk // 2))
        n_jobs += -(-sc.lit_total // SUB_LIT)
        if (need >= decode.LANES * decode.GROUP_CHUNKS
                and n_jobs >= decode.LANES):
            break
    assert n_jobs >= decode.LANES, (n_jobs, "jobs: too few for every lane")
    streams, n_lits, lcmaps, spds, _spans = decode.lane_jobs(frames, ready)
    queues, n_steps, _placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, spds, chunk)
    return queues, n_steps, layout, chunk, len(ready)


def phase_reference(corpus: bytes) -> bytes:
    """The corpus's container from the host-only path (native.compress):
    the bytes the device encode must equal."""
    print(f"[corpus] {len(corpus)} bytes sha256 "
          f"{hashlib.sha256(corpus).hexdigest()}")
    t0 = time.perf_counter()
    blob = native.compress(corpus, dt.DivansOptions(metablock_size=MB_SIZE,
                                                    chunk_nibbles=CHUNK))
    t_enc = time.perf_counter() - t0
    print(f"[reference] native.compress (host C++ only): {len(blob)} bytes "
          f"({len(blob) / len(corpus):.4f}), {len(fmt.deserialize(blob)[2])}"
          f" frames, {t_enc:.2f} s")
    return blob


def phase_compare(blob: bytes, device) -> dict:
    """Kernel against its plain version on every chunk of the main path's
    first lane group (every lane live); returns the kernel's entry
    numbers (max_abs_err, ms, plain_ms, bound)."""
    queues, n_steps, layout, chunk, n_frames = _first_group(blob)
    runs = {"kernel": [], "plain": []}
    busiest = [-1, None]   # the chunk with the most bytes to decode
    max_live = [0]         # most lanes live in one chunk

    def recorder(fn, log):
        def call(model, words, lcmap, luts, sc_in, s):
            n_act = int(torch.clamp(sc_in[3], 0, s).sum())
            max_live[0] = max(max_live[0], int((sc_in[3] > 0).sum()))
            if n_act > busiest[0]:
                busiest[:] = [n_act, tuple(t.clone() for t in
                                           (model, words, lcmap, luts, sc_in))]
            res = fn(model, words, lcmap, luts, sc_in, s)
            log.append(tuple(t.clone() for t in res))
            return res
        return call

    out_k = decode.decode_lanes(queues, n_steps, chunk, layout, device,
                                chunk_fn=recorder(lit_decode.lit_decode_chunk,
                                                  runs["kernel"]))
    out_p = decode.decode_lanes(queues, n_steps, chunk, layout, device,
                                chunk_fn=recorder(
                                    lit_decode.lit_decode_chunk_plain,
                                    runs["plain"]))
    torch.cuda.synchronize()
    assert len(runs["kernel"]) == len(runs["plain"]) == n_steps
    max_err = 0
    for step, (k, p) in enumerate(zip(runs["kernel"], runs["plain"])):
        for name, a, b in zip(("bytes", "ctx", "sc_out"), k, p):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            assert err == 0, f"chunk {step}: kernel {name} differs by {err}"
    assert torch.equal(out_k, out_p)
    b = out_k.shape[0]
    assert max_live[0] == b, f"only {max_live[0]} of {b} lanes decoded"

    n_act, (model, words, lcmap, luts, sc_in) = busiest
    s = chunk // 2
    ms = _cuda_ms(lambda: lit_decode.lit_decode_chunk(
        model, words, lcmap, luts, sc_in, s), 50)
    plain_ms = _cuda_ms(lambda: lit_decode.lit_decode_chunk_plain(
        model, words, lcmap, luts, sc_in, s), 2)
    _b, _c, sc_out = lit_decode.lit_decode_chunk(model, words, lcmap, luts,
                                                 sc_in, s)
    n_live = int((sc_in[3] > 0).sum())
    # bytes: every input read once (each live lane's planes and lcmap, the
    # luts, the scalars, and the renorm words this chunk pulls), every
    # output written once; a lane with nothing left reads no plane
    n_bytes = (n_live * (model[0].numel() * 2 + lcmap[0].numel() * 4)
               + luts.numel() * 4 + sc_in.numel() * 4
               + int(sc_out[3].sum()) * 2 + 2 * b * s + sc_out.numel() * 4)
    # operations: ~64 integer ops per nibble (word select, 15 compares and
    # adds, 16 selects, 2 divisions, the state update) x 2 nibbles per
    # decoded byte
    n_ops = 64 * 2 * n_act
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT32_OPS_PER_S * 1e3
    print(f"[dec-compare] first lane group ({n_frames} frames): {n_steps} "
          f"chunks x {b} lanes, all {b} lanes live: kernel == plain on "
          f"bytes, ctx, state, p1, p2, pulls (max_abs_err {max_err}) | "
          f"busiest chunk ({n_live} lanes live, {n_act} bytes decoded, "
          f"{n_bytes} bytes moved): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {max(bytes_ms, ops_ms):.6f} ms")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_main(blob: bytes, corpus: bytes, device, smi: str) -> int:
    """The port's main path at full size; returns the kernel launches of
    one decode."""
    n_frames = len(fmt.deserialize(blob)[2])
    assert dt.decompress(blob) == corpus, "warm decode differs"
    times = []
    launches = None
    for run in range(3):
        if run == 0:
            lit_decode.LAUNCHES = 0
            decode.STATS.update(device_frames=0, host_frames=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = dt.decompress(blob)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if run == 0:
            launches = lit_decode.LAUNCHES
            stats = dict(decode.STATS)
        assert raw == corpus, "decoded bytes differ from the corpus"
    assert launches > 0, "the main path never launched the kernel"
    assert stats == {"device_frames": n_frames, "host_frames": 0}, stats
    mbps = len(corpus) / min(times) / 1e6

    # one more decode with per-step CUDA events: kernel vs commit time
    _w, _mb, frames, _crc, flags = fmt.deserialize(blob)
    timing: list = []
    raw = decode.decompress_frames(
        frames, flags_to_chunk(flags),
        ModelLayout(PROFILES["cm"], lo_bucketed=True), device, timing=timing)
    torch.cuda.synchronize()
    assert raw == corpus
    kernel_ms = sum(e[1].elapsed_time(e[2]) for e, _h in timing)
    commit_ms = sum(e[0].elapsed_time(e[1]) + e[2].elapsed_time(e[3])
                    for e, _h in timing)
    issue_ms = sum(h for _e, h in timing) * 1e3
    print(f"[dec-main] decode e2e {mbps:.2f} MB/s best of 3 after a warm one "
          f"({', '.join(f'{t:.3f}' for t in times)} s) | kernel launches "
          f"{launches} per decode, frames {stats} | {smi}")
    print(f"[dec-main] timed decode: kernel {kernel_ms:.1f} ms over "
          f"{len(timing)} launches ({kernel_ms / len(timing):.4f} ms each), "
          f"commit {commit_ms:.1f} ms (device timeline); host time issuing "
          f"the steps {issue_ms:.1f} ms | {smi}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    name, smi = phase_device()
    phase_build()
    corpus = build_corpus(CORPUS_BYTES)
    blob = phase_reference(corpus)
    enc = phase_encode_compare(corpus, device, smi)
    enc_launches = phase_encode_main(corpus, blob, smi)
    dec = phase_compare(blob, device)
    dec_launches = phase_main(blob, corpus, device, smi)
    rows = [("lit_decode_chunk", lit_decode, dec, dec_launches,
             "divans_tpu/codec/pallas_decode.py:182"),
            ("lit_pass", lit_pass, enc["lit_pass"], enc_launches["lit_pass"],
             "divans_tpu/codec/pallas_lit_pass.py:99"),
            ("encode_lanes", rans_encode, enc["encode_lanes"],
             enc_launches["encode_lanes"],
             "divans_tpu/ans/pallas_kernels.py:57")]
    kernels = [{
        "name": k_name, "route": "cuda",
        "source": f"divans_tpu_torch/csrc/{mod.NAME}.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": None}
        for k_name, mod, e, launches, replaces in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
