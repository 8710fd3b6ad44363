#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Every kernel runs on the card; every plain version it is held against
runs on host copies of the same inputs with one intra-op thread, its
time on the host's clock, but kernel 5's over more than
HOST_PLAIN_ENTRIES model entries, which runs on the card (_plain_run).

Phases, each printing its line; any failure raises and exits non-zero:
  1. device: the card's name and power limit (nvidia-smi) and CUDA;
  2. build: the seven kernels (csrc/lit_decode.cu, lit_pass.cu,
     rans_encode.cu, cmd_pass.cu, deferred_pass.cu, model_pass.cu,
     scan_decode.cu), one nvcc each, all started together, and the host
     C++ library;
  3. a 48 MiB corpus, and its host-only container (native.compress,
     metablock 2^18, chunk_nibbles 256): the reference bytes;
  4. encode kernels against their plain versions: the main path's first
     batch (the corpus's first HYBRID_BATCH frames, packed its way) goes
     through the literal model pass twice, the kernel and its plain
     PyTorch version (equal starts and freqs; its bound by the rows each
     chunk counted beside the old count of 384 x 16 entries a chunk),
     then through the rANS encode twice (equal flags, flagged words,
     header and states); the literal pass also on edge lanes
     (lit_edge_lanes: commits that leave entry 15 at or above 0x8000,
     rows at the 24-pass cap, the weight clamps, inactive bytes, no
     mixing, ragged and empty lanes) at chunk 16, 256 and 1024;
  5. encode main path: after one warm encode, the corpus is compressed
     on the card through divans_tpu_torch.compress three times; the
     container must equal the reference bytes, both encode kernels must
     have launched and no frame may have left the device path; one
     event-timed encode under torch.profiler, whose lit-pass stage is
     split into the kernel's own device time and the card's wait;
  6. decode kernel against its plain version: the main path's first
     lane group of that container, taken on until every lane has a job
     (so every thread block of the kernel decodes), runs twice, once
     as the kernel's one launch on the card and once as the plain group
     decode (the chunk loop in PyTorch), on the same tensors; the bytes
     and every lane's final carry (state, cursor, p1, p2, n_rem, queue
     position, committed model, weights, pend) must be equal; then one
     launch is timed back to back against its bound;
  7. decode main path: after one warm decode, the container is
     decompressed on the card through divans_tpu_torch.decompress three
     times; the output must equal the corpus, the kernel must have
     launched (once a lane group) and no frame may have left the device
     path; one more decode with CUDA events around each group's launch,
     then the host stages alone (structure pass, CRC); then the decode's
     opt-in routes ([dec-routes], phase_routes): kernel 1 resumed from a
     carry against its plain version (the first lane group's first 32
     chunks as two segments from idle_carry: the bytes and every carry
     field) and against one launch (the whole group in segments of 64
     chunks), decode_literals_batch against the numpy oracle
     decode_literals_np on two sub-streams' heads, the container through
     each route (resume, resume with qpl 2, qpl 2 and 3, backlog 0 and
     3) beside the default route, each equal to the corpus with its
     frames by path, launches and MB/s, and one decompress with
     DIVANS_DEC_RESUME=1 set, whose launches must equal its segments;
  8. quality 11: the corpus's first 16 MiB and its host-only quality-11
     container (native.compress: the matcher's command lists with
     dictionary edges through the trace FSM): the reference bytes;
  9. quality-11 encode kernels against their plain versions on that
     path's first batch, packed its way (all 16 lanes live): the cmd
     model pass and the rANS encode on the cmd lanes, the literal model
     pass and the rANS encode on the lit lanes, compared as in phase 4;
     the cmd pass also on edge lanes (cmd_edge_lanes: commits that leave
     entry 15 at or above 0x8000 with lim above it, rows at the 24-pass
     cap, all 256 rows) at s 16, 64 and 256, and its bound by the rows
     each chunk counted beside the old count of R x 16 entries a chunk;
 10. quality-11 encode main path (the uniform device lanes): after one
     warm encode, divans_tpu_torch.compress three times; the container
     must equal the reference bytes, the cmd pass, lit pass and rANS
     kernels must have launched and every frame's cmd stream and
     literals must have been coded on the card;
 11. decode kernel against its plain version on the quality-11
     container's first lane group, as in phase 6 (every lane that has a
     job live);
 12. quality-11 round trip: divans_tpu_torch.decompress of that
     container on the card equals the 16 MiB, no frame on the host, the
     kernel launched once a lane group;
 13. the mix profile (force_stride_value=4, quality 10) on the whole
     corpus, whose literals the generic deferred pass codes: the
     host-only reference; on the first batch's generic literal lanes
     (built by encode.batch_jobs) that pass, kernel against plain, then
     the rANS encode on its output; the generic pass also on edge lanes
     (generic_edge_lanes: 2s rows a chunk, a row hit by every step, the
     renorm cap, the weight clamps) at s 16, 256 and 1024; one warm and
     three timed encodes (each equal to the reference, launching the
     generic pass, no frame's literals elsewhere); one event-timed
     encode under torch.profiler, whose generic-pass stage is split into
     the kernel's own device time and the card's wait; one round trip
     (the decode of this profile runs on the host);
 14. the stride profile (the CLI's -nocm: no context map, no mixing) on
     the first 16 MiB: the reference; on the first batch the generic
     pass against its plain version, then the rANS encode on its
     output; one warm and one timed encode;
 15. the mix profile at quality 11 on the first 4 MiB (the uniform
     path: the cmd pass on the cmd lanes, the generic pass on the
     literals, the rANS encode on both): the reference; on the first
     batch the cmd pass and the rANS encode on the cmd lanes, the
     generic pass and the rANS encode on the literal lanes, each
     against its plain version; one warm and one timed encode;
 16. the adaptive profile (chunk_nibbles=0, the default options) on the
     whole corpus (phase_adaptive): the host-only reference
     (native.compress); on the main path's own inputs the per-nibble
     model pass (csrc/model_pass.cu: one call over the 192 frames'
     traces, two launches, the row chains then the weight chains, timed,
     then kernel against plain on each trace's first AD_CMP_STEPS steps,
     a prefix of the whole call's; one more call times each frame's
     phases on the card's clock), the rANS encode on the 384 lanes of
     that compare (timed on the whole launch's lanes) and the decode scan
     (csrc/scan_decode.cu: one launch over the reference container's 192
     frames, timed, then kernel against plain on the same packed frames
     cut at AD_SCAN_CMP_STEPS micro-steps, each window a prefix of the
     whole launch's; one more launch reads each frame's cmd-warp and
     literal-warp finish and wait cycles); the model pass also on
     adaptive_edge_traces (coinciding rows, padding steps, the weight
     clamps, rows with a max of 0 or below) over the cm rows (model in
     shared memory) and the mix rows (global slab), the scan also on
     frames with a flipped bit in a cmd and a lit stream, on
     mix-profile lanes, and on scan_path_lanes (frames written at the
     trace level: wrapped literal lengths that send a copy's C_CS row
     into the literal rows, the escape drain, in the cm and the mix
     profile; a mix lane of ~3,000 micro-steps through the global slab,
     mixing and not), each to its end, the lanes that reached each path
     printed; one warm and three timed encodes
     through divans_tpu_torch.compress (each equal to the reference, the
     model pass's two launches and the rANS kernel's one), one encode
     traced (each tracelog span's host ms and, by torch.profiler's
     key_averages, its device ms; the trace upload at 40 B a step); one
     warm and three timed decodes through divans_tpu_torch.decompress
     (equal to the corpus, one scan launch, no frame on the host), one
     traced the same way, and the host-only decode of the same
     container beside it (every frame through native.decode_metablock);
 17. the same in the stride profile (use_context_map=False) on the first
     16 MiB (64 frames), one timed run each way;
 18. the same at quality 11 on the first 4 MiB (16 frames): the frames
     holding dict commands leave the scan for the host, counted;
 19. detection (stride_detection_quality=1, speed_detection_quality=1,
     chunk 256) on a 16 MiB record corpus made from the seed (int16
     random walks on four channels): the detected stride (> 1) and
     speeds printed; the host-only reference (native.compress); the
     hybrid takes the detected options (the host codes the cmd
     streams, encode.STATS printed): on the first batch the generic
     pass on the mix profile's literals and the rANS encode on them
     against their plain versions (_deferred_compare: the rANS encode
     on each lane's first RANS_CMP_STEPS steps, timed on the whole
     lanes); one warm and one timed encode equal to the reference; one
     round trip (on the host, the mix profile);
 20. the same options at chunk 0 on the same corpus: the adaptive
     kernels on the path's inputs (_adaptive_compare cut at
     OPT_AD_CMP_STEPS and OPT_SCAN_CMP_STEPS), one timed encode, one
     round trip (the scan flags the mix frames to the host, counted);
 21. speed detection at chunk 256 on the corpus's first 16 MiB (stride
     1 keeps the cm profile), on the hybrid: the lit pass at the
     detected speeds and the rANS encode on the first batch, the decode
     kernel on
     the container's first lane group cut at DEC_CMP_CHUNKS chunks (the
     bytes a prefix of the whole launch's), one timed encode, one round
     trip through the decode kernel;
 22. the IR optimizer at quality 10: level 1 on the first 4 MiB, level 2
     on the first 256 KiB, each at chunk 256 (as phase 21) and at chunk
     0 (as phase 20);
 23. quality 11 without the context map at chunk 256 on the first 512 KiB
     (the Python trace FSM, the cmd pass and the generic pass): the
     host-only reference is the golden engine's; one timed encode, one
     round trip (on the host);
 24. the host options, each on 256 KiB: block split (text then
     records), prior-bitmask masks (records), context-map clustering at
     chunk 0 and 256, external probabilities made from the seed, and
     streamed frames: compress equal to the host-only reference
     (native.compress, else the golden engine), decompress on the card,
     the frames by path (scan, literal kernel, native, golden) printed;
 25. billing (compress(billing_out=), quality 10, chunk 256) on the
     corpus's first 16 MiB: no hybrid, so the cmd pass, the lit pass
     and the rANS encode on the first batch against their plain
     versions (cut as phase 19); the billed encode equal to the unbilled
     one, every cmd stream on the card, the billing table's TOTAL and
     both MB/s printed; the billing dict against a device="cpu" run's on
     the first 256 KiB;
 26. billing at chunk 0 on the same 16 MiB: the model pass on the path's
     traces and the rANS encode against their plain versions (cut as
     phase 20), the billed encode equal to the unbilled one, the billing
     dict against a CPU run's on the first 16 KiB at metablock 2^12;
 27. the CLI (divans_tpu_torch.cli.main) on the 48 MiB through files:
     -c -timing (equal to compress's container; the tracelog stage
     table printed) and -d (equal to the corpus), launches counted, MB/s
     beside compress's and decompress's;
 28. the streaming adapters (io_adapters) on the first 16 MiB at the
     defaults in 1 MiB writes and reads, on the host (no launch): the
     reader's output equals the input, the writer's container decodes
     through decompress on the card (one scan launch); then the port's C
     API shim (divans_tpu_torch/c, [capi]) built with this machine's
     compiler: the same 16 MiB through its example binary (no card
     visible) and through the shim by ctypes at the same piece size,
     each direction timed beside the adapters', the container equal to
     the writer's, no kernel launched (one line instead where cc, make,
     python3-config or the Python headers are missing);
 29. metablock data parallelism (parallel/dist, phase_dist) on the first
     16 MiB (64 frames) on two meshes, make_mesh() (every visible card)
     and four shards of card 0 on four streams: the sharded encode step
     at chunk 256 (the cm traces split by stream, the literals cut into
     32 KiB sub-streams, kernel 5 on both streams, then kernel 2) and at
     chunk 0 (the adaptive traces, A1 on each stream's sub-traces, then
     kernel 2), each step timed by the host clock and by CUDA events, the
     container assembled in frame order equal to native.compress's and
     the same on both meshes; kernel 5 (whole), A1 (each lane's first
     2,048 steps) and kernel 2 (each lane's first 16,384 steps) against
     their plain versions on each shard's first lanes; the sharded decode
     step of the chunk-256 container on the four shards (every literal
     sub-stream one a lane, 512 lanes a step; kernel 1 against its plain
     version on the first shard's first 32 chunks), the scripts executed
     into the 16 MiB; with more than one card, compress and decompress
     with device="cuda:N" on the last card (else a line says this was not
     reached);
 30. the port without its native library ([no-native], phase_no_native):
     native.load patched to return None for the phase, so the host
     stages take the reference's lib-less Python routes (the greedy
     parse, the Python dictionary scan and trace FSM, the golden
     structure pass and script executor) while each device stage stays
     on its kernel; the corpus's first 1 MiB at chunk 256 (quality 10)
     and at chunk 0, one 256 KiB frame at quality 11: each encoded and
     decoded through divans_tpu_torch beside the same input with the
     library (each stage's seconds and MB/s side by side), the lib-less
     container equal to the input on the card (at chunk 256 through
     CmdScripts feeding kernel 1, every frame on it; at chunk 0 one
     scan launch) and through native.decompress with the library back;
     each kernel that ran against its plain version on the run's own
     inputs (the cmd pass, the lit pass and the rANS encode on the
     frames' lanes, kernel 1 on the CmdScripts' first lane group cut at
     DEC_CMP_CHUNKS, A1 and A2 cut at OPT_AD_CMP_STEPS and
     OPT_SCAN_CMP_STEPS), one "no-native" entry a kernel.
Each path's launches are counted with the counts set to 0 just before
its run.  Then one JSON line with the kernels' numbers, one entry for
each kernel and path (the kernel's launches on that path, its
comparison on that path's inputs), and as the last line {"ok": true,
"device": {...}}.  Needs CUDA; exits non-zero without it.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import glob
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import divans_tpu_torch as dt
from divans_tpu_torch import (api, cli, cuda_build, io_adapters, native,
                              tracelog)
from divans_tpu_torch.ans import rans_encode
from divans_tpu_torch.ans.coder_np import ANSEncoder
from divans_tpu_torch.codec import (adaptive, billing, cmd_pass, decode,
                                    deferred_pass, encode, lit_decode,
                                    lit_pass, model_pass, scan_decode)
from divans_tpu_torch.codec.deferred import (SUB_LIT, chunk_to_flags,
                                             cmd_chunk, flags_to_chunk,
                                             lit_subs_join)
from divans_tpu_torch.codec.layout import (FLAG_PROFILES, PROFILE_FLAGS,
                                           ModelLayout, PROFILES,
                                           profile_for_options)
from divans_tpu_torch.container import format as fmt
from divans_tpu_torch.ir.detect import apply_detection
from divans_tpu_torch.parallel import dist
from divans_tpu_torch.probability.speed import u8_to_speed

CORPUS_BYTES = 48 << 20
Q11_BYTES = 16 << 20     # the quality-11 corpus: the first 16 MiB
STRIDE_BYTES = 16 << 20  # the stride-profile corpus: the first 16 MiB
Q11_MIX_BYTES = 4 << 20  # the quality-11 mix-profile corpus: the first 4 MiB
MB_SIZE = 1 << 18
CHUNK = 256
# peaks of one H100 SXM at 700 W (NVIDIA's data sheet and Hopper
# whitepaper): HBM at 3.35 TB/s; INT32 at 132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock, one op per lane per clock (the same clock gives
# the sheet's 67 TFLOP/s fp32 from 128 fp32 lanes and 2 flops an FMA)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# integer operations, counted from the kernels' code (a 32-bit integer
# division is a sequence of ~25 instructions on this card; the exact
# FP64 floor division of csrc/floor_div.cuh ~12, and its reciprocal ~10
# once a divisor, issued at the INT32 rate: the card has as many FP64
# lanes as INT32 ones; every model pass divides that way): the literal
# model pass does ~65 a nibble (the
# packed byte's fields, three row-entry loads, one reciprocal and two
# floor divisions, the stores, the histogram and mask atomics) and ~130
# more a nibble that mixes (three more loads, two more reciprocals and
# four more divisions, three averages at one entry, the adjustment),
# ~4 a model entry of each row a chunk counted, in the commit that
# follows it, and one comparison for each row it did not count (the two
# weight commits, ~100 a chunk, left out); the count it replaces took a
# flat ~250 a nibble (five integer divisions), printed beside; the
# rANS encode ~40 a symbol (a compare, a shift,
# one floor division, the update, the loads and stores); the cmd model
# pass ~74 a step (three row-entry loads, one reciprocal and two floor
# divisions, the histogram atomic, the stores; ~90 with the divisions
# at the integer unit's ~25, printed beside), ~6 a model entry of each
# row a chunk counted, in the commit that follows it (renorm passes not
# counted), and one comparison for each row it did not count; the
# generic deferred pass ~84 a step (three row-entry loads, one
# reciprocal and two floor divisions, up to three atomics and the
# stores), ~143 more a mixing step (three more loads, three averages at
# one entry, two more reciprocals and four more divisions, the
# adjustments, three more atomics), and ~97 a touched row in each commit
# (the pend's 16 entries summed and cleared, one reciprocal and one
# division, one renorm pass); priced at ~100, ~150 and ~100 before,
# with the divisions at ~25, printed beside
LIT_PASS_OPS_PER_NIBBLE = 65
LIT_PASS_OPS_PER_MIX_NIBBLE = 130
LIT_PASS_OPS_PER_ENTRY = 4
LIT_PASS_OPS_PER_NIBBLE_BEFORE = 250
RANS_OPS_PER_SYMBOL = 40
CMD_PASS_OPS_PER_STEP = 74
CMD_PASS_OPS_PER_STEP_BEFORE = 90
CMD_PASS_OPS_PER_ENTRY = 6
# decode.STATS's frame counts (it counts kernel 1's lane groups beside
# them)
DECODE_FRAMES = ("device_frames", "host_frames", "golden_frames")
# the literal decode, counted as the function needs it (not as the
# kernel's rescaled grids spend it): ~90 a decoded nibble on the chain
# (word select, 15 compares and adds, the two exact floor divisions of
# the symbol's start and freq, the state update, the next context), ~110
# a nibble for its adjustment and counts (four exact floor divisions,
# the bit length, two clamps, the atomic), and per chunk a lane decodes
# ~15 a premixed entry (the average alone: two loads, four products, two
# shifts, two adds, a shift, the i16 wrap, the store) over 192 x 16 and
# ~6 a committed entry (the add, the cumulative count, one renorm pass)
# over 385 x 16
DECODE_OPS_PER_NIBBLE = 90
ADJ_OPS_PER_NIBBLE = 110
PREMIX_OPS_PER_ENTRY = 15
COMMIT_OPS_PER_ENTRY = 6
GENERIC_OPS_PER_STEP = 84
GENERIC_OPS_PER_MIX_STEP = 143
GENERIC_OPS_PER_COMMIT = 97
GENERIC_OPS_BEFORE = (100, 150, 100)   # step, mixing step, commit
# the adaptive profile's kernels, counted as the function needs them:
# the model pass ~230 a step (the trace row, two row gathers, one
# reciprocal and two floor divisions for (start, freq), two 16-entry
# blends at ~6 an entry, two row stores, the lane store) and ~170 more a
# mixing step (three averaged entries, two more reciprocals and four
# more divisions for the freqs under the cm and nibble rows, the mixer
# update with its bit lengths and one more division); the decode scan
# ~230 a coded nibble (the word pull, the row gathers, 15 compares for
# the symbol, one reciprocal and two divisions, the state advance, one
# 16-entry blend, the state's transition), ~370 more a nibble that
# mixes (16 averages, two reciprocals and four divisions, the mixer
# update, the cm row's blend), and ~30 a copy micro-step (at least one
# for each 8 bytes the literals did not write)
MODEL_PASS_OPS_PER_STEP = 230
MODEL_PASS_OPS_PER_MIX_STEP = 170
SCAN_OPS_PER_NIBBLE = 230
SCAN_OPS_PER_MIX_NIBBLE = 370
SCAN_OPS_PER_COPY_STEP = 30
KERNEL_MODULES = (lit_decode, lit_pass, rans_encode, cmd_pass, deferred_pass,
                  model_pass, scan_decode)


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
          f" cuda {torch.version.cuda} | count {torch.cuda.device_count()} | "
          f"host cores (os.cpu_count) {os.cpu_count()}")
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


def _tensors(x):
    """The tensors in x (a tensor, or a dict, list or tuple of them)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _on(x, device):
    """x (a tensor, or a dict, list or tuple of them) on device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _on(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_on(v, device) for v in x)
    return x


def _plain_run(fn, *args, host: bool = True, **kw):
    """(fn's result on its inputs' device, its milliseconds): a kernel's
    plain version, one run on the same inputs.  On the host (copies of
    the inputs, one intra-op thread, the host's clock) unless `host` is
    False: a plain version is a chain of small operations over a few
    lanes, up to a few times cheaper on the host than as launches on the
    card, so every compare keeps its depth inside the run's time limit.
    A plain version over a model too large for one host thread
    (HOST_PLAIN_ENTRIES) runs on the card, timed by CUDA events."""
    if not host:
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        res = fn(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        return res, e0.elapsed_time(e1)
    device = next(_tensors((args, kw))).device
    cpu = torch.device("cpu")
    args, kw = _on(args, cpu), _on(kw, cpu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.set_num_threads(threads)
    return _on(res, device), ms


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


def _layout(opts) -> ModelLayout:
    return ModelLayout(PROFILES[profile_for_options(opts)], lo_bucketed=True)


def _first_batch(corpus: bytes, opts, billing: bool = False):
    """The host side of the main path's first batch (the corpus's first
    HYBRID_BATCH frames, or all of a shorter one; host_frame on 8
    threads, as a billed encode prepares them when `billing`)."""
    layout = _layout(opts)
    end = min(len(corpus), encode.HYBRID_BATCH * MB_SIZE)
    blocks = [corpus[o:o + MB_SIZE] for o in range(0, end, MB_SIZE)]
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(
            lambda b: encode.host_frame(b, opts, layout, CHUNK, billing),
            blocks))


def _lit_pass_compare(got, device, tag: str, smi: str):
    """The literal model pass, kernel against plain, on the batch's lit
    lanes, packed the main path's way; returns (entry, the kernel's
    starts, freqs, the lanes' counts)."""
    rows, spds, _spans = encode.batch_lanes(got)
    packed, spd, n_nib = (torch.from_numpy(a).to(device)
                          for a in encode.batch_inputs(rows, spds, CHUNK))
    b, n = packed.shape[0], 2 * packed.shape[1]
    live = int((n_nib > 0).sum())
    n_sym = int(n_nib.sum())
    (st_p, fr_p), plain_ms = _plain_run(lit_pass.lit_pass_plain, packed,
                                        spd, n_nib, CHUNK)
    st_k, fr_k = lit_pass.lit_pass(packed, spd, n_nib, CHUNK)
    torch.cuda.synchronize()
    err = _max_err([(st_k, st_p), (fr_k, fr_p)])
    assert err == 0, f"lit_pass kernel differs from its plain version by {err}"
    ms = _cuda_ms(lambda: lit_pass.lit_pass(packed, spd, n_nib, CHUNK), 20)
    longest = int(((n_nib + CHUNK - 1) // CHUNK).max())
    # bytes: each live literal byte read once (2 B), speeds and counts,
    # starts and freqs written once; operations per nibble and per commit
    (n_ops, flat_ops, dense_ops), n_mix = _lit_work(packed, n_nib, CHUNK)
    n_bytes = n_sym + b * 28 + 8 * b * n
    e = _entry(ms, plain_ms, n_bytes, n_ops, err)
    flat = _entry(ms, plain_ms, n_bytes, flat_ops, err)
    dense = _entry(ms, plain_ms, n_bytes, dense_ops, err)
    print(f"[{tag}] lit_pass bound by the work the function needs "
          f"({n_mix} of {n_sym} nibbles mix; the rows each chunk counted): "
          f"{e['bound_ms']:.6f} ms ({n_ops} ops); at the flat "
          f"{LIT_PASS_OPS_PER_NIBBLE_BEFORE} a nibble: {flat['bound_ms']:.6f}"
          f" ms ({flat_ops} ops); with 384 x 16 entries a chunk as well: "
          f"{dense['bound_ms']:.6f} ms ({dense_ops} ops) | {smi}")
    print(f"[{tag}] lit lanes: {b} lanes, {live} live, {n_sym} nibbles, N "
          f"{n}, longest lane {longest} chunks | lit_pass kernel == plain on "
          f"starts, freqs (max_abs_err {err}): kernel {ms:.4f} ms "
          f"({ms / longest * 1e3:.3f} us a chunk of the longest lane), "
          f"plain {plain_ms:.2f} ms, bound {e['bound_ms']:.6f} ms by "
          f"{e['bound_by']} ({e['n_bytes']} B, {e['n_ops']} ops) | "
          f"{cuda_build.ptxas_usage(lit_pass.NAME)} | {smi}")
    return e, st_k, fr_k, n_nib


def _rans_work(fr, counts):
    """(bytes, operations) the rANS encode needs on these lanes: starts
    and freqs of each coded symbol read once, counts, words and flags
    written once over [B, N], states."""
    b, n = fr.shape
    n_sym = int(counts.sum())
    return (8 * n_sym + 4 * b + 3 * b * n + 4 * b,
            RANS_OPS_PER_SYMBOL * n_sym)


def _rans_compare(st, fr, counts, tag: str, lanes: str, smi: str,
                  main=None) -> dict:
    """The rANS encode, kernel against plain, of a model pass's (start,
    freq): equal flags, flagged words, compact header and states.  With
    `main` (the main path's own (starts, freqs, counts), of which these
    lanes are a cut), the entry's ms and bound are the kernel's on those
    lanes, by CUDA events, and the compare's kernel ms goes beside."""
    b, n = st.shape
    n_sym = int(counts.sum())
    (w_p, f_p, s_p), plain_ms = _plain_run(rans_encode.encode_lanes_plain,
                                           st, fr, counts)
    w_k, f_k, s_k = rans_encode.encode_lanes(st, fr, counts)
    h_p = rans_encode.compact_global(w_p, f_p, counts, s_p)[1]
    h_k = rans_encode.compact_global(w_k, f_k, counts, s_k)[1]
    torch.cuda.synchronize()
    flagged = f_k != 0
    err = _max_err([(f_k, f_p), (s_k, s_p), (h_k, h_p),
                    (w_k[flagged], w_p[flagged])])
    assert err == 0, f"encode_lanes kernel differs from its plain version " \
        f"on the {lanes} by {err}"
    ms = _cuda_ms(lambda: rans_encode.encode_lanes(st, fr, counts), 20)
    n_words = int(h_k[0].sum())
    e = _entry(ms, plain_ms, *_rans_work(fr, counts), err)
    main_txt = " | bound"
    if main is not None:
        ms_main = _cuda_ms(lambda: rans_encode.encode_lanes(*main), 5)
        e = dict(_entry(ms_main, plain_ms, *_rans_work(main[1], main[2]),
                        err), compare_ms=ms, compare=lanes)
        main_txt = (f" | the main path's {main[1].shape[0]} lanes "
                    f"({int(main[2].sum())} symbols, N {main[1].shape[1]}):"
                    f" kernel {ms_main:.4f} ms a launch, bound")
    print(f"[{tag}] {lanes}: {b} lanes, {n_sym} symbols, N {n} | "
          f"encode_lanes kernel == plain on flags, flagged words, header, "
          f"states (max_abs_err {err}, {n_words} words): kernel {ms:.4f} "
          f"ms, plain {plain_ms:.2f} ms{main_txt} {e['bound_ms']:.6f} ms by "
          f"{e['bound_by']} ({e['n_bytes']} B, {e['n_ops']} ops); its real "
          f"limit is the serial chain per lane | {smi}")
    return e


def _rans_edge_compare(device, tag: str, smi: str) -> None:
    """The rANS encode, kernel against plain, on lanes outside the model
    passes' contract, so that the producer's tile vote fails and the
    exact signed chain runs: one step each with freq > 2^15, a negative
    start, start + freq > 2^15; a start of 2^31 - 1 at the last step of
    a tile, which leaves the state negative (x >= 1, freq 2^15 - 1) for
    the valid tiles after it; random int32 pairs.  Beside them a valid
    lane, freqs <= 0 (clamped to 1), freq 2^15 with start 0 (the bound
    wraps), an empty lane and counts that end inside a tile.  Rows of N
    = 1024 and 1021 (the 16-byte and the 4-byte copies).  Every word,
    flag and state must be equal."""
    gen = torch.Generator().manual_seed(5)
    i32 = torch.int32
    for n in (1024, 1021):
        b = 9
        fr = torch.randint(1, 2048, (b, n), generator=gen, dtype=i32)
        st = torch.randint(0, 32768 - 2048, (b, n), generator=gen, dtype=i32)
        counts = torch.full((b,), n, dtype=i32)
        fr[1, 700] = 40000
        st[2, 300] = -5
        st[3, 500], fr[3, 500] = 32000, 1000
        st[4, 512], fr[4, 512] = 2**31 - 1, 32767   # tile [512, 768)'s last
        st[5] = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                              dtype=i32)
        fr[5] = torch.randint(-2**31, 2**31 - 1, (n,), generator=gen,
                              dtype=i32)
        fr[6, 100:110], fr[6, 900] = 0, -7
        st[6, 400:420], fr[6, 400:420] = 0, 32768
        counts[7], counts[8] = 0, 600
        st, fr, counts = st.to(device), fr.to(device), counts.to(device)
        (w_p, f_p, s_p), _ms = _plain_run(rans_encode.encode_lanes_plain,
                                          st, fr, counts)
        w_k, f_k, s_k = rans_encode.encode_lanes(st, fr, counts)
        torch.cuda.synchronize()
        err = _max_err([(w_k, w_p), (f_k, f_p), (s_k, s_p)])
        assert err == 0, f"encode_lanes kernel differs from its plain " \
            f"version outside the contract (N {n}) by {err}"
    print(f"[{tag}] encode_lanes kernel == plain on every word, flag and "
          f"state of {b} lanes outside the model passes' contract (the "
          f"exact chain; N 1024 and 1021; max_abs_err 0) | {smi}")


def _stats(**counts) -> dict:
    """encode.STATS with these counts, every other one 0."""
    return dict(dict.fromkeys(encode.STATS, 0), **counts)


def _sum_entries(parts: list[dict]) -> dict:
    """One batch's launches of a kernel as one entry: the times, bytes
    and operations summed, the worst error."""
    return _entry(sum(p["ms"] for p in parts),
                  sum(p["plain_ms"] for p in parts),
                  sum(p["n_bytes"] for p in parts),
                  sum(p["n_ops"] for p in parts),
                  max(p["max_abs_err"] for p in parts))


def phase_encode_compare(corpus: bytes, device, smi: str) -> dict:
    """Both encode kernels against their plain versions on the quality-10
    main path's first batch; returns their entries (max_abs_err, ms,
    plain_ms, bound)."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK)
    got = _first_batch(corpus, opts)
    assert all(g.lit_row is not None for g in got), \
        "a frame's literals left the lit pass"
    tag = "enc-compare"
    print(f"[{tag}] first batch: {len(got)} frames of {MB_SIZE} B, chunk "
          f"{CHUNK}")
    lp, st, fr, n_nib = _lit_pass_compare(got, device, tag, smi)
    _lit_edge_compare(device, tag, smi)
    re_ = _rans_compare(st, fr, n_nib, tag, "lit lanes", smi)
    _rans_edge_compare(device, tag, smi)
    return {"lit_pass": lp, "encode_lanes": re_}


def _encode_runs(data: bytes, ref: bytes, opts, kernels: dict,
                 expect: dict | None, tag: str, smi: str, runs: int = 3,
                 warm: bool = True):
    """One warm encode (when `warm`), then `runs` timed ones through
    divans_tpu_torch.compress, each equal to `ref`.  The launches of
    `kernels` ({entry name: kernel module}) and encode.STATS are counted
    over the first timed run (the counts set to 0 just before it): every
    kernel must have launched and the frame counts must be `expect` (the
    others 0); with expect None, every cmd stream must be coded on the
    host (the hybrid) when native.supports takes the options and none
    otherwise (the uniform lanes), and each stream's counts must sum to
    the frames.  Returns (launches, best MB/s)."""
    if warm:
        assert dt.compress(data, opts) == ref, f"[{tag}] warm encode differs"
    times = []
    for run in range(runs):
        if run == 0:
            for m in kernels.values():
                m.LAUNCHES = 0
            encode.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = dt.compress(data, opts)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if run == 0:
            launches = {k: m.LAUNCHES for k, m in kernels.items()}
            stats = dict(encode.STATS)
        assert blob == ref, f"[{tag}] device encode differs from " \
            "native.compress"
    assert all(launches.values()), f"[{tag}] a kernel never ran: {launches}"
    if expect is not None:
        assert stats == _stats(**expect), stats
    else:
        n = len(fmt.deserialize(ref)[2])
        host = n if native.supports(opts) else 0
        assert stats["cmd_host"] == host and \
            stats["cmd_device"] + stats["cmd_generic"] == n - host and \
            stats["lit_device"] + stats["lit_generic"] == n, stats
    mbps = len(data) / min(times) / 1e6
    print(f"[{tag}] encode e2e {mbps:.2f} MB/s best of {runs}"
          f"{' after a warm one' if warm else ''} "
          f"({', '.join(f'{t:.3f}' for t in times)} s), output == "
          f"the host-only reference | launches {launches} per encode, "
          f"frames {stats} | {smi}")
    return launches, mbps


def phase_encode_main(corpus: bytes, ref: bytes, smi: str) -> dict:
    """The port's encode at full size on the card; returns the kernel
    launches of one encode."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK)
    n = len(fmt.deserialize(ref)[2])
    launches, _mbps = _encode_runs(
        corpus, ref, opts, {"lit_pass": lit_pass, "encode_lanes": rans_encode},
        dict(cmd_host=n, lit_device=n), "enc-main", smi)
    _timed_encode(corpus, ref, opts, "enc-main", smi,
                  split=("lit_pass", "lit_pass_kernel"))
    return launches


def _timed_encode(corpus: bytes, ref: bytes, opts, tag: str, smi: str,
                  split: tuple[str, str] | None = None):
    """One more encode with CUDA events around each batch's device
    stages; prints their device time and the issuing thread's wait.
    `split` = (stage, kernel symbol): the encode runs under
    torch.profiler (CUDA activities), and the stage's time between
    events is split into the kernel's own device time and the rest, the
    card waiting (for the issuing thread, allocations, the launch)."""
    blocks = [corpus[o:o + MB_SIZE] for o in range(0, len(corpus), MB_SIZE)]
    timing: list = []
    prof = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA], acc_events=True)
        if split is not None else contextlib.nullcontext())
    with prof:
        t0 = time.perf_counter()
        frames = encode.compress_frames(blocks, opts, _layout(opts), CHUNK,
                                        torch.device("cuda"), timing=timing)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    assert [(f.cmd, f.lit) for f in frames] == \
        [(f.cmd, f.lit) for f in fmt.deserialize(ref)[2]]
    stage_ms: dict = {}
    for marks, _w in timing:
        for (name, e0), (_n, e1) in zip(marks, marks[1:]):
            stage_ms[name] = stage_ms.get(name, 0.0) + e0.elapsed_time(e1)
    wait_s = sum(w for _m, w in timing)
    stages = ", ".join(f"{k} {v:.1f} ms" for k, v in stage_ms.items())
    print(f"[{tag}] timed encode ({len(timing)} batches, {wall:.3f} s "
          f"wall): {stages} (device timeline); the issuing thread waited "
          f"{wait_s:.3f} s for the host stages | {smi}")
    if split is not None:
        stage, symbol = split
        kernel_us, launches = 0.0, 0
        for ev in prof.key_averages():
            if symbol in ev.key:
                kernel_us += getattr(ev, "device_time_total",
                                     getattr(ev, "cuda_time_total", 0.0))
                launches += ev.count
        total = stage_ms[stage]
        if kernel_us > 0:
            kernel = kernel_us / 1e3
            print(f"[{tag}] {stage} {total:.3f} ms between events (traced "
                  f"encode, {len(timing)} batches): kernel {kernel:.3f} ms "
                  f"on the device ({launches} launches, "
                  f"{kernel / max(launches, 1):.4f} ms each, torch.profiler)"
                  f", the card waiting {total - kernel:.3f} ms "
                  f"({(total - kernel) / total:.1%}) | {smi}")
        else:
            print(f"[{tag}] {stage} {total:.3f} ms between events: kernel "
                  f"device time not measured (the profiler saw none) | "
                  f"{smi}")
    return stage_ms


def _first_group(blob: bytes):
    """The main path's first lane group, built its way (decode_structure,
    lane_jobs, pack_lane_queues) from the container's leading frames:
    frames are taken until the group holds decompress_frames' chunk
    target, and on until every lane has a job (or the frames run out).
    Returns (LaneQueues, n_steps, layout, chunk, n_frames, the lanes that
    have a job)."""
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
    streams, n_lits, lcmaps, spds, _spans = decode.lane_jobs(frames, ready)
    queues, n_steps, _placement = decode.pack_lane_queues(
        streams, n_lits, lcmaps, spds, chunk)
    return (queues, n_steps, layout, chunk, len(ready),
            min(decode.LANES, n_jobs))


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


def _group_work(queues, carry, n_steps: int, s: int):
    """(bytes, operations) one group launch needs.  Bytes: the renorm
    words up to each lane's final cursor, each stream's tables (lcmap,
    speeds, state, count, offset), the luts and perm read once; the
    bytes, the scalars, the committed model and the pend written once.
    Operations: DECODE_OPS_PER_NIBBLE and ADJ_OPS_PER_NIBBLE for each
    decoded nibble, and for each chunk a lane decodes, the premix of 192
    x 16 entries (the averages; the kernel's grid divisions are its own
    choice, not counted) and the commit of 385 x 16."""
    n_lit = queues.n_lit.astype(np.int64)
    n_bytes_dec = int(n_lit.sum())
    lane_chunks = int(((n_lit + s - 1) // s).sum())
    n_streams = int((n_lit > 0).sum())
    lanes = queues.words.shape[0]
    words = int(((carry["cursor"].long() + 1) // 2).sum()) * 4
    out = lanes * n_steps * s + sum(int(v.numel()) * 4 for v in carry.values())
    n_bytes = words + n_streams * (64 + 6 + 3) * 4 + (512 + 384) * 4 + out
    n_ops = ((DECODE_OPS_PER_NIBBLE + ADJ_OPS_PER_NIBBLE) * 2 * n_bytes_dec
             + (PREMIX_OPS_PER_ENTRY * 192 * 16
                + COMMIT_OPS_PER_ENTRY * 385 * 16) * lane_chunks)
    return n_bytes, n_ops, n_bytes_dec, lane_chunks


def phase_compare(blob: bytes, device, tag: str, smi: str,
                  cut: int | None = None) -> dict:
    """The fused decode kernel against the plain group decode on the
    main path's first lane group (every lane that has a job live): equal
    bytes and an equal final carry of every lane; then one launch timed
    back to back.  With `cut`, both run the group's first `cut` chunks
    only (the chunk loop is causal: the kernel's bytes there are checked
    a prefix of the whole launch's), and the launch is timed whole.
    Returns the kernel's entry numbers (max_abs_err, ms, plain_ms,
    bound)."""
    queues, n_steps, layout, chunk, n_frames, n_lanes = _first_group(blob)
    live = int((queues.counts > 0).sum())
    assert live == n_lanes, f"{live} lanes have a job, expected {n_lanes}"
    return _group_compare(queues, n_steps, layout, chunk, device, tag, smi,
                          "first lane group", f" ({n_frames} frames)", cut)


def _group_compare(queues, n_steps: int, layout, chunk: int, device,
                   tag: str, smi: str, what: str, note: str = "",
                   cut: int | None = None):
    """phase_compare on a lane group's queues (decode.LaneQueues) of
    n_steps chunks; `what` (and `note`) name the group on the printed
    line."""
    q, perm, n_pass = decode.group_inputs(queues, chunk, layout, device)
    s = chunk // 2
    live = int((q["counts"] > 0).sum())
    n_cmp = n_steps if cut is None else min(cut, n_steps)
    (out_p, carry_p), plain_ms = _plain_run(lit_decode.decode_group_plain,
                                            q, perm, n_pass, n_cmp, s)
    out_k, carry_k = lit_decode.decode_group(q, perm, n_pass, n_cmp, s)
    torch.cuda.synchronize()
    assert set(carry_k) == set(carry_p) == set(lit_decode.CARRY)
    errs = {k: _max_err([(carry_k[k], carry_p[k])]) for k in lit_decode.CARRY}
    errs["bytes"] = _max_err([(out_k, out_p)])
    max_err = max(errs.values())
    assert max_err == 0, f"[{tag}] decode_group differs from its plain " \
        f"version: {errs}"
    ms = _cuda_ms(lambda: lit_decode.decode_group(q, perm, n_pass, n_steps,
                                                  s), 5)
    if n_cmp < n_steps:
        out_f, carry_k = lit_decode.decode_group(q, perm, n_pass, n_steps, s)
        assert torch.equal(out_f[:, :n_cmp * s], out_k), \
            f"[{tag}] the cut's bytes are not a prefix of the whole launch's"
    n_bytes, n_ops, n_dec, lane_chunks = _group_work(queues, carry_k,
                                                     n_steps, s)
    e = _entry(ms, plain_ms, n_bytes, n_ops, max_err)
    if n_cmp < n_steps:
        e["compare"] = f"the {what}'s first {n_cmp} chunks"
    print(f"[{tag}] {what}{note}: {n_steps} chunks "
          f"x {out_k.shape[0]} lanes (compared on {n_cmp}), {live} lanes "
          f"with a job, {n_dec} "
          f"bytes decoded over {lane_chunks} lane-chunks, {n_pass} renorm "
          f"passes a commit | decode_group kernel == plain on the bytes and "
          f"every lane's final carry ({', '.join(lit_decode.CARRY)}; "
          f"max_abs_err {max_err}): kernel {ms:.4f} ms a launch "
          f"({ms / n_steps * 1e3:.2f} us a chunk), plain {plain_ms:.2f} ms, "
          f"bound {e['bound_ms']:.6f} ms by {e['bound_by']} "
          f"({e['n_bytes']} B, {e['n_ops']} ops) | {smi}")
    return e


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
            decode.reset_stats()
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
    assert {k: stats[k] for k in DECODE_FRAMES} == {
        "device_frames": n_frames, "host_frames": 0, "golden_frames": 0}, \
        stats
    mbps = len(corpus) / min(times) / 1e6

    # one more decode with CUDA events around each group's launch, then
    # the host stages alone: the structure pass on the decode's 8
    # threads, and the CRC check
    _w, _mb, frames, crc, flags = fmt.deserialize(blob)
    chunk = flags_to_chunk(flags)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    timing: list = []
    t0 = time.perf_counter()
    raw = decode.decompress_frames(frames, chunk, layout, device,
                                   timing=timing)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert raw == corpus
    kernel_ms = sum(e[0].elapsed_time(e[1]) for e, _h in timing)
    issue_ms = sum(h for _e, h in timing) * 1e3
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda f: decode.decode_structure(f, chunk, layout),
                    frames))
    t_struct = time.perf_counter() - t0
    t0 = time.perf_counter()
    fmt.check_crc(raw, crc)
    t_crc = time.perf_counter() - t0
    print(f"[dec-main] decode e2e {mbps:.2f} MB/s best of 3 after a warm one "
          f"({', '.join(f'{t:.3f}' for t in times)} s) | kernel launches "
          f"{launches} per decode (one a lane group), frames {stats} | {smi}")
    print(f"[dec-main] timed decode ({wall:.3f} s wall, CRC not included): "
          f"kernel {kernel_ms:.1f} ms over {len(timing)} group launches "
          f"({kernel_ms / len(timing):.4f} ms each, device timeline); host "
          f"time issuing the groups {issue_ms:.1f} ms | host stages alone: "
          f"structure pass {t_struct:.3f} s on 8 threads, CRC {t_crc:.3f} s "
          f"| {smi}")
    return launches


ROUTE_CMP_CHUNKS = 16    # [dec-routes]: kernel 1 against plain, two segments
ROUTE_SEG_CHUNKS = 64    # the kernel resumed over the whole group, a segment
ROUTE_ORACLE_BYTES = 4096   # decode_literals_np on each stream's head
# each route by the reference's environment variables
ROUTES = (("resume", dict(DIVANS_DEC_RESUME="1")),
          ("resume qpl2", dict(DIVANS_DEC_RESUME="1", DIVANS_DEC_QPL="2")),
          ("qpl2", dict(DIVANS_DEC_QPL="2")),
          ("qpl3", dict(DIVANS_DEC_QPL="3")),
          ("backlog0", dict(DIVANS_DEC_BACKLOG="0")),
          ("backlog3", dict(DIVANS_DEC_BACKLOG="3")))


def _carry_errs(got: dict, want: dict) -> dict:
    assert set(got) == set(want) == set(lit_decode.CARRY)
    return {k: _max_err([(got[k], want[k])]) for k in lit_decode.CARRY}


@contextlib.contextmanager
def _environ(env: dict):
    """The variables of env set in os.environ, and restored after."""
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def _timed_decode_route(blob: bytes, device, timing: list) -> bytes:
    """divans_tpu_torch.decompress of a deferred container with CUDA
    events around each launch: as api.decompress (the layout from the
    container's flags, decode.decompress_frames reading the route's
    variables, the CRC checked), with decompress_frames' timing list."""
    _w, _mb, frames, crc, flags = fmt.deserialize(blob)
    layout = ModelLayout(PROFILES[FLAG_PROFILES[flags & 0b11]],
                         lo_bucketed=True)
    raw = decode.decompress_frames(frames, flags_to_chunk(flags), layout,
                                   device, timing)
    fmt.check_crc(raw, crc)
    return raw


def _route_runs(blob: bytes, corpus: bytes, device, env: dict):
    """One route, its variables set: a warm decode with CUDA events around
    each launch and the counts set to 0 just before it (launches, frames
    by path, kernel ms a launch), then three timed decodes through
    divans_tpu_torch.decompress; each equal to the corpus.  Returns (MB/s
    best of 3, launches, STATS, ms a launch, seconds)."""
    with _environ(env):
        _launches_zeroed()
        decode.reset_stats()
        timing: list = []
        assert _timed_decode_route(blob, device, timing) == corpus, env
        torch.cuda.synchronize()
        launches = lit_decode.LAUNCHES
        stats = dict(decode.STATS)
        assert len(timing) == launches, (len(timing), launches)
        ms = (sum(e[0].elapsed_time(e[1]) for e, _h in timing) / len(timing)
              if timing else 0.0)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = dt.decompress(blob)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            assert raw == corpus, f"route {env} differs from the corpus"
    return len(corpus) / min(times) / 1e6, launches, stats, ms, times


def _resume_compare(blob: bytes, device, smi: str) -> dict:
    """Kernel 1 resumed from a carry on the main path's first lane group:
    two segments of ROUTE_CMP_CHUNKS chunks from idle_carry, the kernel
    against its plain version (bytes and every carry field); then the
    kernel over the whole group in segments of ROUTE_SEG_CHUNKS against
    one launch (bytes and carry), timed a segment launch.  Returns the
    entry (ms and bound a segment launch; plain ms of the compare's two
    segments)."""
    queues, n_steps, layout, chunk, n_frames, _n = _first_group(blob)
    q, perm, n_pass = decode.group_inputs(queues, chunk, layout, device)
    s = chunk // 2
    lanes = queues.words.shape[0]

    def two_segments(fn, q, perm):
        carry, outs = lit_decode.idle_carry(lanes, q["words"].device), []
        for _ in range(2):
            out, carry = fn(q, perm, n_pass, ROUTE_CMP_CHUNKS, s, carry=carry)
            outs.append(out)
        return torch.cat(outs, dim=1), carry

    (out_p, carry_p), plain_ms = _plain_run(
        two_segments, lit_decode.decode_group_plain, q, perm)
    out_k, carry_k = two_segments(lit_decode.decode_group, q, perm)
    torch.cuda.synchronize()
    errs = _carry_errs(carry_k, carry_p)
    errs["bytes"] = _max_err([(out_k, out_p)])
    # the idle start decodes what the preloaded start decodes
    head, _c = lit_decode.decode_group(q, perm, n_pass, 2 * ROUTE_CMP_CHUNKS,
                                       s)
    errs["bytes vs one launch"] = _max_err([(out_k, head)])
    assert max(errs.values()) == 0, f"[dec-routes] resumed kernel 1 " \
        f"differs from its plain version: {errs}"

    bounds = list(range(0, n_steps, ROUTE_SEG_CHUNKS)) + [n_steps]

    def segmented():
        carry, outs = None, []
        for lo, hi in zip(bounds, bounds[1:]):
            out, carry = lit_decode.decode_group(q, perm, n_pass, hi - lo, s,
                                                 carry=carry)
            outs.append(out)
        return torch.cat(outs, dim=1), carry

    whole, carry_w = lit_decode.decode_group(q, perm, n_pass, n_steps, s)
    out_s, carry_s = segmented()
    torch.cuda.synchronize()
    seg_errs = _carry_errs(carry_s, carry_w)
    seg_errs["bytes"] = _max_err([(out_s, whole)])
    assert max(seg_errs.values()) == 0, f"[dec-routes] the segmented " \
        f"kernel differs from one launch: {seg_errs}"
    n_seg = len(bounds) - 1
    seg_ms = _cuda_ms(segmented, 3) / n_seg
    one_ms = _cuda_ms(lambda: lit_decode.decode_group(q, perm, n_pass,
                                                      n_steps, s), 3)
    # a segment launch: its share of the group's work, and the carry it
    # reads (every segment after the first) beside the one it writes
    n_bytes, n_ops, n_dec, lane_chunks = _group_work(queues, carry_w,
                                                     n_steps, s)
    carry_bytes = sum(int(v.numel()) * 4 for v in carry_w.values())
    e = _entry(seg_ms, plain_ms,
               (n_bytes + (n_seg - 1) * carry_bytes) // n_seg,
               n_ops // n_seg, max(max(errs.values()), max(seg_errs.values())))
    e["compare"] = (f"the first lane group's first {2 * ROUTE_CMP_CHUNKS} "
                    f"chunks as two segments from idle_carry (plain_ms), and "
                    f"the whole group in {n_seg} segments of "
                    f"{ROUTE_SEG_CHUNKS} against one launch")
    print(f"[dec-routes] kernel 1 resumed from a carry, first lane group "
          f"({n_frames} frames, {n_steps} chunks x {lanes} lanes, {n_dec} "
          f"bytes over {lane_chunks} lane-chunks): two segments of "
          f"{ROUTE_CMP_CHUNKS} chunks from idle_carry, kernel == plain on the "
          f"bytes and every carry field ({', '.join(lit_decode.CARRY)}) and "
          f"== one launch's first {2 * ROUTE_CMP_CHUNKS} chunks (max_abs_err "
          f"{max(errs.values())}; plain {plain_ms:.2f} ms); {n_seg} segments "
          f"of {ROUTE_SEG_CHUNKS} == one launch on the bytes and carry "
          f"(max_abs_err {max(seg_errs.values())}): {seg_ms:.4f} ms a "
          f"segment launch, {seg_ms * n_seg:.4f} ms in all against "
          f"{one_ms:.4f} ms for one launch; bound {e['bound_ms']:.6f} ms a "
          f"segment by {e['bound_by']} | {smi}")
    return e


def _oracle_compare(blob: bytes, device, smi: str) -> None:
    """decode_literals_batch on the card (one stream a lane) against the
    numpy oracle decode_literals_np on the head of the container's first
    two literal sub-streams (decoding is causal, so a head is a
    prefix)."""
    _w, _mb, frames, _crc, flags = fmt.deserialize(blob)
    chunk = flags_to_chunk(flags)
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    scripts = decode.decode_structures(frames[:2], chunk, layout)
    assert scripts is not None, "a leading frame left the envelope"
    streams, n_lits, lcmaps, spds, _spans = decode.lane_jobs(
        frames, list(enumerate(scripts)))
    streams, n_lits = streams[:2], n_lits[:2]
    assert len(streams) == 2, "fewer than two literal sub-streams"
    got = decode.decode_literals_batch(streams, n_lits, lcmaps[:2], spds[:2],
                                       chunk, layout, device)
    t0 = time.perf_counter()
    for g, st, n, lc, sp in zip(got, streams, n_lits, lcmaps, spds):
        k = min(n, ROUTE_ORACLE_BYTES)
        assert g[:k] == decode.decode_literals_np(st, k, lc, sp, chunk), \
            "[dec-routes] decode_literals_batch differs from the oracle"
    print(f"[dec-routes] decode_literals_batch on the card == "
          f"decode_literals_np on the first {ROUTE_ORACLE_BYTES} bytes of "
          f"{len(streams)} sub-streams ({n_lits} bytes each; the oracle "
          f"{time.perf_counter() - t0:.1f} s) | {smi}")


def phase_routes(blob: bytes, corpus: bytes, device, smi: str):
    """[dec-routes]: the decode's opt-in routes on the q10 container.
    Kernel 1 resumed from a carry (_resume_compare); the numpy oracle;
    each route of ROUTES (its variables set) beside the default route,
    decoded the same way in this phase (each equal to the corpus: frames
    by path, launches, MB/s best of 3 of divans_tpu_torch.decompress
    after a warm run); one more divans_tpu_torch.decompress with
    DIVANS_DEC_RESUME=1 set, whose launches must equal its segments.
    Returns (the resume entry, the resume route's launches)."""
    t_all = time.perf_counter()
    entry = _resume_compare(blob, device, smi)
    _oracle_compare(blob, device, smi)
    base = _route_runs(blob, corpus, device, {})
    print(f"[dec-routes] default (grouped) route: {base[0]:.2f} MB/s best "
          f"of 3 ({', '.join(f'{t:.3f}' for t in base[4])} s) | launches "
          f"{base[1]} ({base[3]:.4f} ms each, device timeline) | frames "
          f"{base[2]} | {smi}")
    launches = None
    for name, env in ROUTES:
        mbps, n, stats, ms, times = _route_runs(blob, corpus, device, env)
        if name == "resume":
            launches = n
            assert n > 0, "the resume route never launched the kernel"
        if env.get("DIVANS_DEC_BACKLOG") == "0":
            assert n == 0 and stats["host_frames"] == sum(stats.values())
        print(f"[dec-routes] {name} {env}: == the corpus, {mbps:.2f} MB/s "
              f"best of 3 ({', '.join(f'{t:.3f}' for t in times)} s) beside "
              f"the default's {base[0]:.2f} ({mbps / base[0]:.3f}x) | "
              f"launches {n}{f' ({ms:.4f} ms each)' if n else ''} | frames "
              f"{stats} | {smi}")
    # the environment reaches the route through the entry point
    _launches_zeroed()
    tracelog.clear()
    tracelog.enable()
    try:
        with _environ(dict(DIVANS_DEC_RESUME="1")):
            raw = dt.decompress(blob)
    finally:
        tracelog.enable(False)
    n_seg = sum(ev.name == "decode/segment" for ev in tracelog.events())
    tracelog.clear()
    assert raw == corpus, "DIVANS_DEC_RESUME=1 decode differs"
    assert 0 < n_seg == lit_decode.LAUNCHES, (n_seg, lit_decode.LAUNCHES)
    print(f"[dec-routes] divans_tpu_torch.decompress with DIVANS_DEC_RESUME=1"
          f": == the corpus, {lit_decode.LAUNCHES} launches == {n_seg} "
          f"segments | phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return entry, launches


def q11_options():
    return dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK,
                            quality=11)


def phase_q11_reference(corpus16: bytes) -> bytes:
    """The quality-11 corpus's container from the host-only path
    (native.compress at quality 11): the bytes its device encode must
    equal."""
    t0 = time.perf_counter()
    blob = native.compress(corpus16, q11_options())
    t_enc = time.perf_counter() - t0
    print(f"[q11-reference] native.compress quality 11 (host only, the "
          f"dictionary index included): {len(corpus16)} bytes -> "
          f"{len(blob)} ({len(blob) / len(corpus16):.4f}), "
          f"{len(fmt.deserialize(blob)[2])} frames, {t_enc:.2f} s")
    return blob


def phase_q11_compare(corpus16: bytes, device, smi: str) -> dict:
    """The three encode kernels against their plain versions on the
    quality-11 main path's first batch, packed its way: the cmd model
    pass and the rANS encode on the cmd lanes, the literal model pass
    and the rANS encode on the lit lanes.  Returns their entries, the
    rANS encode's two launches summed."""
    got = _first_batch(corpus16, q11_options())
    assert all(g.lit_row is not None for g in got), \
        "a frame's literals left the lit pass"
    tag = "q11-compare"
    print(f"[{tag}] first batch: {len(got)} frames of {MB_SIZE} B")
    cmd, st_k, fr_k, n_steps = _cmd_pass_compare(got, device, tag, smi)
    _cmd_edge_compare(device, tag, smi)
    re_cmd = _rans_compare(st_k, fr_k, n_steps, tag, "cmd lanes", smi)
    lp, st, fr, n_nib = _lit_pass_compare(got, device, tag, smi)
    re_lit = _rans_compare(st, fr, n_nib, tag, "lit lanes", smi)
    return {"cmd_pass": cmd, "lit_pass": lp,
            "encode_lanes": _sum_entries([re_cmd, re_lit])}


def _cmd_work(packed, n_steps, r: int, s: int):
    """(operations the cmd pass needs, the same at the integer unit's
    division, CMD_PASS_OPS_PER_STEP_BEFORE a step, and counted the old
    way).  CMD_PASS_OPS_PER_STEP a step; for each chunk that a later
    chunk of its lane commits, CMD_PASS_OPS_PER_ENTRY x 16 for each row
    it counted and one comparison for each of the R rows it did not.
    The old way took R x 16 entries for every chunk of every lane."""
    p = packed.cpu().numpy().astype(np.int64)
    counted = other = lane_chunks = 0
    for i, k in enumerate(n_steps.cpu().tolist()):
        if k == 0:
            continue
        lane_chunks += -(-k // s)
        q = p[i, :k]
        chunk_of = np.arange(k) // s
        sel = (((q >> 12) & 1) != 0) & (chunk_of < chunk_of[-1])
        rows = np.unique(chunk_of[sel] * 256 + (q[sel] & 0xFF))
        counted += int((rows % 256 < r).sum())
        other += int(chunk_of[-1]) * r
    other -= counted
    n_sym = int(n_steps.sum())
    commit = CMD_PASS_OPS_PER_ENTRY * 16 * counted + other
    return (CMD_PASS_OPS_PER_STEP * n_sym + commit,
            CMD_PASS_OPS_PER_STEP_BEFORE * n_sym + commit,
            CMD_PASS_OPS_PER_STEP_BEFORE * n_sym
            + CMD_PASS_OPS_PER_ENTRY * r * 16 * lane_chunks)


def _lit_work(packed, n_nib, chunk: int):
    """Operations of the lit pass: (what the function needs, the same at
    the flat per-nibble count of integer divisions it replaces, and that
    count with a dense commit).  LIT_PASS_OPS_PER_NIBBLE a nibble
    and LIT_PASS_OPS_PER_MIX_NIBBLE more a nibble that mixes (an active
    byte with its mix bit); for each chunk that a later chunk of its lane
    commits, LIT_PASS_OPS_PER_ENTRY x 16 for each of the two model rows
    of each count row it counted, and one comparison for each other of
    the 384 model rows.  The dense count took 384 x 16 entries for every
    chunk of every lane."""
    p = packed.cpu().numpy().astype(np.int64)
    s = chunk // 2
    counted = other = lane_chunks = n_mix = 0
    for i, k in enumerate(n_nib.cpu().tolist()):
        if k == 0:
            continue
        lane_chunks += -(-k // chunk)
        last = (k - 1) // chunk   # the lane's last chunk, never committed
        q = p[i, :k // 2]
        n_mix += 2 * int(((q >> 14) & (q >> 15) & 1).sum())
        chunk_of = np.arange(q.shape[0]) // s
        sel = (((q >> 14) & 1) != 0) & (chunk_of < last)
        ctx, hi = q[sel] & 63, (q[sel] >> 6) & 15
        keys = np.concatenate([chunk_of[sel] * 192 + ctx,
                               chunk_of[sel] * 192 + 64 + (ctx >> 3) * 16
                               + hi])
        counted += 2 * len(np.unique(keys))
        other += last * 384
    other -= counted
    n_sym = int(n_nib.sum())
    commit = LIT_PASS_OPS_PER_ENTRY * 16 * counted + other
    return (LIT_PASS_OPS_PER_NIBBLE * n_sym
            + LIT_PASS_OPS_PER_MIX_NIBBLE * n_mix + commit,
            LIT_PASS_OPS_PER_NIBBLE_BEFORE * n_sym + commit,
            LIT_PASS_OPS_PER_NIBBLE_BEFORE * n_sym
            + LIT_PASS_OPS_PER_ENTRY * 384 * 16 * lane_chunks), n_mix


def _cmd_pass_compare(got, device, tag: str, smi: str):
    """The cmd model pass, kernel against plain, on the batch's cmd
    lanes, packed the main path's way (every frame's cmd stream on the
    cmd pass); returns (entry, the kernel's starts, freqs, the lanes'
    counts)."""
    assert all(g.cmd_row is not None for g in got), \
        "a frame's cmd stream left the cmd pass"
    s = cmd_chunk(CHUNK)
    packed, inc, lim, n_steps = (
        torch.from_numpy(a).to(device)
        for a in encode.cmd_batch_inputs(got, s))
    b, n = packed.shape
    r = inc.shape[1]
    live = int((n_steps > 0).sum())
    assert live == b == len(got), (live, b)
    (st_p, fr_p), plain_ms = _plain_run(cmd_pass.cmd_pass_plain, packed,
                                        inc, lim, n_steps, s)
    st_k, fr_k = cmd_pass.cmd_pass(packed, inc, lim, n_steps, s)
    torch.cuda.synchronize()
    err = _max_err([(st_k, st_p), (fr_k, fr_p)])
    assert err == 0, f"cmd_pass kernel differs from its plain version by {err}"
    ms = _cuda_ms(lambda: cmd_pass.cmd_pass(packed, inc, lim, n_steps, s), 20)
    n_sym = int(n_steps.sum())
    # bytes: each step read once (2 B), the row speeds and counts, starts
    # and freqs written once over [B, N]
    n_ops, int_ops, dense_ops = _cmd_work(packed, n_steps, r, s)
    cmd = _entry(ms, plain_ms, 2 * n_sym + 8 * b * r + 4 * b + 8 * b * n,
                 n_ops, err)
    before = _entry(ms, plain_ms, cmd["n_bytes"], int_ops, err)
    dense = _entry(ms, plain_ms, cmd["n_bytes"], dense_ops, err)
    print(f"[{tag}] cmd_pass bound by the rows each chunk counted, FP64 "
          f"divisions: {cmd['bound_ms']:.6f} ms ({n_ops} ops); with the "
          f"divisions at the integer unit's ~25 (PR 6-7's count): "
          f"{before['bound_ms']:.6f} ms ({int_ops} ops); R x 16 entries a "
          f"chunk as well: {dense['bound_ms']:.6f} ms ({dense_ops} ops) | "
          f"{smi}")
    print(f"[{tag}] cmd lanes: {b} lanes, {live} live, {n_sym} cmd steps, "
          f"N {n}, {r} rows, chunk {s} steps | cmd_pass kernel == plain on "
          f"starts, freqs (max_abs_err {err}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {cmd['bound_ms']:.6f} ms by "
          f"{cmd['bound_by']} ({cmd['n_bytes']} B, {cmd['n_ops']} ops) | "
          f"{smi}")
    return cmd, st_k, fr_k, n_steps


def phase_q11_main(corpus16: bytes, ref: bytes, smi: str) -> dict:
    """The quality-11 encode (uniform device lanes) at full size on the
    card; returns the kernel launches of one encode."""
    opts = q11_options()
    n = len(fmt.deserialize(ref)[2])
    launches, _mbps = _encode_runs(
        corpus16, ref, opts, {"cmd_pass": cmd_pass, "lit_pass": lit_pass,
                              "encode_lanes": rans_encode},
        dict(cmd_device=n, lit_device=n), "q11-main", smi)
    _timed_encode(corpus16, ref, opts, "q11-main", smi)
    return launches


def phase_q11_roundtrip(blob: bytes, corpus16: bytes, smi: str) -> int:
    """The quality-11 container decoded on the card; returns the kernel
    launches of that decode."""
    n_frames = len(fmt.deserialize(blob)[2])
    lit_decode.LAUNCHES = 0
    decode.reset_stats()
    t0 = time.perf_counter()
    raw = dt.decompress(blob)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert raw == corpus16, "quality-11 round trip differs"
    assert {k: decode.STATS[k] for k in DECODE_FRAMES} == {
        "device_frames": n_frames, "host_frames": 0, "golden_frames": 0}, \
        decode.STATS
    launches = lit_decode.LAUNCHES
    assert launches > 0, "the quality-11 decode never launched the kernel"
    print(f"[q11-roundtrip] decompress on the card == the {len(raw)}-byte "
          f"corpus, {len(raw) / wall / 1e6:.2f} MB/s (one run), frames "
          f"{decode.STATS}, {launches} kernel launches | {smi}")
    return launches


# ------------------------------------------- the generic deferred pass

def mix_options(**kw):
    """The mix profile: a forced stride of 4 with the context map."""
    return dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK,
                            force_stride_value=4, **kw)


def stride_options():
    """The stride profile, the CLI's -nocm: no context map, no mixing."""
    return dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK,
                            use_context_map=False, dynamic_context_mixing=0)


def phase_profile_reference(data: bytes, opts, tag: str):
    """The container of `data` from the host-only path (native.compress)
    on these options: the bytes the device encode must equal.  Returns
    (blob, seconds)."""
    t0 = time.perf_counter()
    blob = native.compress(data, opts)
    t_enc = time.perf_counter() - t0
    print(f"[{tag}] native.compress (host C++ only), profile "
          f"{profile_for_options(opts)}, quality {opts.quality}: {len(data)} "
          f"bytes -> {len(blob)} ({len(blob) / len(data):.4f}), "
          f"{len(fmt.deserialize(blob)[2])} frames, {t_enc:.2f} s "
          f"({len(data) / t_enc / 1e6:.2f} MB/s)")
    return blob, t_enc


def _generic_work(trace, counts, s: int):
    """(bytes, operations, the operations at PR 6-7's prices) the generic
    pass needs on these lanes: each live step's 40 B of trace read once,
    the counts, starts and freqs written once over [B, N];
    GENERIC_OPS_PER_STEP a live step, the mix steps' extra, and
    GENERIC_OPS_PER_COMMIT for each row a chunk touched that a later
    chunk of its lane commits."""
    b, n = trace.shape[:2]
    n_sym = n_mix = commits = 0
    for i, k in enumerate(counts.tolist()):
        if k == 0:
            continue
        t = trace[i, :k]
        chunk_of = np.arange(k) // s
        later = chunk_of < chunk_of[-1]   # the lane's last chunk never commits
        mix = t[:, 5] != 0
        hit = (t[:, 3] != 0) & later
        cm_hit = mix & (t[:, 8] != 0) & later
        keys = np.concatenate([chunk_of[hit] * (1 << 20) + t[hit, 0],
                               chunk_of[cm_hit] * (1 << 20) + t[cm_hit, 7]])
        n_sym += k
        n_mix += int(mix.sum())
        commits += len(np.unique(keys))
    step, mix_step, commit = GENERIC_OPS_BEFORE
    return (40 * n_sym + 4 * b + 8 * b * n,
            GENERIC_OPS_PER_STEP * n_sym + GENERIC_OPS_PER_MIX_STEP * n_mix
            + GENERIC_OPS_PER_COMMIT * commits,
            step * n_sym + mix_step * n_mix + commit * commits)


def _generic_compare(got, opts, device, tag: str, smi: str,
                     job: str = "lit_generic"):
    """The generic deferred pass, kernel against plain, on the batch's
    lanes for it (its `job`, "lit_generic" or "cmd_generic", built by
    batch_jobs as the main path builds it); returns (entry, the kernel's starts, freqs, the
    lanes' counts).  The kernel is launched as the main path launches
    it: host_frame range-checked the lanes, so no check on the card."""
    jobs, _places = encode.batch_jobs(got, range(len(got)), _layout(opts),
                                      CHUNK)
    (arrays, (r, s)), = [(a, p) for name, a, p in jobs if name == job]
    return _generic_lanes_compare(
        arrays, r, s, device, tag, smi,
        f"first batch: {len(got)} frames of {MB_SIZE} B | {job} lanes")


def _generic_lanes_compare(arrays, r: int, s: int, device, tag: str,
                           smi: str, what: str):
    """_generic_compare on these lanes (host arrays: trace int32 [B, N,
    10], counts int32 [B]; range-checked on the host) with r rows at
    chunk s; `what` names them on the printed line."""
    trace, counts = (torch.from_numpy(a).to(device) for a in arrays)
    b, n = trace.shape[:2]
    host = b * r * 16 <= HOST_PLAIN_ENTRIES
    (st_p, fr_p), plain_ms = _plain_run(deferred_pass.deferred_pass_plain,
                                        trace, counts, r, s, host=host)
    st_k, fr_k = deferred_pass.deferred_pass(trace, counts, r, s,
                                             checked=True)
    torch.cuda.synchronize()
    err = _max_err([(st_k, st_p), (fr_k, fr_p)])
    assert err == 0, f"deferred_pass kernel differs from its plain version " \
        f"by {err}"
    ms = _cuda_ms(lambda: deferred_pass.deferred_pass(trace, counts, r, s,
                                                      checked=True), 10)
    n_bytes, n_ops, int_ops = _generic_work(*arrays, s)
    e = _entry(ms, plain_ms, n_bytes, n_ops, err)
    before = _entry(ms, plain_ms, n_bytes, int_ops, err)
    print(f"[{tag}] deferred_pass bound with FP64 divisions: "
          f"{e['bound_ms']:.6f} ms by {e['bound_by']} ({n_ops} ops); with "
          f"the divisions at the integer unit's ~25 (PR 6-7's count): "
          f"{before['bound_ms']:.6f} ms by {before['bound_by']} ({int_ops} "
          f"ops) | {smi}")
    live = int((counts > 0).sum())
    print(f"[{tag}] {what}: {b} lanes, {live} live, {int(counts.sum())} "
          f"steps, N "
          f"{n}, {r} rows, chunk {s} | deferred_pass kernel == plain on "
          f"starts, freqs (max_abs_err {err}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms (on the {'host' if host else 'card'}), bound "
          f"{e['bound_ms']:.6f} ms by {e['bound_by']} ({e['n_bytes']} B, "
          f"{e['n_ops']} ops) | {smi}")
    return e, st_k, fr_k, counts


def generic_edge_lanes(s: int, seed: int = 11):
    """Lanes for kernel 5 at chunk s (numpy, seeded), with their row
    count 4s + 8: every step mixing on distinct rows, so that each chunk
    touches 2s rows (at s = 1024, more than the kernel's fold area holds
    at once); one row and one cm row hit by every step; a random lane
    with a ragged end; an empty lane; touched rows driven to the 24-pass
    cap; the mixer weights driven to their clamps."""
    rng = np.random.default_rng(seed + s)
    r = 4 * s + 8

    def lane(n, mix=1.0):
        t = np.zeros((n, 10), np.int32)
        t[:, 0] = rng.integers(0, 2 * s, n)
        t[:, 1] = rng.integers(0, 16, n)
        t[:, 2] = 1
        t[:, 3] = rng.integers(1, 64, n)
        t[:, 4] = rng.integers(64, 0x7000, n)
        t[:, 5] = rng.random(n) < mix
        t[:, 6] = rng.integers(0, 2, n)
        t[:, 7] = rng.integers(2 * s, 4 * s, n)
        t[:, 8] = rng.integers(1, 64, n)
        t[:, 9] = rng.integers(64, 0x7000, n)
        return t

    distinct = lane(4 * s)
    for c in range(4):
        distinct[c * s:(c + 1) * s, 0] = rng.permutation(2 * s)[:s]
        distinct[c * s:(c + 1) * s, 7] = 2 * s + rng.permutation(2 * s)[:s]
    hot = lane(3 * s)
    hot[:, 0], hot[:, 7] = 3, 4 * s + 5
    capped = lane(5 * s, mix=0.0)
    capped[:, 3], capped[:, 4] = 1 << 21, 64
    capped[:, 0] = rng.integers(0, 4, capped.shape[0])
    clamps = lane(4 * s)
    clamps[:, 1], clamps[:, 3], clamps[:, 6], clamps[:, 7] = 3, 0, 1, 2 * s
    clamps[:, 8], clamps[:, 9] = 64, 0x7000
    return [distinct, hot, lane(3 * s + s // 2, mix=0.5),
            np.zeros((0, 10), np.int32), capped, clamps], r


def _generic_edge_compare(device, tag: str, smi: str) -> None:
    """Kernel 5 against its plain version on generic_edge_lanes at s =
    16, 256 and 1024: equal starts and freqs."""
    for s in (16, 256, 1024):
        lanes, r = generic_edge_lanes(s)
        trace, counts = (torch.from_numpy(a).to(device)
                         for a in encode.generic_inputs(lanes, s))
        (st_p, fr_p), _ms = _plain_run(deferred_pass.deferred_pass_plain,
                                       trace, counts, r, s)
        st_k, fr_k = deferred_pass.deferred_pass(trace, counts, r, s)
        torch.cuda.synchronize()
        err = _max_err([(st_k, st_p), (fr_k, fr_p)])
        assert err == 0, f"deferred_pass kernel differs from its plain " \
            f"version on the edge lanes at s {s} by {err}"
    assert deferred_pass.build().dtpu_deferred_pass_smem(1024) == \
        deferred_pass.shared_bytes(1024)
    print(f"[{tag}] deferred_pass kernel == plain on starts, freqs of "
          f"{len(lanes)} edge lanes at s 16, 256 and 1024 (2s rows a chunk, "
          f"a row hit by every step, the renorm cap, the weight clamps; "
          f"max_abs_err 0; {deferred_pass.shared_bytes(1024)} B of shared "
          f"memory at s 1024) | {smi}")


def cmd_edge_lanes(s: int, seed: int = 12):
    """Lanes for kernel 4 at chunk s over 256 rows (numpy, seeded):
    (packed steps, inc, lim, step counts).  Two lanes hit a third of
    their rows in turn (rows r with r % 3 == chunk % 3), so a row is
    coded against only after two commits: one with lim 0xA000, whose
    commits leave entry 15 at or above 0x8000 every few turns; one with
    inc 2^22, whose rows hit the 24-pass cap and stay above 0x8000.
    Beside them a renorm-heavy lane over all 256 rows, a ragged lane
    with inactive steps and an empty lane."""
    rng = np.random.default_rng(seed + s)
    r = cmd_pass.MAX_ROWS
    n = 30 * s

    def steps(rows, act):
        return (rows | rng.integers(0, 16, rows.shape[0]) << 8
                | act.astype(np.int64) << 12).astype(np.uint16)

    chunk_of = np.arange(n) // s
    turns = 3 * rng.integers(0, 4, n) + chunk_of % 3
    # 32768 // s: a row's commit adds ~8192 to its entry 15
    lanes = [(steps(turns, np.ones(n, bool)), 32768 // s, 0xA000),
             (steps(turns, np.ones(n, bool)), 1 << 22, 0x8000),
             (steps(rng.integers(0, r, n), rng.random(n) < 0.8), 700, 4096),
             (steps(rng.integers(0, r, n), rng.random(n) < 0.3), 24, 0x2000),
             (steps(rng.integers(0, r, n), np.ones(n, bool)), 16, 0x2000)]
    packed = np.stack([p for p, _i, _l in lanes])
    inc = np.stack([np.full(r, i, np.int32) for _p, i, _l in lanes])
    lim = np.stack([np.full(r, lm, np.int32) for _p, _i, lm in lanes])
    counts = np.array([n, n, n, n - s - 7, 0], np.int32)
    return packed, inc, lim, counts


def _cmd_edge_compare(device, tag: str, smi: str) -> None:
    """Kernel 4 against its plain version on cmd_edge_lanes at s = 16,
    64 and 256: equal starts and freqs."""
    for s in (16, cmd_chunk(CHUNK), 256):
        packed, inc, lim, counts = (torch.from_numpy(a).to(device)
                                    for a in cmd_edge_lanes(s))
        (st_p, fr_p), _ms = _plain_run(cmd_pass.cmd_pass_plain, packed,
                                       inc, lim, counts, s)
        st_k, fr_k = cmd_pass.cmd_pass(packed, inc, lim, counts, s)
        torch.cuda.synchronize()
        err = _max_err([(st_k, st_p), (fr_k, fr_p)])
        assert err == 0, f"cmd_pass kernel differs from its plain version " \
            f"on the edge lanes at s {s} by {err}"
    assert cmd_pass.build().dtpu_cmd_pass_smem() == cmd_pass.SHARED_BYTES
    print(f"[{tag}] cmd_pass kernel == plain on starts, freqs of "
          f"{packed.shape[0]} edge lanes over 256 rows at s 16, 64 and 256 "
          f"(lim above 0x8000, the renorm cap; max_abs_err 0) | {smi}")


def lit_edge_lanes(chunk: int, seed: int = 13):
    """Lanes for kernel 3 at this chunk (numpy, seeded): (rows, spd),
    rows[i] uint16 [n_i] packed bytes (ctx | hi<<6 | lo<<10 | act<<14 |
    mix<<15, ctx 0 where inactive, as native.pack_lit packs them), spd
    int32 [B, 6] = (inc, lim) of speeds 0, 2 and 3.  Two lanes hit a
    third of their count rows in turn (ctx and idx = (ctx>>3)*16 + hi
    both equal to the chunk's index mod 3), so a row is coded against
    only after two commits: one with lim 0xA000, whose commits leave
    entry 15 at or above 0x8000 every few turns; one with inc 2^30 / s,
    whose rows hit the 24-pass cap and stay above 0x8000.  Beside them a
    lane of two symbols in turns, which its cm rows learn fast and its
    nibble rows slowly, so the weights reach their clamps and the 24-bit
    over-rule; a lane with inactive bytes and a ragged end; a non-mixing
    lane; a ragged lane; an empty lane."""
    rng = np.random.default_rng(seed + chunk)
    s = chunk // 2

    def lane(n, act=1.0, mix=1.0):
        x = np.zeros((n, 5), np.int64)          # ctx, hi, lo, act, mix
        x[:, 0] = rng.integers(0, 64, n)
        x[:, 1] = rng.integers(0, 16, n)
        x[:, 2] = rng.integers(0, 16, n)
        x[:, 3] = rng.random(n) < act
        x[:1, 3] = 1                            # the first byte is live
        x[:, 4] = (rng.random(n) < mix) & (x[:, 3] != 0)
        return x

    def turns():
        n = 30 * s
        r = np.arange(n) // s % 3
        x = lane(n)
        x[:, 0] = 3 * rng.integers(0, 4, n) + r
        x[:, 1] = (r - (x[:, 0] >> 3) * 16) % 3 + 3 * rng.integers(0, 5, n)
        return x

    # symbols 12 and 3 in turns of 6 chunks: the fast cm rows learn each
    # turn's symbol, the slow nibble rows keep some of both, so the first
    # chunks of a turn drive the nibble weight up by ~2^21 a byte
    two = lane(36 * s)
    two[:, 0] = rng.choice([5, 40], two.shape[0])
    two[:, 1] = np.where(np.arange(36 * s) // (6 * s) % 2 == 0, 12, 3)
    two[:, 2] = two[:, 1]
    slow, fast = max(1, 64 // s), 8192 // s
    lanes = [(turns(), [32768 // s, 0xA000] * 3),
             (turns(), [(1 << 30) // s, 0x8000] * 3),
             (two, [slow, 0x7000, fast, 0x7000, fast, 0x7000]),
             (lane(7 * s + 3, act=0.7, mix=0.5),
              [20, 0x3000, 32, 0x4000, 12, 0x1800]),
             (lane(6 * s, mix=0.0), [16, 0x2000, 24, 0x2000, 8, 0x1000]),
             (lane(5 * s + s // 2 + 1), [24, 0x4000, 16, 0x4000, 20, 0x4000]),
             (lane(0), [24, 0x4000, 16, 0x4000, 20, 0x4000])]
    rows = []
    for x, _sp in lanes:
        x[x[:, 3] == 0, 0] = 0
        rows.append((x[:, 0] | x[:, 1] << 6 | x[:, 2] << 10 | x[:, 3] << 14
                     | x[:, 4] << 15).astype(np.uint16))
    return rows, np.array([sp for _x, sp in lanes], np.int32)


def _lit_edge_compare(device, tag: str, smi: str) -> None:
    """Kernel 3 against its plain version on lit_edge_lanes at chunk 16,
    256 and 1024: equal starts and freqs."""
    for chunk in (16, CHUNK, 1024):
        rows, spds = lit_edge_lanes(chunk)
        packed, spd, n_nib = (torch.from_numpy(a).to(device)
                              for a in encode.batch_inputs(rows, spds, chunk))
        (st_p, fr_p), _ms = _plain_run(lit_pass.lit_pass_plain, packed,
                                       spd, n_nib, chunk)
        st_k, fr_k = lit_pass.lit_pass(packed, spd, n_nib, chunk)
        torch.cuda.synchronize()
        err = _max_err([(st_k, st_p), (fr_k, fr_p)])
        assert err == 0, f"lit_pass kernel differs from its plain version " \
            f"on the edge lanes at chunk {chunk} by {err}"
    lib = lit_pass.build()
    assert lib.dtpu_lit_pass_smem() == lit_pass.SHARED_BYTES
    for chunk in (16, 32, CHUNK, 512, 1024):
        assert lib.dtpu_lit_pass_threads(chunk) == lit_pass.threads(chunk)
    print(f"[{tag}] lit_pass kernel == plain on starts, freqs of "
          f"{len(rows)} edge lanes at chunk 16, 256 and 1024 (lim above "
          f"0x8000, the renorm cap, the weight clamps, inactive bytes, no "
          f"mixing, ragged and empty lanes; max_abs_err 0; "
          f"{lit_pass.SHARED_BYTES} B of shared memory, "
          f"{lit_pass.threads(CHUNK)} threads a block at chunk {CHUNK}) | "
          f"{smi}")


def adaptive_edge_traces(r: int, seed: int = 14):
    """Traces for the adaptive model pass over r rows (numpy, seeded,
    codec/trace.py's columns): a lane whose nibble and cm rows coincide
    on a third of its steps, among the first 8 rows (row 0 included); a
    lane with padding steps among its steps (the reference's all-zero
    padding row, stream -1, and stream -1 with live fields: both adapt
    the model and emit nothing); a lane that codes two symbols in turns
    with a fast cm row and a slow nibble row, which drives the weights to
    their clamps; a lane whose speeds wrap entry 15 past 32767 (rows with
    a max of 0 or below, divided as XLA divides; rows brought to a max of
    exactly 0 first) and renorm at lim 0; an empty lane."""
    rng = np.random.default_rng(seed)

    def lane(n, mix=0.5):
        t = np.zeros((n, 10), np.int32)
        t[:, 0] = rng.integers(0, r, n)
        t[:, 1] = rng.integers(0, 16, n)
        t[:, 2] = rng.integers(0, 2, n)
        t[:, 3] = rng.integers(0, 0x200, n)
        t[:, 4] = rng.integers(0x400, 0x4001, n)
        t[:, 5] = rng.random(n) < mix
        t[:, 6] = rng.integers(0, 2, n)
        t[:, 7] = rng.integers(0, r, n)
        t[:, 8] = rng.integers(0, 0x200, n)
        t[:, 9] = rng.integers(0x400, 0x4001, n)
        return t

    coincide = lane(3000)
    coincide[:, 0] = rng.integers(0, 8, 3000)
    coincide[:, 7] = rng.integers(0, 8, 3000)
    coincide[::3, 7] = coincide[::3, 0]
    padded = lane(3000)
    pad = rng.random(3000) < 0.2
    padded[pad, 2] = -1
    zero = pad & (rng.random(3000) < 0.5)
    padded[zero] = 0
    padded[zero, 2] = -1
    padded[zero, 4] = padded[zero, 9] = 0x4000
    turns = lane(4000, mix=1.0)
    turns[:, 0], turns[:, 7], turns[:, 6] = 5, 6, 1
    turns[:, 1] = np.where(np.arange(4000) // 250 % 2 == 0, 12, 3)
    turns[:, 3], turns[:, 4] = 1, 0x7000
    turns[:, 8], turns[:, 9] = 0x600, 0x4000
    wrap = lane(2000, mix=0.7)
    wrap[:, 0] = rng.integers(0, 16, 2000)
    wrap[:, 7] = rng.integers(0, 16, 2000)
    wrap[:, 3] = rng.integers(0x2000, 0x8000, 2000)
    wrap[:, 8] = rng.integers(0x2000, 0x8000, 2000)
    wrap[:, 4] = rng.integers(0x8000, 0x10000, 2000)
    wrap[:, 9] = rng.integers(0x8000, 0x10000, 2000)
    wrap[::7, 4] = 0
    # rows 100..139 brought to a max of exactly 0 (64 + 0xFFC0 wraps to
    # 0), each then coded against, mixed with itself
    zero_max = lane(80, mix=0.0)
    zero_max[:, 0] = zero_max[:, 7] = 100 + np.arange(80) // 2
    zero_max[0::2, 1], zero_max[0::2, 3], zero_max[0::2, 4] = 0, 0xFFC0, 0x7FFF
    zero_max[0::2, 7], zero_max[0::2, 8], zero_max[0::2, 9] = 0, 0, 0x7FFF
    zero_max[1::2, 5] = 1
    wrap = np.concatenate([zero_max, wrap])
    return [coincide, padded, turns, wrap, np.zeros((0, 10), np.int32)]


def phase_mix(corpus: bytes, device, smi: str) -> dict:
    """The mix profile at full width (force_stride_value=4, quality 10,
    the whole corpus): the host-only reference, kernel 5 and then the
    rANS encode against their plain versions on the first batch's
    literal lanes, one warm and three timed encodes, one event-timed
    encode, and a round trip (decoded on the host, as in the reference).
    Returns the entries and launches of kernel 5 and the rANS encode."""
    opts = mix_options()
    ref, t_ref = phase_profile_reference(corpus, opts, "mix-reference")
    got = _first_batch(corpus, opts)
    assert all(g.lit_trace is not None for g in got), \
        "a mix-profile frame's literals left the generic pass"
    e5, st, fr, counts = _generic_compare(got, opts, device, "mix-compare",
                                          smi)
    _generic_edge_compare(device, "mix-compare", smi)
    re_ = _rans_compare(st, fr, counts, "mix-compare", "generic lit lanes",
                        smi)
    n = len(fmt.deserialize(ref)[2])
    launches, mbps = _encode_runs(
        corpus, ref, opts, {"deferred_pass": deferred_pass,
                            "encode_lanes": rans_encode},
        dict(cmd_host=n, lit_generic=n), "mix-main", smi)
    print(f"[mix-main] device encode {mbps:.2f} MB/s against native.compress "
          f"{len(corpus) / t_ref / 1e6:.2f} MB/s in this run | {smi}")
    _timed_encode(corpus, ref, opts, "mix-main", smi,
                  split=("lit_generic_pass", "deferred_pass_kernel"))
    decode.reset_stats()
    t0 = time.perf_counter()
    assert dt.decompress(ref) == corpus, "mix-profile round trip differs"
    wall = time.perf_counter() - t0
    assert {k: decode.STATS[k] for k in DECODE_FRAMES} == {
        "device_frames": 0, "host_frames": n, "golden_frames": 0}, \
        decode.STATS
    print(f"[mix-roundtrip] decompress == the {len(corpus)}-byte corpus, "
          f"{len(corpus) / wall / 1e6:.2f} MB/s (one run, every frame on "
          f"the host: no device decode of this profile) | {smi}")
    return {"deferred_pass": (e5, launches["deferred_pass"]),
            "encode_lanes": (re_, launches["encode_lanes"])}


def phase_stride(data: bytes, device, smi: str):
    """The stride profile (the CLI's -nocm) on the corpus's first
    STRIDE_BYTES: the host-only reference, kernel 5 and then the rANS
    encode against their plain versions on the first batch's literal
    lanes, one warm and one timed encode.  Returns the entries and
    launches of kernel 5 and the rANS encode."""
    opts = stride_options()
    ref, t_ref = phase_profile_reference(data, opts, "stride-reference")
    e5, st, fr, counts = _generic_compare(_first_batch(data, opts), opts,
                                          device, "stride-compare", smi)
    re_ = _rans_compare(st, fr, counts, "stride-compare",
                        "generic lit lanes", smi)
    n = len(fmt.deserialize(ref)[2])
    launches, mbps = _encode_runs(
        data, ref, opts, {"deferred_pass": deferred_pass,
                          "encode_lanes": rans_encode},
        dict(cmd_host=n, lit_generic=n), "stride-main", smi, runs=1)
    print(f"[stride-main] device encode {mbps:.2f} MB/s against "
          f"native.compress {len(data) / t_ref / 1e6:.2f} MB/s in this run "
          f"| {smi}")
    return {"deferred_pass": (e5, launches["deferred_pass"]),
            "encode_lanes": (re_, launches["encode_lanes"])}


def phase_q11_mix(data: bytes, device, smi: str):
    """The mix profile at quality 11 on the corpus's first Q11_MIX_BYTES:
    the uniform path, the cmd pass on the cmd lanes, kernel 5 on the
    literals, the rANS encode on both.  The host-only reference; on the
    first batch the cmd pass and the rANS encode on the cmd lanes, kernel
    5 and the rANS encode on the literal lanes, each against its plain
    version; one warm and one timed encode.  Returns the entries and
    launches of the three kernels, the rANS encode's two launches a
    batch summed."""
    opts = mix_options(quality=11)
    ref, t_ref = phase_profile_reference(data, opts, "q11-mix-reference")
    got = _first_batch(data, opts)
    tag = "q11-mix-compare"
    cmd, st, fr, n_steps = _cmd_pass_compare(got, device, tag, smi)
    re_cmd = _rans_compare(st, fr, n_steps, tag, "cmd lanes", smi)
    e5, st, fr, counts = _generic_compare(got, opts, device, tag, smi)
    re_lit = _rans_compare(st, fr, counts, tag, "generic lit lanes", smi)
    n = len(fmt.deserialize(ref)[2])
    launches, mbps = _encode_runs(
        data, ref, opts, {"cmd_pass": cmd_pass,
                          "deferred_pass": deferred_pass,
                          "encode_lanes": rans_encode},
        dict(cmd_device=n, lit_generic=n), "q11-mix-main", smi, runs=1)
    print(f"[q11-mix-main] device encode {mbps:.2f} MB/s against "
          f"native.compress {len(data) / t_ref / 1e6:.2f} MB/s in this run "
          f"| {smi}")
    return {"cmd_pass": (cmd, launches["cmd_pass"]),
            "deferred_pass": (e5, launches["deferred_pass"]),
            "encode_lanes": (_sum_entries([re_cmd, re_lit]),
                             launches["encode_lanes"])}


# ------------------------------------------------ the adaptive profile

AD_STRIDE_BYTES = 16 << 20
AD_Q11_BYTES = 4 << 20
# the adaptive kernels are held against their plain versions on the main
# path's own inputs, the plain loops cut to fit the run: the model pass
# on the first AD_CMP_STEPS steps of every frame's trace (the pass is
# causal, so its lanes there are an exact prefix of the whole launch's,
# which is checked), the rANS encode on that pass's 2B lanes, the scan on
# the main path's container (every frame, the window 2^19) with
# max_steps cut to AD_SCAN_CMP_STEPS micro-steps (the lanes' state after
# that many; each window up to the cut's wpos a prefix of the whole
# launch's, checked); the entries' ms and bound are the whole launches'
AD_CMP_STEPS = 4096
AD_SCAN_CMP_STEPS = 6144
AD_EDGE_MB = 1 << 12     # the scan's edge frames (flipped bits, mix lanes)


def _ad_layout(opts) -> ModelLayout:
    return ModelLayout(PROFILES[profile_for_options(opts)], lo_bucketed=False)


def _ad_traces(blocks, opts):
    """The adaptive traces of these blocks, on 8 threads."""
    layout = _ad_layout(opts)
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(lambda b: adaptive.frame_trace(b, opts, layout),
                           blocks))


def _model_pass_work(traces):
    """(bytes, operations) the model pass needs on these traces: each
    step's 40 B of trace read once, each coded step's (start, freq) and
    the counts written once; MODEL_PASS_OPS_PER_STEP a step and
    MODEL_PASS_OPS_PER_MIX_STEP more a mixing one."""
    n = sum(t.shape[0] for t in traces)
    n_out = sum(int((t[:, 2] >= 0).sum()) for t in traces)
    n_mix = sum(int((t[:, 5] != 0).sum()) for t in traces)
    b = len(traces)
    return (40 * n + 4 * b + 8 * n_out + 8 * b,
            MODEL_PASS_OPS_PER_STEP * n + MODEL_PASS_OPS_PER_MIX_STEP * n_mix)


def _model_pass_args(traces, r: int, device) -> tuple:
    flat, n_steps = model_pass.pack_traces(traces)
    n_lane = max(1, max(max(model_pass.lane_counts(t)) for t in traces))
    return (torch.from_numpy(flat).to(device),
            torch.from_numpy(n_steps).to(device), r, n_lane)


def _model_pass_run(traces, r: int, device):
    args = _model_pass_args(traces, r, device)
    return lambda: model_pass.model_pass(*args)


def _sm_clock_mhz() -> float:
    """The card's SM clock now (nvidia-smi clocks.sm), in MHz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def _model_pass_phases(traces, r: int, device, tag: str, smi: str) -> None:
    """One more launch of the model pass on the main path's traces with
    each frame's phases timed on the card (%globaltimer): the longest
    frame's row chains, steps in parallel and weight chains, and each
    phase's longest over the frames."""
    flat, n_steps = model_pass.pack_traces(traces)
    n_lane = max(1, max(max(model_pass.lane_counts(t)) for t in traces))
    _out, ns = model_pass.model_pass_phases(
        torch.from_numpy(flat).to(device),
        torch.from_numpy(n_steps).to(device), r, n_lane)
    ns = ns.cpu().numpy() / 1e6
    i = int(np.argmax(n_steps))
    n_mix = [int(((traces[i][:, 5] != 0) & (traces[i][:, 6] == w)).sum())
             for w in (0, 1)]
    print(f"[{tag}] model_pass phases (ms, the card's clock): longest frame "
          f"({int(n_steps[i])} steps, {n_mix[0]} + {n_mix[1]} mixing steps "
          f"of mixers 0 + 1) row chains {ns[i, 0]:.4f}, steps "
          f"{ns[i, 1]:.4f}, weight chains {ns[i, 2]:.4f} "
          f"({ns[i, 2] * 1e3 / max(max(n_mix), 1):.3f} us a mixing step); "
          f"longest over the {len(traces)} frames: row chains "
          f"{ns[:, 0].max():.4f}, steps {ns[:, 1].max():.4f}, weight chains "
          f"{ns[:, 2].max():.4f} | {smi}")


def _model_pass_compare(traces, r: int, device, tag: str, smi: str,
                        steps: int = AD_CMP_STEPS):
    """The model-pass kernel on the main path's traces (one launch over
    every frame, timed by CUDA events), and against its plain version on
    each trace's first `steps` steps: equal starts, freqs and counts
    of every lane, and the kernel's lanes there a prefix of the whole
    launch's.  Returns (entry, the whole launch's (starts, freqs, counts),
    the cut's)."""
    full = _model_pass_run(traces, r, device)
    ms = _cuda_ms(full, 2)
    st_f, fr_f, c_f = full()
    cut = [t[:steps] for t in traces]
    (st_p, fr_p, c_p), plain_ms = _plain_run(
        model_pass.model_pass_plain, *_model_pass_args(cut, r, device))
    kernel = _model_pass_run(cut, r, device)
    st_k, fr_k, c_k = kernel()
    torch.cuda.synchronize()
    err = _max_err([(st_k, st_p), (fr_k, fr_p), (c_k, c_p)])
    assert err == 0, f"model_pass kernel differs from its plain version " \
        f"by {err}"
    n_cut = st_k.shape[1]
    live = torch.arange(n_cut, device=device)[None] < c_k[:, None]
    assert torch.equal(st_f[:, :n_cut][live], st_k[live]) and \
        torch.equal(fr_f[:, :n_cut][live], fr_k[live]), \
        "the cut's lanes are not a prefix of the whole launch's"
    cut_ms = _cuda_ms(kernel, 10)
    n_bytes, n_ops = _model_pass_work(traces)
    what = (f"the first {steps} steps of each of the main path's "
            f"{len(traces)} frames")
    e = dict(_entry(ms, plain_ms, n_bytes, n_ops, err), compare=what,
             compare_ms=cut_ms)
    n = sum(t.shape[0] for t in traces)
    n_mix = sum(int((t[:, 5] != 0).sum()) for t in traces)
    longest = max(t.shape[0] for t in traces)
    print(f"[{tag}] model_pass on the main path: {len(traces)} frames, {n} "
          f"steps ({n_mix} mixing), longest frame {longest} steps, {r} rows "
          f"| kernel {ms:.4f} ms a call of two launches "
          f"({ms / max(longest, 1) * 1e3:.4f} us a step of the longest "
          f"frame), bound {e['bound_ms']:.6f} ms by {e['bound_by']} "
          f"({n_bytes} B, {n_ops} ops); its real limit is a frame's weight "
          f"chains | on {what} ({int(c_k.sum())} "
          f"steps coded, {2 * len(traces)} lanes) kernel == plain on "
          f"starts, freqs, counts (max_abs_err {err}) and == the whole "
          f"launch's prefix: kernel {cut_ms:.4f} ms, plain {plain_ms:.2f} ms "
          f"| {cuda_build.ptxas_usage(model_pass.NAME)} | {smi}")
    return e, (st_f, fr_f, c_f), (st_k, fr_k, c_k)


def _model_pass_edge_compare(device, tag: str, smi: str) -> None:
    """The model-pass kernel against its plain version on
    adaptive_edge_traces, over the cm layout's rows (the model in shared
    memory) and the mix layout's (the global slab)."""
    lib = model_pass.build()
    assert lib.dtpu_model_pass_max_shared() == model_pass.MAX_SHARED_MODEL
    assert scan_decode.build().dtpu_scan_decode_max_shared() == \
        model_pass.MAX_SHARED_MODEL
    for prof in ("cm", "mix"):
        r = scan_decode.layout_of(prof).num_rows
        lanes = adaptive_edge_traces(r)
        got = _model_pass_run(lanes, r, device)()
        want, _ms = _plain_run(model_pass.model_pass_plain,
                               *_model_pass_args(lanes, r, device))
        torch.cuda.synchronize()
        err = _max_err(list(zip(got, want)))
        assert err == 0, f"model_pass kernel differs from its plain " \
            f"version on the edge traces over {r} rows by {err}"
    print(f"[{tag}] model_pass kernel == plain on starts, freqs, counts of "
          f"{len(lanes)} edge traces over the cm rows (model in shared "
          f"memory) and the mix rows (global slab): coinciding rows, "
          f"padding steps, the weight clamps, rows with a max of 0 or below "
          f"(max_abs_err 0) | {smi}")


def _scan_work(frames, traces, wpos):
    """(bytes, operations) the scan needs on these frames: their streams
    read once, their window bytes, ok and wpos written once;
    SCAN_OPS_PER_NIBBLE a coded nibble (the encode trace's steps),
    SCAN_OPS_PER_MIX_NIBBLE more a mixing one, SCAN_OPS_PER_COPY_STEP a
    copy micro-step, one for each 8 bytes the literals did not write.  A
    frame the scan flags counts the share of this its wpos reached."""
    n_bytes = n_ops = 0.0
    for f, t, w in zip(frames, traces, wpos.tolist()):
        share = min(1.0, w / max(f.raw_len, 1))
        lit = int((t[:, 2] == 1).sum()) // 2
        n_bytes += share * (len(f.cmd) + len(f.lit) + f.raw_len) + 9
        n_ops += share * (
            SCAN_OPS_PER_NIBBLE * t.shape[0]
            + SCAN_OPS_PER_MIX_NIBBLE * int((t[:, 5] != 0).sum())
            + SCAN_OPS_PER_COPY_STEP * (-(-(f.raw_len - lit) // 8)))
    return int(n_bytes), int(n_ops)


def _scan_args(frames, device):
    packed = scan_decode.pack_frames(frames)
    return [torch.from_numpy(a).to(device) for a in packed[:5]], packed[5:]


def _scan_compare(args, w: int, steps: int, profile: str):
    """The scan kernel against its plain version on these packed frames
    at `steps` micro-steps: equal windows, ok and wpos on every lane.
    Returns (the error, the kernel's (window, ok, wpos), plain ms)."""
    (w_p, ok_p, wp_p), plain_ms = _plain_run(scan_decode.decode_scan_plain,
                                             *args, profile, w, steps)
    got = scan_decode.decode_scan(*args, profile, w, steps)
    torch.cuda.synchronize()
    w_k, ok_k, wp_k = got
    err = _max_err([(w_k, w_p), (ok_k.to(torch.int32), ok_p.to(torch.int32)),
                    (wp_k, wp_p)])
    assert err == 0, f"decode_scan kernel differs from its plain version " \
        f"({profile}) by {err}"
    return err, got, plain_ms


def _scan_main_compare(frames, traces, profile: str, device, tag: str,
                       smi: str, cut: int = AD_SCAN_CMP_STEPS) -> dict:
    """The scan kernel on the main path's container (one launch over every
    frame at its own max_steps, timed by CUDA events), and against its
    plain version on the same packed frames at `cut` micro-steps, each
    window up to the cut's wpos a prefix of the whole
    launch's.  Returns the entry."""
    args, (w, steps) = _scan_args(frames, device)
    full = lambda: scan_decode.decode_scan(*args, profile, w, steps)
    ms = _cuda_ms(full, 2)
    w_f, ok_f, wp_f = full()
    err, (w_k, ok_k, wp_k), plain_ms = _scan_compare(args, w, cut, profile)
    below = torch.arange(w, device=device)[None] < wp_k[:, None]
    assert bool((wp_f >= wp_k).all()) and torch.equal(w_f[below],
                                                      w_k[below]), \
        "the cut's windows are not a prefix of the whole launch's"
    cut_ms = _cuda_ms(
        lambda: scan_decode.decode_scan(*args, profile, w, cut), 3)
    _scan_clocks(args, w, steps, profile, traces, ms, tag, smi)
    n_bytes, n_ops = _scan_work(frames, traces, wp_f.cpu())
    what = (f"every lane of the main path's container (window {w}) cut at "
            f"{cut} micro-steps")
    e = dict(_entry(ms, plain_ms, n_bytes, n_ops, err), compare=what,
             compare_ms=cut_ms)
    print(f"[{tag}] decode_scan on the main path's container: {len(frames)} "
          f"lanes, window {w}, max_steps {steps}, {int(ok_f.sum())} ok | "
          f"kernel {ms:.4f} ms a launch, bound {e['bound_ms']:.6f} ms by "
          f"{e['bound_by']} ({n_bytes} B, {n_ops} ops); its real limit is "
          f"the slower of a frame's two warps | on {what} ({int(wp_k.sum())} "
          f"bytes written, {int(ok_k.sum())} lanes done) kernel == plain on "
          f"windows, ok, wpos (max_abs_err {err}) and == the whole launch's "
          f"prefix: kernel {cut_ms:.4f} ms, plain {plain_ms:.2f} ms | "
          f"{cuda_build.ptxas_usage(scan_decode.NAME)} | {smi}")
    return e


def _scan_clocks(args, w: int, steps: int, profile: str, traces, ms: float,
                 tag: str, smi: str) -> None:
    """One more launch of the scan with each frame's two warps timed
    (clock64 from the block's start): the cmd warp's and the literal
    warp's finish and the cycles each waited on the other, on the frame
    whose literal warp finished last, at the SM clock read after the
    launch."""
    (_w, _ok, _wp), clocks = scan_decode.decode_scan_clocks(*args, profile,
                                                            w, steps)
    clocks = clocks.cpu().numpy()
    mhz = _sm_clock_mhz()
    i = int(np.argmax(clocks[:, 1]))
    longest = max(t.shape[0] for t in traces)
    print(f"[{tag}] decode_scan warps on the frame whose literal warp "
          f"finished last (frame {i}, {traces[i].shape[0]} coded nibbles): "
          f"cmd warp {int(clocks[i, 0])} cycles ({int(clocks[i, 2])} "
          f"waiting on the ring), literal warp {int(clocks[i, 1])} cycles "
          f"({int(clocks[i, 3])} waiting for records; "
          f"{clocks[i, 1] / mhz / 1e3:.4f} ms at "
          f"{mhz:.0f} MHz, clocks.sm after the launch; "
          f"{clocks[i, 1] / max(traces[i].shape[0], 1):.1f} cycles a coded "
          f"nibble); the whole launch {ms:.4f} ms is "
          f"{ms * 1e3 / max(longest, 1):.4f} us a coded nibble of the "
          f"longest frame ({longest}) | {smi}")


def _flip(f, stream: str, seed: int):
    """The frame with one bit flipped past the state of one stream."""
    rng = np.random.default_rng(seed)
    b = bytearray(getattr(f, stream))
    b[int(rng.integers(4, len(b)))] ^= 1 << int(rng.integers(0, 8))
    if stream == "cmd":
        return fmt.MetablockFrame(f.raw_len, bytes(b), f.lit)
    return fmt.MetablockFrame(f.raw_len, f.cmd, bytes(b))


class ScanFrameWriter:
    """One adaptive frame written at the trace level, for the scan's paths
    that no command list reaches.  Each command's nibbles are traced as
    the scan's FSM reads them (scan_decode.decode_scan_plain: every row
    from the FSM registers, the header and the window, every blend speed
    from SPEED_TAB or the header), in the serial FSM's order;
    `scan_frames` codes the traces (model_pass.model_pass_plain's (start, freq), the
    serial coder ans/coder_np).

    `escape` writes a literal whose length wraps (L_LAST at 29 bits, a
    negative mantissa): llen goes negative, the run writes one byte, and
    the next copy's C_CS row, c_ccs + ((l4s >> 4) & 3) + 4 (llen - 1),
    lands below 0, which the scan reads and writes at that plus R: a
    literal row (csrc/scan_decode.cu drains the ring first).  `drains`
    counts the coded cmd steps whose row is a literal row."""

    def __init__(self, profile: str):
        lay = scan_decode.layout_of(profile)
        self.lay, self.r = lay, lay.num_rows
        self.seg = {k: v[0] for k, v in lay.segments.items()}
        self.lit_sel = lay.profile.lit_sel
        self.rows: list[tuple] = []
        self.out = bytearray()
        self.l4s, self.llen = 3 << 4, 1
        self.dlru = [4, 11, 15, 16]
        self.dcm = [0, 1, 2, 3]
        self.lcm = [0] * 64
        self.pm_mode, self.combine = 3, 0
        self.speeds = [(0x10, 0x2000)] * 4
        self.drains = 0
        self.micro = 0        # the scan's micro-steps so far
        self.mix_micro = 0    # of them, literal nibbles coded mixed

    # ------------------------------------------------------ coded steps

    def _cmd(self, state: int, term: int, v: int, speed=None) -> None:
        flat = scan_decode._i32(
            self.seg[scan_decode._STATE_SEG[state]] + term)
        row = flat + self.r if flat < 0 else flat
        assert 0 <= row < self.r, (state, flat)   # read and written there
        self.drains += row >= self.seg["lit_hi"]
        inc, lim = speed or (int(x) for x in scan_decode.SPEED_TAB[state])
        self.rows.append((row, v, 0, inc, lim, 0, 0, 0, 0,
                          model_pass.NOOP_LIM))
        self.micro += 1

    def _rows_of(self, r0: int, p1: int, p2: int):
        """(hi, lo, cm_hi, cm_lo) rows of a literal byte with high nibble
        r0 after bytes p2, p1."""
        seg, lay = self.seg, self.lay
        sel = int(scan_decode.LUT0[self.pm_mode, p1]
                  | scan_decode.LUT1[self.pm_mode, p2])
        ctx = self.lcm[sel & 63]
        if self.lit_sel == 0:
            lo = ctx >> lay.lo_shift
            return (seg["lit_hi"] + ctx, seg["lit_lo"] + lo * 16 + r0,
                    seg["cm_first"] + ctx,
                    seg["cm_second"] + r0 * lay.nctx_lo + lo)
        return (seg["lit_hi"] + p1, seg["lit_lo"] + p1 * 16 + r0,
                seg["cm_first"] + ctx,
                seg["cm_second"] + r0 * lay.nctx_lo + ctx)

    def _byte(self, b: int) -> None:
        p1 = self.out[-1] if self.out else 0
        p2 = self.out[-2] if len(self.out) > 1 else 0
        hi, lo, cm_hi, cm_lo = self._rows_of(b >> 4, p1, p2)
        inc, lim = self.speeds[0]
        for flat, v, which, cm, cm_sp in ((hi, b >> 4, 1, cm_hi,
                                           self.speeds[3]),
                                          (lo, b & 15, 0, cm_lo,
                                           self.speeds[2])):
            if self.combine:
                self.rows.append((flat, v, 1, inc, lim, 1, which, cm,
                                  *cm_sp))
                self.mix_micro += 1
            else:
                self.rows.append((flat, v, 1, inc, lim, 0, 0, 0, 0,
                                  model_pass.NOOP_LIM))
        self.micro += 2
        self.out.append(b)

    def _begin(self, v: int) -> None:
        self._cmd(scan_decode.BEGIN, self.l4s >> 4, v)
        if v == 3:
            self.l4s = ((self.l4s >> 2) | 128) & 0xFF
        elif v == 1:
            self.l4s = ((self.l4s >> 2) | 64) & 0xFF

    def _mant(self, state: int, acc: int, e: int, term=None, speed=None):
        """The mantissa nibbles of acc (its top bit e preset), high first;
        term(first), speed(first): the row term and speed of each."""
        lrem = scan_decode._rum4(e)
        first = 1
        for nrem in range(lrem - 4, -1, -4):
            self._cmd(state, term(first) if term else 0,
                      (acc >> nrem) & 15, speed(first) if speed else None)
            first = 0

    # --------------------------------------------------------- commands

    def literal(self, data: bytes) -> None:
        """A literal run (BEGIN 3, its length, its bytes)."""
        n = len(data)
        assert n >= 1
        s = scan_decode
        self._begin(3)
        if n <= 14:
            self._cmd(s.L_CS, 0, n - 1)
            self.llen = n
        elif n <= 16:
            self._cmd(s.L_CS, 0, 14)
            self._cmd(s.L_BEG, 0, n - 15)   # llen kept: the scan's quirk
        else:
            acc = n - 15
            e = acc.bit_length() - 1
            self._cmd(s.L_CS, 0, 14)
            if e <= 13:
                self._cmd(s.L_BEG, 0, e + 1)
            else:
                self._cmd(s.L_BEG, 0, 15)
                self._cmd(s.L_LAST, 0, e - 14)
            self._mant(s.L_MANT, acc, e)
            self.llen = n
        for b in data:
            self._byte(b)

    def copy(self, n: int, dist: int) -> None:
        """A copy of n >= 1 bytes from dist back: BEGIN 1, the length
        (C_CS, or C_BEG and its mantissa), the distance (an LRU hit at
        C_DMN, or C_DBEG and its mantissa)."""
        s = scan_decode
        assert 1 <= n and 1 <= dist <= len(self.out)
        self._begin(1)
        cs = ((self.l4s >> 4) & 3) + scan_decode._i32(
            4 * min(self.llen - 1, 3))
        if n < 15:
            self._cmd(s.C_CS, cs, n)
        else:
            e = n.bit_length() - 1
            assert 3 <= e <= 17
            self._cmd(s.C_CS, cs, 15)
            self._cmd(s.C_BEG, 0, e - 3)
            clen = e + 1
            self._mant(s.C_MANT, n, e,
                       term=lambda first: (clen % 4) + 1 if first else 0)
        aprior = self.dcm[min(max(n, 2) - 2, 3)]
        dmn = aprior * 2 + (1 if self.llen < 8 else 0)
        if dist in self.dlru:
            self._cmd(s.C_DMN, dmn, self.dlru.index(dist))
        else:
            self._cmd(s.C_DMN, dmn, 15)
            dbeg = aprior * 8 + (n.bit_length() >> 2)
            if dist == 1:
                self._cmd(s.C_DBEG, dbeg, 0)
            else:
                e = dist.bit_length() - 1
                assert 1 <= e <= 13
                self._cmd(s.C_DBEG, dbeg, e)
                fi_d = ((e + 1) & 3) + 1
                self._mant(
                    s.C_DMANT, dist, e,
                    term=lambda first: aprior * 5 + (fi_d if first else 0),
                    speed=lambda first: (
                        (0x4 << ((fi_d & 6) << ((fi_d & 2) >> 1)))
                        if first else 0x4, 0x4000))
        l0, l1, l2, l3 = self.dlru
        if dist == l1:
            self.dlru = [dist, l0, l2, l3]
        elif dist == l2:
            self.dlru = [dist, l0, l1, l3]
        elif dist != l0:
            self.dlru = [dist, l0, l1, l2]
        for _ in range(n):
            self.out.append(self.out[-dist])
        self.micro += -(-n // min(scan_decode.COPY_CHUNK, dist))

    def header(self, pm_mode: int, combine: int, speeds, lit_map,
               dist_map) -> None:
        """A prediction-mode header (BEGIN 7): the mode, the mixing flag,
        four (inc, lim) speeds as 7-bit bytes, the literal and distance
        context maps (mnemonics where the LRU holds the value, else
        escapes), the mv_mode the profile takes (0, or 1 for stride)."""
        s = scan_decode
        self._begin(7)
        self.lcm, self.dcm = [0] * 64, [0, 1, 2, 3]
        self._cmd(s.P_ONLY, 0, pm_mode)
        self.pm_mode = pm_mode
        self._cmd(s.P_DCM, 0, combine)
        self.combine = int((combine & 3) != 0)
        self._cmd(s.P_PD, 0, 0)
        for inc8, lim8 in speeds:
            for k, v in enumerate((inc8 >> 3, inc8 & 7, lim8 >> 3,
                                   lim8 & 7)):
                self._cmd(s.P_SPD, k, v)
        self.speeds = [(u8_to_speed(a), u8_to_speed(b)) for a, b in speeds]
        for which, values in ((0, lit_map), (1, dist_map)):
            lru = list(range(13))
            for i, val in enumerate(values):
                if val in lru:
                    self._cmd(s.P_CMN, which, lru.index(val))
                else:
                    self._cmd(s.P_CMN, which, 15)
                    self._cmd(s.P_CF, which, val >> 4)
                    self._cmd(s.P_CS, which, val & 15)
                pos = lru.index(val) if val in lru else 12
                lru = [val] + lru[:pos] + lru[pos + 1:]
                (self.lcm if which == 0 else self.dcm)[i] = val
            self._cmd(s.P_CMN, which, 14)
        self._cmd(s.P_MVMODE, 0, 1 if self.lit_sel else 0)

    def escape(self, kind: str, n: int, dist: int, low: int) -> None:
        """A literal whose length wraps, its one byte (low nibble `low`),
        then a copy of n bytes from dist back whose C_CS row is that
        byte's `kind` row ("hi", "lo", "cm_hi", "cm_lo"): the byte's high
        nibble is chosen for the row, and where no high nibble makes the
        row's index reachable (the C_CS index steps by 4), a one-byte
        literal goes first to move the context."""
        kinds = ("hi", "lo", "cm_hi", "cm_lo")
        for pre in [None] + list(range(256)):
            out = self.out + bytes([] if pre is None else [pre])
            l4s = self.l4s if pre is None else ((self.l4s >> 2) | 128) & 0xFF
            l4s = ((((l4s >> 2) | 128) & 0xFF) >> 2 | 64) & 0xFF
            p1 = out[-1] if out else 0
            p2 = out[-2] if len(out) > 1 else 0
            for r0 in range(16):
                t = self._rows_of(r0, p1, p2)[kinds.index(kind)]
                x = t - self.r - self.seg["c_ccs"] - ((l4s >> 4) & 3)
                if x % 4 == 0:
                    break
            else:
                continue
            break
        else:
            raise AssertionError(f"no reachable {kind} row")
        if pre is not None:
            self.literal(bytes([pre]))
        acc = x // 4 - 14     # llen - 1 = x / 4: llen = acc + 15
        u = acc & 0xFFFFFFFF
        assert acc < 0 and u >> 29 & 1, acc   # L_LAST's 2^29, negative
        s = scan_decode
        self._begin(3)
        self._cmd(s.L_CS, 0, 14)
        self._cmd(s.L_BEG, 0, 15)
        self._cmd(s.L_LAST, 0, 15)
        self._mant(s.L_MANT, u, 29)
        self.llen = acc + 15
        self._byte((r0 << 4) | low)
        drains = self.drains
        self.copy(n, dist)
        assert self.drains > drains

    def finish(self) -> np.ndarray:
        """BEGIN 15 (the end); the frame's trace."""
        self._begin(15)
        return np.array(self.rows, np.int32).reshape(-1, 10)


def scan_frames(writers) -> list:
    """The writers' frames: their traces through the plain model pass
    (model_pass_plain, every lane in lockstep), each stream coded by the
    serial rANS coder (ans/coder_np)."""
    traces = [w.finish() for w in writers]
    r = writers[0].r
    assert all(w.r == r for w in writers)
    flat, n_steps = model_pass.pack_traces(traces)
    counts = [model_pass.lane_counts(t) for t in traces]
    n_lane = max(max(c) for c in counts)
    st, fr, _n = model_pass.model_pass_plain(
        torch.from_numpy(flat), torch.from_numpy(n_steps), r, n_lane)
    frames = []
    for i, w in enumerate(writers):
        streams = []
        for s in (0, 1):
            enc = ANSEncoder()
            for a, f in zip(st[2 * i + s, :counts[i][s]].tolist(),
                            fr[2 * i + s, :counts[i][s]].tolist()):
                enc.put(a, f)
            streams.append(enc.flush())
        frames.append(fmt.MetablockFrame(len(w.out), *streams))
    return frames


SCAN_PATH_SEED = 15
_VOCAB = [b"the ", b"scan ", b"ring ", b"warp ", b"row ", b"drain ",
          b"slab ", b"model ", b"\n", b"(x) ", b"0x1f, ", b"=> "]


def _text_of(rng, n: int) -> bytes:
    """n bytes of seeded words, now and then a random byte."""
    out = bytearray()
    while len(out) < n:
        out += _VOCAB[int(rng.integers(len(_VOCAB)))]
        if rng.random() < 0.1:
            out.append(int(rng.integers(256)))
    return bytes(out[:n])


def _header_of(w: ScanFrameWriter, rng, pm_mode: int, combine: int) -> None:
    """A header with seeded speeds and context maps."""
    speeds = [(int(rng.choice([40, 44, 48, 52, 56])),
               int(rng.choice([88, 96, 104, 112, 120]))) for _ in range(4)]
    p = w.lay.profile
    w.header(pm_mode, combine, speeds,
             [int(x) for x in rng.integers(0, p.nctx, 64)],
             [int(x) for x in rng.permutation(p.nd)])


def scan_path_lanes(profile: str, seed: int = SCAN_PATH_SEED) -> list:
    """Frames that run the decode scan's two paths no command list reaches,
    written at the trace level (ScanFrameWriter), each a dict of name,
    frame, data (what it decodes to), drains (the coded cmd steps whose
    row is a literal row: the kernel's escape drain), micro (the scan's
    micro-steps) and mix_micro (literal nibbles coded mixed):
      * escape-first: the frame's first command is a literal whose length
        wraps, so the next copy's C_CS row is that byte's lo row while its
        record is in flight;
      * escape-in-flight: literal runs and copies, then a literal run, a
        wrapped one and a copy onto its lo row; a header turns mixing on;
        wrapped lengths onto a cm_lo, a hi row (two copies after it: two
        drains) and a cm_hi row;
      * slab (the mix profile only: the model in the global slab): ~3,000
        micro-steps of literals and copies, first before any header
        (mixing off), then under a header that mixes, then under one that
        does not; mv_mode 0 in each, so the reference's scan runs it to
        its end (it flags the mix frames that compress writes at their
        mv_mode, jax_decode.py:603-606)."""
    rng = np.random.default_rng(seed)
    writers = {}

    w = writers["escape-first"] = ScanFrameWriter(profile)
    w.escape("lo", 6, 1, int(rng.integers(16)))
    w.literal(_text_of(rng, 40))
    w.copy(12, 7)
    w.literal(_text_of(rng, 20))

    w = writers["escape-in-flight"] = ScanFrameWriter(profile)
    w.literal(_text_of(rng, 200))
    w.copy(20, 50)
    w.literal(_text_of(rng, 60))
    w.copy(30, 100)
    w.literal(_text_of(rng, 40))
    w.escape("lo", 10, 30, int(rng.integers(16)))
    w.literal(_text_of(rng, 60))
    _header_of(w, rng, 2, 1)
    w.literal(_text_of(rng, 150))
    w.copy(17, 40)
    w.literal(_text_of(rng, 30))
    w.escape("cm_lo", 8, 20, int(rng.integers(16)))
    w.literal(_text_of(rng, 40))
    w.escape("hi", 4, 2, int(rng.integers(16)))
    w.copy(5, 9)
    w.literal(_text_of(rng, 30))
    w.escape("cm_hi", 6, 11, int(rng.integers(16)))
    w.literal(_text_of(rng, 20))

    if profile == "mix":
        w = writers["slab"] = ScanFrameWriter(profile)
        w.literal(_text_of(rng, 300))
        w.copy(40, 120)
        w.literal(bytes(int(x) for x in rng.integers(0, 256, 150)))
        w.copy(16, 16)
        _header_of(w, rng, 1, 1)
        w.literal(_text_of(rng, 300))
        w.copy(25, 60)
        w.literal(_text_of(rng, 250))
        w.copy(100, 300)
        _header_of(w, rng, 0, 0)
        w.literal(_text_of(rng, 200))
        w.copy(30, 80)
        w.literal(_text_of(rng, 100))
    frames = scan_frames(list(writers.values()))
    return [dict(name=name, frame=f, data=bytes(w.out), drains=w.drains,
                 micro=w.micro, mix_micro=w.mix_micro)
            for (name, w), f in zip(writers.items(), frames)]


def _scan_path_compare(device, tag: str, smi: str) -> int:
    """The scan kernel against its plain version, to the lanes' end, on
    scan_path_lanes' frames in the cm profile (the shared-model build) and
    the mix profile (the slab build): the escape drain, and the slab past
    its first micro-steps; every lane ok and equal to its data.  Prints
    how many lanes reached each path; returns the error."""
    errs, parts = [], []
    for profile in ("cm", "mix"):
        lanes = scan_path_lanes(profile)
        args, (w, steps) = _scan_args([x["frame"] for x in lanes], device)
        err, (w_k, ok_k, wp_k), plain_ms = _scan_compare(args, w, steps,
                                                         profile)
        errs.append(err)
        for i, x in enumerate(lanes):
            assert bool(ok_k[i]) and w_k[i, :len(x["data"])].cpu().numpy(
            ).tobytes() == x["data"], f"[{tag}] {profile} {x['name']} differs"
        drained = [x for x in lanes if x["drains"]]
        build = "slab" if not model_pass.model_in_shared(
            scan_decode.layout_of(profile).num_rows) else "shared-model"
        parts.append(
            f"{profile} ({build} build): {len(drained)} of {len(lanes)} lanes "
            f"reached the escape drain ({sum(x['drains'] for x in drained)} "
            f"cmd rows in the literal rows), "
            + (f"{len(lanes)} ran the slab to their end (up to "
               f"{max(x['micro'] for x in lanes)} micro-steps, "
               f"{sum(x['mix_micro'] for x in lanes)} nibbles mixed), "
               if build == "slab" else "")
            + f"max_abs_err {err}, plain {plain_ms:.1f} ms")
    print(f"[{tag}] decode_scan kernel == plain on the crafted lanes "
          f"(scan_path_lanes; each ok and == its data): "
          f"{'; '.join(parts)} | {smi}")
    return max(errs)


def _scan_edge_compare(data: bytes, opts, device, tag: str, smi: str) -> int:
    """The scan kernel against its plain version, to the lanes' end, on
    the first two frames of `data` at AD_EDGE_MB with a flipped bit in
    the cmd and the lit stream (ok and wpos of corrupt lanes), on two
    mix-profile frames (the model in the global slab; the reference's
    scan flags them at the mode header, so only its first micro-steps run
    there), and on the crafted lanes of _scan_path_compare.  Returns the
    error."""
    lib = scan_decode.build()
    assert lib.dtpu_scan_decode_n_params() == scan_decode.N_PARAMS
    edge = dataclasses.replace(opts, metablock_size=AD_EDGE_MB)
    head = data[:2 * AD_EDGE_MB]
    frames = fmt.deserialize(native.compress(head, edge))[2]
    bad = [_flip(frames[0], "cmd", 1), _flip(frames[1], "lit", 2)]
    args, (w, steps) = _scan_args(bad, device)
    err, (_w, ok_bad, _wp), _p = _scan_compare(
        args, w, steps, profile_for_options(opts))
    mix = dataclasses.replace(edge, force_stride_value=4)
    mix_frames = fmt.deserialize(native.compress(head, mix))[2]
    args, (w, steps) = _scan_args(mix_frames, device)
    err_mix, (_w, ok_mix, wp_mix), _p = _scan_compare(args, w, steps, "mix")
    print(f"[{tag}] decode_scan kernel == plain on two {AD_EDGE_MB}-byte "
          f"frames with a flipped bit in the cmd and the lit stream (ok: "
          f"{bool(ok_bad[0])}, {bool(ok_bad[1])}; max_abs_err {err}) and on "
          f"{len(mix_frames)} mix-profile lanes (the model in the global "
          f"slab; {int(ok_mix.sum())} ok, wpos {wp_mix.tolist()}: flagged "
          f"at the mode header as the reference flags them; max_abs_err "
          f"{err_mix}) | {smi}")
    return max(err, err_mix, _scan_path_compare(device, tag, smi))


def _adaptive_compare(data: bytes, opts, ref: bytes, device, tag: str,
                      smi: str, edges: bool = False,
                      steps: int = AD_CMP_STEPS,
                      scan_steps: int = AD_SCAN_CMP_STEPS,
                      traces=None) -> dict:
    """The adaptive path's kernels on the main path's inputs (its frames
    at the options' metablock size, its container `ref`) against their
    plain versions: the model pass, the rANS encode on its lanes, and the
    scan (cut at `steps` and `scan_steps`).  `opts` are resolved (no
    detection left to run: ir/detect.apply_detection).  With
    `edges`, also the model pass on the edge traces and the scan on
    _scan_edge_compare's frames.  `traces`: the frames' traces when the
    caller has them (the main path's own).  Returns the kernels'
    entries."""
    blocks = [data[o:o + opts.metablock_size]
              for o in range(0, len(data), opts.metablock_size)]
    profile = profile_for_options(opts)
    r = _ad_layout(opts).num_rows
    print(f"[{tag}] the main path's {len(blocks)} frames at metablock "
          f"{opts.metablock_size}, profile {profile}, quality {opts.quality}")
    if traces is None:
        traces = _ad_traces(blocks, opts)
    mp, full, cut = _model_pass_compare(traces, r, device, tag, smi, steps)
    _model_pass_phases(traces, r, device, tag, smi)
    if edges:
        _model_pass_edge_compare(device, tag, smi)
    re_ = _rans_compare(*cut, tag, "adaptive lanes of the model pass's "
                        f"compare (the first {steps} steps of each "
                        "frame)", smi, main=full)
    del full, cut
    frames = fmt.deserialize(ref)[2]
    sc = _scan_main_compare(frames, traces, profile, device, tag, smi,
                            scan_steps)
    if edges:
        # the edge lanes' error folds into the entry's
        sc["max_abs_err"] = max(sc["max_abs_err"], _scan_edge_compare(
            data, opts, device, tag, smi))
    return {"model_pass": mp, "encode_lanes": re_, "scan_decode": sc}


def _traced_call(fn):
    """fn() once under torch.profiler (CPU and CUDA activities, every
    thread where this torch's profiler can) with the tracelog on:
    (its result, its spans, {span name: [host ms, calls, device ms]}),
    the host ms summed over the span's events and the device ms from
    key_averages() (the kernels and copies launched inside it)."""
    kw = {}
    try:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    tracelog.clear()
    tracelog.enable()
    try:
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA], **kw) as prof:
            out = fn()
            torch.cuda.synchronize()
    finally:
        tracelog.enable(False)
    evs = sorted(tracelog.events(), key=lambda e: e.t0)
    tracelog.clear()
    device = {ev.key: getattr(ev, "device_time_total",
                              getattr(ev, "cuda_time_total", 0.0)) / 1e3
              for ev in prof.key_averages()}
    stages: dict = {}
    for e in evs:
        row = stages.setdefault(e.name, [0.0, 0, device.get(e.name, 0.0)])
        row[0] += e.dt * 1e3
        row[1] += 1
    return out, evs, stages


def _stage_text(stages: dict) -> str:
    return ", ".join(f"{k} {h:.1f} host / {d:.1f} device ms"
                     + (f" ({n} spans)" if n > 1 else "")
                     for k, (h, n, d) in stages.items())


def _adaptive_timed_encode(data: bytes, opts, device, tag: str,
                           smi: str) -> dict:
    """One more encode through divans_tpu_torch.compress, traced
    (_traced_call); prints each span's host and device ms and the trace
    upload (40 B a step of the frames' traces)."""
    t0 = time.perf_counter()
    _blob, evs, stages = _traced_call(
        lambda: dt.compress(data, opts, device=device))
    wall = time.perf_counter() - t0
    steps = sum(e.meta["steps"] for e in evs
                if e.name == "encode/frame_trace")
    up = 40 * steps
    up_ms = stages["encode/upload"][0]
    print(f"[{tag}] traced encode ({stages['encode/frame_trace'][1]} "
          f"frames, {wall:.3f} s wall): {_stage_text(stages)}; trace upload "
          f"{up} B ({up / up_ms / 1e6:.2f} GB/s over the host span, "
          f"pageable) | {smi}")
    return stages


def _host_decode_runs(frames, profile: str, data: bytes, runs: int):
    """Best MB/s of `runs` host-only decodes of these frames after a warm
    one: every frame through native.decode_metablock at chunk 0
    (decode._host_decode, the path of the frames the scan flags) on the
    decode's pool, each equal to `data`."""
    layout = ModelLayout(PROFILES[profile], lo_bucketed=False)
    times = []
    for run in range(runs + 1):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(adaptive._pool_width()) as ex:
            raw = b"".join(ex.map(
                lambda f: decode._host_decode(f, layout, 0)[0], frames))
        if run:
            times.append(time.perf_counter() - t0)
        assert raw == data, "the host-only decode differs"
    return len(data) / min(times) / 1e6


def _adaptive_decode_runs(blob: bytes, data: bytes, device, tag: str,
                          smi: str, runs: int = 3,
                          expect_host: int | None = 0) -> int:
    """One warm decode, then `runs` timed ones through
    divans_tpu_torch.decompress, each equal to `data`; the scan's
    launches and the frames by path counted over the first timed run
    (expect_host frames on the host, when given); then one traced
    decode (_traced_call), and the host-only decode of the same container
    (_host_decode_runs) beside it.  Returns the launches."""
    assert dt.decompress(blob) == data, f"[{tag}] warm decode differs"
    times = []
    for run in range(runs):
        if run == 0:
            scan_decode.LAUNCHES = 0
            adaptive.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = dt.decompress(blob)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if run == 0:
            launches = scan_decode.LAUNCHES
            stats = dict(adaptive.STATS)
        assert raw == data, f"[{tag}] decoded bytes differ"
    assert launches == 1, f"[{tag}] {launches} scan launches, expected 1"
    if expect_host is not None:
        assert stats["host_frames"] == expect_host, stats
    mbps = len(data) / min(times) / 1e6
    raw, evs, stages = _traced_call(lambda: dt.decompress(blob,
                                                          device=device))
    assert raw == data, f"[{tag}] the traced decode differs"
    steps = next(e.meta["max_steps"] for e in evs if e.name == "decode/scan")
    print(f"[{tag}] decode e2e {mbps:.2f} MB/s best of {runs} after a warm "
          f"one ({', '.join(f'{t:.3f}' for t in times)} s), output == the "
          f"input | scan launches {launches} per decode, frames {stats} | "
          f"traced decode: {_stage_text(stages)}; the scan launch's "
          f"max_steps {steps} | {smi}")
    _w, _mb, frames, _crc, flags = fmt.deserialize(blob)
    host = _host_decode_runs(frames, FLAG_PROFILES[flags], data, runs)
    print(f"[{tag}] host-only decode of the same container "
          f"(native.decode_metablock at chunk 0 on "
          f"{adaptive._pool_width()} threads, every frame) {host:.2f} MB/s "
          f"best of {runs}: the scan path decodes at {mbps / host:.3f} of "
          f"its rate | {smi}")
    return launches


def phase_adaptive(corpus: bytes, device, smi: str, tag: str, opts,
                   runs: int = 3, edges: bool = False,
                   expect_host: int | None = 0) -> dict:
    """The adaptive profile (chunk_nibbles=0) on `corpus` with `opts`:
    the host-only reference (native.compress), the kernels against their
    plain versions on the main path's inputs (_adaptive_compare), one
    warm and `runs` timed encodes through divans_tpu_torch.compress (each
    equal to the reference, both encode kernels launched once an encode),
    one traced encode, and the decode (_adaptive_decode_runs).
    Returns each kernel's (entry, launches)."""
    ref, t_ref = phase_profile_reference(corpus, opts, f"{tag}-reference")
    cmp = _adaptive_compare(corpus, opts, ref, device, f"{tag}-compare",
                            smi, edges=edges)
    launches, mbps = _encode_runs(
        corpus, ref, opts, {"model_pass": model_pass,
                            "encode_lanes": rans_encode},
        {}, f"{tag}-main", smi, runs=runs)
    assert launches == {"model_pass": 2, "encode_lanes": 1}, launches
    print(f"[{tag}-main] device encode {mbps:.2f} MB/s against "
          f"native.compress {len(corpus) / t_ref / 1e6:.2f} MB/s in this run "
          f"| {smi}")
    _adaptive_timed_encode(corpus, opts, device, f"{tag}-main", smi)
    dec = _adaptive_decode_runs(ref, corpus, device, f"{tag}-main", smi,
                                runs=runs, expect_host=expect_host)
    return {"model_pass": (cmp["model_pass"], launches["model_pass"]),
            "encode_lanes": (cmp["encode_lanes"], launches["encode_lanes"]),
            "scan_decode": (cmp["scan_decode"], dec)}


# ------------------------------------- the options beyond the defaults

DETECT_BYTES = 16 << 20      # the record corpus (detection)
SPEED_BYTES = 16 << 20       # speed detection: the text corpus's head
OPT_BYTES = 4 << 20          # the IR optimizer at level 1
OPT2_BYTES = 256 << 10       # level 2 (one frame): its Python actuary
                             # takes ~4 s a frame on one core
Q11_NOCM_BYTES = 512 << 10   # quality 11 without the context map (two
                             # frames): the Python trace FSM ~1.5 s a frame
HOST_OPT_BYTES = 256 << 10   # each host option (the golden engine's
                             # encode reads ~0.1 MB/s)
# the new paths' compares, cut to fit the plain loops (each a prefix of
# the main path's own inputs or of its whole launch, checked): the rANS
# encode on each lane's first RANS_CMP_STEPS steps of the batch's
# (start, freq), the decode on the first lane group's first
# DEC_CMP_CHUNKS chunks, the adaptive model pass and scan as
# _adaptive_compare cuts them, at OPT_AD_CMP_STEPS and OPT_SCAN_CMP_STEPS
RANS_CMP_STEPS = 16384
DEC_CMP_CHUNKS = 32
OPT_AD_CMP_STEPS = 2048
OPT_SCAN_CMP_STEPS = 2048
SEED = 0
# the largest model (lanes x rows x 16 entries) whose plain version runs
# on the host: kernel 5's on 128 detection lanes of 20,865 rows (43 M
# entries) took 25.3 s on one host thread of an H100 machine, against
# 1.7 s on the card
HOST_PLAIN_ENTRIES = 1 << 24


def build_records(target: int, seed: int = SEED) -> bytes:
    """A table of fixed-width little-endian records made from the seed:
    int16 random walks on four channels (8-byte records), the data the
    stride profile is for (sensor samples, audio, image rows)."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-40, 41, (target // 8, 4), dtype=np.int64)
    return np.cumsum(steps, axis=0).astype("<i2").tobytes()


def _option_reference(data: bytes, opts, tag: str):
    """The host-only container (api.host_compress: native.compress where
    its FSM takes the options, else the golden engine) and its seconds."""
    t0 = time.perf_counter()
    blob = api.host_compress(data, opts)
    t_ref = time.perf_counter() - t0
    print(f"[{tag}] host-only reference: {len(data)} bytes -> {len(blob)} "
          f"({len(blob) / len(data):.4f}), {len(fmt.deserialize(blob)[2])} "
          f"frames, {t_ref:.2f} s ({len(data) / t_ref / 1e6:.2f} MB/s)")
    return blob, t_ref


def _resolve(data: bytes, opts, tag: str):
    """The options with detection resolved (ir/detect.apply_detection),
    printed."""
    t0 = time.perf_counter()
    res = apply_detection(data, opts)
    spd = [(s.inc, s.lim) for s in res.literal_adaptation or ()]
    print(f"[{tag}] detection on {len(data)} bytes "
          f"({time.perf_counter() - t0:.2f} s): stride "
          f"{res.force_stride_value or 1}, speeds (inc, lim) {spd or 'default'}"
          f", profile {profile_for_options(res)}")
    return res


def _rans_cut_compare(st, fr, counts, tag: str, lanes: str, smi: str):
    """_rans_compare on each lane's first RANS_CMP_STEPS steps of a model
    pass's output, the kernel timed on the whole lanes."""
    k = RANS_CMP_STEPS
    cut = (st[:, :k].contiguous(), fr[:, :k].contiguous(),
           torch.clamp(counts, max=k))
    return _rans_compare(*cut, tag, f"{lanes}, each lane's first {k} steps",
                         smi, main=(st, fr, counts))


def _deferred_compare(data: bytes, res, device, tag: str, smi: str,
                      billing: bool = False, got=None) -> dict:
    """The kernels of the path's first batch (host_frame on the resolved
    options, as a billed encode prepares it when `billing`; batch_jobs'
    packing): on the uniform lanes the cmd streams' pass (kernel 4, or 5
    where a frame's speeds vary within a row), the literals' (kernel 3,
    or 5 outside its envelope), each against its plain version on the
    whole batch, then the rANS encode on both (cut as _rans_cut_compare
    says); on the hybrid the host codes the cmd streams, so only the
    literals' pass and its rANS encode.  `got`: the batch's host_frame
    results when the caller has them (the main path's own).  Returns
    {kernel name: entry}, the rANS encode's launches summed."""
    if got is None:
        got = _first_batch(data, res, billing)
    hybrid = all(g.cmd is not None for g in got)
    print(f"[{tag}] first batch: {len(got)} frames of {MB_SIZE} B, profile "
          f"{profile_for_options(res)}, quality {res.quality}, cmd streams "
          f"{'on the host (the hybrid)' if hybrid else 'on the card'}")
    out, rans = {}, []
    if not hybrid:
        if all(g.cmd_row is not None for g in got):
            out["cmd_pass"], st, fr, n = _cmd_pass_compare(got, device, tag,
                                                           smi)
        else:
            out["deferred_pass"], st, fr, n = _generic_compare(
                got, res, device, tag, smi, job="cmd_generic")
        rans.append(_rans_cut_compare(st, fr, n, tag, "cmd lanes", smi))
    if all(g.lit_row is not None for g in got):
        out["lit_pass"], st, fr, n = _lit_pass_compare(got, device, tag, smi)
    else:
        assert "deferred_pass" not in out
        out["deferred_pass"], st, fr, n = _generic_compare(got, res, device,
                                                           tag, smi)
    rans.append(_rans_cut_compare(st, fr, n, tag, "lit lanes", smi))
    out["encode_lanes"] = _sum_entries(rans)
    return out


def _roundtrip(blob: bytes, data: bytes, modules: dict, tag: str, smi: str,
               options=None) -> dict:
    """One decode through divans_tpu_torch.decompress on the card, equal
    to `data`; the launches of `modules` counted from 0 and the frames by
    path printed (the scan, the literal kernel, native code, the golden
    engine).  Returns the launches."""
    for m in modules.values():
        m.LAUNCHES = 0
    decode.reset_stats()
    adaptive.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = dt.decompress(blob, options=options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert raw == data, f"[{tag}] round trip differs"
    launches = {k: m.LAUNCHES for k, m in modules.items()}
    paths = {"scan": adaptive.STATS["scan_frames"],
             "literal kernel": decode.STATS["device_frames"],
             "native": adaptive.STATS["host_frames"]
             + decode.STATS["host_frames"],
             "golden": adaptive.STATS["golden_frames"]
             + decode.STATS["golden_frames"]}
    n = len(fmt.deserialize(blob)[2])
    assert sum(paths.values()) == n, (paths, n)
    print(f"[{tag}] decompress on the card == the {len(data)}-byte input, "
          f"{len(data) / wall / 1e6:.2f} MB/s (one run, {wall:.3f} s) | "
          f"frames: {paths} | launches {launches} | {smi}")
    return launches


DEFERRED_KERNELS = {"cmd_pass": cmd_pass, "lit_pass": lit_pass,
                    "deferred_pass": deferred_pass,
                    "encode_lanes": rans_encode}
ADAPTIVE_KERNELS = {"model_pass": model_pass, "encode_lanes": rans_encode}


def _deferred_option_path(data: bytes, opts, device, tag: str, smi: str,
                          warm: bool = False, decode_cmp: bool = True,
                          golden_ref: bool = False) -> dict:
    """One option at chunk 256, on the hybrid or the uniform lanes as
    native.supports routes it: the host-only
    reference, the kernels on the first batch (_deferred_compare), the
    decode kernel on the container's first lane group (cut at
    DEC_CMP_CHUNKS; cm containers only), one timed encode through
    divans_tpu_torch.compress (after a warm one when `warm`) equal to
    the reference, the kernels that took the batch launched, and one
    round trip.  Returns {kernel: (entry, launches)}."""
    t_all = time.perf_counter()
    res = _resolve(data, opts, f"{tag}-detect")
    ref, t_ref = _option_reference(data, opts, f"{tag}-reference")
    cmp = _deferred_compare(data, res, device, f"{tag}-compare", smi)
    out = {}
    if decode_cmp:
        out["decode_group"] = phase_compare(ref, device, f"{tag}-dec-compare",
                                            smi, cut=DEC_CMP_CHUNKS)
    launches, mbps = _encode_runs(
        data, ref, opts, {k: DEFERRED_KERNELS[k] for k in cmp}, None,
        f"{tag}-main", smi, runs=1, warm=warm)
    print(f"[{tag}-main] device encode {mbps:.2f} MB/s against the host-only "
          f"reference {len(data) / t_ref / 1e6:.2f} MB/s in this run | {smi}")
    dec = _roundtrip(ref, data, {"decode_group": lit_decode},
                     f"{tag}-roundtrip", smi)
    if decode_cmp:
        assert dec["decode_group"] > 0, f"[{tag}] the decode kernel never ran"
        out["decode_group"] = (out["decode_group"], dec["decode_group"])
    for k, e in cmp.items():
        out[k] = (e, launches[k])
    print(f"[{tag}] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return out


def _adaptive_option_path(data: bytes, opts, device, tag: str,
                          smi: str) -> dict:
    """One option at chunk 0: the host-only reference, the adaptive
    kernels on the path's inputs (_adaptive_compare at OPT_AD_CMP_STEPS
    and OPT_SCAN_CMP_STEPS), one timed encode through
    divans_tpu_torch.compress equal to the reference (the model pass's
    two launches and the rANS encode's one), and one round trip (one
    scan launch; the frames it flags decode on the host, counted).
    Returns {kernel: (entry, launches)}."""
    t_all = time.perf_counter()
    res = _resolve(data, opts, f"{tag}-detect")
    ref, t_ref = _option_reference(data, opts, f"{tag}-reference")
    cmp = _adaptive_compare(data, res, ref, device, f"{tag}-compare", smi,
                            steps=OPT_AD_CMP_STEPS,
                            scan_steps=OPT_SCAN_CMP_STEPS)
    launches, mbps = _encode_runs(data, ref, opts, ADAPTIVE_KERNELS, {},
                                  f"{tag}-main", smi, runs=1, warm=False)
    assert launches == {"model_pass": 2, "encode_lanes": 1}, launches
    print(f"[{tag}-main] device encode {mbps:.2f} MB/s against the host-only "
          f"reference {len(data) / t_ref / 1e6:.2f} MB/s in this run | {smi}")
    dec = _roundtrip(ref, data, {"scan_decode": scan_decode},
                     f"{tag}-roundtrip", smi)
    assert dec["scan_decode"] == 1, dec
    print(f"[{tag}] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return {"model_pass": (cmp["model_pass"], launches["model_pass"]),
            "encode_lanes": (cmp["encode_lanes"], launches["encode_lanes"]),
            "scan_decode": (cmp["scan_decode"], dec["scan_decode"])}


def phase_detect(records: bytes, device, smi: str) -> dict:
    """Stride and speed detection on the record corpus, deferred: the
    hybrid (detection resolved into a stride and speeds, which the
    mechanical trace takes), so the host codes the cmd streams; a
    detected stride > 1 keeps the context map (the mix profile), so the
    literals take the generic pass; one warm and one timed encode; the
    round trip decodes on the host (the mix profile, as in the
    reference)."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK,
                            stride_detection_quality=1,
                            speed_detection_quality=1)
    res = apply_detection(records, opts)
    assert res.force_stride_value > 1, \
        f"detected stride {res.force_stride_value}: change the corpus"
    return _deferred_option_path(records, opts, device, "det", smi,
                                 warm=True, decode_cmp=False)


def phase_detect_adaptive(records: bytes, device, smi: str) -> dict:
    opts = dt.DivansOptions(metablock_size=MB_SIZE,
                            stride_detection_quality=1,
                            speed_detection_quality=1)
    return _adaptive_option_path(records, opts, device, "det-ad", smi)


def phase_speeds(data: bytes, device, smi: str) -> dict:
    """Speed detection on the text corpus's head at chunk 256, on the
    hybrid (the host codes the cmd streams): stride 1 keeps the cm
    profile, so kernel 3 codes the literals at the detected speeds and
    kernel 1 decodes them."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK,
                            speed_detection_quality=1)
    return _deferred_option_path(data, opts, device, "speeds", smi)


def phase_optimizer(corpus: bytes, device, smi: str) -> dict:
    """The IR optimizer at levels 1 (OPT_BYTES) and 2 (OPT2_BYTES),
    quality 10, at chunk 256 (kernels 4, 3, 2; kernel 1 on the round
    trip) and at chunk 0 (A1 and 2; A2 on the round trip)."""
    out = {}
    for level, size in ((1, OPT_BYTES), (2, OPT2_BYTES)):
        data = corpus[:size]
        out[f"opt{level}"] = _deferred_option_path(
            data, dt.DivansOptions(metablock_size=MB_SIZE,
                                   chunk_nibbles=CHUNK,
                                   divans_ir_optimizer=level),
            device, f"opt{level}", smi)
        out[f"opt{level}-ad"] = _adaptive_option_path(
            data, dt.DivansOptions(metablock_size=MB_SIZE,
                                   divans_ir_optimizer=level),
            device, f"opt{level}-ad", smi)
    return out


def phase_q11_nocm(data: bytes, device, smi: str) -> dict:
    """Quality 11 without the context map at chunk 256: the matcher's
    command lists through the Python trace FSM (native code refuses the
    stride layout's lists), the cmd pass on the cmd lanes, kernel 5 on
    the literals; the host-only reference is the golden engine's; the
    round trip decodes on the host (the stride profile)."""
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK,
                            quality=11, use_context_map=False)
    return _deferred_option_path(data, opts, device, "q11-nocm", smi,
                                 decode_cmp=False)


def phase_host_options(text: bytes, records: bytes, smi: str) -> None:
    """The options the reference keeps on the host, each on
    HOST_OPT_BYTES: compress (the host route) equal to the host-only
    reference (native.compress where it covers them, else the golden
    engine), then decompress on the card (options= for ECDF), the frames
    by path printed."""
    half = HOST_OPT_BYTES // 2
    mixed = text[:half] + records[:half]   # text, then records
    rng = np.random.default_rng(SEED)
    ecdf = rng.integers(1, 256, 8 * HOST_OPT_BYTES, dtype=np.uint8).tobytes()
    cases = [
        ("block-split", mixed, dict(block_split=True)),
        ("prior-bitmask", records[:HOST_OPT_BYTES],
         dict(prior_bitmask_detection=1)),
        ("cmap16", text[:HOST_OPT_BYTES], dict(cmap_clustering=16)),
        ("cmap16-c256", text[:HOST_OPT_BYTES],
         dict(cmap_clustering=16, chunk_nibbles=CHUNK)),
        ("ecdf", text[:HOST_OPT_BYTES], dict(external_probs=ecdf)),
        ("streaming", text[:HOST_OPT_BYTES],
         dict(streaming_chunk_bytes=65536))]
    for name, data, kw in cases:
        t_all = time.perf_counter()
        opts = dt.DivansOptions(metablock_size=MB_SIZE, **kw)
        ref, t_ref = _option_reference(data, opts, f"host-{name}-reference")
        t0 = time.perf_counter()
        blob = dt.compress(data, opts)
        t_enc = time.perf_counter() - t0
        assert blob == ref, f"[host-{name}] compress differs from the " \
            "host-only reference"
        flags = fmt.parse_header(blob)[2]
        print(f"[host-{name}] compress == the host-only reference, "
              f"{len(data) / t_enc / 1e6:.3f} MB/s; container profile "
              f"{FLAG_PROFILES[flags & 3]}, chunk {flags_to_chunk(flags)}")
        _roundtrip(blob, data, {"scan_decode": scan_decode,
                                "decode_group": lit_decode},
                   f"host-{name}-roundtrip", smi,
                   options=opts if opts.external_probs else None)
        print(f"[host-{name}] phase {time.perf_counter() - t_all:.1f} s")


# ------------------------------- the user surface: billing, CLI, streams

BILL_BYTES = 16 << 20        # billing: the corpus's first 16 MiB
BILL_CPU_BYTES = 256 << 10   # the billing dict against a CPU run's (one
                             # frame at chunk 256)
BILL_AD_CPU_BYTES = 16 << 10  # the same at chunk 0, at metablock 2^12:
BILL_AD_CPU_MB = 1 << 12      # the plain model pass takes ~2 ms a step
STREAM_BYTES = 16 << 20      # the streaming adapters: the first 16 MiB,
STREAM_PIECE = 1 << 20       # written and read in 1 MiB pieces
ALL_KERNELS = {m.NAME: m for m in KERNEL_MODULES}


def _bill_total(bits: dict) -> str:
    """The TOTAL line of codec/billing.format_table's table."""
    return " ".join(billing.format_table(bits, 1, 1).splitlines()[-2].split())


def _billed_cpu_compare(data: bytes, opts, tag: str, smi: str) -> None:
    """compress(billing_out=) on the card against a device="cpu" run (the
    plain versions) on `data`: the same billing dict, __detail__
    included, and the same container."""
    t0 = time.perf_counter()
    cpu_bits: dict = {}
    cpu_blob = dt.compress(data, opts, device="cpu", billing_out=cpu_bits)
    t_cpu = time.perf_counter() - t0
    bits: dict = {}
    blob = dt.compress(data, opts, billing_out=bits)
    assert bits == cpu_bits, f"[{tag}] the card's billing differs from " \
        "the CPU run's"
    assert blob == cpu_blob, f"[{tag}] the containers differ"
    print(f"[{tag}] billing on the card == the device='cpu' run's on the "
          f"first {len(data)} bytes at metablock {opts.metablock_size} "
          f"({len(bits) - 1} designations and the per-CDF report; "
          f"{_bill_total(bits)}; CPU run {t_cpu:.1f} s) | {smi}")


def _billed_main(data: bytes, opts, kernels: dict, tag: str, smi: str):
    """One compress through divans_tpu_torch.compress without billing
    (after a warm one), then one with billing_out, the launches of
    `kernels` and the frames by path counted over it (set to 0 just
    before); the billed container equals the unbilled one.  Returns
    (launches, billing dict)."""
    dt.compress(data, opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = dt.compress(data, opts)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    for m in kernels.values():
        m.LAUNCHES = 0
    encode.reset_stats()
    bits: dict = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = dt.compress(data, opts, billing_out=bits)
    torch.cuda.synchronize()
    t_bill = time.perf_counter() - t0
    launches = {k: m.LAUNCHES for k, m in kernels.items()}
    stats = dict(encode.STATS)
    assert blob == ref, f"[{tag}] the billed container differs"
    assert all(launches.values()), f"[{tag}] a kernel never ran: {launches}"
    route = f" | frames {stats}" if opts.chunk_nibbles else ""
    print(f"[{tag}] compress(billing_out=) == compress on {len(data)} bytes "
          f"({len(fmt.deserialize(blob)[2])} frames): billed "
          f"{len(data) / t_bill / 1e6:.2f} MB/s ({t_bill:.3f} s), unbilled "
          f"{len(data) / t_ref / 1e6:.2f} MB/s ({t_ref:.3f} s) | launches "
          f"{launches}{route} | {smi}")
    print(f"[{tag}] billing table: {_bill_total(bits)}, actual "
          f"{len(blob)} bytes | {smi}")
    return launches, bits


def phase_bill(corpus: bytes, device, smi: str) -> dict:
    """Billing at chunk 256 (quality 10) on the first BILL_BYTES: no
    hybrid, so every cmd stream goes to the card's cmd pass (kernel 4),
    the literals to kernel 3, both to kernel 2, and every step's freq
    comes back.  The kernels against their plain versions on the first
    batch (as a billed encode prepares it), the billed encode equal to
    the unbilled one with every cmd stream on the card, and the billing
    dict against a CPU run's on the first BILL_CPU_BYTES.  Returns
    {kernel: (entry, launches)}."""
    t_all = time.perf_counter()
    data = corpus[:BILL_BYTES]
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK)
    cmp = _deferred_compare(data, opts, device, "bill-compare", smi,
                            billing=True)
    assert "cmd_pass" in cmp and "lit_pass" in cmp, sorted(cmp)
    launches, _bits = _billed_main(
        data, opts, {k: DEFERRED_KERNELS[k] for k in cmp}, "bill-main", smi)
    n = len(data) // MB_SIZE
    assert encode.STATS == _stats(cmd_device=n, lit_device=n), encode.STATS
    _billed_cpu_compare(data[:BILL_CPU_BYTES], opts, "bill-cpu", smi)
    print(f"[bill] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return {k: (e, launches[k]) for k, e in cmp.items()}


def phase_bill_adaptive(corpus: bytes, device, smi: str) -> dict:
    """Billing at chunk 0 (the defaults) on the first BILL_BYTES: A1 and
    kernel 2, the freqs copied back from A1's lanes.  A1 on the path's
    traces against its plain version (cut at OPT_AD_CMP_STEPS), kernel 2
    on that compare's lanes (timed on the whole launch's), the billed
    encode equal to the unbilled one, and the billing dict against a CPU
    run's on the first BILL_AD_CPU_BYTES at metablock BILL_AD_CPU_MB.
    Returns {kernel: (entry, launches)}."""
    t_all = time.perf_counter()
    data = corpus[:BILL_BYTES]
    opts = dt.DivansOptions(metablock_size=MB_SIZE)
    tag = "bill-ad-compare"
    blocks = [data[o:o + MB_SIZE] for o in range(0, len(data), MB_SIZE)]
    traces = _ad_traces(blocks, opts)
    mp, full, cut = _model_pass_compare(traces, _ad_layout(opts).num_rows,
                                        device, tag, smi, OPT_AD_CMP_STEPS)
    re_ = _rans_compare(*cut, tag, "adaptive lanes of the model pass's "
                        f"compare (the first {OPT_AD_CMP_STEPS} steps of "
                        "each frame)", smi, main=full)
    del full, cut
    launches, _bits = _billed_main(data, opts, ADAPTIVE_KERNELS,
                                   "bill-ad-main", smi)
    assert launches == {"model_pass": 2, "encode_lanes": 1}, launches
    _billed_cpu_compare(data[:BILL_AD_CPU_BYTES],
                        dt.DivansOptions(metablock_size=BILL_AD_CPU_MB),
                        "bill-ad-cpu", smi)
    print(f"[bill-ad] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return {"model_pass": (mp, launches["model_pass"]),
            "encode_lanes": (re_, launches["encode_lanes"])}


def _launches_zeroed() -> None:
    for m in KERNEL_MODULES:
        m.LAUNCHES = 0


def phase_cli(corpus: bytes, smi: str) -> None:
    """The CLI on the corpus through files in a temporary directory:
    `-c -timing`, whose container equals divans_tpu_torch.compress's and
    whose stage table (tracelog.report) is printed, then `-d`, whose
    output equals the corpus; the kernels each launched, counted; the
    CLI's MB/s beside the API's."""
    t_all = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = dt.compress(corpus)
    t_api_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert dt.decompress(ref) == corpus, "[cli] api round trip differs"
    t_api_d = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        src, out, back = (os.path.join(d, n) for n in ("in", "out", "back"))
        with open(src, "wb") as f:
            f.write(corpus)
        err = io.StringIO()
        tracelog.clear()
        _launches_zeroed()
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                rc = cli.main(["-c", "-timing", src, out])
            t_c = time.perf_counter() - t0
        finally:
            tracelog.enable(False)
            tracelog.clear()
        launches_c = {k: m.LAUNCHES for k, m in ALL_KERNELS.items()
                      if m.LAUNCHES}
        with open(out, "rb") as f:
            blob = f.read()
        assert rc == 0 and blob == ref, "[cli] -c differs from compress"
        table = err.getvalue().strip().splitlines()
        assert table and table[-1].strip().endswith("TOTAL"), table
        print(f"[cli] -c -timing {len(corpus)} bytes -> {len(blob)} == "
              f"divans_tpu_torch.compress's container | launches "
              f"{launches_c} | stage table (tracelog.report):")
        for line in table:
            print(f"[cli]   {line}")
        _launches_zeroed()
        t0 = time.perf_counter()
        rc = cli.main(["-d", out, back])
        t_d = time.perf_counter() - t0
        launches_d = {k: m.LAUNCHES for k, m in ALL_KERNELS.items()
                      if m.LAUNCHES}
        with open(back, "rb") as f:
            assert rc == 0 and f.read() == corpus, "[cli] -d differs"
    assert launches_c == {"model_pass": 2, "rans_encode": 1}, launches_c
    assert launches_d == {"scan_decode": 1}, launches_d
    mb = len(corpus) / 1e6
    print(f"[cli] -d == the corpus | launches {launches_d} | CLI -c "
          f"{mb / t_c:.2f} MB/s, -d {mb / t_d:.2f} MB/s (files included) "
          f"against compress {mb / t_api_c:.2f} MB/s, decompress "
          f"{mb / t_api_d:.2f} MB/s (one run each) | {smi}")
    print(f"[cli] phase {time.perf_counter() - t_all:.1f} s | {smi}")


def phase_stream(corpus: bytes, smi: str) -> None:
    """The streaming adapters at the defaults on the first STREAM_BYTES,
    written and read in STREAM_PIECE pieces, on the host (no kernel
    launched, counted): the reader's output equals the input, and the
    writer's container decodes through divans_tpu_torch.decompress on
    the card (one scan launch)."""
    t_all = time.perf_counter()
    data = corpus[:STREAM_BYTES]
    opts = dt.DivansOptions()
    _launches_zeroed()
    sink = io.BytesIO()
    t0 = time.perf_counter()
    w = io_adapters.CompressorWriter(sink, opts)
    for off in range(0, len(data), STREAM_PIECE):
        w.write(data[off:off + STREAM_PIECE])
    w.flush_final()
    t_w = time.perf_counter() - t0
    blob = sink.getvalue()
    t0 = time.perf_counter()
    r = io_adapters.DecompressorReader(io.BytesIO(blob), opts)
    got = bytearray()
    while True:
        piece = r.read(STREAM_PIECE)
        if not piece:
            break
        got += piece
    t_r = time.perf_counter() - t0
    assert bytes(got) == data, "[stream] the reader's output differs"
    host = {k: m.LAUNCHES for k, m in ALL_KERNELS.items() if m.LAUNCHES}
    assert not host, f"[stream] the adapters launched kernels: {host}"
    mb = len(data) / 1e6
    print(f"[stream] CompressorWriter {len(data)} bytes in {STREAM_PIECE}-"
          f"byte writes -> {len(blob)} ({len(fmt.deserialize(blob)[2])} "
          f"frames) {mb / t_w:.2f} MB/s; DecompressorReader in "
          f"{STREAM_PIECE}-byte reads == the input {mb / t_r:.2f} MB/s "
          f"(host only, no kernel launched) | {smi}")
    dec = _roundtrip(blob, data, {"scan_decode": scan_decode},
                     "stream-roundtrip", smi)
    assert dec == {"scan_decode": 1}, dec
    print(f"[stream] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return blob, mb / t_w, mb / t_r


# ------------------------------------------------ the C API shim

REPO_ROOT = os.path.dirname(os.path.abspath(__file__))
CAPI_DIR = os.path.join(REPO_ROOT, "divans_tpu_torch", "c")
CAPI_OUT = os.path.join(REPO_ROOT, "divans_tpu_torch", "_build", "capi")
CAPI_BYTES = STREAM_BYTES    # [capi]: the corpus's first 16 MiB
NEEDS_MORE_INPUT, NEEDS_MORE_OUTPUT, FAILURE = 1, 2, 3


def capi_missing() -> list:
    """The tools the shim's build needs that this machine lacks."""
    inc = sysconfig.get_config_var("INCLUDEPY") or ""
    return [name for name, ok in (
        ("cc", shutil.which("cc")), ("make", shutil.which("make")),
        ("python3-config", shutil.which("python3-config")),
        ("the Python headers", os.path.exists(os.path.join(inc,
                                                            "Python.h"))))
        if not ok]


def capi_build() -> str:
    """make -C divans_tpu_torch/c with this interpreter; the build
    directory."""
    subprocess.run(["make", "-C", CAPI_DIR, f"PYTHON={sys.executable}"],
                   check=True, capture_output=True, timeout=300)
    return CAPI_OUT


def capi_lib(path: str):
    """The shim loaded into this interpreter (ctypes.PyDLL: the GIL stays
    held across each call), its entry points typed."""
    lib = ctypes.PyDLL(path)
    p, sz, u8 = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint8
    lib.divans_new_compressor.restype = p
    lib.divans_set_option.argtypes = [p, u8, ctypes.c_uint32]
    lib.divans_set_option.restype = u8
    for fn in (lib.divans_encode, lib.divans_decode):
        fn.argtypes = [p, p, sz, ctypes.POINTER(sz), p, sz,
                       ctypes.POINTER(sz)]
        fn.restype = u8
    lib.divans_encode_flush.argtypes = [p, p, sz, ctypes.POINTER(sz)]
    lib.divans_encode_flush.restype = u8
    lib.divans_free_compressor.argtypes = [p]
    lib.divans_new_decompressor.restype = p
    lib.divans_free_decompressor.argtypes = [p]
    lib.divans_last_error_code.restype = ctypes.c_int32
    return lib


def capi_encode(lib, data: bytes, piece: int, out_cap: int,
                selectors=()) -> tuple:
    """data through the shim's compressor: the options set by
    divans_set_option (selector, value) pairs, the input fed `piece`
    bytes a call, the output drained `out_cap` bytes a call.  Returns
    (the container, each divans_set_option result, the result codes
    seen)."""
    c = lib.divans_new_compressor()
    res = [lib.divans_set_option(c, sel, val) for sel, val in selectors]
    out, codes = bytearray(), set()
    buf = ctypes.create_string_buffer(out_cap)
    size = ctypes.c_size_t
    for off in range(0, len(data), piece):
        chunk = data[off:off + piece]
        in_off = size(0)
        while True:
            out_off = size(0)
            r = lib.divans_encode(c, chunk, len(chunk), ctypes.byref(in_off),
                                  buf, out_cap, ctypes.byref(out_off))
            out += buf.raw[:out_off.value]
            codes.add(r)
            if r != NEEDS_MORE_OUTPUT:
                break
    while True:
        out_off = size(0)
        r = lib.divans_encode_flush(c, buf, out_cap, ctypes.byref(out_off))
        out += buf.raw[:out_off.value]
        codes.add(r)
        if r != NEEDS_MORE_OUTPUT:
            break
    lib.divans_free_compressor(c)
    return bytes(out), res, codes


def capi_decode(lib, blob: bytes, piece: int, out_cap: int) -> tuple:
    """blob through the shim's decompressor, fed `piece` bytes a call,
    drained `out_cap` bytes a call (until a failure).  Returns (the bytes,
    the last result, divans_last_error_code, the result codes seen)."""
    d = lib.divans_new_decompressor()
    out, codes, r = bytearray(), set(), NEEDS_MORE_INPUT
    buf = ctypes.create_string_buffer(out_cap)
    size = ctypes.c_size_t
    for off in range(0, len(blob), piece):
        chunk = blob[off:off + piece]
        in_off = size(0)
        while True:
            out_off = size(0)
            r = lib.divans_decode(d, chunk, len(chunk), ctypes.byref(in_off),
                                  buf, out_cap, ctypes.byref(out_off))
            out += buf.raw[:out_off.value]
            codes.add(r)
            if r != NEEDS_MORE_OUTPUT:
                break
        if r == FAILURE:
            break
    code = lib.divans_last_error_code()
    lib.divans_free_decompressor(d)
    return bytes(out), r, code, codes


def phase_capi(corpus: bytes, stream: tuple, smi: str) -> None:
    """The C API shim bound to the port (divans_tpu_torch/c), built with
    this machine's compiler, on the corpus's first CAPI_BYTES at the
    defaults: the example binary's round trip (its own process, no card
    visible, so it can launch nothing), then the shim driven through
    ctypes in this process at the [stream] piece size, each direction
    timed: the container equal to the [stream] writer's, the output to the
    input, no kernel launched (counted).  Where a tool the build needs is
    missing, one line says which."""
    missing = capi_missing()
    if missing:
        print(f"[capi] not built: this machine has no {', '.join(missing)} "
              f"| {smi}")
        return
    t_all = time.perf_counter()
    data = corpus[:CAPI_BYTES]
    blob_stream, w_mbps, r_mbps = stream
    t0 = time.perf_counter()
    out_dir = capi_build()
    t_build = time.perf_counter() - t0
    mb = len(data) / 1e6
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "in")
        with open(src, "wb") as f:
            f.write(data)
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   DIVANS_TPU_PYTHONPATH=REPO_ROOT,
                   PATH=os.path.dirname(sys.executable) + os.pathsep
                   + os.environ.get("PATH", ""))
        t0 = time.perf_counter()
        r = subprocess.run([os.path.join(out_dir, "example"), src], env=env,
                           capture_output=True, text=True, timeout=600)
        t_ex = time.perf_counter() - t0
        # what the example's embedded interpreter pays before any byte
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c",
                        "import divans_tpu_torch.capi_support"], env=env,
                       check=True, timeout=300)
        t_start = time.perf_counter() - t0
    assert r.returncode == 0 and r.stdout.startswith(f"ok {len(data)} -> "), \
        f"[capi] example failed: {r.stdout} {r.stderr}"
    _launches_zeroed()
    lib = capi_lib(os.path.join(out_dir, "libdivans_tpu_torch_capi.so"))
    t0 = time.perf_counter()
    blob, _res, enc_codes = capi_encode(lib, data, STREAM_PIECE, STREAM_PIECE)
    t_enc = time.perf_counter() - t0
    assert blob == blob_stream, "[capi] the shim's container differs from " \
        "the streaming writer's"
    t0 = time.perf_counter()
    got, res, _code, dec_codes = capi_decode(lib, blob, STREAM_PIECE,
                                             STREAM_PIECE)
    t_dec = time.perf_counter() - t0
    assert res == 0 and got == data, "[capi] the shim's decode differs"
    launched = {k: m.LAUNCHES for k, m in ALL_KERNELS.items() if m.LAUNCHES}
    assert not launched, f"[capi] the shim launched kernels: {launched}"
    print(f"[capi] built (make -C divans_tpu_torch/c, {t_build:.1f} s); "
          f"example {r.stdout.strip()}: the round trip of {len(data)} bytes "
          f"and its two corrupt decodes (the flipped CRC's reads the whole "
          f"container) in {t_ex:.2f} s wall ({mb / t_ex:.2f} MB/s), of "
          f"which ~{t_start:.2f} s the interpreter's start and imports (a "
          f"python3 importing capi_support, timed alone), no card visible "
          f"| ctypes in {STREAM_PIECE}-byte pieces: "
          f"divans_encode {mb / t_enc:.2f} MB/s (== the [stream] writer's "
          f"container; results {sorted(enc_codes)}), divans_decode "
          f"{mb / t_dec:.2f} MB/s (== the input; results "
          f"{sorted(dec_codes)}), no kernel launched | [stream] writer "
          f"{w_mbps:.2f} MB/s, reader {r_mbps:.2f} MB/s | {smi}")
    print(f"[capi] phase {time.perf_counter() - t_all:.1f} s | {smi}")


# ------------------------------------------------ metablock data parallelism

DIST_BYTES = 16 << 20     # [dist]: the corpus's first 16 MiB (64 frames)
DIST_CMP_LANES = 16       # the compare's lanes: each shard's first ones
DIST_SUB_LANES = 4 * decode.LANES   # the decode's lanes a step (4 shards)


def _dist_span(timing: list) -> tuple[dict, list]:
    """({device: ms from its first shard's start to its last shard's
    end}, each shard's own ms) of a step's timing list (device, start
    event, end event); events compare only on their own device."""
    spans = {}
    for dev in dict.fromkeys(d for d, _s, _e in timing):
        evs = [(s, e) for d, s, e in timing if d == dev]
        ref = evs[0][0]
        spans[str(dev)] = (max(ref.elapsed_time(e) for _s, e in evs)
                           - min(ref.elapsed_time(s) for s, _e in evs))
    return spans, [s.elapsed_time(e) for _d, s, e in timing]


def _dist_run(step, args, tag: str, smi: str) -> tuple:
    """One call of a dist step after a warm one (which allocates the
    pinned host buffers), with the kernels' counts set to 0 just before
    it: (its outputs, the counts read just after); prints its host clock
    (and its host stages, tracelog) and CUDA-event times."""
    step(*args)
    _launches_zeroed()
    timing: list = []
    tracelog.clear()
    tracelog.enable()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(*args, timing=timing)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tracelog.enable(False)
    stages: dict = {}
    for ev in tracelog.events():
        stages[ev.name] = stages.get(ev.name, 0.0) + ev.dt
    tracelog.clear()
    launches = {k: m.LAUNCHES for k, m in ALL_KERNELS.items() if m.LAUNCHES}
    spans, per = _dist_span(timing)
    print(f"[{tag}] step {wall * 1e3:.1f} ms host clock ("
          f"{', '.join(f'{k} {v * 1e3:.1f}' for k, v in stages.items())} "
          f"ms); by CUDA events, each device from its first shard's start "
          f"to its last shard's end: "
          f"{', '.join(f'{d} {ms:.3f}' for d, ms in spans.items())} ms; "
          f"each shard {', '.join(f'{ms:.3f}' for ms in per)} ms | "
          f"launches {launches} | {smi}")
    return out, launches


def _dist_cmp_rows(mesh, b: int) -> list[int]:
    """The compare's rows: each shard's first DIST_CMP_LANES // len(mesh)
    rows of a batch of b."""
    per, k = b // len(mesh), max(1, DIST_CMP_LANES // len(mesh))
    return [i * per + j for i in range(len(mesh)) for j in range(min(k, per))]


def _dist_encode(data: bytes, opts, traces, meshes, tag: str, smi: str):
    """The sharded encode step of `data`'s frames (their `traces`) on each
    mesh: cmd and lit sub-traces (at chunk > 0 the lit ones cut into
    sub-streams), padded to every mesh's size; the container assembled in
    frame order must equal native.compress's and be the same on every
    mesh.  Returns (the container, the padded (cmd, lit) batches, r_cmd,
    r_lit, the last mesh's launches)."""
    chunk = opts.chunk_nibbles
    profile = profile_for_options(opts)
    layout = ModelLayout(PROFILES[profile], lo_bucketed=chunk > 0)
    blocks = [data[o:o + MB_SIZE] for o in range(0, len(data), MB_SIZE)]
    t0 = time.perf_counter()
    ref = native.compress(data, opts)
    t_ref = time.perf_counter() - t0
    cmd_ts, lit_ts, _m, r_cmd, r_lit = encode.split_stream_traces(traces,
                                                                  layout)
    if chunk:
        lit_ts, spans = encode.split_lit_sub_traces(lit_ts)
    else:
        spans = [(i, 1) for i in range(len(blocks))]
    multiple = int(np.lcm.reduce([len(m) for m in meshes]))
    ct = dist.pad_batch(deferred_pass.pad_traces(
        cmd_ts, cmd_chunk(chunk) if chunk else 1), multiple)
    lt = dist.pad_batch(deferred_pass.pad_traces(lit_ts, max(chunk, 1)),
                        multiple)
    print(f"[{tag}] {len(blocks)} frames of {MB_SIZE} B, chunk {chunk}, "
          f"profile {profile}: cmd batch {ct.shape[0]} x {ct.shape[1]} steps "
          f"({r_cmd} rows), lit batch {lt.shape[0]} x {lt.shape[1]} steps "
          f"({r_lit} rows; {len(lit_ts)} "
          f"{'sub-streams' if chunk else 'streams'}), padded with empty "
          f"lanes to a multiple of {multiple}; native.compress "
          f"{len(data) / t_ref / 1e6:.2f} MB/s | {smi}")
    flags = PROFILE_FLAGS[profile] | chunk_to_flags(chunk)
    blobs, launches = [], None
    for mesh in meshes:
        step = dist.sharded_encode_step(mesh, r_cmd, r_lit, chunk)
        # shards x cards
        name = f"{tag}-mesh{len(mesh)}x{len(set(mesh.devices))}"
        ((cw, cn, cs), (lw, ln, ls)), launches = _dist_run(
            step, (ct, lt), name, smi)
        cmd = rans_encode.lanes_to_bytes(cw, cn, cs)
        lit = rans_encode.lanes_to_bytes(lw, ln, ls)
        assert not any(cmd[len(blocks):] + lit[len(lit_ts):]), \
            f"[{name}] an empty lane coded words"
        frames = [fmt.MetablockFrame(
            len(b), cmd[i], lit_subs_join(lit[o:o + k]) if chunk else lit[o])
            for i, (b, (o, k)) in enumerate(zip(blocks, spans))]
        blob = fmt.serialize(frames, opts.window_size, opts.mb_log2,
                             native.crc32c(data), flags=flags)
        assert blob == ref, f"[{name}] the container differs from " \
            "native.compress's"
        blobs.append(blob)
        print(f"[{name}] mesh {[str(d) for d in mesh.devices]}: the "
              f"container ({len(blob)} B) == native.compress's | {smi}")
    assert all(b == blobs[0] for b in blobs), "the meshes' containers differ"
    return ref, (ct, lt), r_cmd, r_lit, launches


def _dist_decode(blob: bytes, data: bytes, mesh, device, tag: str, smi: str):
    """The sharded decode step on the chunk-256 container: every frame's
    structure (native), its literal sub-streams one a lane in steps of
    DIST_SUB_LANES lanes, the step on `mesh`, each frame's literals
    reassembled and its script executed: the output must equal `data`.
    Kernel 1 against its plain version on the first step's first shard's
    first DEC_CMP_CHUNKS chunks.  Returns (entry, launches)."""
    _w, _mb, frames, _crc, flags = fmt.deserialize(blob)
    chunk = flags_to_chunk(flags)
    s = chunk // 2
    layout = ModelLayout(PROFILES["cm"], lo_bucketed=True)
    with ThreadPoolExecutor(8) as ex:
        scs = list(ex.map(lambda f: decode.decode_structure(f, chunk, layout),
                          frames))
    assert all(sc is not None for sc in scs), "a frame left the envelope"
    streams, n_lits, lcmaps, spds, spans = decode.lane_jobs(
        frames, list(enumerate(scs)))
    lit = np.zeros(sum(n_lits), np.uint8)
    lit_off = np.concatenate([[0], np.cumsum(n_lits)])
    total, entry = {}, None
    for lo in range(0, len(streams), DIST_SUB_LANES):
        hi = min(lo + DIST_SUB_LANES, len(streams))
        queues, n_steps, placement = decode.pack_lane_queues(
            streams[lo:hi], n_lits[lo:hi], lcmaps[lo:hi], spds[lo:hi], chunk,
            lanes=DIST_SUB_LANES)
        assert int(queues.counts.max()) <= 1, "a lane holds two streams"
        step = dist.sharded_decode_step(mesh, layout, chunk, n_steps)
        (out, _cursor), launches = _dist_run(
            step, (queues,), f"{tag}-step{lo // DIST_SUB_LANES}", smi)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        out = out.numpy()
        for j, place in enumerate(placement, start=lo):
            if place is not None:
                lane, c_off = place
                lit[lit_off[j]:lit_off[j + 1]] = \
                    out[lane, c_off * s:c_off * s + n_lits[j]]
        if entry is None:
            entry = _group_compare(
                decode.lane_slice(queues, 0, decode.LANES), n_steps, layout,
                chunk, device, f"{tag}-compare", smi,
                "first shard of the first step", cut=DEC_CMP_CHUNKS)
    out_buf = np.empty(len(data), np.uint8)
    offsets = np.concatenate([[0], np.cumsum([f.raw_len for f in frames])])
    for i, (sc, (o, k)) in enumerate(zip(scs, spans)):
        native.execute_script(sc, lit[lit_off[o]:lit_off[o + k]],
                              out=out_buf[offsets[i]:offsets[i + 1]])
    assert out_buf.tobytes() == data, f"[{tag}] the decode differs"
    print(f"[{tag}] {len(frames)} frames, {len(streams)} literal sub-streams"
          f" one a lane in {-(-len(streams) // DIST_SUB_LANES)} step(s) of "
          f"{DIST_SUB_LANES} lanes on {[str(d) for d in mesh.devices]}; the "
          f"scripts executed: == the {len(data)}-byte input | launches "
          f"{total} | {smi}")
    return entry, total.get(lit_decode.NAME, 0)


def phase_dist(corpus: bytes, device, smi: str) -> dict:
    """Metablock data parallelism (parallel/dist) on the first DIST_BYTES:
    the sharded encode step at chunk 256 (kernel 5 and 2) and at chunk 0
    (A1 and 2) on make_mesh() (every visible card) and on four shards of
    card 0, each container equal to native.compress's and the same on
    both meshes; each kernel against its plain version on each shard's
    first lanes (kernel 5 whole, A1 on each lane's first OPT_AD_CMP_STEPS
    steps, 2 on each lane's first RANS_CMP_STEPS); the sharded decode
    step of the chunk-256 container on the four shards, equal to the
    data.  With more than one card, compress and decompress on the last
    one.  Returns each kernel's (entry, launches on the four-shard
    mesh)."""
    t_all = time.perf_counter()
    data = corpus[:DIST_BYTES]
    blocks = [data[o:o + MB_SIZE] for o in range(0, len(data), MB_SIZE)]
    mesh4 = dist.make_mesh(["cuda:0"] * 4)
    meshes = [dist.make_mesh(), mesh4]
    out = {}
    # chunk 256: the cm profile's mechanical traces, kernel 5 on both
    # streams (cmd at cmd_chunk(256) = 64)
    opts = dt.DivansOptions(metablock_size=MB_SIZE, chunk_nibbles=CHUNK)
    with ThreadPoolExecutor(8) as ex:
        traces = list(ex.map(
            lambda b: encode.frame_trace(b, opts, _layout(opts)), blocks))
    blob, (ct, lt), r_cmd, r_lit, launches = _dist_encode(
        data, opts, traces, meshes, "dist", smi)
    del traces
    assert launches == {"deferred_pass": 8, "rans_encode": 8}, launches
    gen, rans = [], []
    for x, r, s, what in ((ct, r_cmd, cmd_chunk(CHUNK), "cmd"),
                          (lt, r_lit, CHUNK, "lit")):
        rows = _dist_cmp_rows(mesh4, x.shape[0])
        arrays = (x[rows], np.count_nonzero(x[rows][:, :, 2] >= 0, axis=1)
                  .astype(np.int32))
        e, st, fr, n = _generic_lanes_compare(
            arrays, r, s, device, "dist-compare", smi,
            f"{what} lanes {rows[:4]}... (each shard's first)")
        gen.append(e)
        rans.append(_rans_cut_compare(st, fr, n, "dist-compare",
                                      f"{what} lanes", smi))
    out["deferred_pass"] = (_sum_entries(gen), launches["deferred_pass"])
    out["encode_lanes"] = (_sum_entries(rans), launches["rans_encode"])
    del ct, lt
    dec, dec_launches = _dist_decode(blob, data, mesh4, device, "dist-dec",
                                     smi)
    out["decode_group"] = (dec, dec_launches)
    # chunk 0: the adaptive traces, A1 on each stream's sub-traces
    opts0 = dt.DivansOptions(metablock_size=MB_SIZE)
    traces = _ad_traces(blocks, opts0)
    blob0, (ct, lt), r_cmd, r_lit, launches = _dist_encode(
        data, opts0, traces, meshes, "dist-ad", smi)
    del traces
    assert launches == {"model_pass": 16, "rans_encode": 8}, launches
    a1, rans = [], []
    for sid, (x, r, what) in enumerate(((ct, r_cmd, "cmd"),
                                        (lt, r_lit, "lit"))):
        rows = _dist_cmp_rows(mesh4, x.shape[0])
        subs = [x[i][x[i, :, 2] >= 0] for i in rows]
        e, (st, fr, n), _cut = _model_pass_compare(
            subs, r, device, f"dist-ad-compare-{what}", smi,
            steps=OPT_AD_CMP_STEPS)
        a1.append(e)
        rans.append(_rans_cut_compare(
            st[sid::2].contiguous(), fr[sid::2].contiguous(),
            n[sid::2].contiguous(), "dist-ad-compare", f"{what} lanes", smi))
    out["model_pass"] = (_sum_entries(a1), launches["model_pass"])
    out["encode_lanes-ad"] = (_sum_entries(rans), launches["rans_encode"])
    del ct, lt
    n_dev = torch.cuda.device_count()
    if n_dev > 1:
        last = f"cuda:{n_dev - 1}"
        for o, ref in ((opts, blob), (opts0, blob0)):
            _launches_zeroed()
            got = dt.compress(data, o, device=last)
            assert got == ref, f"[dist-guard] compress on {last} differs"
            assert dt.decompress(got, device=last) == data, \
                f"[dist-guard] decompress on {last} differs"
            launches = {k: m.LAUNCHES for k, m in ALL_KERNELS.items()
                        if m.LAUNCHES}
            print(f"[dist-guard] chunk {o.chunk_nibbles}: compress and "
                  f"decompress with device={last!r} == native.compress's "
                  f"container and the data | launches {launches}; "
                  f"make_mesh() ran one shard a card, {last} included | "
                  f"{smi}")
    else:
        print(f"[dist-guard] not reached: {n_dev} card visible, so no "
              f"compress or decompress on a card other than the current "
              f"one, and make_mesh() has one shard | {smi}")
    print(f"[dist] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return out


# ------------------------------------ the port without its native library

NN_BYTES = 1 << 20          # [no-native]: the corpus's first 1 MiB (four
                            # frames) at chunk 256 and at chunk 0: the
                            # greedy parse and the Python trace FSM take
                            # ~4 s a frame on one core
NN_Q11_BYTES = 256 << 10    # one frame at quality 11: the Python
                            # dictionary scan takes ~30 s a frame
# each entry of the kernels line and the module that counts its launches
ENTRY_MODULES = {"cmd_pass": cmd_pass, "lit_pass": lit_pass,
                 "deferred_pass": deferred_pass, "encode_lanes": rans_encode,
                 "decode_group": lit_decode, "model_pass": model_pass,
                 "scan_decode": scan_decode}


@contextlib.contextmanager
def _native_absent():
    """native.load patched to return None for the block (the library
    absent: every host stage takes the reference's lib-less route), then
    restored."""
    real = native.load
    native.load = lambda: None
    try:
        yield
    finally:
        native.load = real


@contextlib.contextmanager
def _spy(module, name: str, calls: list):
    """module.name wrapped for the block: each call appends (its first
    argument, its result, its start and end on the host clock) to
    `calls` (from any thread)."""
    real = getattr(module, name)

    def spy(*args, **kw):
        t0 = time.perf_counter()
        res = real(*args, **kw)
        calls.append((args[0], res, t0, time.perf_counter()))
        return res

    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def _span(calls: list) -> float:
    """Seconds from the first call's start to the last call's end (the
    calls run on a pool: their sum would count the overlap)."""
    return (max(c[3] for c in calls) - min(c[2] for c in calls)
            if calls else 0.0)


def _nn_run(data: bytes, opts, native_on: bool):
    """One encode and one decode of `data` through divans_tpu_torch on the
    card, with the library or without it (_native_absent), the launches
    of each counted from 0 and the frames by path; the host stages of
    each timed by _spy as their span (the encode's host_frame at chunk
    256, _host_frame at chunk 0: the trace and its packing; the decode's
    structure pass at chunk 256, the scripts' execution), and the CRC of
    the input alone.  Returns the container, a dict of the numbers, the
    host results in frame order and the scripts' classes."""
    chunk = opts.chunk_nibbles
    absent = contextlib.nullcontext() if native_on else _native_absent()
    host, struct, execs = [], [], []
    r = {}
    with absent:
        _launches_zeroed()
        encode.reset_stats()
        with _spy(encode if chunk else adaptive,
                  "host_frame" if chunk else "_host_frame", host):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blob = dt.compress(data, opts)
            torch.cuda.synchronize()
            r["enc_s"] = time.perf_counter() - t0
        r["enc_launches"] = {k: m.LAUNCHES for k, m in ALL_KERNELS.items()
                             if m.LAUNCHES}
        r["enc_stats"] = dict(encode.STATS)
        _launches_zeroed()
        decode.reset_stats()
        adaptive.reset_stats()
        with _spy(decode, "decode_structure", struct), \
                _spy(decode, "execute", execs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = dt.decompress(blob)
            torch.cuda.synchronize()
            r["dec_s"] = time.perf_counter() - t0
        assert raw == data, "the round trip differs"
        r["dec_launches"] = {k: m.LAUNCHES for k, m in ALL_KERNELS.items()
                             if m.LAUNCHES}
        r["dec_stats"] = dict(decode.STATS if chunk else adaptive.STATS)
        t0 = time.perf_counter()
        native.crc32c(data)
        r["crc_s"] = time.perf_counter() - t0
    r["host_s"], r["struct_s"], r["exec_s"] = (_span(c) for c in
                                               (host, struct, execs))
    by_raw = {c[0]: c[1] for c in host}
    order = [by_raw[data[o:o + MB_SIZE]] for o in range(0, len(data),
                                                         MB_SIZE)]
    scripts = sorted({type(c[0]).__name__ for c in execs})
    return blob, r, order, scripts


def _nn_line(tag: str, what: str, n: int, s_off: float, s_on: float,
             smi: str) -> None:
    print(f"[{tag}] {what}: without the library {s_off:.3f} s "
          f"({n / s_off / 1e6:.3f} MB/s), with it {s_on:.3f} s "
          f"({n / s_on / 1e6:.3f} MB/s) | {smi}")


def _nn_case(data: bytes, opts, device, tag: str, smi: str) -> dict:
    """One input without the library against the same with it: the
    encode and the decode through divans_tpu_torch (_nn_run), each
    stage's seconds and MB/s side by side; the lib-less container
    decodes on the card to the input (at chunk 256 through CmdScripts
    from the golden structure pass feeding kernel 1) and, with the
    library back, through native.decompress (an independent decoder).
    Then each kernel that ran, against its plain version on the main
    path's own inputs (the host results the run made), cut as the option
    paths cut them: at chunk 256 the cmd pass (or kernel 5), the lit
    pass and the rANS encode on the frames' lanes and kernel 1 on the
    container's first lane group (its scripts CmdScripts, cut at
    DEC_CMP_CHUNKS); at chunk 0 A1, the rANS encode and A2 (cut at
    OPT_AD_CMP_STEPS and OPT_SCAN_CMP_STEPS).  Returns {kernel: (entry,
    launches on the lib-less path)}."""
    t_all = time.perf_counter()
    chunk = opts.chunk_nibbles
    n = len(data)
    n_frames = -(-n // MB_SIZE)
    blob_lib, on, _o, _s = _nn_run(data, opts, True)
    blob, off, host, scripts = _nn_run(data, opts, False)
    t0 = time.perf_counter()
    assert native.decompress(blob) == data, \
        f"[{tag}] native.decompress of the lib-less container differs"
    t_native = time.perf_counter() - t0
    print(f"[{tag}] {n} bytes, {n_frames} frames, chunk {chunk}, quality "
          f"{opts.quality}: lib-less container {len(blob)} B "
          f"({len(blob) / n:.4f}), with the library {len(blob_lib)} B "
          f"({len(blob_lib) / n:.4f}); the lib-less one round-trips on the "
          f"card and through native.decompress ({t_native:.3f} s) | {smi}")
    _nn_line(tag, "encode e2e", n, off["enc_s"], on["enc_s"], smi)
    _nn_line(tag, "encode host stage (each frame's trace and its packing "
             "on the pool, first start to last end)", n, off["host_s"],
             on["host_s"], smi)
    _nn_line(tag, "decode e2e", n, off["dec_s"], on["dec_s"], smi)
    if chunk:
        _nn_line(tag, "decode structure pass (on the pool, first start to "
                 "last end)", n, off["struct_s"], on["struct_s"], smi)
        _nn_line(tag, "decode script execution (first start to last end)",
                 n, off["exec_s"], on["exec_s"], smi)
    _nn_line(tag, "CRC32c of the input, alone (each decode checks it)", n,
             off["crc_s"], on["crc_s"], smi)
    print(f"[{tag}] without the library: encode launches "
          f"{off['enc_launches']}, frames {off['enc_stats']} | decode "
          f"launches {off['dec_launches']}, frames {off['dec_stats']}, "
          f"scripts {scripts} | with it: encode launches "
          f"{on['enc_launches']}, frames {on['enc_stats']}, decode launches "
          f"{on['dec_launches']} | {smi}")
    el, dl, st = off["enc_launches"], off["dec_launches"], off["enc_stats"]
    if chunk:
        # no hybrid: both streams of every frame on the card
        assert st["cmd_host"] == 0 and st["lit_device"] == n_frames and \
            st["cmd_device"] + st["cmd_generic"] == n_frames, st
        assert el.get("lit_pass") and el.get("rans_encode") and \
            (el.get("cmd_pass") or el.get("deferred_pass")), el
        assert {k: off["dec_stats"][k] for k in DECODE_FRAMES} == {
            "device_frames": n_frames, "host_frames": 0,
            "golden_frames": 0}, off["dec_stats"]
        assert dl.get("lit_decode") and scripts == ["CmdScript"], \
            (dl, scripts)
        cmp = _deferred_compare(data, opts, device, f"{tag}-compare", smi,
                                got=host)
        with _native_absent():
            cmp["decode_group"] = phase_compare(
                blob, device, f"{tag}-dec-compare", smi, cut=DEC_CMP_CHUNKS)
    else:
        assert el == {"model_pass": 2, "rans_encode": 1}, el
        assert dl == {"scan_decode": 1}, dl
        cmp = _adaptive_compare(data, opts, blob, device, f"{tag}-compare",
                                smi, steps=OPT_AD_CMP_STEPS,
                                scan_steps=OPT_SCAN_CMP_STEPS,
                                traces=[t for t, _c in host])
    launches = {**el, **dl}
    print(f"[{tag}] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return {k: (e, launches[ENTRY_MODULES[k].NAME]) for k, e in cmp.items()}


def phase_no_native(corpus: bytes, device, smi: str) -> dict:
    """The port without its native library ([no-native]): native.load
    patched to return None, so the host stages take the reference's
    Python routes (the greedy parse, the Python dictionary scan and trace
    FSM, the golden structure pass and script executor) while every
    device stage stays on its kernel, at metablock 2^18 with 32 KiB
    literal sub-streams: the first NN_BYTES at chunk 256 (quality 10)
    and at chunk 0, one NN_Q11_BYTES frame at quality 11 (chunk 256),
    each as _nn_case runs it.  Returns each kernel's (entry, launches),
    the cases' compares summed into one entry and their launches
    added."""
    t_all = time.perf_counter()
    base = dict(metablock_size=MB_SIZE)
    cases = [("no-native-c256", corpus[:NN_BYTES],
              dt.DivansOptions(chunk_nibbles=CHUNK, **base)),
             ("no-native-c0", corpus[:NN_BYTES], dt.DivansOptions(**base)),
             ("no-native-q11", corpus[:NN_Q11_BYTES],
              dt.DivansOptions(chunk_nibbles=CHUNK, quality=11, **base))]
    parts: dict = {}
    for tag, data, opts in cases:
        for k, (e, launches) in _nn_case(data, opts, device, tag,
                                         smi).items():
            parts.setdefault(k, []).append((e, launches))
    print(f"[no-native] phase {time.perf_counter() - t_all:.1f} s | {smi}")
    return {k: (_sum_entries([e for e, _l in v]), sum(l for _e, l in v))
            for k, v in parts.items()}


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
    dec = phase_compare(blob, device, "dec-compare", smi)
    dec_launches = phase_main(blob, corpus, device, smi)
    # the decode's opt-in routes on the same container
    resume, resume_launches = phase_routes(blob, corpus, device, smi)
    corpus16 = corpus[:Q11_BYTES]
    blob16 = phase_q11_reference(corpus16)
    q11 = phase_q11_compare(corpus16, device, smi)
    q11_launches = phase_q11_main(corpus16, blob16, smi)
    dec16 = phase_compare(blob16, device, "q11-dec-compare", smi)
    dec16_launches = phase_q11_roundtrip(blob16, corpus16, smi)
    mix = phase_mix(corpus, device, smi)
    stride = phase_stride(corpus[:STRIDE_BYTES], device, smi)
    q11_mix = phase_q11_mix(corpus[:Q11_MIX_BYTES], device, smi)
    # the adaptive profile (chunk_nibbles=0): the defaults, the stride
    # profile, quality 11
    ad = phase_adaptive(corpus, device, smi, "ad", dt.DivansOptions(),
                        edges=True)
    ad_stride = phase_adaptive(corpus[:AD_STRIDE_BYTES], device, smi,
                               "ad-stride",
                               dt.DivansOptions(use_context_map=False),
                               runs=1)
    # quality 11: the frames with dict commands leave the scan for the
    # host (counted and printed, not expected)
    ad_q11 = phase_adaptive(corpus[:AD_Q11_BYTES], device, smi, "ad-q11",
                            dt.DivansOptions(quality=11), runs=1,
                            expect_host=None)
    # the options beyond the defaults: detection (the record corpus),
    # speed detection, the IR optimizer, quality 11 without the context
    # map on the card; the host options
    t_opts = time.perf_counter()
    records = build_records(DETECT_BYTES)
    det = phase_detect(records, device, smi)
    det_ad = phase_detect_adaptive(records, device, smi)
    speeds = phase_speeds(corpus[:SPEED_BYTES], device, smi)
    opt = phase_optimizer(corpus, device, smi)
    nocm = phase_q11_nocm(corpus[:Q11_NOCM_BYTES], device, smi)
    phase_host_options(corpus, records, smi)
    print(f"[options] the option phases took "
          f"{time.perf_counter() - t_opts:.1f} s | {smi}")
    # the user surface: billing at chunk 256 and 0, the CLI, the
    # streaming adapters, the C API shim over them
    t_surface = time.perf_counter()
    bill = phase_bill(corpus, device, smi)
    bill_ad = phase_bill_adaptive(corpus, device, smi)
    phase_cli(corpus, smi)
    stream = phase_stream(corpus, smi)
    phase_capi(corpus, stream, smi)
    print(f"[surface] the billing, CLI, stream and C API phases took "
          f"{time.perf_counter() - t_surface:.1f} s | {smi}")
    # metablock data parallelism: the sharded steps of parallel/dist
    dist_k = phase_dist(corpus, device, smi)
    # the port without its native library: the reference's lib-less
    # routes on the host, every device stage on its kernel
    no_native = phase_no_native(corpus, device, smi)
    # one entry a kernel and path: its launches counted on that path's
    # run, its comparison made on that path's own inputs
    decode_src = "divans_tpu/codec/pallas_decode.py:182"
    lit_src = "divans_tpu/codec/pallas_lit_pass.py:99"
    rans_src = "divans_tpu/ans/pallas_kernels.py:57"
    cmd_src = "divans_tpu/codec/pallas_cmd_pass.py:144"
    generic_src = "divans_tpu/codec/pallas_model.py:100"
    # the adaptive profile's device programs (XLA scans, no Pallas kernel)
    model_src = "divans_tpu/codec/jax_engine.py:77"
    scan_src = "divans_tpu/codec/jax_decode.py:98"
    rows = [("decode_group", lit_decode, "quality-10 decode", dec,
             dec_launches, decode_src),
            ("decode_group", lit_decode, "quality-11 decode", dec16,
             dec16_launches, decode_src),
            # ms and bound a segment launch of the resumed kernel
            ("decode_group", lit_decode, "resume", resume, resume_launches,
             decode_src),
            ("lit_pass", lit_pass, "quality-10 encode", enc["lit_pass"],
             enc_launches["lit_pass"], lit_src),
            ("lit_pass", lit_pass, "quality-11 encode", q11["lit_pass"],
             q11_launches["lit_pass"], lit_src),
            ("encode_lanes", rans_encode, "quality-10 encode",
             enc["encode_lanes"], enc_launches["encode_lanes"], rans_src),
            # a batch launches it twice (cmd lanes, lit lanes): its ms,
            # plain_ms and bound_ms are the two launches' sum
            ("encode_lanes", rans_encode, "quality-11 encode",
             q11["encode_lanes"], q11_launches["encode_lanes"], rans_src),
            # compared on each profile's first batch's generic lit lanes
            ("encode_lanes", rans_encode, "mix-profile encode",
             *mix["encode_lanes"], rans_src),
            ("encode_lanes", rans_encode, "stride-profile encode",
             *stride["encode_lanes"], rans_src),
            # cmd lanes and generic lit lanes, summed as at quality 11
            ("encode_lanes", rans_encode, "quality-11 mix-profile encode",
             *q11_mix["encode_lanes"], rans_src),
            ("cmd_pass", cmd_pass, "quality-11 encode", q11["cmd_pass"],
             q11_launches["cmd_pass"], cmd_src),
            ("cmd_pass", cmd_pass, "quality-11 mix-profile encode",
             *q11_mix["cmd_pass"], cmd_src),
            ("deferred_pass", deferred_pass, "mix-profile encode",
             *mix["deferred_pass"], generic_src),
            ("deferred_pass", deferred_pass, "stride-profile encode",
             *stride["deferred_pass"], generic_src),
            ("deferred_pass", deferred_pass, "quality-11 mix-profile encode",
             *q11_mix["deferred_pass"], generic_src),
            # the adaptive profile: each timed on its path's whole launch
            # and compared on that path's inputs cut to fit the plain
            # loop ("compare", "compare_ms": the kernel on the cut)
            ("encode_lanes", rans_encode, "adaptive encode",
             *ad["encode_lanes"], rans_src),
            ("encode_lanes", rans_encode, "adaptive stride-profile encode",
             *ad_stride["encode_lanes"], rans_src),
            ("encode_lanes", rans_encode, "adaptive quality-11 encode",
             *ad_q11["encode_lanes"], rans_src),
            ("model_pass", model_pass, "adaptive encode",
             *ad["model_pass"], model_src),
            ("model_pass", model_pass, "adaptive stride-profile encode",
             *ad_stride["model_pass"], model_src),
            ("model_pass", model_pass, "adaptive quality-11 encode",
             *ad_q11["model_pass"], model_src),
            ("scan_decode", scan_decode, "adaptive decode",
             *ad["scan_decode"], scan_src),
            ("scan_decode", scan_decode, "adaptive stride-profile decode",
             *ad_stride["scan_decode"], scan_src),
            ("scan_decode", scan_decode, "adaptive quality-11 decode",
             *ad_q11["scan_decode"], scan_src)]
    # the options on the card: each kernel on each new path, compared on
    # that path's inputs (the rANS encode's cmd and lit launches summed)
    option_paths = [
        (det, "detected-stride encode", "detected-stride decode"),
        (det_ad, "adaptive detected-stride encode",
         "adaptive detected-stride decode"),
        (speeds, "speed-detected encode", "speed-detected decode"),
        (opt["opt1"], "IR-optimizer level-1 encode",
         "IR-optimizer level-1 decode"),
        (opt["opt2"], "IR-optimizer level-2 encode",
         "IR-optimizer level-2 decode"),
        (opt["opt1-ad"], "adaptive IR-optimizer level-1 encode",
         "adaptive IR-optimizer level-1 decode"),
        (opt["opt2-ad"], "adaptive IR-optimizer level-2 encode",
         "adaptive IR-optimizer level-2 decode"),
        (nocm, "quality-11 no-context-map encode", None),
        (bill, "bill", None),
        (bill_ad, "bill-ad", None)]
    srcs = {"cmd_pass": cmd_src, "lit_pass": lit_src,
            "deferred_pass": generic_src, "encode_lanes": rans_src,
            "model_pass": model_src, "decode_group": decode_src,
            "scan_decode": scan_src}
    mods = {k: (ENTRY_MODULES[k], src) for k, src in srcs.items()}
    for got, enc_path, dec_path in option_paths:
        for k_name, (e, launches) in got.items():
            path = dec_path if k_name in ("decode_group", "scan_decode") \
                else enc_path
            rows.append((k_name, mods[k_name][0], path, e, launches,
                         mods[k_name][1]))
    # the sharded steps on four shards of card 0: 5/dist, 2/dist,
    # A1/dist-ad, 2/dist-ad, 1/dist
    for key, path in (("deferred_pass", "dist encode"),
                      ("encode_lanes", "dist encode"),
                      ("model_pass", "dist adaptive encode"),
                      ("encode_lanes-ad", "dist adaptive encode"),
                      ("decode_group", "dist decode")):
        k_name = key.split("-")[0]
        rows.append((k_name, mods[k_name][0], path, *dist_k[key],
                     mods[k_name][1]))
    # without the native library: every kernel that path ran, its
    # launches over the three cases' runs, its compares summed
    for k_name, (e, launches) in no_native.items():
        rows.append((k_name, mods[k_name][0], "no-native", e, launches,
                     mods[k_name][1]))
    kernels = [{
        "name": k_name, "path": path, "route": "cuda",
        "source": f"divans_tpu_torch/csrc/{mod.NAME}.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": e["max_abs_err"], "ms": e["ms"],
        "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
        "bound_by": e["bound_by"], "library_ms": None,
        "n_bytes": e["n_bytes"], "n_ops": e["n_ops"],
        **{k: e[k] for k in ("compare", "compare_ms") if k in e}}
        for k_name, mod, path, e, launches, replaces in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
