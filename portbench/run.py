#!/usr/bin/env python3
"""The benchmark of divans_tpu_torch, the PyTorch and CUDA port: one
run of one cell on one NVIDIA GPU.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration
(`configs/<name>.json`: the codec options, the kernels its paths build)
and a traffic mix (`traffic/<name>.json`: block size, distinct blocks,
the share of reads and writes, clients).  The run:

  1. set-up: imports, the kernels' and the host library's builds, the
     seed's corpus (corpus.py), the containers its reads decode (made
     by the program), one warm call of each operation;
  2. the window: each client issues its next call when its last one
     returns, reads through divans_tpu_torch.api.decompress and writes
     through api.compress on the card, until the first completion after
     --seconds;
  3. with --trace 1 the window runs under torch.profiler with the
     program's tracelog on, and the per-layer readers
     (`metrics/<name>.py`) read the spans, the counters and the card's
     timeline; with --trace 0 the end-to-end metrics are taken by the
     host's clock;
  4. the check (check.py): every output of the window against the plain
     reference, each number printed beside its limit.

The last line of standard output is the result as one JSON object.  It
exits non-zero, printing no result, without a CUDA device, with fewer
devices than the cell asks for, or when JAX or the JAX package has been
imported.  CPU tests drive the same path through `rehearse`, with the
plain versions of the kernels.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

PROGRAM = "divans_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "divans_tpu")
# the program's counters (each module's STATS), read before and after
# the window
COUNTERS = {"adaptive": "codec.adaptive", "decode": "codec.decode",
            "encode": "codec.encode"}


class BenchError(Exception):
    """A run that cannot give a result (no card, a missing program, a
    forbidden import): exit non-zero with no result line."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, so
    the interpreter's own start counts)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------ the cell

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    base: str


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None,
              base: str = HERE) -> Cell:
    """The cell's configuration, traffic and metrics, found by name:
    configs by their `file`, traffic/<name>.json, and per-layer readers
    metrics/<name>.py under `base`."""
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg_file = os.path.join(os.path.dirname(base), cfg_entry["file"])
    if not os.path.exists(cfg_file):
        cfg_file = os.path.join(base, "configs", f"{w['config']}.json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, w["chips"], _json(cfg_file),
                _json(os.path.join(base, "traffic",
                                   f"{w['traffic']}.json")),
                e2e, per_layer, base)


def reader(base: str, metric: str):
    """metrics/<metric>.py's `read(run)`."""
    path = os.path.join(base, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the run

@dataclasses.dataclass
class Call:
    client: int
    op: str
    block: int
    t0: float
    t1: float
    out: bytes | None
    error: str | None


class Run:
    """What the readers read: the cell, its inputs, the window's calls,
    the program's spans and counter deltas, and the card's timeline
    (None off the card)."""

    def __init__(self, cell, seed, blocks, containers, opts):
        self.cell = cell
        self.seed = seed
        self.blocks = blocks
        self.containers = containers
        self.opts = opts
        self.calls: list[Call] = []
        self.t0 = self.t1 = 0.0
        self.spans: list = []
        self.stats: dict[str, int] = {}
        self.device = None
        self._traces: dict[int, list] = {}

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def ops(self, op: str) -> list[Call]:
        return [c for c in self.calls if c.op == op and c.error is None]

    def span_ms(self, name: str) -> float | None:
        got = [dt for n, _t0, _t1, dt in self.spans if n == name]
        return 1e3 * sum(got) / len(got) if got else None

    def block_traces(self, block: int) -> list:
        """The block's frames' adaptive traces, built by the reference's
        own binding of the host library (cached)."""
        if block not in self._traces:
            from portbench.reference import codec as ref
            opts = ref.options_of(self.cell.config)
            mb = opts.metablock_size
            raw = self.blocks[block]
            with ThreadPoolExecutor(8) as pool:
                self._traces[block] = list(pool.map(
                    lambda o: ref.frame_trace(raw[o:o + mb], opts),
                    range(0, len(raw), mb)))
        return self._traces[block]


def _counters():
    out = {}
    for key, mod in COUNTERS.items():
        stats = importlib.import_module(f"{PROGRAM}.{mod}").STATS
        out.update({f"{key}.{k}": v for k, v in stats.items()})
    return out


def _sequence(traffic: dict, rng, n_blocks: int) -> list[tuple[str, int]]:
    """One cycle of (op, block): the ops' pattern by weight, shuffled by
    the seed, each op walking the seed's order of the blocks."""
    pattern = [m["op"] for m in traffic["ops"] for _ in range(m["weight"])]
    order = rng.permutation(n_blocks).tolist()
    n = max(len(pattern), n_blocks)
    pattern = [pattern[i % len(pattern)] for i in rng.permutation(n)]
    seen: dict[str, int] = {}
    out = []
    for op in pattern:
        k = seen.get(op, 0)
        seen[op] = k + 1
        out.append((op, order[k % n_blocks]))
    return out


class Harness:
    """One cell's set-up, window and check; `device` is "cuda" on the
    card and "cpu" in the rehearsal."""

    def __init__(self, cell: Cell, seed: int, device: str, setup: dict,
                 block_bytes: int | None = None,
                 distinct: int | None = None):
        self.cell = cell
        self.seed = seed
        self.device = device
        self.setup = setup
        t = cell.traffic
        self.block_bytes = block_bytes or t["block_bytes"]
        self.distinct = distinct or t["distinct"]

    def prepare(self, pools=None) -> Run:
        import numpy as np
        from divans_tpu_torch import api
        from divans_tpu_torch.options import DivansOptions
        from portbench import corpus
        t = time.perf_counter()
        data, shares = corpus.build(self.block_bytes * self.distinct,
                                    self.seed, pools)
        blocks = [data[i * self.block_bytes:(i + 1) * self.block_bytes]
                  for i in range(self.distinct)]
        self.setup["corpus"] = time.perf_counter() - t
        self.shares = shares
        opts = DivansOptions(**self.cell.config["options"])
        ops = {m["op"] for m in self.cell.traffic["ops"]}
        t = time.perf_counter()
        containers = ([api.compress(b, opts, device=self.device)
                       for b in blocks] if "read" in ops else [])
        self.setup["containers"] = time.perf_counter() - t
        run = Run(self.cell, self.seed, blocks, containers, opts)
        rng = np.random.default_rng(self.seed % (1 << 64))
        self.sequence = _sequence(self.cell.traffic, rng, len(blocks))
        if self.device != "cpu":
            import torch
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        for op in sorted(ops):
            self._call(run, op, self.sequence[0][1] if op == "write"
                       else 0)
        self.setup["warm"] = time.perf_counter() - t
        return run

    def _call(self, run: Run, op: str, block: int) -> bytes:
        from divans_tpu_torch import api
        if op == "read":
            return api.decompress(run.containers[block], device=self.device)
        if op == "write":
            return api.compress(run.blocks[block], run.opts,
                                device=self.device)
        raise BenchError(f"unknown op {op!r}")

    def window(self, run: Run, seconds: float, trace: bool) -> None:
        """The timed calls; with `trace`, under the profiler and the
        program's tracelog."""
        import torch
        from divans_tpu_torch import tracelog
        clients = self.cell.traffic.get("clients", 1)
        marks: list[float] = []
        lock = threading.Lock()
        record = torch.profiler.record_function if trace else None

        def client(k: int) -> list[Call]:
            got = []
            i = k * len(self.sequence) // clients
            while True:
                op, block = self.sequence[i % len(self.sequence)]
                i += 1
                t0 = time.perf_counter()
                out = err = None
                try:
                    if record is None:
                        out = self._call(run, op, block)
                    else:
                        with record("portbench/call"):
                            with lock:
                                marks.append(t0)
                            out = self._call(run, op, block)
                except Exception as e:  # noqa: BLE001 - counted as failed
                    err = f"{type(e).__name__}: {e}"
                t1 = time.perf_counter()
                got.append(Call(k, op, block, t0, t1, out, err))
                if t1 >= deadline:
                    return got

        before = _counters()
        prof = None
        if trace:
            tracelog.clear()
            tracelog.enable(True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device != "cpu":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        run.t0 = time.perf_counter()
        deadline = run.t0 + seconds
        if clients == 1:
            calls = client(0)
        else:
            with ThreadPoolExecutor(clients) as pool:
                calls = [c for f in [pool.submit(client, k)
                                     for k in range(clients)]
                         for c in f.result()]
        run.t1 = max(c.t1 for c in calls)
        run.calls = sorted(calls, key=lambda c: c.t0)
        if prof is not None:
            prof.__exit__(None, None, None)
            tracelog.enable(False)
            # a span's t0 counts from the log's origin, on perf_counter
            origin = tracelog._t_origin
            run.spans = [(e.name, origin + e.t0, origin + e.t0 + e.dt, e.dt)
                         for e in tracelog.events()]
            tracelog.clear()
            self._read_trace(run, prof, sorted(marks))
        after = _counters()
        run.stats = {k: after[k] - before.get(k, 0) for k in after}

    def _read_trace(self, run: Run, prof, marks: list[float]) -> None:
        from portbench.devtrace import DeviceTrace
        if self.device == "cpu":
            return
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            run.device = DeviceTrace.from_chrome(path, marks, run.t0, run.t1)
        log(f"[trace] {size} B of trace, {len(run.device.events)} device "
            f"events, read in {time.perf_counter() - t:.3f} s")


# --------------------------------------------------------- the metrics

def _percentile(values: list[float], q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values), q))


def end_to_end(run: Run, name: str, setup_s: float) -> float:
    """An end-to-end metric by its name: setup_s; <op>_MBps (bytes of
    the op's completed calls, 10^6, over the window); <op>_p<q>_ms (the
    q-th percentile of the times of the op's calls); op decode or
    encode."""
    if name == "setup_s":
        return setup_s
    kind, _, stat = name.partition("_")
    op = {"decode": "read", "encode": "write"}[kind]
    calls = run.ops(op)
    if stat == "MBps":
        n = sum(len(run.blocks[c.block]) for c in calls)
        return n / 1e6 / run.window_s
    if stat.startswith("p") and stat.endswith("_ms"):
        # a failed call counts too (its time to the failure), so a run
        # in which every call failed still has a tail to print
        times = [1e3 * (c.t1 - c.t0) for c in run.calls if c.op == op]
        return _percentile(times, float(stat[1:-3]))
    raise BenchError(f"no rule for the end-to-end metric {name}")


def per_layer(run: Run) -> dict:
    out = {}
    for m in run.cell.per_layer:
        v = reader(run.cell.base, m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(run: Run) -> dict | None:
    from portbench.devtrace import label_gaps
    if run.device is None:
        return None
    return {"device_ops": run.device.top_ops(10),
            "idle_gaps": label_gaps(run.device.gaps(),
                                    [s[:3] for s in run.spans], run.calls)}


# --------------------------------------------------------- the command

def _device_info(device: str, chips: int, trace_run: Run | None) -> dict:
    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": max(
                    torch.cuda.max_memory_allocated(i)
                    for i in range(chips))}
    if trace_run is not None:
        dev = trace_run.device
        info["busy_s"] = dev.busy_s if dev else 0.0
        info["window_s"] = dev.window_s if dev else trace_run.window_s
    return info


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def set_up(cell: Cell, seed: int, device: str, setup: dict,
           block_bytes: int | None = None, distinct: int | None = None,
           pools=None):
    """The host library, the kernels, the seed's inputs and the warm
    calls: (harness, run, setup_s)."""
    from divans_tpu_torch import cuda_build, native
    t = time.perf_counter()
    native.load()
    setup["native"] = time.perf_counter() - t
    t = time.perf_counter()
    mods = [importlib.import_module(f"{PROGRAM}.{m}")
            for m in cell.config.get("kernels", [])]
    if device != "cpu":
        with ThreadPoolExecutor(max(1, len(mods))) as pool:
            list(pool.map(lambda m: m.build(), mods))
    setup["kernels"] = time.perf_counter() - t
    setup["kernel_build_s"] = sum(cuda_build.BUILD_SECONDS.values())
    h = Harness(cell, seed, device, setup, block_bytes, distinct)
    run = h.prepare(pools)
    setup_s = process_age()
    log(f"[setup] {cell.name} seed {seed}: interpreter start and imports "
        f"{setup['interpreter'] + setup['imports']:.3f} s, host library "
        f"{setup['native']:.3f} s, kernels {setup['kernels']:.3f} s (build "
        f"or load {setup['kernel_build_s']:.3f}), corpus "
        f"{setup['corpus']:.3f} s ({h.shares[0]} B text, {h.shares[1]} B "
        f"headers, {h.shares[2]} B binary), containers "
        f"{setup['containers']:.3f} s, warm {setup['warm']:.3f} s; setup_s "
        f"{setup_s:.3f}")
    return h, run, setup_s


def measure(h: Harness, run: Run, seconds: float, trace: bool,
            setup_s: float, fault: str | None = None) -> dict:
    """The window, its metrics and the check; the result's dict.
    `fault` (faults.KINDS) plants a fault for the control and the tests."""
    import contextlib
    from portbench import check, faults
    cell = h.cell
    ops = {m["op"] for m in cell.traffic["ops"]}
    ctx = (faults.plant(fault, next(iter(ops)), run.blocks, run.containers)
           if fault else contextlib.nullcontext())
    with ctx:
        h.window(run, seconds, trace)
    result = {"correct": False, "attempted": len(run.calls),
              "failed": sum(1 for c in run.calls if c.error is not None)}
    if trace:
        metrics = per_layer(run)
    else:
        metrics = {m["name"]: {"value": end_to_end(run, m["name"], setup_s),
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    result["metrics"] = metrics
    result["device"] = _device_info(h.device, cell.chips,
                                    run if trace else None)
    bd = breakdown(run) if trace else None
    if bd is not None:
        result["breakdown"] = bd
    for c in run.calls:
        if c.error is not None:
            log(f"[call] {c.op} block {c.block} failed: {c.error}")
            break
    times = [1e3 * (c.t1 - c.t0) for c in run.calls]
    log(f"[window] {len(times)} calls in {run.window_s:.3f} s; call ms p5 "
        f"{_percentile(times, 5):.2f}, p50 {_percentile(times, 50):.2f}, "
        f"p95 {_percentile(times, 95):.2f}, max {max(times):.2f}; the "
        f"first fifth's p50 {_percentile(times[:len(times) // 5 or 1], 50):.2f}"
        f", the last fifth's {_percentile(times[-(len(times) // 5 or 1):], 50):.2f}")
    checks, checked = check.verdict(run.calls, run.blocks, cell.config,
                                    cell.traffic, h.seed)
    run.calls = []
    result["correct"] = result["attempted"] > 0 and check.is_correct(checks)
    result["frames_checked"] = checked
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, setup: dict, fault: str | None = None,
            block_bytes: int | None = None, distinct: int | None = None,
            pools=None) -> dict:
    """Set-up, window, metrics and check of one run."""
    h, run, setup_s = set_up(cell, seed, device, setup, block_bytes,
                             distinct, pools)
    return measure(h, run, seconds, trace, setup_s, fault)


def rehearse(name: str, seed: int, seconds: float = 0.5, trace: bool = False,
             fault: str | None = None, bench: dict | None = None,
             base: str = HERE, block_bytes: int = 768, distinct: int = 2,
             pools=None) -> dict:
    """The run's path on the CPU with the kernels' plain versions, at a
    tiny size (no look for a card): for the tests."""
    cell = load_cell(name, bench, base)
    setup = {"interpreter": 0.0, "imports": 0.0}
    return execute(cell, seed, seconds, trace, "cpu", setup, fault,
                   block_bytes, min(distinct, cell.traffic["distinct"]),
                   pools)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    setup = {"interpreter": process_age() - (time.perf_counter() - T_START)}
    t = time.perf_counter()
    cell = load_cell(args.workload)
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        raise BenchError(f"the program ({PROGRAM}/) is not in {ROOT}")
    # the program's and torch's caches stay inside the checkout
    cache = os.path.join(HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < cell.chips:
        raise BenchError(f"{cell.name} needs {cell.chips} devices, "
                         f"{torch.cuda.device_count()} visible")
    import divans_tpu_torch  # noqa: F401
    setup["imports"] = time.perf_counter() - t
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: "
        f"{power_limit()} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", setup)
    bad = forbidden_modules()
    if bad:
        raise BenchError(f"forbidden modules imported: {', '.join(bad)}")
    for k, c in result["checks"].items():
        log(f"[check] {k} {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BenchError as e:
        log(f"portbench: {e}")
        sys.exit(3)
