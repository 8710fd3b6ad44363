"""A configuration, a traffic mix, a cell and a per-layer metric are
taken up by adding files and entries alone: the harness finds them by
name, with no file of it edited."""
import copy
import json
import os
import shutil

from portbench import run


def test_added_files_are_found_by_name(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(run.HERE, base,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: open(p, "rb").read() for p in map(str, base.rglob("*"))
              if os.path.isfile(p)}
    # a new configuration, mix and per-layer metric: files of their own
    cfg = json.load(open(base / "configs" / "adaptive-q10.json"))
    cfg.update(name="adaptive-q10-w20")
    cfg["options"]["window_size"] = 20
    (base / "configs" / "adaptive-q10-w20.json").write_text(json.dumps(cfg))
    (base / "traffic" / "mixed-rw-1k.json").write_text(json.dumps({
        "ops": [{"op": "read", "weight": 3}, {"op": "write", "weight": 1}],
        "block_bytes": 1024, "distinct": 3, "clients": 2,
        "check_frames": 1}))
    (base / "metrics" / "calls_per_s.py").write_text(
        "def read(run):\n"
        "    return len(run.calls) / run.window_s\n")
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": "adaptive-q10-w20",
                             "source": "https://github.com/dropbox/divans",
                             "file": "portbench/configs/adaptive-q10-w20.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "w20.mixed-rw-1k",
                               "config": "adaptive-q10-w20",
                               "traffic": "mixed-rw-1k", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("decode_MBps", "encode_MBps"):
            m["workloads"].append("w20.mixed-rw-1k")
    bench["end_to_end"].append({"name": "encode_p50_ms", "unit": "ms",
                                "better": "lower", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["w20.mixed-rw-1k"]})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "api", "moves": "decode_MBps",
                               "workloads": ["w20.mixed-rw-1k"]})
    got = run.rehearse("w20.mixed-rw-1k", 3, seconds=1.0, bench=bench,
                       base=str(base), block_bytes=1024, distinct=3)
    assert got["correct"], got
    assert set(got["metrics"]) == {"decode_MBps", "encode_MBps",
                                   "encode_p50_ms", "setup_s"}
    got = run.rehearse("w20.mixed-rw-1k", 3, seconds=0.5, trace=True,
                       bench=bench, base=str(base), block_bytes=1024,
                       distinct=3)
    assert got["metrics"]["calls_per_s"]["value"] > 0
    # the harness's own files are untouched
    for p, b in before.items():
        assert open(p, "rb").read() == b
