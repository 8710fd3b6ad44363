"""Every cell of BENCHMARK.json through the harness's rehearsal path
(the CPU, the kernels' plain versions, a tiny size), the result's keys,
and the command's refusal without a card."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run

ROOT = run.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def _keys_ok(result: dict, cell: run.Cell, trace: bool) -> None:
    assert list(result)[:3] == ["correct", "attempted", "failed"]
    assert list(result)[-1] == "checks"
    want = {m["name"] for m in (cell.per_layer if trace else
                                cell.end_to_end)}
    if trace:
        assert set(result["metrics"]) <= want
    else:
        assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearsal(name):
    cell = run.load_cell(name)
    got = run.rehearse(name, 2 ** 31 + 11, seconds=0.2)
    assert got["correct"], got
    assert got["attempted"] >= 1 and got["failed"] == 0
    _keys_ok(got, cell, trace=False)
    assert got["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", ["adaptive.read-4m", "adaptive.write-4m"])
def test_traced_rehearsal(name):
    cell = run.load_cell(name)
    got = run.rehearse(name, 5, seconds=0.2, trace=True)
    assert got["correct"], got
    _keys_ok(got, cell, trace=True)
    # off the card only the host's spans and counters have a reading
    assert not any(m["source"] == "device_trace" and m["name"]
                   in got["metrics"] for m in cell.per_layer)
    assert got["metrics"], got


def test_every_metric_has_a_reader():
    for m in BENCH["per_layer"]:
        assert callable(run.reader(run.HERE, m["name"]))
    for w in BENCH["workloads"]:
        cell = run.load_cell(w["name"])
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert cell.per_layer


def test_command_refuses_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_command_refuses_without_the_program(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark's own runs are on "
                    "the card")


def test_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "adaptive.read-48m", "--seed", "77", "--seconds",
                        "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["device"]["platform"] == "gpu"
