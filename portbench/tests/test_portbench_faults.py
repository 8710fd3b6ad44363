"""The check against a broken timed path: the control and each fault a
cell can have make `correct` false, a sound run leaves it true; and the
imports: no JAX nor the JAX package after a run, nothing of the program
in the reference."""
import json
import os
import subprocess
import sys

import pytest

from portbench import run

# (cell, fault, seconds): stale needs two calls on different blocks, and
# the 48 MiB read decodes one container only, so it cannot have that
# fault; a window of ~2 calls on the CPU at this size
CASES = [(cell, fault, 2.5 if fault == "stale" else 0.2)
         for cell in ("adaptive.read-4m", "adaptive.write-4m",
                      "adaptive.read-48m")
         for fault in ("control", "stale", "half", "altered")
         if not (fault == "stale" and cell.endswith("48m"))]


@pytest.mark.parametrize("cell,fault,seconds", CASES)
def test_fault_fails_the_check(cell, fault, seconds):
    got = run.rehearse(cell, 11, seconds=seconds, fault=fault,
                       block_bytes=512)
    assert not got["correct"], got
    assert any(c["value"] > c["limit"] for c in got["checks"].values())


def test_fault_planted_below_the_entry_point():
    """A decode altered inside the pipeline: the program's own CRC check
    raises, and the failed call fails the run."""
    from divans_tpu_torch.codec import adaptive
    orig = adaptive.decompress_frames

    def altered(*a, **kw):
        out = orig(*a, **kw)
        return bytes([out[0] ^ 1]) + out[1:]

    cell = run.load_cell("adaptive.read-4m")
    h, r, setup_s = run.set_up(cell, 12, "cpu", {"interpreter": 0.0,
                                                 "imports": 0.0}, 512, 2)
    adaptive.decompress_frames = altered
    try:
        got = run.measure(h, r, 0.2, False, setup_s)
    finally:
        adaptive.decompress_frames = orig
    assert not got["correct"] and got["failed"] >= 1
    assert got["checks"]["failed_calls"]["value"] >= 1


SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
got = run.rehearse("adaptive.write-4m", 4, seconds=0.2, block_bytes=512)
print(json.dumps([got["correct"], run.forbidden_modules(),
                  sorted(m for m in sys.modules if m.split(".")[0] in
                         ("jax", "jaxlib", "flax", "divans_tpu"))]))
"""


def test_no_jax_after_a_run():
    p = subprocess.run([sys.executable, "-c", SCRIPT.format(root=run.ROOT)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    correct, bad, names = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and bad == [] and names == []


def test_forbidden_modules_compared_by_whole_top_level_name(monkeypatch):
    import types
    for name in ("jaxfoo", "divans_tpu_torch_x.y", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "divans_tpu.api",
                        types.ModuleType("divans_tpu.api"))
    assert run.forbidden_modules() == ["divans_tpu"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.codec, portbench.work, "
            "portbench.check, portbench.corpus; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('divans_tpu') or "
            "m.split('.')[0] in ('jax', 'jaxlib', 'flax')))" % run.ROOT)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
