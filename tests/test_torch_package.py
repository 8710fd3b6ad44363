"""Package rules of the PyTorch port (divans_tpu_torch): it loads neither
JAX nor the JAX package, it never quietly falls back to the CPU, and the
repo's undefined-name lint covers it."""
import ast
import glob
import importlib.util
import os
import re
import subprocess
import sys

import pytest
import torch

import divans_tpu_torch
from divans_tpu_torch import cuda_build
from divans_tpu_torch.ans import rans_encode
from divans_tpu_torch.codec import (cmd_pass, deferred_pass, lit_decode,
                                    lit_pass, model_pass, scan_decode)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(glob.glob(os.path.join(REPO, "divans_tpu_torch", "**",
                                           "*.py"), recursive=True)) \
    + [os.path.join(REPO, "chip_smoke.py")]


def _rel(p):
    return os.path.relpath(p, REPO)


def test_import_loads_no_jax():
    """In a fresh interpreter, importing the port (and chip_smoke, which
    imports all of its modules) leaves no jax and no divans_tpu module."""
    code = ("import sys; import divans_tpu_torch, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'divans_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


# the host modules of the golden engine and the options, and the user
# surface (stage tracing, billing, the IR text, the CLI, the streaming
# adapters): copies of the JAX package's modules that import no JAX, of
# which the port keeps its own
HOST_MODULES = ["probability.scalar", "probability.blend_cdf",
                "probability.external_cdf", "ans.coder_np", "codec.model",
                "codec.engine_np", "codec.deferred", "codec.trace",
                "ir.detect", "ir.optimize", "ir.blocks", "ir.cmaps",
                "ir.matcher", "tracelog", "codec.billing", "ir.ir_text",
                "cli", "io_adapters"]


def test_host_modules_load_no_jax():
    """In a fresh interpreter, importing each host module of the golden
    engine and the options, and running the golden engine and detection
    on a few bytes, leaves no jax and no divans_tpu module."""
    code = ("import sys, importlib; "
            + "; ".join(f"importlib.import_module('divans_tpu_torch.{m}')"
                        for m in HOST_MODULES)
            + "; from divans_tpu_torch.codec import engine_np; "
            "from divans_tpu_torch.options import DivansOptions as O; "
            "d = bytes(range(256)) * 20; "
            "o = O(stride_detection_quality=1, speed_detection_quality=1); "
            "assert engine_np.decompress(engine_np.compress(d, o)) == d; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'divans_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=_rel)
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        for root in roots:
            assert root not in ("jax", "jaxlib", "divans_tpu"), \
                f"{_rel(path)}:{node.lineno} imports {root}"


C_FILES = sorted(glob.glob(os.path.join(REPO, "divans_tpu_torch", "c", "**",
                                        "*"), recursive=True))


def test_c_shim_imports_only_the_port():
    """The port's C shim (divans_tpu_torch/c) imports divans_tpu_torch
    modules only, each of which exists, and no file there mentions
    jax."""
    found = []
    for path in C_FILES:
        if os.path.isdir(path):
            continue
        text = open(path, encoding="utf-8").read()
        assert "jax" not in text.lower(), f"{_rel(path)} mentions jax"
        if path.endswith(".c"):
            found += re.findall(r'PyImport_ImportModule\("([^"]*)"\)', text)
    assert found
    for name in found:
        assert name.split(".")[0] == "divans_tpu_torch", name
        assert importlib.util.find_spec(name) is not None, name


def test_decompress_without_cuda_raises(monkeypatch):
    blob = divans_tpu_torch.compress(
        b"abc" * 1000, divans_tpu_torch.DivansOptions(chunk_nibbles=256),
        device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        divans_tpu_torch.decompress(blob)
    assert divans_tpu_torch.decompress(blob, device="cpu") == b"abc" * 1000


def _meta(shape, dtype):
    return torch.zeros(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: lit_decode.decode_group(
        {"words": _meta((1, 64), torch.int32)}, _meta((384,), torch.int32),
        1, 4, 128),
    lambda: lit_pass.lit_pass(_meta((1, 128), torch.uint16),
                              _meta((1, 6), torch.int32),
                              _meta((1,), torch.int32), 256),
    lambda: rans_encode.encode_lanes(*[_meta((1, 512), torch.int32)] * 2,
                                     _meta((1,), torch.int32)),
    lambda: cmd_pass.cmd_pass(_meta((1, 64), torch.uint16),
                              *[_meta((1, 203), torch.int32)] * 2,
                              _meta((1,), torch.int32), 64),
    lambda: deferred_pass.deferred_pass(_meta((1, 256, 10), torch.int32),
                                        _meta((1,), torch.int32), 385, 256),
    lambda: model_pass.model_pass(_meta((16, 10), torch.int32),
                                  _meta((1,), torch.int32), 2379, 16),
    lambda: scan_decode.decode_scan(
        *[_meta(s, torch.int32) for s in ((1,), (1, 16), (1,), (1, 16),
                                          (1,))], "cm", 16, 1024),
], ids=["lit_decode", "lit_pass", "rans_encode", "cmd_pass", "deferred_pass",
        "model_pass", "scan_decode"])
def test_kernel_wrapper_rejects_other_devices(call):
    """Each wrapper takes the plain version only for CPU tensors; any
    other device is the kernel's or an error, never a silent fallback."""
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("touched,rebuilds", [
    (None, False), ("k.cu", True), ("floor_div.cuh", True)],
    ids=["nothing", "source", "header"])
def test_kernel_rebuilds_when_its_source_or_a_header_is_newer(
        tmp_path, monkeypatch, touched, rebuilds):
    """cuda_build.load compiles csrc/<name>.cu again when the source or
    any csrc/*.cuh header (which the sources include) is newer than the
    built library, and only then (nvcc and the loader stubbed)."""
    csrc, build = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    build.mkdir()
    for f in ("k.cu", "floor_div.cuh"):
        (csrc / f).write_text("")
        os.utime(csrc / f, (1000, 1000))
    (build / "k.so").write_text("")
    os.utime(build / "k.so", (2000, 2000))
    if touched:
        os.utime(csrc / touched, (3000, 3000))
    runs = []

    def fake_nvcc(cmd, **_kw):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class Lib:
        def __getattr__(self, _name):
            return type("Fn", (), {})()

    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda _path: Lib())
    cuda_build.load("k", {"entry": []})
    assert len(runs) == int(rebuilds)


def _lint_module():
    spec = importlib.util.spec_from_file_location(
        "_repo_lint", os.path.join(REPO, "tests", "test_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", PORT_FILES, ids=_rel)
def test_port_undefined_names(path):
    """tests/test_lint.py's undefined-name check, over the port."""
    _lint_module().test_no_undefined_names(path)
