"""The port's CLI (divans_tpu_torch/cli.py) against divans_tpu.cli, in
tmp_path: every mode (-c, -d, -i, -ir, -recode) and the flags -serial,
-bill, -timing, -v and -version.  The port's main runs with
device="cpu" (each kernel's plain version).  Output files, and the
billing table and ratio lines on stderr, are byte-equal."""
import glob
import os

import numpy as np
import pytest

from divans_tpu import cli as jcli
from divans_tpu import tracelog as jtracelog

from divans_tpu_torch import cli, tracelog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(TEXT) - n))
    return TEXT[start:start + n]


@pytest.fixture(autouse=True)
def no_stage_events():
    """Both stage logs empty and off (each CLI prints its table on stderr
    whenever its log holds events)."""
    for log in (tracelog, jtracelog):
        log.enable(False)
        log.clear()
    yield
    for log in (tracelog, jtracelog):
        log.enable(False)
        log.clear()


def _both(tmp_path, capsys, argv, data: bytes):
    """Run both CLIs on `data` with `argv`; returns ((port output bytes,
    port stderr), (reference output bytes, reference stderr))."""
    src = tmp_path / "in"
    src.write_bytes(data)
    res = []
    for name, run in (("port", lambda a: cli.main(a, device="cpu")),
                      ("ref", jcli.main)):
        out = tmp_path / f"out_{name}"
        capsys.readouterr()
        assert run([*argv, str(src), str(out)]) == 0
        res.append((out.read_bytes(), capsys.readouterr().err))
    return res


# name: (argv, input size).  Defaults (chunk 0) stay small: the plain
# model pass and scan run a nibble at a time on the CPU.
COMPRESS = {
    "defaults": ([], 1500),
    "deferred": (["-deferred"], 6000),
    "q9_nocm": (["-q9", "-nocm", "-deferred=128", "-bs4096"], 6000),
    "q11": (["-q11"], 1500),
    "serial": (["-serial", "-deferred"], 2000),
    "verbose": (["-v", "-deferred", "-w20"], 3000),
}


@pytest.mark.parametrize("name", COMPRESS)
def test_compress_and_decompress_match_reference(name, tmp_path, capsys):
    argv, n = COMPRESS[name]
    data = _text(n, seed=len(name))
    (blob, err), (ref, ref_err) = _both(tmp_path, capsys, ["-c", *argv],
                                        data)
    assert blob == ref
    assert err == ref_err
    dec = [a for a in argv if a == "-serial"]
    (raw, _e), (ref_raw, _r) = _both(tmp_path, capsys, ["-d", *dec], blob)
    assert raw == ref_raw == data


def test_passthrough_of_a_container(tmp_path, capsys):
    data = _text(2000, seed=1)
    (blob, _e), _ref = _both(tmp_path, capsys, ["-c", "-deferred"], data)
    (again, _e), (ref_again, _r) = _both(tmp_path, capsys, ["-c"], blob)
    assert again == ref_again == blob


@pytest.mark.parametrize("argv,n", [(["-deferred"], 6000),
                                    (["-v"], 1500)])
def test_bill_matches_reference(argv, n, tmp_path, capsys):
    """-bill: the container and the billing table on stderr (with -v the
    per-CDF rows too) equal the reference's."""
    data = _text(n, seed=n)
    (blob, err), (ref, ref_err) = _both(tmp_path, capsys,
                                        ["-c", "-bill", *argv], data)
    assert blob == ref
    assert err == ref_err
    assert "TOTAL (model)" in err
    if "-v" in argv:
        assert "per-CDF entropy debug" in err


def test_ir_modes_match_reference(tmp_path, capsys):
    """-ir dumps the same text; -recode of it gives the input; -i codes
    it into the same container, which -d -serial decodes to the input."""
    data = _text(9000, seed=4)
    (text, _e), (ref_text, _r) = _both(tmp_path, capsys, ["-ir", "-bs4096"],
                                       data)
    assert text == ref_text and text.startswith(b"window 22\n")
    (raw, _e), (ref_raw, _r) = _both(tmp_path, capsys, ["-recode"], text)
    assert raw == ref_raw == data
    one = text.split(b"window 22\n")[1]   # the first metablock's IR
    (blob, _e), (ref_blob, _r) = _both(tmp_path, capsys, ["-i"],
                                       b"window 22\n" + one)
    assert blob == ref_blob
    (dec, _e), _r = _both(tmp_path, capsys, ["-d", "-serial"], blob)
    assert dec == data[:4096]


def test_timing_prints_the_stage_table(tmp_path, capsys):
    data = _text(3000, seed=2)
    (blob, err), (ref, ref_err) = _both(
        tmp_path, capsys, ["-c", "-deferred", "-timing"], data)
    assert blob == ref
    assert "TOTAL" in err and "encode/host_cmd_wait" in err
    assert "TOTAL" in ref_err


def test_version_and_unknown_flag(capsys):
    assert cli.main(["-version"], device="cpu") == 0
    assert capsys.readouterr().out == "divans_tpu_torch 0.1.0\n"
    with pytest.raises(SystemExit) as e:
        cli.main(["-frobnicate"], device="cpu")
    assert e.value.code == 2
