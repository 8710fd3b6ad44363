"""The port's textual IR (divans_tpu_torch/ir/ir_text.py) against the
reference's divans_tpu/ir/ir_text.py on the same command lists: the
matcher's lists on seeded text at quality 9 and 11 (Dict commands), a
block-split list, and a hand-made list with ltype/ctype/dtype switches
and a PredictionMode with context maps, mixing values and speeds.  dump
gives the same text, parse(dump(...)) the same commands, and recode
the input bytes."""
import glob
import os

import numpy as np
import pytest

from divans_tpu.ir import commands as jcmds
from divans_tpu.ir import ir_text as jir
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions
from divans_tpu.probability import speed as jspeed

import divans_tpu_torch as port
from divans_tpu_torch.ir import commands as cmds
from divans_tpu_torch.ir import ir_text, matcher
from divans_tpu_torch.probability import speed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))


def _text(n: int, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(TEXT) - n))
    return TEXT[start:start + n]


def _hetero(n: int, seed: int) -> bytes:
    """Text, an int16 wave, text: segments block split separates."""
    t = np.arange(n // 4)
    wave = (20000 * np.sin(t / 300.0) + 3000 * np.sin(t / 17.0)).astype(
        "<i2").tobytes()
    text = _text(n // 2, seed)
    return text[:3 * n // 8] + wave + text[3 * n // 8:]


@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


def _reprs(commands):
    return [repr(c) for c in commands]


def _check(commands, jcommands, window: int, data: bytes | None):
    """Both dumps equal; each parse returns its package's commands (the
    parses equal each other, and dumping a parse gives the same text);
    recode gives `data`."""
    assert _reprs(commands) == _reprs(jcommands)
    text = ir_text.dump(commands, window, len(data) if data else None)
    assert text == jir.dump(jcommands, window, len(data) if data else None)
    w, parsed = ir_text.parse(text)
    jw, jparsed = jir.parse(text)
    assert w == jw == window
    assert _reprs(parsed) == _reprs(jparsed)
    assert ir_text.dump(parsed, window, len(data) if data else None) == text
    if data is not None:
        assert ir_text.recode(commands) == ir_text.recode(parsed) == \
            jir.recode(jcommands) == data
    return parsed


@pytest.mark.parametrize("quality,n", [(9, 12000), (11, 6000)])
def test_matcher_lists_match_reference(quality, n, dictionary_indexes):
    data = _text(n, seed=quality)
    commands = matcher.build_commands(data, port.DivansOptions(
        quality=quality))
    jcommands = jmatcher.build_commands(data, JOptions(quality=quality))
    parsed = _check(commands, jcommands, 22, data)
    if quality == 11:
        assert any(isinstance(c, cmds.Dict) for c in parsed)
    non_pm = [c for c in commands if not isinstance(c, cmds.PredictionMode)]
    assert _reprs(non_pm) == _reprs(
        [c for c in parsed if not isinstance(c, cmds.PredictionMode)])


def test_block_split_list_matches_reference():
    data = _hetero(24000, seed=5)
    commands = matcher.build_commands(data, port.DivansOptions(
        block_split=True))
    jcommands = jmatcher.build_commands(data, JOptions(block_split=True))
    parsed = _check(commands, jcommands, 22, data)
    assert any(isinstance(c, cmds.BlockSwitchLiteral) for c in parsed)


def _hand_made(c, sp):
    """A list with every kind of line, built from a package's commands
    module `c` and speed module `sp`."""
    rng = np.random.default_rng(9)
    lcm = bytes(rng.integers(0, 64, 128, dtype=np.uint8))
    dcm = bytes(rng.integers(0, 4, 8, dtype=np.uint8))
    mv = bytes(rng.integers(0, 2, 8192, dtype=np.uint8) * 4)
    pm = c.PredictionMode(
        literal_prediction_mode=1, context_mixing=1,
        speeds=(sp.Speed(16, 8192), sp.Speed(32, 4096), sp.SLOW, sp.FAST),
        literal_context_map=lcm, distance_context_map=dcm, mixing_values=mv)
    return [pm, c.Literal(b"hello, world! "),
            c.Literal(bytes(range(200, 240)), high_entropy=True),
            c.BlockSwitchLiteral(1, 4), c.Copy(distance=14, num_bytes=30),
            c.BlockSwitchCommand(1), c.BlockSwitchDistance(1),
            c.BlockSwitchLiteral(0), c.Copy(distance=1, num_bytes=5),
            c.Literal(b"tail")]


def test_hand_made_list_matches_reference():
    parsed = _check(_hand_made(cmds, speed), _hand_made(jcmds, jspeed), 18,
                    None)
    assert ir_text.recode(parsed) == jir.recode(_hand_made(jcmds, jspeed))
    pm = parsed[0]
    assert (pm.literal_context_map, pm.distance_context_map) == \
        (_hand_made(cmds, speed)[0].literal_context_map,
         _hand_made(cmds, speed)[0].distance_context_map)


REFERENCE_LINES = """# a comment, then a blank line

window 20 len 64
prediction utf8 lcontextmap 0 1 2 3 cmspeedinc 8 cmspeedmax 8192
insert 4 61626364
rndins 2 ff00
insert 0
copy 0 from 3
copy 6 from 3 ctx 1
dict 4 word 4,0 74696d65 func 0 74696d65 ctx 2
ltype 1 2
ctype 1
dtype 0
"""


def test_parse_accepts_reference_annotations():
    """Comments, blank lines, empty inserts and copies, ctx annotations
    and the word hex of a dict line, as the reference parser takes them."""
    w, parsed = ir_text.parse(REFERENCE_LINES)
    jw, jparsed = jir.parse(REFERENCE_LINES)
    assert w == jw == 20
    assert _reprs(parsed) == _reprs(jparsed)
    assert ir_text.recode(parsed) == jir.recode(jparsed)


@pytest.mark.parametrize("text", ["window 22\nfrobnicate 3\n",
                                  "window 22\ninsert 3 6162\n",
                                  "window 22\ncopy 3 to 1\n"])
def test_bad_lines_raise(text):
    with pytest.raises(ValueError):
        ir_text.parse(text)


def test_recode_rejects_a_copy_outside_the_window():
    with pytest.raises(ValueError):
        ir_text.recode([cmds.Literal(b"ab"), cmds.Copy(distance=3,
                                                       num_bytes=1)])
