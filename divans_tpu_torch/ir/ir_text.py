"""Textual IR: the port of divans_tpu/ir/ir_text.py, the debugging
oracle in the reference CLI's dialect (its command printer and parser),
so the reference's `.ir` fixtures parse and recode directly.

    window <log2> [len <total>]
    prediction <utf8|sign|lsb6|msb6> [lcontextmap n...] [dcontextmap n...]
        [mixingvalues n...] [cmspeedinc a [b]] [cmspeedmax a [b]]
        [stspeedinc a [b]] [stspeedmax a [b]] [mxspeedinc ...] (mx ignored)
    ltype <N> [stride] | ctype <N> | dtype <N>
    copy <N> from <D> [ctx C]            (len 0 lines are dropped)
    insert <N> <hex-bytes>
    dict <FINAL> word <LEN>,<IDX> [hexword] func <T> [hexout] [ctx C]

Extra trailing tokens (the ctx annotations the reference prints) are
accepted and ignored, as in the reference parser.  Everything here runs
on the host: `recode` executes commands into bytes with no entropy
coding.
"""
from __future__ import annotations

from . import commands as cmds
from ..probability.speed import Speed, DEFAULT_LITERAL_SPEED
from .. import dictionary

_PM_NAMES = {"lsb6": 0, "msb6": 1, "sign": 2, "utf8": 3}
_PM_RNAMES = {v: k for k, v in _PM_NAMES.items()}


def dump(commands: list[cmds.Command], window: int,
         total_len: int | None = None) -> str:
    """Commands -> IR text (reference print dialect)."""
    head = f"window {window}"
    if total_len is not None:
        head += f" len {total_len}"
    lines = [head]
    for c in commands:
        if isinstance(c, cmds.PredictionMode):
            parts = [f"prediction {_PM_RNAMES[c.literal_prediction_mode]}"]
            if c.literal_context_map:
                parts.append("lcontextmap " + " ".join(
                    str(b) for b in c.literal_context_map))
            if c.distance_context_map:
                parts.append("dcontextmap " + " ".join(
                    str(b) for b in c.distance_context_map))
            if any(c.mixing_values):
                parts.append("mixingvalues " + " ".join(
                    str(b) for b in c.mixing_values))
            sp = c.speeds
            parts.append(f"stspeedinc {sp[0].inc} {sp[1].inc} "
                         f"stspeedmax {sp[0].lim} {sp[1].lim}")
            parts.append(f"cmspeedinc {sp[2].inc} {sp[3].inc} "
                         f"cmspeedmax {sp[2].lim} {sp[3].lim}")
            lines.append(" ".join(parts))
        elif isinstance(c, cmds.Literal):
            verb = "rndins" if c.high_entropy else "insert"
            lines.append(f"{verb} {len(c.data)} {c.data.hex()}")
        elif isinstance(c, cmds.Copy):
            lines.append(f"copy {c.num_bytes} from {c.distance}")
        elif isinstance(c, cmds.Dict):
            word = dictionary.load().raw_word(c.word_size, c.word_id)
            out = dictionary.load().transform_word(
                c.word_size, c.word_id, c.transform)
            lines.append(f"dict {c.final_size} word "
                         f"{c.word_size},{c.word_id} {word.hex()} "
                         f"func {c.transform} {out.hex()}")
        elif isinstance(c, cmds.BlockSwitchLiteral):
            lines.append(f"ltype {c.block_type} {c.stride}")
        elif isinstance(c, cmds.BlockSwitchCommand):
            lines.append(f"ctype {c.block_type}")
        elif isinstance(c, cmds.BlockSwitchDistance):
            lines.append(f"dtype {c.block_type}")
        else:
            raise ValueError(f"cannot dump {c!r}")
    return "\n".join(lines) + "\n"


def parse(text: str) -> tuple[int, list[cmds.Command]]:
    """IR text -> (window, commands)."""
    window = 22
    out: list[cmds.Command] = []
    for raw_line in text.splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        tok = line.split()
        kind = tok[0]
        if kind == "window":
            window = int(tok[1])
        elif kind == "prediction":
            out.append(_parse_prediction(tok))
        elif kind in ("insert", "rndins"):
            n = int(tok[1])
            if n == 0:
                continue
            data = bytes.fromhex(tok[2])
            if len(data) != n:
                raise ValueError(f"insert of {n} bytes holds {len(data)}: "
                                 f"{line[:60]}")
            out.append(cmds.Literal(data, high_entropy=(kind == "rndins")))
        elif kind == "copy":
            if tok[2] != "from":
                raise ValueError(f"bad copy line: {line[:60]}")
            n = int(tok[1])
            if n == 0:
                continue
            out.append(cmds.Copy(distance=int(tok[3]), num_bytes=n))
        elif kind == "dict":
            if tok[2] != "word":
                raise ValueError(f"bad dict line: {line[:60]}")
            wlen, wid = tok[3].split(",")
            func = tok[tok.index("func") + 1]
            out.append(cmds.Dict(word_size=int(wlen), word_id=int(wid),
                                 transform=int(func),
                                 final_size=int(tok[1])))
        elif kind == "ltype":
            out.append(cmds.BlockSwitchLiteral(
                int(tok[1]), int(tok[2]) if len(tok) > 2 else 0))
        elif kind == "ctype":
            out.append(cmds.BlockSwitchCommand(int(tok[1])))
        elif kind == "dtype":
            out.append(cmds.BlockSwitchDistance(int(tok[1])))
        else:
            raise ValueError(f"unknown IR line: {line[:60]}")
    return window, out


def _take_ints(tok: list[str], key: str, limit: int = 1 << 30) -> list[int]:
    if key not in tok:
        return []
    vals = []
    for t in tok[tok.index(key) + 1:]:
        try:
            vals.append(int(t))
        except ValueError:
            break
        if len(vals) >= limit:
            break
    return vals


def _parse_prediction(tok: list[str]) -> cmds.PredictionMode:
    pm = _PM_NAMES[tok[1]]
    lcm = bytes(_take_ints(tok, "lcontextmap"))
    dcm = bytes(_take_ints(tok, "dcontextmap"))
    mv = bytes(_take_ints(tok, "mixingvalues", 8192))
    st_inc = _take_ints(tok, "stspeedinc", 2)
    st_max = _take_ints(tok, "stspeedmax", 2)
    cm_inc = _take_ints(tok, "cmspeedinc", 2)
    cm_max = _take_ints(tok, "cmspeedmax", 2)

    def _pair(incs, maxs, d_inc, d_max):
        lo = Speed(incs[0] if incs else d_inc, maxs[0] if maxs else d_max)
        hi = Speed(incs[1] if len(incs) > 1 else lo.inc,
                   maxs[1] if len(maxs) > 1 else lo.lim)
        return lo, hi

    d = DEFAULT_LITERAL_SPEED
    st_lo, st_hi = _pair(st_inc, st_max, d.inc, d.lim)
    cm_lo, cm_hi = _pair(cm_inc, cm_max, 8, 8192)
    return cmds.PredictionMode(
        literal_prediction_mode=pm, context_mixing=1 if lcm else 0,
        speeds=(st_lo, st_hi, cm_lo, cm_hi),
        literal_context_map=lcm, distance_context_map=dcm, mixing_values=mv)


def recode(commands: list[cmds.Command]) -> bytes:
    """Execute the IR into raw bytes with no entropy coding (the
    reference CLI's -recode oracle)."""
    out = bytearray()
    d = dictionary.load()
    for c in commands:
        if isinstance(c, cmds.Literal):
            out += c.data
        elif isinstance(c, cmds.Copy):
            if not 1 <= c.distance <= len(out):
                raise ValueError(f"copy distance {c.distance} out of window")
            start = len(out) - c.distance
            for i in range(c.num_bytes):
                out.append(out[start + i])
        elif isinstance(c, cmds.Dict):
            word = d.transform_word(c.word_size, c.word_id, c.transform)
            if len(word) != c.final_size:
                raise ValueError(f"dict word of {len(word)} bytes, line says "
                                 f"{c.final_size}")
            out += word
        elif isinstance(c, (cmds.PredictionMode, cmds.BlockSwitchLiteral,
                            cmds.BlockSwitchCommand, cmds.BlockSwitchDistance)):
            pass
        else:
            raise ValueError(f"cannot recode {c!r}")
    return bytes(out)
