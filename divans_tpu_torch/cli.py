"""Command-line interface of the port: divans_tpu/cli.py's modes and
flags, with compress, decompress and billing on the card.

    python -m divans_tpu_torch.cli [mode] [flags] [infile [outfile]]

Modes (default -c):
  -c            compress raw bytes on the card (passthrough if already
                compressed)
  -d            decompress on the card
  -i            compress from textual IR (ir/ir_text, the golden engine)
  -ir           dump the matcher's IR as text
  -recode       execute textual IR into raw bytes (no entropy coding)

Flags (the same spellings as divans_tpu.cli):
  -q<N>         quality 1..11 (e.g. -q9, -q11)
  -w<N>         log2 window size 10..24
  -bs<N>        metablock size in bytes (power of two)
  -cm / -nocm   enable/disable the literal context map
  -mixing=<N>   dynamic context mixing level 0..14
  -speed=<inc>,<lim>  literal adaptation speed
  -deferred[=N] chunk-deferred adaptation profile (N = chunk nibbles,
                default 256)
  -blocksplit   literal block-type segmentation + per-segment strides
                (host encode)
  -cmapcluster[=K] clustered literal context map (default 16; host
                encode)
  -streaming[=N] bounded-latency streamed frames every ~N input bytes
                (default 64 KiB; host encode)
  -priormask[=q] per-context prior-bitmask detection (host encode)
  -serial       the golden serial engine on the host (codec/engine_np)
  -bill         per-substate bit accounting (codec/billing) on stderr;
                with -v adds the per-CDF count/cost/entropy rows
  -timing       stage timeline to stderr (tracelog)
  -v            print per-file ratio to stderr
  -version      print version
"""
from __future__ import annotations

import dataclasses
import sys

from . import __version__, tracelog
from .options import DivansOptions
from .probability.speed import Speed


def _fail(msg: str) -> "NoReturn":
    print(f"divans_tpu_torch: {msg}", file=sys.stderr)
    raise SystemExit(2)


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the CLI on `argv`; compress, decompress and billing run on
    `device` (the card unless the caller passes "cpu")."""
    argv = list(sys.argv[1:] if argv is None else argv)
    mode = "-c"
    opts = {}
    engine = "auto"
    verbose = False
    files: list[str] = []
    for a in argv:
        if a in ("-c", "-d", "-i", "-ir", "-recode", "--recode"):
            mode = a.lstrip("-")
        elif a.startswith("-q") and a[2:].replace(".", "").isdigit():
            opts["quality"] = min(11, max(1, int(float(a[2:]))))
        elif a.startswith("-w") and a[2:].isdigit():
            opts["window_size"] = int(a[2:])
        elif a.startswith("-bs") and a[3:].isdigit():
            opts["metablock_size"] = int(a[3:])
        elif a == "-cm":
            opts["use_context_map"] = True
        elif a == "-nocm":
            opts["use_context_map"] = False
            opts.setdefault("dynamic_context_mixing", 0)
        elif a.startswith("-mixing="):
            opts["dynamic_context_mixing"] = int(a.split("=")[1])
        elif a.startswith("-speed="):
            inc, lim = a.split("=")[1].split(",")
            sp = Speed(int(inc), int(lim))
            opts["literal_adaptation"] = (sp, sp, sp, sp)
        elif a.startswith("-deferred"):
            opts["chunk_nibbles"] = int(a.split("=")[1]) if "=" in a else 256
        elif a.startswith("-priormask"):
            opts["prior_bitmask_detection"] = \
                int(a.split("=")[1]) if "=" in a else 1
        elif a == "-blocksplit":
            opts["block_split"] = True
        elif a.startswith("-cmapcluster"):
            opts["cmap_clustering"] = \
                int(a.split("=")[1]) if "=" in a else 16
        elif a.startswith("-streaming"):
            opts["streaming_chunk_bytes"] = \
                int(a.split("=")[1]) if "=" in a else 1 << 16
        elif a == "-serial":
            engine = "golden"
        elif a == "-bill":
            engine = "bill"
        elif a == "-v":
            verbose = True
        elif a == "-timing":
            tracelog.enable()
        elif a in ("-version", "--version"):
            print(f"divans_tpu_torch {__version__}")
            return 0
        elif a in ("-h", "--help"):
            print(__doc__)
            return 0
        elif a.startswith("-"):
            _fail(f"unknown flag {a} (see -h)")
        else:
            files.append(a)

    if opts.get("quality", 0) >= 11 and "metablock_size" not in opts:
        # quality 11 is the ratio point: one model domain as large as the
        # window allows, as divans_tpu.cli sets it (-bs trades it back
        # for parallel frames)
        opts["metablock_size"] = 1 << 24
    options = DivansOptions(**opts)
    if files:
        with open(files[0], "rb") as f:
            data = f.read()
    else:
        data = sys.stdin.buffer.read()
    out = _run(mode, data, options, engine, verbose, device)
    if len(files) > 1:
        with open(files[1], "wb") as f:
            f.write(out)
    else:
        sys.stdout.buffer.write(out)
    if verbose and mode in ("c", "i"):
        print(f"ratio {len(out) / max(1, len(data)):.4f}", file=sys.stderr)
    if tracelog.events():
        print(tracelog.report(), file=sys.stderr)
    return 0


def _run(mode: str, data: bytes, options: DivansOptions, engine: str,
         verbose: bool = False, device=None) -> bytes:
    from . import api, constants
    from .codec import engine_np
    from .ir import ir_text

    if mode == "c":
        if data[:4] == constants.MAGIC:   # already compressed: passthrough
            return data
        if engine == "golden":
            return engine_np.compress(data, options)
        if engine == "bill":
            from .codec import billing
            bits: dict = {}
            out = api.compress(data, options, device=device, billing_out=bits)
            print(billing.format_table(bits, len(data), len(out)),
                  file=sys.stderr)
            if verbose and "__detail__" in bits:
                print(bits["__detail__"], file=sys.stderr)
            return out
        return api.compress(data, options, device=device)
    if mode == "d":
        if engine == "golden":
            return engine_np.decompress(data)
        return api.decompress(data, device=device)
    if mode == "recode":
        _w, commands = ir_text.parse(data.decode())
        return ir_text.recode(commands)
    if mode == "i":
        from .codec.layout import PROFILE_FLAGS, profile_for_options
        from .container import format as fmt
        from .container.crc32c import crc32c
        _w, commands = ir_text.parse(data.decode())
        raw = ir_text.recode(commands)
        mb = 1 << max(12, (max(1, len(raw)) - 1).bit_length())
        options = dataclasses.replace(options,
                                      metablock_size=min(mb, 1 << 24))
        cmd_b, lit_b = engine_np.encode_metablock(raw, commands, options)
        return fmt.serialize([fmt.MetablockFrame(len(raw), cmd_b, lit_b)],
                             options.window_size, options.mb_log2,
                             crc32c(raw),
                             flags=PROFILE_FLAGS[profile_for_options(options)])
    if mode == "ir":
        from .ir.matcher import build_commands
        mb = options.metablock_size
        return "".join(
            ir_text.dump(build_commands(data[off:off + mb], options),
                         options.window_size)
            for off in range(0, len(data), mb)).encode()
    _fail(f"unknown mode {mode}")


if __name__ == "__main__":
    raise SystemExit(main())
