"""Dense model layout: prior-table keys -> flat rows of one model array.

A copy of divans_tpu/codec/layout.py: the profiles, their container
flags, the segment table the native library, the model passes and the
decode commit index by, and the golden engine's (table, key) -> row map
(idx_for_key, for the Python trace FSM codec/trace).  Row 0 is a frozen
CDF_INIT row.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Profile:
    name: str
    nb: int        # distinct command/literal block types
    nd: int        # distinct distance-context-map values
    nctx: int      # distinct literal-context-map values
    lit_sel: int   # which `sel` value the literal tables use (0=cm, 1=stride)
    hi_shape: tuple[int, int]   # dense (index_b, index_c) dims, high nibble
    lo_shape: tuple[int, int]   # dense (index_b, index_c) dims, low nibble
    # per-context mixing masks add the sel=1 stride tables
    hi_s_shape: tuple[int, int] | None = None
    lo_s_shape: tuple[int, int] | None = None


PROFILE_CM = Profile("cm", nb=1, nd=4, nctx=64, lit_sel=0,
                     hi_shape=(1, 64), lo_shape=(64, 16))
PROFILE_STRIDE = Profile("stride", nb=1, nd=4, nctx=1, lit_sel=1,
                         hi_shape=(256, 1), lo_shape=(256, 16))
PROFILE_MIX = Profile("mix", nb=1, nd=4, nctx=64, lit_sel=0,
                      hi_shape=(1, 64), lo_shape=(64, 16),
                      hi_s_shape=(256, 64), lo_s_shape=(256, 16))
PROFILE_SPLIT = Profile("split", nb=1, nd=4, nctx=256, lit_sel=0,
                        hi_shape=(1, 256), lo_shape=(256, 16),
                        hi_s_shape=(256, 256), lo_s_shape=(256, 16))

# deferred streams bucket the lo-nibble context dimension 64 -> 8
LO_BUCKET_SHIFT = 3

PROFILES = {p.name: p
            for p in (PROFILE_CM, PROFILE_STRIDE, PROFILE_MIX,
                      PROFILE_SPLIT)}
PROFILE_FLAGS = {"cm": 0, "stride": 1, "mix": 2, "split": 3}
FLAG_PROFILES = {v: k for k, v in PROFILE_FLAGS.items()}


def profile_for_options(options) -> str:
    """The model profile a stream written with `options` stays within."""
    if not options.use_context_map:
        return "stride"
    if options.block_split:
        return "split"
    if options.force_stride_value > 1:
        return "mix"  # constant mask + context map (ir/detect.py)
    if options.prior_bitmask_detection:
        return "mix"  # detection may emit a mask; stay in the wide profile
    return "cm"


def emitted_profile(options, command_lists) -> str:
    """The narrowest profile the *emitted* streams stay within.

    profile_for_options sizes the encode layout by what the options MAY
    produce; the container flag records what the metablocks actually
    used, so e.g. block_split on homogeneous data (no switches emitted)
    stays a plain cm container, byte-identical to the default encode."""
    from ..ir import commands as cmds
    if not options.use_context_map:
        return "stride"
    split = masked = False
    for cl in command_lists:
        for c in cl:
            if isinstance(c, cmds.BlockSwitchLiteral):
                split = True
            elif isinstance(c, cmds.PredictionMode) and any(c.mixing_values):
                masked = True
    if split:
        return "split"
    return "mix" if masked else "cm"


class ModelLayout:
    """Segment table for one profile.  `lo_bucketed=True` is the deferred
    variant: lit_lo/cm_second context dims shrink 64 -> 8."""

    def __init__(self, profile: Profile, lo_bucketed: bool = False):
        self.profile = profile
        self.lo_bucketed = lo_bucketed
        p = profile
        lo_shape = p.lo_shape
        nctx_lo = p.nctx
        self.lo_shift = 0
        if lo_bucketed and p.lit_sel == 0:
            lo_shape = (p.lo_shape[0] >> LO_BUCKET_SHIFT, p.lo_shape[1])
            nctx_lo = p.nctx >> LO_BUCKET_SHIFT
            self.lo_shift = LO_BUCKET_SHIFT
        self.lo_shape = lo_shape
        self.nctx_lo = nctx_lo
        self.segments: dict[str, tuple[int, tuple[int, ...]]] = {}
        off = 1  # row 0 = frozen CDF_INIT
        for name, shape in [
            # --- command stream ---
            ("cc", (16,)),
            ("ll_cs", (p.nb,)), ("ll_beg", (p.nb,)), ("ll_last", (p.nb,)),
            ("ll_mant", (p.nb,)),
            ("c_ccs", (p.nb, 16)), ("c_cbeg", (p.nb,)), ("c_clast", (p.nb,)),
            ("c_cmant", (p.nb, 5)),
            ("c_dmn", (p.nd, 2)), ("c_dbeg", (p.nd, 8)), ("c_dlast", (p.nd,)),
            ("c_dmant", (p.nd, 5)),
            ("d_sbeg", (p.nb,)), ("d_slast", (p.nb,)), ("d_idx", (p.nd, 5)),
            ("d_tr", (2, 16)),
            ("bt_mn", (3,)), ("bt_f", (3,)), ("bt_s", (3,)), ("bt_stride", (1,)),
            ("pm_only", (1,)), ("pm_dcm", (1,)), ("pm_pd", (1,)),
            ("pm_palette", (4,)), ("pm_mvmode", (1,)), ("pm_mix", (17,)),
            ("pm_cmn", (2,)), ("pm_cf", (2,)), ("pm_cs", (2,)),
            # --- literal stream ---
            ("lit_hi", p.hi_shape), ("lit_lo", lo_shape),
            ("cm_first", (p.nctx,)), ("cm_second", (16, nctx_lo)),
        ] + ([("lit_hi_s", p.hi_s_shape), ("lit_lo_s", p.lo_s_shape)]
             if p.hi_s_shape else []):
            self.segments[name] = (off, shape)
            off += int(np.prod(shape))
        self.num_rows = off

    def idx(self, seg: str, *coords):
        """Flat row index of `coords` in segment `seg`."""
        off, shape = self.segments[seg]
        assert len(coords) == len(shape), (seg, coords, shape)
        flat = 0
        for c, dim in zip(coords, shape):
            flat = flat * dim + c
        return off + flat

    # ------------------------------------------------ golden-key mapping
    def idx_for_key(self, table: str, key: tuple) -> int:
        """Map a golden-engine (PriorTable name, key tuple) to a flat row.

        Raises KeyError/AssertionError when the key is outside this
        profile's dense bounds (caller falls back to a wider profile)."""
        p = self.profile

        def _chk(v, n):
            if not 0 <= v < n:
                raise KeyError(f"{table}{key} outside profile {p.name}")
            return v

        if table == "cc":
            return self.idx("cc", _chk(key[0], 16))
        if table == "lit_len":
            kind, ctype = key[0], _chk(key[1], p.nb)
            return self.idx({"cs": "ll_cs", "beg": "ll_beg",
                             "last": "ll_last", "mant": "ll_mant"}[kind], ctype)
        if table == "copy":
            kind = key[0]
            if kind == "ccs":
                return self.idx("c_ccs", _chk(key[1], p.nb), _chk(key[2], 16))
            if kind == "cbeg":
                return self.idx("c_cbeg", _chk(key[1], p.nb))
            if kind == "clast":
                return self.idx("c_clast", _chk(key[1], p.nb))
            if kind == "cmant":
                return self.idx("c_cmant", _chk(key[1], p.nb), _chk(key[2], 5))
            if kind == "dmn":
                return self.idx("c_dmn", _chk(key[1], p.nd), _chk(key[2], 2))
            if kind == "dbeg":
                return self.idx("c_dbeg", _chk(key[1], p.nd), _chk(key[2], 8))
            if kind == "dlast":
                return self.idx("c_dlast", _chk(key[1], p.nd))
            if kind == "dmant":
                return self.idx("c_dmant", _chk(key[1], p.nd), _chk(key[2], 5))
        if table == "dict":
            kind = key[0]
            if kind == "sbeg":
                return self.idx("d_sbeg", _chk(key[1], p.nb))
            if kind == "slast":
                return self.idx("d_slast", _chk(key[1], p.nb))
            if kind == "idx":
                return self.idx("d_idx", _chk(key[1], p.nd), _chk(key[2], 5))
            if kind == "tr":
                return self.idx("d_tr", _chk(key[1], 2), _chk(key[2], 16))
        if table == "btype":
            kind = key[0]
            if kind == "stride":
                return self.idx("bt_stride", 0)
            return self.idx({"mn": "bt_mn", "f": "bt_f", "s": "bt_s"}[kind],
                            _chk(key[1], 3))
        if table == "pred":
            kind = key[0]
            if kind in ("only", "dcm", "pd", "mvmode"):
                return self.idx("pm_" + kind, 0)
            if kind == "palette":
                return self.idx("pm_palette", _chk(key[1], 4))
            if kind == "mix":
                return self.idx("pm_mix", _chk(key[1], 17))
            return self.idx({"cmn": "pm_cmn", "cf": "pm_cf",
                             "cs": "pm_cs"}[kind], _chk(key[1], 2))
        if table in ("lit_hi", "lit_lo"):
            sel, b, c = key
            if sel == 1 and p.hi_s_shape is not None:
                name = "lit_hi_s" if table == "lit_hi" else "lit_lo_s"
                shape = p.hi_s_shape if table == "lit_hi" else p.lo_s_shape
                return self.idx(name, _chk(b, shape[0]), _chk(c, shape[1]))
            if sel != p.lit_sel:
                raise KeyError(f"lit sel {sel} outside profile {p.name}")
            shape = p.hi_shape if table == "lit_hi" else self.lo_shape
            return self.idx(table, _chk(b, shape[0]), _chk(c, shape[1]))
        if table == "cm":
            if key[0] == 0:
                return self.idx("cm_first", _chk(key[1], p.nctx))
            # key[2] arrives pre-bucketed (engine_np._literal_nibble)
            return self.idx("cm_second", _chk(key[1], 16),
                            _chk(key[2], self.nctx_lo))
        raise KeyError((table, key))
