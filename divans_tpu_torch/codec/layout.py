"""Dense model layout: prior-table keys -> flat rows of one model array.

A copy of the subset of divans_tpu/codec/layout.py the port uses: the
profiles, their container flags, and the segment table the native
library and the decode commit index by.  Row 0 is a frozen CDF_INIT row.
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
    """The model profile a stream written with `options` stays within
    (the options the port's compress accepts: no block split, no
    prior-bitmask detection)."""
    if not options.use_context_map:
        return "stride"
    if options.force_stride_value > 1:
        return "mix"  # constant mask + context map
    return "cm"


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
