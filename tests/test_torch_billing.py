"""Per-substate bit accounting: the port's compress(billing_out=) against
divans_tpu.codec.jax_engine.compress(billing_out=), the billing dict
(the "__detail__" per-CDF report included) exactly, on seeded text and
records: the cm profile at chunk 0 and 256, the stride and mix profiles
at 256, and quality 11.  The billed container equals the unbilled one
(native.compress, whose bytes the port's compress equals), and at chunk
256 every cmd stream goes to the card's passes (no hybrid)."""
import glob
import os

import numpy as np
import pytest

from divans_tpu.codec import billing as jbilling
from divans_tpu.codec import jax_engine
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import native
from divans_tpu_torch.codec import billing, encode
from divans_tpu_torch.ir import matcher

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = b"".join(open(f, "rb").read() for f in sorted(glob.glob(
    os.path.join(REPO, "divans_tpu", "**", "*.py"), recursive=True)))


def _text(n: int, seed: int) -> bytes:
    """The sorted divans_tpu sources from a seeded offset, with a seeded
    binary tail."""
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(TEXT) - n))
    k = n // 8
    return TEXT[start:start + n - k] + rng.integers(
        0, 256, k, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


# name: (options, input size, encode.STATS of the billed run).  The
# chunk-0 case is smaller: its plain model pass runs a nibble at a time.
CASES = {
    "cm_deferred": (dict(chunk_nibbles=256), 16384,
                    dict(cmd_device=2, lit_device=2)),
    "cm_adaptive": (dict(), 4096, None),
    "mix_deferred": (dict(chunk_nibbles=256, force_stride_value=4), 16384,
                     dict(cmd_device=2, lit_generic=2)),
    "stride_deferred": (dict(chunk_nibbles=256, use_context_map=False,
                             dynamic_context_mixing=0), 16384,
                        dict(cmd_device=2, lit_generic=2)),
    "q11_deferred": (dict(chunk_nibbles=256, quality=11), 16384,
                     dict(cmd_device=2, lit_device=2)),
}


@pytest.mark.parametrize("name", CASES)
def test_billing_matches_reference(name, dictionary_indexes):
    kw, n, stats = CASES[name]
    kw = dict(metablock_size=1 << 13, **kw)
    data = _text(n, seed=sum(map(ord, name)))
    ref: dict = {}
    ref_blob = jax_engine.compress(data, JOptions(**kw), billing_out=ref)
    encode.reset_stats()
    got: dict = {}
    blob = port.compress(data, port.DivansOptions(**kw), device="cpu",
                         billing_out=got)
    assert got == ref
    assert "__detail__" in got and len(got) > 2
    assert blob == ref_blob == native.compress(data,
                                               port.DivansOptions(**kw))
    if stats is not None:
        want = dict.fromkeys(encode.STATS, 0)
        want.update(stats)
        assert encode.STATS == want
    assert billing.format_table(got, len(data), len(blob)) == \
        jbilling.format_table(ref, len(data), len(blob))


def test_host_options_bill_nothing():
    """Host-only options (here streamed frames) leave billing_out empty,
    as the reference's golden route does."""
    data = _text(3000, seed=3)
    kw = dict(metablock_size=1 << 12, streaming_chunk_bytes=1024)
    ref: dict = {}
    ref_blob = jax_engine.compress(data, JOptions(**kw), billing_out=ref)
    got: dict = {}
    blob = port.compress(data, port.DivansOptions(**kw), device="cpu",
                         billing_out=got)
    assert got == ref == {}
    assert blob == ref_blob


def test_empty_input_bills_nothing():
    got: dict = {}
    blob = port.compress(b"", port.DivansOptions(chunk_nibbles=256),
                         device="cpu", billing_out=got)
    assert got == {}
    assert port.decompress(blob, device="cpu") == b""
