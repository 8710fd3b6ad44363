"""Every option of the port's compress against the JAX package's, byte
for byte, and every container back through the port's decompress:
stride and speed detection, the IR optimizer at levels 1 and 2, quality
11 without the context map, block split, prior-bitmask masks,
context-map clustering, external probabilities (ECDF) and streamed
frames, at chunk 0 and 256; and the modules under them (ir/detect,
ir/optimize, ir/blocks, ir/cmaps, the greedy matcher, build_commands,
the native binding's masks and block switches).  compress(device="cpu")
runs each kernel's plain version.  Inputs: the sorted divans_tpu
sources and numpy-seeded records, 4-32 KiB."""
import glob
import os

import numpy as np
import pytest

from divans_tpu import api as japi
from divans_tpu import native as jnative
from divans_tpu.codec import engine_np as jeng
from divans_tpu.codec import jax_engine
from divans_tpu.ir import blocks as jblocks
from divans_tpu.ir import cmaps as jcmaps
from divans_tpu.ir import detect as jdetect
from divans_tpu.ir import matcher as jmatcher
from divans_tpu.ir import optimize as joptimize
from divans_tpu.options import DivansOptions as JOptions

import divans_tpu_torch as port
from divans_tpu_torch import native
from divans_tpu_torch.codec import adaptive, decode, encode
from divans_tpu_torch.ir import blocks, cmaps, detect, matcher, optimize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FILES = sorted(glob.glob(os.path.join(REPO, "divans_tpu", "**", "*.py"),
                          recursive=True))
TEXT = b"".join(open(f, "rb").read() for f in _FILES)


def _text(n: int, seed: int) -> bytes:
    """Text (the sorted divans_tpu sources) with a seeded binary tail."""
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(TEXT) - n))
    k = n // 8
    return TEXT[start:start + n - k] + rng.integers(
        0, 256, k, dtype=np.uint8).tobytes()


def _records(n: int, seed: int) -> bytes:
    """Fixed-width little-endian records: int16 random walks on four
    channels (8-byte records), the data stride detection is for."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-40, 41, (n // 8, 4))
    return np.cumsum(steps, axis=0).astype("<i2").tobytes()


def _tables(n: int, seed: int) -> bytes:
    """12-byte records (a name, a sine sample, a counter): per-context
    prior-bitmask masks pay off on them."""
    rng = np.random.default_rng(seed)
    k = n // 12
    names = rng.integers(65, 91, (k, 8), dtype=np.uint8)
    names[:, 4:] = names[0, 4:]
    t = np.arange(k)
    f1 = (5000 * np.sin(t / 100.0)).astype("<i2").view(np.uint8)
    f2 = (t * 3).astype("<u2").view(np.uint8)
    return np.concatenate([names, f1.reshape(k, 2), f2.reshape(k, 2)],
                          axis=1).tobytes()


def _hetero(n: int, seed: int) -> bytes:
    """Text, an int16 wave, text: segments block split separates."""
    t = np.arange(n // 4)
    wave = (20000 * np.sin(t / 300.0) + 3000 * np.sin(t / 17.0)).astype(
        "<i2").tobytes()
    text = _text(n // 2, seed)
    return text[:3 * n // 8] + wave + text[3 * n // 8:]


def _ecdf(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(
        1, 256, 8 * n, dtype=np.uint8).tobytes()


DATA = {"text": _text, "records": _records, "tables": _tables,
        "hetero": _hetero}


@pytest.fixture(scope="module")
def dictionary_indexes():
    """Both packages' dictionary indexes, built once and single-threaded
    (the reference's build is not guarded by a lock)."""
    jmatcher._dict_flat_index()
    matcher._dict_flat_index()


def _reset():
    encode.reset_stats()
    adaptive.reset_stats()
    decode.reset_stats()


# name: (options, data, size, metablock size).  The adaptive cases are
# small: their plain model pass and scan run a nibble at a time here
# (~2.5 ms a byte on the test CPU).
CASES = {
    "detect_deferred": (dict(stride_detection_quality=1,
                             speed_detection_quality=1, chunk_nibbles=256),
                        "records", 16000, 1 << 13),
    "detect_adaptive": (dict(stride_detection_quality=1,
                             speed_detection_quality=1),
                        "records", 4400, 1 << 12),
    "speeds_deferred": (dict(speed_detection_quality=1, chunk_nibbles=256),
                        "text", 10000, 1 << 13),
    "stride_only_deferred": (dict(stride_detection_quality=2,
                                  chunk_nibbles=256),
                             "records", 16000, 1 << 13),
    "optimizer1_deferred": (dict(divans_ir_optimizer=1, chunk_nibbles=256),
                            "text", 10000, 1 << 13),
    "optimizer2_deferred": (dict(divans_ir_optimizer=2, chunk_nibbles=256),
                            "text", 10000, 1 << 13),
    "optimizer2_adaptive": (dict(divans_ir_optimizer=2), "text", 1500,
                            1 << 12),
    "optimizer1_q7_deferred": (dict(divans_ir_optimizer=1, quality=7,
                                    chunk_nibbles=256), "text", 8000,
                               1 << 12),
    "q11_nocm_adaptive": (dict(quality=11, use_context_map=False),
                          "text", 1500, 1 << 12),
    "block_split": (dict(block_split=True), "hetero", 32768, 1 << 15),
    "prior_bitmask": (dict(prior_bitmask_detection=1), "tables", 12000,
                      1 << 14),
    "cmap16_adaptive": (dict(cmap_clustering=16), "text", 1200, 1 << 12),
    "cmap16_deferred": (dict(cmap_clustering=16, chunk_nibbles=256),
                        "text", 8000, 1 << 12),
    "ecdf_deferred": ("ecdf", "text", 9000, 1 << 12),
    "streaming": (dict(streaming_chunk_bytes=512), "text", 1200, 1 << 12),
}


@pytest.mark.parametrize("name", CASES)
def test_compress_matches_reference_and_round_trips(name,
                                                    dictionary_indexes):
    kw, kind, n, mb = CASES[name]
    data = DATA[kind](n, seed=sum(map(ord, name)))
    if kw == "ecdf":
        kw = dict(chunk_nibbles=256, external_probs=_ecdf(n, seed=31))
    kw = dict(metablock_size=mb, **kw)
    opts = port.DivansOptions(**kw)
    _reset()
    blob = port.compress(data, opts, device="cpu")
    assert blob == japi.compress(data, JOptions(**kw))
    if name == "detect_adaptive":
        # the reference's device engine (its adaptive model pass on the
        # CPU) on the detected stride and speeds
        assert blob == jax_engine.compress(data, JOptions(**kw))
    got = port.decompress(blob, device="cpu",
                          options=opts if opts.external_probs else None)
    assert got == data


def test_q11_no_context_map_deferred_on_the_card_route(dictionary_indexes):
    """Quality 11 without the context map at chunk 256: the Python trace
    FSM (native code refuses the stride layout's command lists), then
    the uniform lanes (the cmd pass on the cmd streams, the generic pass
    on the literals); the golden engine's bytes (the reference's
    api.compress sends it to jax_engine, byte-identical to it)."""
    data = _text(12000, seed=32)
    kw = dict(metablock_size=1 << 13, quality=11, use_context_map=False,
              chunk_nibbles=256)
    _reset()
    blob = port.compress(data, port.DivansOptions(**kw), device="cpu")
    assert blob == jeng.compress(data, JOptions(**kw))
    assert encode.STATS["lit_generic"] == 2
    assert encode.STATS["cmd_host"] == 0
    assert port.decompress(blob, device="cpu") == data


def _route(name, stats):
    """Compress CASES[name] on the CPU; encode.STATS must be `stats`
    (every other count 0)."""
    kw, kind, n, mb = CASES[name]
    data = DATA[kind](n, seed=sum(map(ord, name)))
    _reset()
    port.compress(data, port.DivansOptions(metablock_size=mb, **kw),
                  device="cpu")
    want = dict.fromkeys(encode.STATS, 0)
    want.update(stats)
    assert encode.STATS == want


@pytest.mark.parametrize("name,stats", [
    ("optimizer1_deferred", dict(cmd_device=2, lit_device=2))])
def test_card_routes_take_the_uniform_lanes(name, stats):
    """Optimized options take the uniform lanes: no cmd stream on the
    host, the literals on the lit pass."""
    _route(name, stats)


@pytest.mark.parametrize("name,stats", [
    ("detect_deferred", dict(cmd_host=2, lit_generic=2)),
    ("speeds_deferred", dict(cmd_host=2, lit_device=2))])
def test_detected_options_take_the_hybrid(name, stats):
    """Detected options take the hybrid, as in the reference (detection
    is resolved into a stride and speeds the mechanical trace takes):
    the cmd streams coded on the host; a detected stride puts the
    literals on the generic pass (the mix profile), detected speeds keep
    the lit pass."""
    _route(name, stats)


# ------------------------------------------------------ modules under them

@pytest.mark.parametrize("kind", ["records", "text", "tables"])
def test_detection_matches_reference(kind):
    data = DATA[kind](20000, seed=34)
    for q in (1, 3):
        assert detect.detect_stride(data, q) == jdetect.detect_stride(data, q)
        assert _speeds(detect.detect_speeds(data, q, 2)) == \
            _speeds(jdetect.detect_speeds(data, q, 2))
        assert detect.detect_prior_bitmask(data, q) == \
            jdetect.detect_prior_bitmask(data, q)
    kw = dict(stride_detection_quality=1, speed_detection_quality=1)
    got = detect.apply_detection(data, port.DivansOptions(**kw))
    ref = jdetect.apply_detection(data, JOptions(**kw))
    assert got.force_stride_value == ref.force_stride_value
    assert _speeds(got.literal_adaptation) == _speeds(ref.literal_adaptation)


def _speeds(speeds):
    return [(s.inc, s.lim) for s in speeds]


def test_optimizer_matches_reference(dictionary_indexes):
    data = _text(16000, seed=35)
    opts = port.DivansOptions()
    commands = matcher.build_commands(data, opts)
    jcommands = jmatcher.build_commands(data, JOptions())
    assert optimize.order1_bits_per_byte(data) == \
        joptimize.order1_bits_per_byte(data)
    for got, ref in ((optimize.optimize(data, commands[1:]),
                      joptimize.optimize(data, jcommands[1:])),
                     (optimize.optimize_measured(data, commands[1:], opts),
                      joptimize.optimize_measured(data, jcommands[1:],
                                                  JOptions()))):
        assert [repr(c) for c in got] == [repr(c) for c in ref]


def test_matcher_helpers_match_reference(dictionary_indexes):
    """The repeat-distance rewrite and the measured costs of a parse (the
    matcher's second-parse helpers) give the reference's results."""
    data = _text(16000, seed=40)
    matches = matcher.find_matches(data, 10)
    assert matches == jmatcher.find_matches(data, 10)
    assert matcher._prefer_repeat_distances(data, matches) == \
        jmatcher._prefer_repeat_distances(data, matches)
    dist16 = [64] * 33
    got = matcher._measured_costs(data, matches, 80, dist16)
    ref = jmatcher._measured_costs(data, matches, 80, dist16)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("quality", [1, 4, 6, 9])
def test_greedy_matcher_matches_reference_and_native(quality):
    data = _text(20000, seed=36)
    got = matcher._find_matches_greedy(data, quality)
    assert got == jmatcher._find_matches_greedy(data, quality)
    assert got == [tuple(m) for m in
                   native.find_matches(data, quality).tolist()]


@pytest.mark.parametrize("kw", [
    dict(quality=5), dict(quality=10), dict(quality=11),
    dict(cmap_clustering=4), dict(block_split=True),
    dict(prior_bitmask_detection=1), dict(divans_ir_optimizer=2),
    dict(force_stride_value=2, use_context_map=False)],
    ids=["q5", "q10", "q11", "cmap4", "split", "mask", "opt2",
         "stride_nocm"])
def test_build_commands_matches_reference(kw, dictionary_indexes):
    data = _hetero(32768, seed=37) if kw.get("block_split") else \
        _tables(16000, seed=37) if kw.get("prior_bitmask_detection") else \
        _text(16000, seed=37)
    got = matcher.build_commands(data, port.DivansOptions(**kw))
    ref = jmatcher.build_commands(data, JOptions(**kw))
    assert [repr(c) for c in got] == [repr(c) for c in ref]


def test_blocks_and_cmaps_match_reference():
    data = _hetero(65536, seed=38)
    segs = blocks.segment(data)
    assert segs == jblocks.segment(data) and len(segs) >= 2
    assert blocks.per_type_strides(data, segs) == \
        jblocks.per_type_strides(data, segs)
    text = _text(20000, seed=38)
    for k in (2, 8, 16):
        assert cmaps.cluster_lcm(text, max_clusters=k) == \
            jcmaps.cluster_lcm(text, max_clusters=k)


@pytest.mark.parametrize("kw,kind", [
    (dict(block_split=True), "hetero"),
    (dict(prior_bitmask_detection=1), "tables"),
    (dict(stride_detection_quality=1, chunk_nibbles=256), "records"),
    (dict(divans_ir_optimizer=1, chunk_nibbles=64), "text"),
    (dict(cmap_clustering=8), "text")],
    ids=["split", "mask", "detect", "optimizer", "cmap_refused"])
def test_native_compress_matches_reference(kw, kind, dictionary_indexes):
    """The host-only native.compress: the reference's container, or None
    where the reference's native code refuses too."""
    data = DATA[kind](32768, seed=39)
    got = native.compress(data, port.DivansOptions(**kw))
    assert got == jnative.compress(data, JOptions(**kw))
    if got is not None:
        assert native.decompress(got) == data
    assert (got is None) == (kind == "text" and "cmap_clustering" in kw)
