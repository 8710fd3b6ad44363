"""The seeded corpus: the same bytes for a seed, others for another,
always the size asked for, with each pool's share capped by what it
holds."""
import numpy as np

from portbench import corpus


def _pools(tmp_path, sizes):
    out = []
    for k, (n_files, size) in enumerate(sizes):
        files = []
        for i in range(n_files):
            p = tmp_path / f"pool{k}_{i}.bin"
            p.write_bytes(bytes([k]) + np.random.default_rng(
                [k, i]).integers(0, 256, size - 1, np.uint8).tobytes())
            files.append(str(p))
        out.append(files)
    return out


def test_seed_repeats_and_varies(tmp_path):
    pools = _pools(tmp_path, [(20, 900), (20, 700), (20, 5000)])
    a, sa = corpus.build(16000, 2 ** 31 + 5, pools)
    b, sb = corpus.build(16000, 2 ** 31 + 5, pools)
    c, _ = corpus.build(16000, 6, pools)
    assert a == b and sa == sb
    # another seed: the same files in another order
    assert a != c and sorted(a) == sorted(c)
    assert len(a) == len(c) == 16000
    assert sa == [8000, 4000, 4000]


def test_shares_capped_by_the_pools(tmp_path):
    pools = _pools(tmp_path, [(2, 1000), (1, 500), (10, 5000)])
    data, shares = corpus.build(20000, 1, pools)
    assert shares == [2000, 500, 17500] and len(data) == 20000
    # text first, then headers, then binary, as the pools' tags show
    assert data[0] == 0 and data[2000] == 1 and data[2500] == 2


def test_real_pools_fill_a_small_corpus(tmp_path, monkeypatch):
    monkeypatch.setattr(corpus, "POOL_CACHE", str(tmp_path / "corpus"))
    data, shares = corpus.build(1 << 16, 42)
    assert len(data) == 1 << 16 and sum(shares) == 1 << 16
    # the second build reads the cache the first one wrote
    assert (tmp_path / f"corpus-{1 << 16}.bin").exists()
    assert data == corpus.build(1 << 16, 42)[0]
    assert sorted(data) == sorted(corpus.build(1 << 16, 43)[0])
