"""The seeded corpus: mixed text, source and binary from this machine's
files.

Three pools, as chip_smoke.build_corpus takes them: this interpreter's
standard-library Python sources (half of the corpus), the C headers
under /usr/include (a quarter) and the shared libraries of the system
and of torch (the rest).  Each share is capped by what its pool holds,
and the binary pool fills what the others leave.

Every seed gets the same files, and the seed sets their order: a fixed
draw (SELECT) chooses which files fill each share, the run's seed
permutes them within their pool, and the pools follow one another.  So
every seed codes the same bytes in another order, cut into other
blocks, and the work a run does moves little with its seed.

The chosen files are read once into POOL_CACHE inside the checkout (one
file, their bytes back to back with an index), and later runs of the
same size read that: opening a few thousand small files took 4-14 s of
each run's set-up on the card's machine.
"""
from __future__ import annotations

import glob
import json
import os
import sysconfig

import numpy as np

SELECT = 20260101        # the fixed draw that chooses the files
POOL_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_cache", "corpus")


def pools() -> list[list[str]]:
    """The three pools' file lists: text, headers, binary."""
    import torch
    stdlib = sysconfig.get_paths()["stdlib"]
    torch_lib = os.path.join(os.path.dirname(torch.__file__), "lib")
    patterns = [[os.path.join(stdlib, "**", "*.py")],
                ["/usr/include/**/*.h"],
                ["/usr/lib/x86_64-linux-gnu/*.so*",
                 os.path.join(torch_lib, "*.so*")]]
    out = []
    for pats in patterns:
        files = set()
        for pat in pats:
            for p in glob.glob(pat, recursive=True):
                if (not os.path.islink(p) and os.path.isfile(p)
                        and os.path.getsize(p) > 0):
                    files.add(p)
        out.append(sorted(files))
    return out


def _choose(files: list[str], rng: np.random.Generator, cap: int) -> list:
    """[(path, bytes to read)] filling cap, in the fixed draw's order."""
    got, tot = [], 0
    for i in rng.permutation(len(files)).tolist():
        if tot >= cap:
            break
        n = min(os.path.getsize(files[i]), cap - tot)
        got.append((files[i], n))
        tot += n
    return got


def choose(target: int, file_pools=None) -> list[list]:
    """Each pool's chosen (path, bytes) for a corpus of `target` bytes."""
    rng = np.random.default_rng(SELECT)
    text, headers, binary = file_pools or pools()
    t = _choose(text, rng, target // 2)
    h = _choose(headers, rng, target // 4)
    rest = target - sum(n for _p, n in t) - sum(n for _p, n in h)
    return [t, h, _choose(binary, rng, rest)]


def _read(chosen: list[list]) -> list[list[bytes]]:
    out = []
    for pool in chosen:
        got = []
        for path, n in pool:
            with open(path, "rb") as f:
                got.append(f.read(n))
        out.append(got)
    return out


def _cached(target: int, file_pools) -> list[list[bytes]]:
    """The chosen files' bytes, from POOL_CACHE when it holds them."""
    head = f"{POOL_CACHE}-{target}.json"
    body = f"{POOL_CACHE}-{target}.bin"
    if file_pools is None and os.path.exists(head) and \
            os.path.exists(body):
        with open(head) as f:
            sizes = json.load(f)
        with open(body, "rb") as f:
            blob = f.read()
        out, off = [], 0
        for pool in sizes:
            out.append([blob[off + a:off + a + n] for a, n in
                        zip(np.cumsum([0] + pool[:-1]).tolist(), pool)])
            off += sum(pool)
        return out
    parts = _read(choose(target, file_pools))
    if file_pools is None:
        os.makedirs(os.path.dirname(POOL_CACHE), exist_ok=True)
        tmp = f"{body}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            for pool in parts:
                for b in pool:
                    f.write(b)
        os.replace(tmp, body)
        with open(f"{head}.{os.getpid()}.tmp", "w") as f:
            json.dump([[len(b) for b in pool] for pool in parts], f)
        os.replace(f"{head}.{os.getpid()}.tmp", head)
    return parts


def build(target: int, seed: int, file_pools=None) -> tuple[bytes, list]:
    """(corpus of `target` bytes, bytes from each pool): the chosen
    files, each pool's in the seed's order."""
    rng = np.random.default_rng(seed % (1 << 64))
    parts = _cached(target, file_pools)
    out, shares = [], []
    for pool in parts:
        out += [pool[i] for i in rng.permutation(len(pool)).tolist()]
        shares.append(sum(map(len, pool)))
    data = b"".join(out)
    if len(data) != target:
        raise RuntimeError(f"the pools hold {len(data)} bytes, fewer than "
                           f"the {target} the traffic needs")
    return data, shares
