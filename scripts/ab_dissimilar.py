"""A/B the device engine on a dissimilar-heavy synthetic set (the other
workload regime from vir61: ~35% unrelated genomes, heavy mutation +
indels): warm pairs/s of --backend jax's engine, checked against native.

Usage: python scripts/ab_dissimilar.py [n_genomes] [label]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lzani.core import native_engine as ne
from lzani.params import Params


DEFAULT_N = 150


def synth(N):
    rng = np.random.RandomState(9)
    fams = 4
    bases = [rng.randint(0, 4, int(rng.randint(20000, 40000))
                         ).astype(np.uint8) for _ in range(fams)]
    codes = []
    for _ in range(N):
        if rng.rand() < 0.35:
            codes.append(rng.randint(
                0, 4, int(rng.randint(20000, 40000))).astype(np.uint8))
            continue
        c = bases[int(rng.randint(fams))].copy()
        m = rng.rand(len(c)) < rng.uniform(0.02, 0.12)
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        for _ in range(4):
            p_ = rng.randint(0, len(c) - 100)
            c = np.concatenate([c[:p_], c[p_ + rng.randint(1, 80):]])
        codes.append(np.ascontiguousarray(c))
    codes.sort(key=len, reverse=True)
    return codes


def main():
    from lzani.runtime import enable_compile_cache, set_xla_flags

    set_xla_flags()
    enable_compile_cache()
    from lzani.ops.engine_jax import all2all_jax

    N = int(sys.argv[1]) if len(sys.argv) > 1 else DEFAULT_N
    label = sys.argv[2] if len(sys.argv) > 2 else "run"
    codes = synth(N)
    pairs = len(codes) * (len(codes) - 1)
    p = Params()
    p.no_threads = os.cpu_count() or 1
    ref = ne.all2all(codes, p)
    t0 = time.perf_counter()
    out = all2all_jax(codes, p)   # cold (compile + load)
    cold = time.perf_counter() - t0
    warm = 1e9
    for _ in range(3):  # min-of-3: host noise only ever adds time
        t0 = time.perf_counter()
        out = all2all_jax(codes, p)
        warm = min(warm, time.perf_counter() - t0)
    print(f"[{label}] N={N} pairs={pairs}: warm {pairs/warm:.1f} pairs/s "
          f"(cold {cold:.0f}s) exact={np.array_equal(out, ref)}",
          flush=True)


if __name__ == "__main__":
    main()
