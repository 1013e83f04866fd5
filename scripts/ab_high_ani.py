"""A/B the device engine on the NEAR-IDENTICAL regime: 12 x ~30 kb copies
at 0.3% mutation — long extensions, few events: warm pairs/s of
--backend jax's engine, checked against native.

Usage: python scripts/ab_high_ani.py [n_genomes] [label]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from lzani.core import native_engine as ne
from lzani.params import Params


DEFAULT_N = 12


def synth(N):
    rng = np.random.RandomState(5)
    base = rng.randint(0, 4, 30000).astype(np.uint8)
    codes = []
    for k in range(N):
        c = base.copy()
        m = rng.rand(len(c)) < 0.003
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        codes.append(c[: len(c) - 7 * k])
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
    for _ in range(3):
        t0 = time.perf_counter()
        out = all2all_jax(codes, p)
        warm = min(warm, time.perf_counter() - t0)
    print(f"[{label}] N={N} pairs={pairs}: warm {pairs/warm:.1f} pairs/s "
          f"(cold {cold:.0f}s) exact={np.array_equal(out, ref)}",
          flush=True)


if __name__ == "__main__":
    main()
