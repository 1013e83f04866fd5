"""Bit-exact parity of the JAX device engine against the native oracle.

The device automaton must reproduce the oracle's stats triple (and factor
list) for inputs covering every parser branch: exact copies, substitutions,
indels, duplications (close/distant matches), inversions (the RC half of the
reference buffer), N runs, desyncs, and short/empty sequences.
"""

import numpy as np
import pytest

from lzani.core import native_engine
from lzani.params import Params


def mutate(rng, seq, sub=0.0, indel=0.0):
    out = []
    for c in seq:
        r = rng.random()
        if r < sub:
            out.append(rng.integers(0, 4))
        elif r < sub + indel:
            continue
        elif r < sub + 2 * indel:
            out.extend([c, rng.integers(0, 4)])
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


def rc(seq):
    out = seq[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


def cases():
    rng = np.random.default_rng(7)
    ref = rng.integers(0, 4, 900).astype(np.uint8)
    yield "identical", ref, ref.copy()
    yield "subs2pct", ref, mutate(rng, ref, sub=0.02)
    yield "subs10pct", ref, mutate(rng, ref, sub=0.10)
    yield "indels", ref, mutate(rng, ref, sub=0.02, indel=0.01)
    # inversion: middle third reverse-complemented (exercises RC coordinates)
    inv = ref.copy()
    inv[300:600] = rc(ref[300:600])
    yield "inversion", ref, inv
    # translocation: swap halves (distant matches + region logic)
    yield "translocation", ref, np.concatenate([ref[450:], ref[:450]])
    # duplication (close matches at shifted offsets)
    yield "duplication", ref, np.concatenate([ref[:450], ref[200:400], ref[450:]])
    # N runs in both sequences
    n_ref = ref.copy()
    n_ref[100:140] = 5
    n_q = mutate(rng, ref, sub=0.01)
    n_q[400:460] = 5
    yield "n_runs", n_ref, n_q
    # unrelated sequences (mostly literals, desyncs)
    yield "unrelated", ref, rng.integers(0, 4, 700).astype(np.uint8)
    # short sequences
    yield "short", ref[:60], ref[10:55]
    yield "tiny", ref[:10], ref[:8]
    # query longer than reference
    yield "q_longer", ref[:300], np.concatenate([ref, ref[:200]])


@pytest.fixture(scope="module")
def jax_engine():
    from lzani.ops.engine_jax import parse_pair_jax
    return parse_pair_jax


@pytest.mark.parametrize("name,ref,q", list(cases()),
                         ids=[c[0] for c in cases()])
def test_pair_parity(jax_engine, name, ref, q):
    p = Params()
    want = native_engine.parse_pair(ref, q, p)[0]
    got_stats, got_fac = jax_engine(ref, q, p, want_factors=True)
    want_fac = native_engine.parse_factors(ref, q, p)
    assert got_stats == want, f"{name}: stats {got_stats} != {want}"
    assert got_fac.shape == want_fac.shape, (
        f"{name}: {got_fac.shape} vs {want_fac.shape}")
    assert (got_fac == want_fac).all(), f"{name}: factor lists differ"


def test_pair_parity_nondefault_params(jax_engine):
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 800).astype(np.uint8)
    q = mutate(rng, ref, sub=0.05, indel=0.005)
    p = Params(min_anchor_len=9, min_seed_len=5, max_dist_in_ref=20,
               max_dist_in_query=30, min_region_len=20, approx_window=11,
               approx_mismatches=5, approx_run_len=2)
    want = native_engine.parse_pair(ref, q, p)[0]
    got = jax_engine(ref, q, p)
    assert got == want


def test_batch_matches_oracle(jax_engine):
    """all2all_jax over a small set == native all2all."""
    from lzani.ops.engine_jax import all2all_jax
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, 600).astype(np.uint8)
    codes = [base,
             mutate(rng, base, sub=0.03),
             mutate(rng, base, sub=0.1, indel=0.01),
             rng.integers(0, 4, 500).astype(np.uint8)]
    p = Params()
    p.adjust_threads()
    want = native_engine.all2all(codes, p)
    got = all2all_jax(codes, p)
    assert (got == want).all()
