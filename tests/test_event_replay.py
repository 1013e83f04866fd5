"""Closed-loop validation of the event-log contract: the native parser's own
event log, replayed through lza_replay_finalize, must reproduce the factor
list, stats, and regions bit-for-bit. This is the interface the device
kernel targets: if the kernel emits the same event log, its results are
exact by construction."""

import glob
import os

import numpy as np
import pytest

from lzani.core import native_engine as ne
from lzani.params import Params
from conftest import requires_reference


def check_pair(ref, q, p):
    ev = ne.parse_event_log(ref, q, p)
    fac_oracle = ne.parse_factors(ref, q, p)
    fac_replay = ne.replay_factors(ref, q, p, ev)
    assert np.array_equal(fac_oracle, fac_replay)
    st_oracle, regs_oracle = ne.parse_pair(ref, q, p, want_regions=True)
    st_replay, regs_replay = ne.replay_events(ref, q, p, ev,
                                              want_regions=True)
    assert st_oracle == st_replay
    assert np.array_equal(regs_oracle, regs_replay)
    return len(ev)


def test_replay_random_mutated():
    p = Params()
    rng = np.random.RandomState(7)
    total_ev = 0
    for trial in range(12):
        L = int(rng.randint(300, 4000))
        ref = rng.randint(0, 4, L).astype(np.uint8)
        q = ref.copy()
        # varied mutation densities exercise sync/desync/kill paths
        rate = [3, 5, 9, 17, 33, 65][trial % 6]
        idx = rng.rand(L) < 1.0 / rate
        q[idx] = (q[idx] + rng.randint(1, 4, idx.sum())) % 4
        # sprinkle Ns and an indel
        q[rng.randint(0, L, 5)] = 4
        q = np.delete(q, slice(50, 50 + trial % 7))
        total_ev += check_pair(ref, q, p)
    assert total_ev > 0


def test_replay_unrelated():
    p = Params()
    rng = np.random.RandomState(8)
    ref = rng.randint(0, 4, 3000).astype(np.uint8)
    q = rng.randint(0, 4, 2500).astype(np.uint8)
    check_pair(ref, q, p)


def test_replay_nondefault_params():
    p = Params()
    p.min_anchor_len = 9
    p.min_seed_len = 5
    p.max_dist_in_ref = 20
    p.max_dist_in_query = 25
    p.min_region_len = 20
    rng = np.random.RandomState(9)
    ref = rng.randint(0, 4, 2000).astype(np.uint8)
    q = ref.copy()
    q[::7] = (q[::7] + 1) % 4
    check_pair(ref, q[:1900], p)


@requires_reference
def test_replay_vir61_sample():
    from lzani.io.fasta import load_store

    p = Params()
    p.input_file_names = sorted(
        glob.glob("/root/reference/test/vir61/*.fna"))
    store = load_store(p)
    store.reorder()
    codes = store.codes
    rng = np.random.RandomState(10)
    for _ in range(6):
        r, q = rng.randint(0, len(codes), 2)
        if r == q:
            continue
        check_pair(codes[r], codes[q], p)
