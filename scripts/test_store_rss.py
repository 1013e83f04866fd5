"""U3 acceptance: 100k-genome synthetic ingest at packed density.

Generates a multifasta of N synthetic genomes, ingests it through the
production SequenceStore (3-in-byte packed arena), and reports peak RSS
against the unpacked baseline (1 B/symbol resident — what the round-3
store held). VERDICT r3 item 7 target: peak RSS <= 1/3 of the unpacked
baseline, engines byte-identical (the equality half is pinned by
tests/test_ingest.py::test_packed_store_native_engine_identical).

Usage: python scripts/test_store_rss.py [n_genomes] [mean_len]
"""
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    mean_len = int(sys.argv[2]) if len(sys.argv) > 2 else 25_000
    path = "/tmp/rss_synth.fna"

    rng = np.random.RandomState(5)
    lens = rng.randint(mean_len // 2, mean_len * 3 // 2, n)
    total = int(lens.sum())
    if not os.path.exists(path) or os.path.getsize(path) < total:
        t0 = time.time()
        ACGT = np.frombuffer(b"ACGT", np.uint8)
        with open(path, "wb") as fh:
            for i in range(n):
                fh.write(b">g%d\n" % i)
                row = ACGT[rng.randint(0, 4, int(lens[i]))]
                fh.write(row.tobytes())
                fh.write(b"\n")
        print(f"wrote {path}: {os.path.getsize(path)/1e9:.2f} GB "
              f"({time.time()-t0:.0f}s)", flush=True)

    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss  # KiB
    t0 = time.time()
    from lzani.io.fasta import SequenceStore

    store = SequenceStore()
    store.load_multifasta([path])
    store.reorder()
    packed_bytes = store.codes.nbytes  # production state (pointer table)
    dt = time.time() - t0
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    peak_mb = (rss1 - rss0) / 1024
    unpacked_mb = total / 1e6  # what 1 B/symbol storage alone would hold
    print(f"genomes={len(store)} symbols={total/1e9:.2f}G "
          f"ingest={dt:.0f}s packed={packed_bytes/1e6:.0f}MB "
          f"peak_rss_delta={peak_mb:.0f}MB unpacked_baseline="
          f"{unpacked_mb:.0f}MB ratio={peak_mb/unpacked_mb:.2f}",
          flush=True)
    ok = peak_mb <= unpacked_mb / 3 + 200  # +200MB slack: numpy/python
    print("OK" if ok else "FAIL (peak above 1/3 baseline)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
