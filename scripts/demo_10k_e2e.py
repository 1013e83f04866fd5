"""End-to-end 10k-genome scale demonstration through the CLI (the
driver's stated target: a 10k-virus all2all with a kmer-db pair filter,
the Vclust production shape).

Synthesizes a clustered genome set (families + singletons, 5-30 kb) as
ONE multifasta plus a kmer-db filter selecting the within-family pairs
(~1M directed pairs after symmetrization), then runs the full CLI
pipeline (ingest -> filter load -> reorder -> match -> streaming store)
once per backend and cross-checks the outputs byte-for-byte. Reports
per-phase wall (-V 2 timings go to stderr) and peak RSS.

Usage: python scripts/demo_10k_e2e.py [n_genomes] [backends...]
       (defaults: 10000 native hybrid)
"""
import os
import subprocess
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000
BACKENDS = sys.argv[2:] or ["native", "hybrid"]
WORK = "/tmp/scale10k"
SYM = np.frombuffer(b"ACGT", np.uint8)


def synth_and_write(n, rng):
    """Clustered mix: ~n/50 families, 10% unrelated singletons. Returns
    the per-genome family id (for the filter) after writing the fasta."""
    os.makedirs(WORK, exist_ok=True)
    fams = max(4, n // 50)
    bases = [rng.randint(0, 4, int(rng.randint(5_000, 30_000))
                         ).astype(np.uint8) for _ in range(fams)]
    fam_of = np.full(n, -1, np.int32)
    t0 = time.perf_counter()
    with open(os.path.join(WORK, "genomes.fna"), "wb") as fh:
        for k in range(n):
            if rng.rand() < 0.10:
                seq = rng.randint(0, 4, int(rng.randint(5_000, 30_000))
                                  ).astype(np.uint8)
            else:
                f = int(rng.randint(fams))
                fam_of[k] = f
                seq = bases[f].copy()
                m = rng.rand(len(seq)) < rng.uniform(0.005, 0.08)
                seq[m] = (seq[m] + rng.randint(1, 4, m.sum())) % 4
                lo = int(rng.randint(0, len(seq) // 4))
                hi = lo + int(rng.randint(len(seq) // 2, len(seq) - lo))
                seq = seq[lo:hi].copy()
            fh.write(b">g%07d\n" % k)
            fh.write(SYM[seq].tobytes())
            fh.write(b"\n")
    print(f"fasta: {n} genomes written in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({os.path.getsize(os.path.join(WORK, 'genomes.fna'))/1e6:.0f}"
          f" MB)", flush=True)
    return fam_of


def write_filter(fam_of, rng):
    """kmer-db format: header 'k,name1,...'; row i = 'name,<j1>:<v>,...'
    with 1-based GLOBAL ids (filter.cpp:75). Within-family pairs get a
    passing value; a sprinkle of noise entries fails the threshold."""
    n = len(fam_of)
    names = [f"g{k:07d}" for k in range(n)]
    order = np.argsort(fam_of, kind="stable")
    members = {}
    for k in order:
        f = int(fam_of[k])
        if f >= 0:
            members.setdefault(f, []).append(int(k))
    t0 = time.perf_counter()
    kept = 0
    path = os.path.join(WORK, "fltr.txt")
    with open(path, "w") as fh:
        fh.write("18," + ",".join(names) + "\n")
        rows = [[] for _ in range(n)]
        for f, mem in members.items():
            mem = np.array(mem)
            for a_i, a in enumerate(mem):
                # upper-triangle entries only; loader symmetrizes.
                # ~15% of entries land below the 0.2 CLI threshold, so
                # the loader's threshold branch is actually exercised
                for b in mem[a_i + 1:]:
                    v = rng.uniform(0.05, 0.9)
                    rows[a].append((int(b), v))
        for i, row in enumerate(rows):
            fh.write(names[i])
            for j, v in row:
                fh.write(f",{j + 1}:{v:.4f}")
                if round(v, 4) >= 0.2:  # what the CLI will parse
                    kept += 2  # symmetrized
            fh.write("\n")
    print(f"filter: {kept} directed pairs written in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({os.path.getsize(path)/1e6:.0f} MB)", flush=True)
    return kept


def run_cli(backend, threads):
    out = os.path.join(WORK, f"out.{backend}.tsv")
    cmd = [sys.executable, "-m", "lzani.cli", "all2all",
           "--in-fasta", os.path.join(WORK, "genomes.fna"),
           "--flt-kmerdb", os.path.join(WORK, "fltr.txt"), "0.2",
           "--out", out, "-t", str(threads), "-V", "2",
           "--backend", backend]
    t0 = time.perf_counter()
    so_f = open(os.path.join(WORK, f"{backend}.stdout"), "w+")
    se_f = open(os.path.join(WORK, f"{backend}.stderr"), "w+")
    p = subprocess.Popen(cmd, cwd="/root/repo", stdout=so_f, stderr=se_f,
                         text=True)
    # peak RSS via the kernel's own high-water mark (no /usr/bin/time
    # in this image); VmHWM only grows, so a 50 ms poll is exact unless
    # the child exits within one poll of its peak
    rss_gb = 0.0
    status = f"/proc/{p.pid}/status"
    while p.poll() is None:
        try:
            with open(status) as fh:
                for ln in fh:
                    if ln.startswith("VmHWM"):
                        rss_gb = max(rss_gb, int(ln.split()[1]) / 1e6)
                        break
        except OSError:
            break
        time.sleep(0.05)
    p.wait()
    dt = time.perf_counter() - t0
    se_f.seek(0)
    se = se_f.read()
    so_f.close()
    se_f.close()
    if p.returncode != 0:
        print(se[-2000:], flush=True)
        raise SystemExit(f"{backend} CLI failed")
    # -V 2 timing lines land in stderr; keep the phase summary
    tail = [ln for ln in se.splitlines()
            if ":" in ln and (" s" in ln or "time" in ln.lower())]
    return out, dt, tail, rss_gb


def main():
    rng = np.random.RandomState(1234)
    fam_of = synth_and_write(N, rng)
    kept = write_filter(fam_of, rng)
    threads = os.cpu_count() or 1

    outs = {}
    for be in BACKENDS:
        out, dt, tail, rss_gb = run_cli(be, threads)
        nrows = sum(1 for _ in open(out)) - 1
        print(f"[{be}] wall {dt:.1f}s -> {kept / dt:.0f} pairs/s, "
              f"{nrows} result rows, peak child RSS {rss_gb:.2f} GB",
              flush=True)
        for ln in tail:
            print(f"    {ln}", flush=True)
        outs[be] = out

    if len(outs) > 1:
        import filecmp
        base = BACKENDS[0]
        for be in BACKENDS[1:]:
            same = filecmp.cmp(outs[base], outs[be], shallow=False)
            print(f"outputs {base} == {be}: {same}", flush=True)
            if not same:
                return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
