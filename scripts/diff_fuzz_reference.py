"""Differential fuzzing: our CLI (native backend) vs the real reference
binary (built from /root/reference sources into /tmp/lzani_ref) on random
genome sets and random parameter vectors. Outputs must be byte-identical
(alignment files compared as sorted sets — reference row order is
thread-timing-dependent).

Usage: python scripts/diff_fuzz_reference.py [n_cases] [seed]
"""
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, "/root/repo")

import numpy as np

REF_BIN = "/tmp/lzani_ref"
_pos = [a for a in sys.argv[1:] if not a.startswith("--")]
N = int(_pos[0]) if _pos else 20
SEED = int(_pos[1]) if len(_pos) > 1 else 0

BASES = np.array(list("ACGT"))


def write_fasta(path, seqs):
    with open(path, "w") as fh:
        for i, s in enumerate(seqs):
            fh.write(f">seq{i:03d} synthetic\n")
            txt = "".join(BASES[np.minimum(s, 3)])
            # reinsert Ns
            txt = "".join("N" if c >= 4 else t for c, t in zip(s, txt))
            for j in range(0, len(txt), 70):
                fh.write(txt[j:j + 70] + "\n")


def gen_case(rng):
    n = int(rng.randint(4, 9))
    L = int(rng.randint(300, 3000))
    base = rng.randint(0, 4, L).astype(np.uint8)
    seqs = []
    for i in range(n):
        s = base.copy()
        rate = rng.uniform(0.0, 0.45)
        m = rng.rand(L) < rate
        s[m] = (s[m] + rng.randint(1, 4, m.sum())) % 4
        if rng.rand() < 0.3:
            s[rng.randint(0, L, rng.randint(1, 8))] = 4  # Ns
        if rng.rand() < 0.4:
            k = rng.randint(0, L - 50)
            s = np.delete(s, slice(k, k + rng.randint(1, 40)))
        if rng.rand() < 0.3:  # unrelated
            s = rng.randint(0, 4, rng.randint(250, L + 1)).astype(np.uint8)
        seqs.append(s)
    mal = int(rng.randint(5, 16))
    msl = int(rng.randint(3, mal + 1))
    mrd = int(rng.randint(8, 64))
    mqd = int(rng.randint(8, 64))
    reg = int(rng.randint(8, 50))
    aw = int(rng.randint(4, 24))
    am = int(rng.randint(1, aw))
    ar = int(rng.randint(1, 5))
    flags = ["-a", str(mal), "-s", str(msl), "-r", str(mrd),
             "-q", str(mqd), "-g", str(reg), "--aw", str(aw),
             "--am", str(am), "--ar", str(ar)]
    if rng.rand() < 0.3:
        flags += ["--out-in-percent", "true"]
    fmt = rng.choice(["standard", "lite", "complete",
                      "qidx,ridx,tani,gani,ani,qcov,rcov,nt_match"])
    flags += ["--out-format", str(fmt)]
    if rng.rand() < 0.3:
        col = str(rng.choice(["tani", "gani", "ani", "qcov"]))
        flags += ["--out-filter", col, f"{rng.uniform(0, 0.4):.3f}"]
    return seqs, flags


def write_filter(path, n, rng):
    """Synthesize a kmer-db-style sparse filter (lower-triangle rows with
    1-based ids; the loader symmetrizes)."""
    names = [f"seq{i:03d}" for i in range(n)]
    with open(path, "w") as fh:
        fh.write("kmer-length: 18 fraction: 1 ," + ",".join(names) + ",\n")
        for i in range(n):
            toks = [names[i]]
            for j in range(i):
                if rng.rand() < 0.6:
                    toks.append(f"{j + 1}:{rng.uniform(0.05, 1):.6f}")
            fh.write(",".join(toks) + ",\n")


def write_dir(dirpath, seqs, rng):
    """Per-file mode: a directory of FASTA files, some multi-contig."""
    os.makedirs(dirpath, exist_ok=True)
    for i, s in enumerate(seqs):
        with open(os.path.join(dirpath, f"g{i:03d}.fna"), "w") as fh:
            if rng.rand() < 0.5 and len(s) > 200:
                cut = int(rng.randint(50, len(s) - 50))
                parts = [s[:cut], s[cut:]]
            else:
                parts = [s]
            for k, part in enumerate(parts):
                fh.write(f">g{i:03d}_c{k} x\n")
                txt = "".join("N" if c >= 4 else "ACGT"[c] for c in part)
                for j in range(0, len(txt), 70):
                    fh.write(txt[j:j + 70] + "\n")


def run_case(tc, seqs, flags, workdir, rng=None):
    fa = os.path.join(workdir, f"in_{tc}.fna")
    write_fasta(fa, seqs)
    in_flags = ["--in-fasta", fa]
    if rng is not None and rng.rand() < 0.3:
        d = os.path.join(workdir, f"dir_{tc}")
        write_dir(d, seqs, rng)
        in_flags = ["--in-dir", d, "--multisample-fasta",
                    str(rng.choice(["true", "false"]))]
    if rng is not None and rng.rand() < 0.15:
        flags = flags + ["--out-type", "single-txt"]
    if (rng is not None and rng.rand() < 0.4
            and in_flags[0] == "--in-fasta"):
        # filter names must match reservoir names (seqNNN = multifasta)
        flt = os.path.join(workdir, f"flt_{tc}.csv")
        write_filter(flt, len(seqs), rng)
        flags = flags + ["--flt-kmerdb", flt,
                         f"{rng.uniform(0.0, 0.5):.3f}"]
    ref_out = os.path.join(workdir, f"ref_{tc}.tsv")
    our_out = os.path.join(workdir, f"our_{tc}.tsv")
    ref_aln = os.path.join(workdir, f"ref_{tc}.aln")
    our_aln = os.path.join(workdir, f"our_{tc}.aln")

    # The reference binary reads past its composite buffer on some inputs
    # (verified UB: output varies with MALLOC_PERTURB_). Detect and skip
    # such cases — byte-equivalence is ill-defined there. This engine pads
    # the buffer with N codes instead (deterministic, canonical).
    outs = []
    for perturb in ("37", "111", "203"):
        env = dict(os.environ, MALLOC_PERTURB_=perturb)
        r = subprocess.run([REF_BIN, "all2all"] + in_flags + ["--out",
                            ref_out, "--out-alignment", ref_aln] + flags,
                           capture_output=True, timeout=300, env=env)
        if r.returncode != 0:
            return f"reference binary failed: {r.stderr[-200:]}"
        outs.append(open(ref_out, "rb").read())
    if len(set(outs)) > 1:
        return "SKIP"
    # LZANI_FUZZ_BACKEND=jax routes the case through the device engine,
    # so it faces the reference with random parameters too
    backend = os.environ.get("LZANI_FUZZ_BACKEND", "native")
    r = subprocess.run([sys.executable, "-m", "lzani.cli", "all2all"]
                       + in_flags + ["--out", our_out,
                                     "--out-alignment", our_aln,
                                     "--backend", backend] + flags,
                       capture_output=True, timeout=3000, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if r.returncode != 0:
        return f"our cli failed: {r.stderr[-300:]}"

    a = open(ref_out, "rb").read()
    b = open(our_out, "rb").read()
    # single-txt embeds the output path in its params dump; normalize it
    a = a.replace(ref_out.encode(), b"OUT")
    b = b.replace(our_out.encode(), b"OUT")

    def _norm_inputs(x):
        # --in-dir file listing order: the reference uses raw
        # directory_iterator order (fs-dependent); we sort. Results are
        # unaffected (the reservoir reorders by length/name) — normalize
        # the dump line.
        out = []
        for ln in x.split(b"\n"):
            if ln.startswith(b"input_file_names"):
                key, _, val = ln.partition(b":")
                items = sorted(v.strip() for v in val.split(b",") if v.strip())
                ln = key + b": " + b", ".join(items)
            out.append(ln)
        return b"\n".join(out)

    a = _norm_inputs(a)
    b = _norm_inputs(b)
    if a != b:
        for k, (la, lb) in enumerate(zip(a.splitlines(), b.splitlines())):
            if la != lb:
                return (f"TSV diff at line {k}:\n  ref: {la[:140]}\n"
                        f"  our: {lb[:140]}")
        return f"TSV length diff ({len(a)} vs {len(b)})"
    ra = sorted(open(ref_aln).readlines()[1:])
    rb = sorted(open(our_aln).readlines()[1:])
    if ra != rb:
        for la, lb in zip(ra, rb):
            if la != lb:
                return f"ALN diff:\n  ref: {la[:140]}\n  our: {lb[:140]}"
        return "ALN set diff (lengths)"
    ref_ids = ref_out.replace(".tsv", ".ids.tsv")
    our_ids = our_out.replace(".tsv", ".ids.tsv")
    if os.path.exists(ref_ids) != os.path.exists(our_ids):
        return "ids file presence diff"
    if os.path.exists(ref_ids):
        if open(ref_ids, "rb").read() != open(our_ids, "rb").read():
            return "ids file diff"
    return None


def gen_case_bacterial(rng):
    """Bacterial-shaped case (BASELINE.json configs[4]): 0.5-1.5 Mb
    genomes with rRNA-like repeat islands + IS-element repeats,
    structural indels, tuned long-genome params (mal/msl/reg scaled up
    per the reference README's bacteria guidance)."""
    L = int(rng.randint(500_000, 1_500_000))
    g = rng.randint(0, 4, L).astype(np.uint8)
    unit = rng.randint(0, 4, 5000).astype(np.uint8)
    for _ in range(5):
        p = rng.randint(0, L - 6000)
        g[p:p + 5000] = unit
    is_el = rng.randint(0, 4, 1200).astype(np.uint8)
    for _ in range(20):
        p = rng.randint(0, L - 1500)
        g[p:p + 1200] = is_el
    seqs = [g]
    for k in range(int(rng.randint(1, 3))):
        q = g.copy()
        m = rng.rand(len(q)) < rng.uniform(0.02, 0.08)
        q[m] = (q[m] + rng.randint(1, 4, m.sum())) % 4
        for _ in range(10):
            j = rng.randint(0, len(q) - 5000)
            if rng.rand() < 0.5:
                q = np.delete(q, slice(j, j + rng.randint(100, 3000)))
            else:
                ins = rng.randint(0, 4,
                                  rng.randint(100, 3000)).astype(np.uint8)
                q = np.concatenate([q[:j], ins, q[j:]])
        seqs.append(np.ascontiguousarray(q))
    mal = int(rng.randint(16, 23))
    msl = int(rng.randint(9, 14))
    reg = int(rng.randint(60, 101))
    flags = ["-a", str(mal), "-s", str(msl), "-g", str(reg),
             "--out-format", "complete"]
    return seqs, flags


def main():
    rng = np.random.RandomState(SEED)
    bacterial = "--bacterial" in sys.argv
    fails = 0
    with tempfile.TemporaryDirectory() as wd:
        for tc in range(N):
            seqs, flags = (gen_case_bacterial(rng) if bacterial
                           else gen_case(rng))
            err = run_case(tc, seqs, flags, wd, rng)
            if err == "SKIP":
                print(f"case {tc}: SKIP (reference output is heap-"
                      f"dependent / UB-sensitive)", flush=True)
                continue
            if err:
                fails += 1
                print(f"case {tc}: FAIL ({' '.join(flags)})\n  {err}",
                      flush=True)
            else:
                print(f"case {tc}: OK ({' '.join(flags[:16])}...)",
                      flush=True)
    print("FAILURES:" if fails else "ALL OK:", fails, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
