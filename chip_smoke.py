#!/usr/bin/env python
"""Smoke test of the main path on one GPU (or four, with --chips 4).

    python chip_smoke.py [--seed N]      # phases 0-3 on one card
    python chip_smoke.py --chips 4       # the 4-process launch, one per card

Phase 0 checks that JAX sees a GPU. Phase 1 parses seeded pairs of real
viral length (and one pair of 1 Mb) on the device engine and compares stats
and factor lists with the native oracle. Phase 2 runs the CLI with
--backend jax on a seeded viral-like set (dense, twice, then with a kmer-db
filter and --out-alignment) and compares its outputs with --backend
native.
Phase 3 runs the default hybrid backend with the device made to join and
compares its outputs with native. Phase 4 puts a smaller set of
viral-length genomes (80-190 kb) through the kmer-db filter and
--out-alignment, on --backend jax and on the hybrid, against native. With --chips 4 the script runs only the
CLI's jax.distributed launch as four processes, one per card, on the
phase 2 set, and compares it with native.

Any failure exits nonzero and prints no result. On success the last line
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
Data is generated from --seed under a temporary directory.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# phase 1: one reference of viral length and its queries, one 1 Mb pair
P1_REF_LEN = 60_000
P1_BIG_LEN = 1_000_000
# phase 2/3: the viral-like set, dense. The genome count is cut to 24, and
# the lengths to the low end of viral genomes: the device engine costs one
# loop step per symbol of an unrelated query, so a dense row of
# 80-190 kb genomes takes ~90 s on an H100 (PERF.md), and four dense runs
# would take hours.
SET_GENOMES = 24
SET_LENGTHS = (20_000, 25_000)
# phase 4: genomes of the long half of vir61's range in two species-level
# clusters (up to 5% divergence from their ancestor), filtered as Vclust
# runs them (kmer-db first), so the device parses related pairs only
LONG_GENOMES = 8
LONG_LENGTHS = (80_000, 190_000)
LONG_DIVERGENCE = (0.003, 0.05)


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip()


def read(path):
    with open(path, "rb") as fh:
        return fh.read()


# ---- phase 1 ----------------------------------------------------------------
def phase1(seed):
    import numpy as np

    from lzani import synth
    from lzani.core import native_engine as ne
    from lzani.ops import engine_jax
    from lzani.params import Params

    p = Params()
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, P1_REF_LEN).astype(np.uint8)
    inv = ref.copy()
    third = len(ref) // 3
    inv[third:2 * third] = synth.revcomp(ref[third:2 * third])
    n_runs = synth.mutate(rng, ref, sub=0.01, indel=0.001)
    for s in (5_000, 31_000):
        n_runs[s:s + 400] = 4
    queries = {
        "identical": ref.copy(),
        "sub1": synth.mutate(rng, ref, sub=0.01),
        "sub5_indel": synth.mutate(rng, ref, sub=0.05, indel=0.005),
        "sub15_indel": synth.mutate(rng, ref, sub=0.15, indel=0.015),
        "inversion": inv,
        "unrelated": rng.integers(0, 4, 2 * P1_REF_LEN // 3).astype(np.uint8),
        "n_runs": n_runs,
    }
    big = rng.integers(0, 4, P1_BIG_LEN).astype(np.uint8)
    big_q = synth.mutate(rng, big, sub=0.01, indel=0.001)
    dev = __import__("jax").local_devices()[0]
    budget = engine_jax.DeviceBudget.for_device(dev)

    def run_row(r_codes, q_list):
        codes = [r_codes] + q_list
        q_ids = list(range(1, len(codes)))
        t0 = time.perf_counter()
        h = engine_jax.dispatch_row(codes, 0, q_ids, p, dev, budget, True)
        _, _, stats, facs = engine_jax.collect_row(h, True)
        return stats, facs, time.perf_counter() - t0

    names = list(queries)
    stats, facs, dt = run_row(ref, [queries[k] for k in names])
    _, _, dt_warm = run_row(ref, [queries[k] for k in names])
    for k, name in enumerate(names):
        q = queries[name]
        want = ne.parse_pair(ref, q, p)[0]
        got = tuple(int(x) for x in stats[k])
        check(got == want, f"phase 1 {name}: stats {got} != oracle {want}")
        wf = ne.parse_factors(ref, q, p)
        check(np.array_equal(facs[k], wf),
              f"phase 1 {name}: factor list differs from the oracle's")
    log(f"phase 1: {len(names)} pairs vs a {P1_REF_LEN}-symbol reference "
        f"byte-equal to the oracle; cold {dt:.2f} s, warm {dt_warm:.2f} s "
        f"({len(names) / dt_warm:.3f} pairs/s)")
    stats, facs, dt = run_row(big, [big_q])
    want = ne.parse_pair(big, big_q, p)[0]
    got = tuple(int(x) for x in stats[0])
    check(got == want, f"phase 1 1Mb pair: stats {got} != oracle {want}")
    check(np.array_equal(facs[0], ne.parse_factors(big, big_q, p)),
          "phase 1 1Mb pair: factor list differs from the oracle's")
    log(f"phase 1: {P1_BIG_LEN}-symbol pair (1% substitutions) byte-equal "
        f"to the oracle in {dt:.2f} s (compile included)")


# ---- phases 2 and 3 ---------------------------------------------------------
def make_set(tmp, seed, n=SET_GENOMES, lengths=SET_LENGTHS, tag="set",
             **kw):
    from lzani import synth

    names, codes = synth.viral_set(seed, n, lengths=lengths, **kw)
    fasta = os.path.join(tmp, f"{tag}.fna")
    synth.write_fasta(fasta, names, codes)
    flt = os.path.join(tmp, f"{tag}.kmerdb.txt")
    synth.write_kmerdb_filter(flt, names, codes)
    return fasta, flt, len(codes)


def run_hybrid_greedy(argv):
    """The default backend with the device made to join; fails unless the
    device parsed pairs and nothing fell back to the host."""
    os.environ["LZANI_HYBRID_GREEDY"] = "1"
    try:
        t, m = run_cli(argv)
    finally:
        del os.environ["LZANI_HYBRID_GREEDY"]
    hst = m.hybrid_stats
    check(hst.get("warm_why") is None,
          f"device warm-up refused: {hst.get('warm_why')}")
    check(hst.get("device_pairs", 0) > 0, "the device took no rows")
    check(hst.get("recovered_rows", 0) == 0,
          "device rows were recovered on the host")
    return t, hst


def run_cli(argv):
    """One CLI run in this process, as `python -m lzani.cli` runs it.
    Returns (seconds, the Matcher)."""
    from lzani.cli import parse_args
    from lzani.matcher import Matcher

    t0 = time.perf_counter()
    m = Matcher(parse_args(argv))
    check(m.run_all2all(), f"CLI run failed: {' '.join(argv)}")
    return time.perf_counter() - t0, m


def outputs_equal(a, b, aln=None):
    check(read(a) == read(b), f"{b} differs from {a}")
    ia, ib = (x.replace(".tsv", ".ids.tsv") for x in (a, b))
    check(read(ia) == read(ib), f"{ib} differs from {ia}")
    if aln:
        la = read(aln[0]).decode().splitlines()
        lb = read(aln[1]).decode().splitlines()
        check(la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:]),
              f"{aln[1]} rows differ from {aln[0]}")


def phase2_3(tmp, seed):
    fasta, flt, n = make_set(tmp, seed)
    pairs = n * (n - 1)
    base = ["all2all", "--in-fasta", fasta, "-V", "0"]

    def out(tag):
        return os.path.join(tmp, f"{tag}.tsv")

    flt_args = ["--flt-kmerdb", flt, "0.2"]
    t_nat, _ = run_cli(base + ["--out", out("native"), "--backend",
                               "native"])
    run_cli(base + ["--out", out("native_flt"), "--backend", "native",
                    "--out-alignment", out("native.aln")] + flt_args)
    log(f"phase 2: native {pairs} pairs in {t_nat:.2f} s (all host cores)")
    t_cold, _ = run_cli(base + ["--out", out("jax"), "--backend", "jax"])
    outputs_equal(out("native"), out("jax"))
    t_warm, _ = run_cli(base + ["--out", out("jax2"), "--backend", "jax"])
    outputs_equal(out("native"), out("jax2"))
    log(f"phase 2: --backend jax {pairs} pairs byte-equal to native; cold "
        f"{t_cold:.2f} s, warm {t_warm:.2f} s ({pairs / t_warm:.2f} "
        f"pairs/s)")
    t_flt, m = run_cli(base + ["--out", out("jax_flt"), "--backend", "jax",
                               "--out-alignment", out("jax.aln")]
                       + flt_args)
    outputs_equal(out("native_flt"), out("jax_flt"),
                  (out("native.aln"), out("jax.aln")))
    kept = m.filter.total
    check(0 < kept < pairs, f"the filter kept {kept} of {pairs} pairs")
    log(f"phase 2: kmer-db filter at 0.2 kept {kept} pairs; outputs "
        f"byte-equal and --out-alignment rows set-equal to native "
        f"({t_flt:.2f} s)")

    t_hyb, hst = run_hybrid_greedy(base + ["--out", out("hybrid")])
    outputs_equal(out("native"), out("hybrid"))
    log(f"phase 3: hybrid {pairs} pairs byte-equal to native in "
        f"{t_hyb:.2f} s; device pairs {hst['device_pairs']}, native pairs "
        f"{hst['cpu_pairs']}, warm-up {hst['warm_s']:.2f} s")


def phase4(tmp, seed):
    fasta, flt, n = make_set(tmp, seed, LONG_GENOMES, LONG_LENGTHS, "long",
                             n_ancestors=2, divergence=LONG_DIVERGENCE)
    base = ["all2all", "--in-fasta", fasta, "-V", "0", "--flt-kmerdb", flt,
            "0.2"]

    def out(tag):
        return os.path.join(tmp, f"long_{tag}.tsv")

    run_cli(base + ["--out", out("native"), "--backend", "native",
                    "--out-alignment", out("native.aln")])
    t_jax, m = run_cli(base + ["--out", out("jax"), "--backend", "jax",
                               "--out-alignment", out("jax.aln")])
    outputs_equal(out("native"), out("jax"),
                  (out("native.aln"), out("jax.aln")))
    kept = m.filter.total
    check(0 < kept < n * (n - 1), f"the filter kept {kept} pairs")
    log(f"phase 4: {n} genomes of {LONG_LENGTHS[0]}-{LONG_LENGTHS[1]} "
        f"symbols, kmer-db filter kept {kept} pairs; --backend jax outputs "
        f"byte-equal and --out-alignment rows set-equal to native in "
        f"{t_jax:.2f} s ({kept / t_jax:.3f} pairs/s)")
    t_hyb, hst = run_hybrid_greedy(base + ["--out", out("hybrid")])
    outputs_equal(out("native"), out("hybrid"))
    log(f"phase 4: hybrid byte-equal to native in {t_hyb:.2f} s; device "
        f"pairs {hst['device_pairs']}, native pairs {hst['cpu_pairs']}")


# ---- --chips 4 --------------------------------------------------------------
def device_info_in_child():
    """Platform, kind and count as JAX reports them, asked in a child so
    that this process never holds a card the launch below needs."""
    code = ("import json, jax; d = jax.devices(); print(json.dumps("
            "[d[0].platform, d[0].device_kind, len(d)]))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    check(r.returncode == 0, f"device query failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def multichip(tmp, seed, chips):
    fasta, _, n = make_set(tmp, seed)
    base = ["all2all", "--in-fasta", fasta, "-V", "1"]
    nat = os.path.join(tmp, "native.tsv")
    run_cli(base + ["--out", nat, "--backend", "native"])
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [os.path.join(tmp, f"mc{i}.tsv") for i in range(chips)]
    procs = []
    t0 = time.perf_counter()
    try:
        for i in range(chips):
            env = dict(os.environ,
                       JAX_COORDINATOR_ADDRESS=f"localhost:{port}",
                       JAX_NUM_PROCESSES=str(chips), JAX_PROCESS_ID=str(i))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lzani.cli"] + base
                + ["--out", outs[i], "--backend", "jax"], cwd=HERE, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errs = []
        for pr in procs:
            _, err = pr.communicate(timeout=900)
            errs.append(err)
        for i, pr in enumerate(procs):
            check(pr.returncode == 0,
                  f"process {i} exited {pr.returncode}: {errs[i][-2000:]}")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    dt = time.perf_counter() - t0
    outputs_equal(nat, outs[0])
    check(not any(os.path.exists(o) for o in outs[1:]),
          "a process other than 0 wrote outputs")
    log(f"--chips {chips}: {chips} processes, one card each, "
        f"{n * (n - 1)} pairs byte-equal to native in {dt:.2f} s "
        f"(start-up and compile included)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()
    try:
        if not os.path.isdir(os.path.join(HERE, "lzani")):
            raise SmokeError("the lzani package is not next to this script")
        sys.path.insert(0, HERE)
        from lzani.runtime import enable_compile_cache, set_xla_flags

        log(f"XLA_FLAGS: {set_xla_flags()}")
        if args.chips > 1:
            platform, kind, count = device_info_in_child()
        else:
            import jax

            devs = jax.devices()
            platform, kind, count = (devs[0].platform, devs[0].device_kind,
                                     len(devs))
        check(platform == "gpu", f"JAX found no GPU (platform {platform})")
        check(count >= args.chips, f"{args.chips} cards asked, {count} seen")
        import jax

        log(f"phase 0: {count} x {kind}, jax {jax.__version__}, compile "
            f"cache {enable_compile_cache()}")
        smi = nvidia_smi()
        with tempfile.TemporaryDirectory(prefix="lzani_smoke_") as tmp:
            if args.chips > 1:
                multichip(tmp, args.seed, args.chips)
            else:
                phase1(args.seed)
                phase2_3(tmp, args.seed)
                phase4(tmp, args.seed)
        log(smi)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": platform,
                                             "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
