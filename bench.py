#!/usr/bin/env python
"""Benchmark harness: all-vs-all ANI on the vir61 set (61 virus genomes,
the reference's CI anchor — /root/reference/test/vir61).

Prints ONE JSON line. The HEADLINE metric is the device engine
(`--backend jax`) on the FULL vir61 set, warm (one un-timed run first pays
the compiles); `vs_baseline` divides it by the measured rate of the actual
reference binary (built by scripts/build_reference_binary.sh) at max host
threads, or of the native engine when the binary is unavailable. The
native and hybrid rates are side keys, and the device triples are asserted
byte-equal to the native engine's. Every result names the device it ran
on; without a GPU the bench exits nonzero.

Env toggles:
  BENCH_DEVICE_FAST=1  measure the device engine on a 12-genome subset
  BENCH_SKIP_DISSIM=1  skip the dissimilar-set hybrid keys
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

VIR61 = "/root/reference/test/vir61"
REF_BIN = "/tmp/lzani_ref"


def load_vir61():
    from lzani.params import Params

    p = Params()
    if os.path.isdir(VIR61):
        p.input_file_names = sorted(
            os.path.join(VIR61, f) for f in os.listdir(VIR61))
    else:
        p.input_file_names = [
            os.path.join(REPO, "tests", "data", "multifasta.fna")]
    from lzani.io.fasta import load_store

    store = load_store(p)
    store.reorder()
    return p, store


def reference_cmd(threads: int) -> list[str] | None:
    """Build (once) + warm the reference binary; return its vir61
    invocation, or None when unavailable. Timing happens at the caller
    (interleaved with the engines it is ratioed against)."""
    if not os.path.isdir(VIR61):
        return None
    try:
        if not os.path.exists(REF_BIN):
            subprocess.run(
                ["bash", os.path.join(REPO, "scripts",
                                      "build_reference_binary.sh")],
                check=True, capture_output=True, timeout=600)
        # NB: -V 1, not 0 — the reference crashes at verbosity 0 with no
        # filter (dangling `if (verbosity_level >= 1)` swallows the
        # empty-filter-name check, lz_matcher.cpp:31-39)
        cmd = [REF_BIN, "all2all", "--in-dir", VIR61, "--out",
               "/tmp/bench_ref.tsv", "-t", str(threads), "-V", "1"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        return cmd
    except (OSError, subprocess.SubprocessError):
        return None


def hybrid_why(hst: dict) -> str:
    """One-line verdict for a hybrid run's stats dict, so the bench
    artifact explains a zero/low device share."""
    if not hst:
        return "no stats recorded"
    if hst.get("warm_why"):
        return f"warm-up refused/failed: {hst['warm_why']}"
    if not hst.get("warm_started"):
        return ("lazy-warm gate: at the native pool's early rate the "
                "device would not repay its warm-up (hybrid.device_pays)")
    if hst.get("warm_pending"):
        return "device warm-up did not complete before the queue drained"
    dp = hst.get("device_pairs") or 0
    if dp == 0:
        return ("tail-backlog throttle: the native pool was projected to "
                "drain the queue before the device could drain a row")
    return f"device contributed {dp} pairs"


def time_cmd_best(cmd: list[str], reps: int) -> float:
    dt = 1e9
    for _ in range(reps):  # best-of-N: host noise only ever adds time
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, capture_output=True, timeout=600)
        dt = min(dt, time.perf_counter() - t0)
    return dt


def main() -> int:
    from lzani.runtime import enable_compile_cache, set_xla_flags

    set_xla_flags()
    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX platform {dev.platform}); nothing to "
              f"measure", file=sys.stderr)
        return 1
    enable_compile_cache()

    from lzani.core import native_engine
    from lzani.ops.engine_jax import all2all_jax
    from lzani.ops.hybrid import all2all_hybrid

    p, store = load_vir61()
    codes = store.codes
    n = len(codes)
    pairs = n * (n - 1)
    threads = os.cpu_count() or 1
    ref_cmd = reference_cmd(threads)
    p.no_threads = threads
    native_engine.all2all(codes, p)  # warm (.so build, page-in)
    ref_out = native_engine.all2all(codes, p)

    result = {
        "metric": "vir61_device_pairs_per_s",
        "unit": "pairs/s",
        "backend": "jax",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "n_genomes": n,
        "threads": threads,
    }

    sub = codes[:12] if os.environ.get("BENCH_DEVICE_FAST") else codes
    sub_pairs = len(sub) * (len(sub) - 1)
    t0 = time.perf_counter()
    all2all_jax(sub, p)  # warm: compiles
    result["device_cold_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    dev_out = all2all_jax(sub, p)
    dev_rate = sub_pairs / (time.perf_counter() - t0)
    result["device_n_genomes"] = len(sub)
    result["device_exact"] = bool(np.array_equal(
        dev_out, ref_out[:len(sub), :len(sub) - 1]
        if len(sub) < n else ref_out))

    # the reference / native / hybrid ratios are the headline claims, and
    # host load drifts minute-scale — so all THREE run interleaved
    # round-robin, best-of-3 each
    hst = {}
    cpu_dt = hyb_dt = ref_dt = 1e9
    hyb_out = None

    def _ref():
        nonlocal ref_dt
        if ref_cmd is not None:
            ref_dt = min(ref_dt, time_cmd_best(ref_cmd, 1))

    def _nat():
        nonlocal cpu_dt
        t0 = time.perf_counter()
        native_engine.all2all(codes, p)
        cpu_dt = min(cpu_dt, time.perf_counter() - t0)

    def _hyb():
        nonlocal hyb_dt, hst, hyb_out
        rep_st = {}
        t0 = time.perf_counter()
        out = all2all_hybrid(codes, p, stats=rep_st)
        rep_dt = time.perf_counter() - t0
        if rep_dt < hyb_dt:  # stats travel w/ best rep
            hyb_dt, hst, hyb_out = rep_dt, rep_st, out

    order = (_ref, _nat, _hyb)
    for rep in range(3):
        for j in range(3):
            order[(rep + j) % 3]()
    cpu_rate = pairs / cpu_dt
    ref_rate = pairs / ref_dt if ref_dt < 1e9 else None
    result["hybrid_pairs_per_s"] = round(pairs / hyb_dt, 1)
    result["hybrid_exact"] = bool(np.array_equal(hyb_out, ref_out))
    result["hybrid_device_pairs"] = hst.get("device_pairs")
    result["hybrid_why"] = hybrid_why(hst)

    # --- dissimilar-heavy set: the desync-dominated regime ---------------
    if not os.environ.get("BENCH_SKIP_DISSIM"):
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        import ab_dissimilar as _abd

        dcodes = _abd.synth(int(os.environ.get("BENCH_DISSIM_N", "500")))
        dn = len(dcodes)
        dpairs = dn * (dn - 1)
        d_ref = native_engine.all2all(dcodes, p)  # warm
        d_nat_dt = d_hyb_dt = 1e9
        d_hst = {}
        d_hyb_out = None
        for _ in range(2):
            t0 = time.perf_counter()
            native_engine.all2all(dcodes, p)
            d_nat_dt = min(d_nat_dt, time.perf_counter() - t0)
            rep_st = {}
            t0 = time.perf_counter()
            out = all2all_hybrid(dcodes, p, stats=rep_st)
            rep_dt = time.perf_counter() - t0
            if rep_dt < d_hyb_dt:
                d_hyb_dt, d_hst, d_hyb_out = rep_dt, rep_st, out
        result["dissim_n_genomes"] = dn
        result["dissim_native_pairs_per_s"] = round(dpairs / d_nat_dt, 1)
        result["dissim_hybrid_pairs_per_s"] = round(dpairs / d_hyb_dt, 1)
        result["dissim_hybrid_device_pairs"] = d_hst.get("device_pairs")
        result["dissim_hybrid_exact"] = bool(
            np.array_equal(d_hyb_out, d_ref))
        result["dissim_hybrid_vs_native"] = round(d_nat_dt / d_hyb_dt, 4)
        result["dissim_hybrid_why"] = hybrid_why(d_hst)

    result["native_pairs_per_s"] = round(cpu_rate, 1)
    result["reference_binary_pairs_per_s"] = (round(ref_rate, 1)
                                              if ref_rate else None)
    baseline = ref_rate or cpu_rate
    result["hybrid_vs_baseline"] = round(
        result["hybrid_pairs_per_s"] / baseline, 4)
    result["value"] = round(dev_rate, 1)
    result["vs_baseline"] = round(dev_rate / baseline, 4)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
