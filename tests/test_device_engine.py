"""The device engine as the CLI and the hybrid drive it: regions from the
factor stack, the --backend jax CLI against the native backend, long
queries, batch sizing, the host-built anchor table, device resolution, and
the chip smoke's refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lzani import synth
from lzani.cli import main as cli_main
from lzani.core import native_engine
from lzani.ops import engine_jax, prep
from lzani.ops.hybrid import all2all_hybrid, resolve_device
from lzani.params import Params

from test_jax_engine import cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,ref,q", list(cases()),
                         ids=[c[0] for c in cases()])
def test_factor_stack_regions(name, ref, q):
    """Regions from the device's factor stack equal the oracle's own."""
    p = Params()
    stats, fac = engine_jax.parse_pair_jax(ref, q, p, want_factors=True)
    want_stats, want_regs = native_engine.parse_pair(ref, q, p,
                                                     want_regions=True)
    got_stats, got_regs = native_engine.pseudo_finalize(
        ref, q, p, fac, want_regions=True)
    assert got_stats == want_stats == stats
    assert np.array_equal(got_regs, want_regs)
    assert np.array_equal(
        engine_jax.finalize_regions(ref, q, p, stats, fac), want_regs)


def test_finalize_regions_rejects_disagreeing_stats():
    rng = np.random.default_rng(5)
    ref = rng.integers(0, 4, 600).astype(np.uint8)
    q = synth.mutate(rng, ref, sub=0.03)
    p = Params()
    stats, fac = engine_jax.parse_pair_jax(ref, q, p, want_factors=True)
    bad = (stats[0] + 1, stats[1], stats[2])
    with pytest.raises(RuntimeError, match="disagree"):
        engine_jax.finalize_regions(ref, q, p, bad, fac)


@pytest.fixture(scope="module")
def genome_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("set")
    names, codes = synth.viral_set(3, 7, lengths=(500, 1500),
                                   n_ancestors=2)
    fasta = str(d / "set.fna")
    synth.write_fasta(fasta, names, codes)
    flt = str(d / "flt.txt")
    synth.write_kmerdb_filter(flt, names, codes, k=8)
    return d, fasta, flt


def _run(d, fasta, backend, tag, extra=()):
    out = str(d / f"{tag}.{backend}.tsv")
    argv = ["all2all", "--in-fasta", fasta, "--out", out, "-V", "0",
            "--backend", backend, *extra]
    assert cli_main(argv) == 0
    return out


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_cli_jax_dense_matches_native(genome_set):
    d, fasta, _ = genome_set
    a = _run(d, fasta, "native", "dense")
    b = _run(d, fasta, "jax", "dense")
    assert _read(a) == _read(b)
    assert _read(a.replace(".tsv", ".ids.tsv")) == \
        _read(b.replace(".tsv", ".ids.tsv"))


def test_cli_jax_filter_matches_native(genome_set):
    d, fasta, flt = genome_set
    extra = ("--flt-kmerdb", flt, "0.2")
    a = _run(d, fasta, "native", "flt", extra)
    b = _run(d, fasta, "jax", "flt", extra)
    assert _read(a) == _read(b)
    assert len(_read(a).splitlines()) > 1  # the filter kept some pairs


def test_cli_jax_alignment_matches_native(genome_set):
    d, fasta, _ = genome_set
    alns = {}
    for backend in ("native", "jax"):
        aln = str(d / f"{backend}.aln.tsv")
        out = _run(d, fasta, backend, "aln", ("--out-alignment", aln))
        alns[backend] = (out, aln)
    assert _read(alns["native"][0]) == _read(alns["jax"][0])
    la = _read(alns["native"][1]).decode().splitlines()
    lb = _read(alns["jax"][1]).decode().splitlines()
    # aln rows are a set (the reference's own row order is not fixed)
    assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])
    assert len(la) > 1


def test_query_over_8192_symbols():
    """The device engine takes genomes past the old 8,192-symbol limit."""
    rng = np.random.default_rng(9)
    ref = rng.integers(0, 4, 9000).astype(np.uint8)
    q = synth.mutate(rng, ref, sub=0.04, indel=0.004)
    assert len(q) > 8192
    p = Params()
    got = engine_jax.parse_pair_jax(ref, q, p)
    assert got == native_engine.parse_pair(ref, q, p)[0]


def test_batch_sizing_from_memory_budget():
    per_pair = 4096 * engine_jax.PAIR_BYTES_PER_SYM
    assert engine_jax.max_batch(4096, 10 * per_pair) == 8
    assert engine_jax.max_batch(4096, per_pair - 1) == 1
    # groups by padded length, longest last; each batch within budget
    lens = [100, 5000, 120, 3000, 90, 5100]
    plan = engine_jax.plan_batches(lens, 40, 2 * 8192
                                   * engine_jax.PAIR_BYTES_PER_SYM)
    assert sorted(k for b in plan for k in b) == list(range(len(lens)))
    for b in plan:
        Lq = engine_jax.bucket_len(max(lens[k] for k in b) + 40)
        assert len(b) <= engine_jax.max_batch(
            Lq, 2 * 8192 * engine_jax.PAIR_BYTES_PER_SYM)


def _long_queries(seed, n, lo=1500, hi=3000):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, hi).astype(np.uint8)
    qs = [synth.mutate(rng, ref[:int(rng.integers(lo, hi))], sub=0.05,
                       indel=0.005) for _ in range(n)]
    return [ref] + qs


def test_device_budget_bounds_bytes_in_flight(monkeypatch):
    """Two rows dispatched ahead, with factor stacks kept: the bytes of the
    batches on the device never pass the budget, and what comes back
    equals the oracle."""
    codes = _long_queries(6, 5)
    p = Params()
    one = engine_jax.batch_bytes(1, engine_jax.bucket_len(
        max(len(c) for c in codes) + p.max_dist_in_ref))
    budget = engine_jax.DeviceBudget(3 * one)
    seen = []
    real_admit = engine_jax.DeviceBudget.admit

    def admit(self, batch):
        real_admit(self, batch)
        seen.append((self.used, len(self.live)))

    monkeypatch.setattr(engine_jax.DeviceBudget, "admit", admit)
    rows = [engine_jax.dispatch_row(codes, r, [q for q in range(3) if q != r]
                                    + list(range(3, len(codes))), p,
                                    None, budget, True)
            for r in (0, 1)]
    assert len(seen) == 2 * (len(codes) - 1)  # one lane per batch
    assert max(u for u, _ in seen) <= budget.nbytes
    assert budget.peak <= budget.nbytes
    for h in rows:
        r, q_ids, stats, facs = engine_jax.collect_row(h, True)
        for k, q in enumerate(q_ids):
            want = native_engine.parse_pair(codes[r], codes[q], p)[0]
            assert tuple(int(x) for x in stats[k]) == want
            assert np.array_equal(
                facs[k], native_engine.parse_factors(codes[r], codes[q], p))
    assert budget.used == 0 and not budget.live


def test_small_budget_all2all_regions_match_native(monkeypatch, tmp_path):
    """all2all_jax under a budget of a few lanes gives the native triples
    and the native region dump."""
    codes = _long_queries(7, 4)
    p = Params()
    one = engine_jax.batch_bytes(1, engine_jax.bucket_len(
        max(len(c) for c in codes) + p.max_dist_in_ref))
    monkeypatch.setattr(engine_jax, "batch_budget_bytes",
                        lambda device: 2 * one)
    got_path, want_path = tmp_path / "jax.regions", tmp_path / "nat.regions"
    got = engine_jax.all2all_jax(codes, p, region_path=str(got_path))
    want = native_engine.all2all(codes, p, region_path=str(want_path))
    assert np.array_equal(got, want)

    def as_map(path):
        return {(r, q): regs.tobytes()
                for r, q, regs in native_engine.read_region_dump(str(path))}

    assert as_map(got_path) == as_map(want_path)


def test_batch_budget_reads_device_memory():
    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    gib = 1 << 30
    got = engine_jax.batch_budget_bytes(
        Dev({"bytes_limit": 60 * gib, "bytes_in_use": 20 * gib}))
    assert got == int(40 * gib * engine_jax.BATCH_MEM_SHARE)
    assert engine_jax.batch_budget_bytes(Dev(None)) == \
        engine_jax.HOST_BUDGET_BYTES


def test_host_anchor_table_matches_device_build():
    """The table the oracle's insertion code builds equals the one the
    device loop (prep.build_anchor_table) builds, slot for slot."""
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, 700).astype(np.uint8)
    codes[100:130] = 4
    p = Params()
    idx = engine_jax.RefIndexJax(codes, p)
    anchors = prep.kmer_stream(idx.refbuf, p.min_anchor_len)
    tab, mask = prep.build_anchor_table(anchors, idx.table_size,
                                        idx.ref_true)
    assert np.array_equal(np.asarray(tab), np.asarray(idx.tab))
    assert int(mask) == int(idx.tmask)


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("platform,ok", [("gpu", True), ("cpu", False)])
def test_hybrid_resolves_gpu_only(monkeypatch, platform, ok):
    dev = _FakeDevice(platform)
    monkeypatch.setattr(jax, "local_devices", lambda: [dev])
    got, why = resolve_device()
    assert (got is dev, why) == ((True, None) if ok else (False,
                                                          "no-device"))


@pytest.mark.parametrize("remaining_s,joins", [(30.0, False),
                                                (3600.0, False),
                                                (36_000.0, True)])
def test_hybrid_warm_gate_break_even(remaining_s, joins):
    """At the measured rates (the native pool at 4,250 pairs/s, a device
    row of 23 queries of 25 kb), the device repays its warm-up only on a
    job of hours."""
    from lzani.ops.hybrid import device_pays

    assert device_pays(remaining_s, 4250.0, 23, 25_000) is joins


def test_hybrid_without_gpu_says_no_device(monkeypatch):
    monkeypatch.setenv("LZANI_HYBRID_GREEDY", "1")
    monkeypatch.setattr(jax, "local_devices",
                        lambda: [_FakeDevice("cpu")])
    names, codes = synth.viral_set(4, 5, lengths=(300, 500))
    p = Params()
    stats = {}
    out = all2all_hybrid(codes, p, cpu_threads=2, stats=stats)
    assert np.array_equal(out, native_engine.all2all(codes, p))
    assert stats["warm_why"] == "no-device"
    assert stats["device_pairs"] == 0


def test_cli_refuses_pallas_backend(capsys):
    with pytest.raises(SystemExit) as ei:
        cli_main(["all2all", "--in-fasta", "x.fna", "--backend", "pallas"])
    assert ei.value.code == 1
    assert "jax" in capsys.readouterr().err


def test_chip_smoke_fails_without_gpu(tmp_path):
    """On a host without a GPU the smoke exits nonzero and prints no
    result; alone in a directory it does the same."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, env=env, cwd=REPO,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(_read(os.path.join(REPO, "chip_smoke.py")))
    r = subprocess.run([sys.executable, str(alone)], capture_output=True,
                       text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
