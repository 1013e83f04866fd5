"""Hybrid CPU+GPU scheduler: native thread pool and the device engine
stealing reference rows from one shared atomic queue (the P1 dynamic-row
scheduling of lz_matcher.cpp:184-270 extended across heterogeneous
executors). The device engine runs on the CPU backend here, passed in
explicitly; the contract is exact equality with the pure-native run."""

import os

import jax
import numpy as np
import pytest

from lzani.core import native_engine as ne
from lzani.ops import engine_jax
from lzani.ops.hybrid import all2all_hybrid
from lzani.params import Params

CPU = jax.devices("cpu")[:1]


def _codes(n, rng, lo=250, hi=700):
    out = []
    base = rng.randint(0, 4, hi).astype(np.uint8)
    for k in range(n):
        L = int(rng.randint(lo, hi))
        c = base[:L].copy()
        m = rng.rand(L) < 0.1
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        out.append(c)
    # longest-first, as the store reorder guarantees
    out.sort(key=len, reverse=True)
    return out


@pytest.fixture()
def greedy_claims(monkeypatch):
    # disable the tail throttle so the (slow, CPU-backend) device side
    # deterministically claims at least one row in CI-sized runs
    monkeypatch.setenv("LZANI_HYBRID_GREEDY", "1")


@pytest.fixture()
def slow_cpu(monkeypatch):
    # hold the native pool back until the device warm-up has actually
    # completed (event-driven: a fixed sleep flakes when the host is
    # loaded and the compile slows down), so the device side provably
    # claims rows in CI-sized runs
    import threading
    import time

    warm_done = threading.Event()
    real_cr = engine_jax.collect_row

    def cr(handle, *a, **k):
        out = real_cr(handle, *a, **k)
        warm_done.set()
        return out

    monkeypatch.setattr(engine_jax, "collect_row", cr)
    real = ne.all2all

    def delayed(codes, params, **kw):
        if kw.get("ext_counter") is not None:
            warm_done.wait(120.0)
            time.sleep(0.5)  # give the claim loop a beat to win rows
        return real(codes, params, **kw)

    monkeypatch.setattr(ne, "all2all", delayed)


def test_hybrid_matches_native_dense(greedy_claims, slow_cpu):
    p = Params()
    rng = np.random.RandomState(11)
    codes = _codes(10, rng)
    ref = ne.all2all(codes, p)
    stats = {}
    out = all2all_hybrid(codes, p, devices=CPU, cpu_threads=1,
                         stats=stats)
    assert np.array_equal(ref, out)
    # the device side really claimed rows, and the split is a partition
    assert stats["device_pairs"] > 0
    assert stats["device_pairs"] + stats["cpu_pairs"] == 10 * 9
    assert stats["warm_why"] is None


def test_hybrid_matches_native_filter(greedy_claims):
    p = Params()
    rng = np.random.RandomState(12)
    codes = _codes(9, rng)
    n = len(codes)
    # sparse symmetric-ish filter
    indptr = np.zeros(n + 1, np.int64)
    ids = []
    for r in range(n):
        row = sorted(set(int(q) for q in rng.choice(n, 4) if q != r))
        ids.extend(row)
        indptr[r + 1] = len(ids)
    csr = (indptr, np.array(ids, np.int32))
    ref = ne.all2all(codes, p, filter_csr=csr)
    out = all2all_hybrid(codes, p, filter_csr=csr, devices=CPU,
                         cpu_threads=1)
    assert np.array_equal(ref, out)


def test_hybrid_regions_merge(tmp_path, greedy_claims, slow_cpu):
    """Regions from both executors land in one dump (native writes the
    primary file, the device side's records are appended)."""
    p = Params()
    rng = np.random.RandomState(13)
    codes = _codes(8, rng)
    ref_regs = tmp_path / "native.regions"
    hyb_regs = tmp_path / "hybrid.regions"
    ref = ne.all2all(codes, p, region_path=str(ref_regs))
    stats = {}
    out = all2all_hybrid(codes, p, region_path=str(hyb_regs),
                         devices=CPU, cpu_threads=1, stats=stats)
    assert np.array_equal(ref, out)
    assert stats["device_pairs"] > 0
    assert not os.path.exists(str(hyb_regs) + ".dev")  # merged + removed

    def as_map(path):
        return {(r, q): regs.tobytes()
                for r, q, regs in ne.read_region_dump(str(path))}

    a, b = as_map(ref_regs), as_map(hyb_regs)
    assert a == b


def test_hybrid_recovers_from_device_failure(greedy_claims, slow_cpu,
                                             monkeypatch):
    """A device that dies after warm-up must not lose claimed rows: the
    hybrid driver re-runs them on the host and the result stays exact."""
    p = Params()
    rng = np.random.RandomState(21)
    codes = _codes(10, rng)
    ref = ne.all2all(codes, p)

    calls = {"n": 0}
    real = engine_jax.collect_row

    def dying(handle, *a, **k):
        calls["n"] += 1
        if calls["n"] > 1:  # first call is the warm-up
            raise RuntimeError("injected device crash")
        return real(handle, *a, **k)

    monkeypatch.setattr(engine_jax, "collect_row", dying)
    stats = {}
    out = all2all_hybrid(codes, p, devices=CPU, cpu_threads=1,
                         stats=stats)
    assert calls["n"] > 1  # the device really claimed and then died
    assert stats["recovered_rows"] > 0
    assert np.array_equal(ref, out)


def test_hybrid_survives_dead_device_at_warmup(greedy_claims, monkeypatch):
    """Warm-up failure degrades to a pure-native run, and the stats say
    why."""
    def dead(*a, **k):
        raise RuntimeError("injected: device unreachable")

    monkeypatch.setattr(engine_jax, "dispatch_row", dead)
    p = Params()
    rng = np.random.RandomState(22)
    codes = _codes(8, rng)
    ref = ne.all2all(codes, p)
    stats = {}
    out = all2all_hybrid(codes, p, devices=CPU, cpu_threads=2,
                         stats=stats)
    assert np.array_equal(ref, out)
    assert stats["device_pairs"] == 0
    # greedy mode reserved one row for the device; the host re-ran it
    assert stats["cpu_pairs"] + 7 * stats["recovered_rows"] == 8 * 7
    assert "device unreachable" in stats["warm_why"]


def test_hybrid_small_run_never_warms(monkeypatch):
    """A run the CPU pool finishes before the lazy-warm threshold must
    never pay the device warm-up (engine construction included) — it
    degrades to pure-native with warm_started False."""
    def boom(*a, **k):
        raise AssertionError("engine must not be constructed")

    monkeypatch.setattr(engine_jax.RefIndexJax, "__init__", boom)
    p = Params()
    rng = np.random.RandomState(33)
    codes = _codes(8, rng)
    ref = ne.all2all(codes, p)
    stats = {}
    out = all2all_hybrid(codes, p, devices=CPU, cpu_threads=2,
                         stats=stats)
    assert np.array_equal(ref, out)
    assert stats["warm_started"] is False
    assert stats["device_pairs"] == 0


def test_hybrid_cpu0_delegates_to_pallas(monkeypatch):
    """cpu_threads=0 must degrade to the pure device path (the device
    engine, all2all_jax), on the device it was given."""
    called = {}

    def fake(codes, params, **kw):
        called["device"] = kw.get("device")
        return "sentinel"

    monkeypatch.setattr(engine_jax, "all2all_jax", fake)
    r = all2all_hybrid([np.zeros(10, np.uint8)], Params(),
                       cpu_threads=0, devices=CPU)
    assert r == "sentinel" and called["device"] == CPU[0]


def test_two_ended_claims_are_atomic_across_engines():
    """Head poppers (the native workers) and tail claimers (the device
    scheduler) share one packed {tail:32|head:32} word: claims never
    overlap, the ends never cross, and every row is claimed exactly
    once."""
    import ctypes as ct
    import threading

    N = 5000
    lib = ne.get_lib()
    ctr = np.array([N << 32], np.int64)
    ptr = ctr.ctypes.data_as(ct.POINTER(ct.c_int64))
    claimed = []
    lock = threading.Lock()

    def head_popper():
        got = []
        while True:
            r = int(lib.lza_claim_head(ptr))
            if r < 0:
                break
            got.append(r)
        with lock:
            claimed.extend(got)

    def tail_claimer(k):
        got = []
        while True:
            cnt = ct.c_int64(0)
            s = int(lib.lza_claim_tail(ptr, k, ct.byref(cnt)))
            if s < 0:
                break
            got.extend(range(s, s + cnt.value))
        with lock:
            claimed.extend(got)

    ts = ([threading.Thread(target=head_popper) for _ in range(2)]
          + [threading.Thread(target=tail_claimer, args=(k,))
             for k in (4, 7)])
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(claimed) == list(range(N))


def test_hybrid_module_is_jax_free_at_import_time():
    """The CLI default backend imports ops.hybrid in the matching phase;
    a run too small to warm the device must pay ZERO device cost. Pin it:
    importing ops.hybrid must not pull in the device engine module or
    jax.experimental.pallas (fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import lzani.ops.hybrid\n"
        "assert 'lzani.ops.engine_jax' not in sys.modules\n"
        "assert 'jax.experimental.pallas' not in sys.modules\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=os.path.dirname(
                           os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr[-1000:]


def test_hybrid_warm_thread_clean_teardown():
    """Round-4 regression (MULTICHIP_r04 rc=134): a greedy hybrid run
    whose queue drains while the warm thread is still inside jax import /
    engine construction left a daemon thread alive at interpreter exit,
    and glibc aborted at teardown ("FATAL: exception not rethrown").
    Contract now: all2all_hybrid bounded-joins the warm thread and parks
    any survivor for an unbounded atexit join, so a device-engine-then-
    greedy-hybrid process exits rc=0 with NO shield (os._exit) anywhere.

    Reference bar: the single binary's clean lifecycle
    (lz-ani.cpp:339-356 — joined threads, normal exit)."""
    import subprocess
    import sys

    code = (
        "import os\n"
        "os.environ['XLA_FLAGS'] = "
        "'--xla_force_host_platform_device_count=8'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import numpy as np\n"
        "from lzani.ops.engine_jax import all2all_jax\n"
        "from lzani.ops.hybrid import all2all_hybrid\n"
        "from lzani.core import native_engine\n"
        "from lzani.params import Params\n"
        "params = Params()\n"
        "rng = np.random.RandomState(3)\n"
        "base = rng.randint(0, 4, 300).astype(np.uint8)\n"
        "codes = []\n"
        "for i in range(9):\n"
        "    s = base.copy()\n"
        "    s[::(i + 4)] = (s[::(i + 4)] + 1) % 4\n"
        "    codes.append(s[:300 - 9 * i])\n"
        "devs = jax.devices()[:8]\n"
        "want = native_engine.all2all(codes, params)\n"
        "got = all2all_jax(codes, params, device=devs[0])\n"
        "assert np.array_equal(got, want)\n"
        "os.environ['LZANI_HYBRID_GREEDY'] = '1'\n"
        "goth = all2all_hybrid(codes, params, devices=devs[:1],\n"
        "                      cpu_threads=2)\n"
        "assert np.array_equal(goth, want)\n"
        "print('teardown-ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=os.path.dirname(
                           os.path.dirname(os.path.abspath(__file__))))
    assert r.returncode == 0 and "teardown-ok" in r.stdout, (
        f"rc={r.returncode}\n{r.stderr[-2000:]}")


def test_hybrid_small_run_joins_warm_thread_quickly():
    """Library-caller latency contract: when the queue drains before the
    warm thread reaches a cancel checkpoint, all2all_hybrid returns after
    a BOUNDED join (<= ~2 s) and parks the thread instead of blocking on
    an uninterruptible compile."""
    import threading
    import time

    from lzani.ops import hybrid as hyb

    rng = np.random.RandomState(0)
    codes = _codes(4, rng, lo=120, hi=200)
    params = Params()
    os.environ["LZANI_HYBRID_GREEDY"] = "1"
    try:
        t0 = time.perf_counter()
        got = all2all_hybrid(codes, params, devices=CPU,
                             cpu_threads=2)
        el = time.perf_counter() - t0
    finally:
        del os.environ["LZANI_HYBRID_GREEDY"]
    want = ne.all2all(codes, params)
    assert np.array_equal(got, want)
    # any parked thread must be tracked for the atexit join
    for t in threading.enumerate():
        if t.name.startswith("Thread") and "_warm" in repr(t):
            assert any(pt is t for pt, _ in hyb._parked_warm), \
                "live warm thread not parked for atexit join"
