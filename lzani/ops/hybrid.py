"""Hybrid CPU+GPU all-vs-all scheduler (jax-free at import time).

This module deliberately imports neither jax nor the device engine at
module scope: the CLI's default backend is hybrid, and a run too small
to profit from the device must pay ZERO device cost. The engine is
imported lazily inside the warm-up thread, which only starts once the
native pool's early rate projects a queue long enough for the device to
repay its warm-up (see `device_pays`).

Extends the reference's dynamic row scheduling (lz_matcher.cpp:184-270)
across heterogeneous executors.
"""

from __future__ import annotations

import numpy as np

# ---- warm-thread lifecycle -------------------------------------------------
# A warm-up thread that is still inside jax import / device discovery / a
# compile when the interpreter exits makes glibc abort at teardown
# ("FATAL: exception not rethrown", rc=134) — daemon threads are killed
# mid-C++. The contract: all2all_hybrid sets the cancel flag and does a
# short bounded join; a thread that outlives it is PARKED here and joined
# (unbounded) by an atexit hook, which runs while the interpreter is still
# fully alive. A clean blocking exit always beats an abort; the wait is
# bounded by the warm-up itself, which checks the cancel flag at every
# step boundary.
_parked_warm: list = []
_parked_lock = None
_atexit_registered = False


def _join_parked_warm():
    for t, st in list(_parked_warm):
        st["cancel"] = True
        t.join()
    _parked_warm.clear()


def _park_warm_thread(t, warm_state):
    global _parked_lock, _atexit_registered
    import atexit
    import threading

    if _parked_lock is None:
        _parked_lock = threading.Lock()
    with _parked_lock:
        # drop entries that have since finished
        _parked_warm[:] = [(pt, ps) for pt, ps in _parked_warm
                           if pt.is_alive()]
        _parked_warm.append((t, warm_state))
        if not _atexit_registered:
            atexit.register(_join_parked_warm)
            _atexit_registered = True


# Device seconds per symbol of a row's longest query, before the first row
# has drained: the automaton costs one loop step per symbol of an unrelated
# query, 120-320 us on an H100 with command buffers depending on batch width
# and power limit, and ~22 us per symbol of a similar one (PERF.md). The
# high end keeps the first claim from making the device the run's
# critical path.
DEVICE_SEC_PER_SYM = 350e-6
# Wall seconds a busy native pool loses to the device side's warm-up (jax
# import, device start, the first compile, all competing with the pool for
# host cores): 43.19 s against 39.01 s for a 300-genome run on a 16-core
# H100 host (PERF.md).
WARM_UP_WALL_S = 4.2


def device_pays(remaining_s: float, native_rate: float,
                pairs_per_row: float, longest: int) -> bool:
    """Whether the pairs the device would parse over the native pool's
    remaining time save more wall time than its warm-up costs the pool.
    The device's rate is priced at DEVICE_SEC_PER_SYM per symbol of a
    row's longest query."""
    dev_rate = pairs_per_row / (DEVICE_SEC_PER_SYM * max(longest, 1))
    return remaining_s * dev_rate / native_rate > WARM_UP_WALL_S


def resolve_device(devices=None):
    """(device, why_not) for the hybrid's device side. Explicitly passed
    devices are used as given; a discovered device must be a GPU — on a
    host without one the native pool owns the run (policy, not a
    failure)."""
    import jax

    if devices is None:
        devices = jax.local_devices()
        if devices and devices[0].platform != "gpu":
            devices = []
    if not devices:
        return None, "no-device"
    return devices[0], None


def _warm_pair():
    """A tiny seeded pair the warm-up parses end to end on the device."""
    rng = np.random.RandomState(0)
    ref = rng.randint(0, 4, 200).astype(np.uint8)
    q = ref.copy()
    q[::13] = (q[::13] + 1) % 4
    return [ref, q]


def all2all_hybrid(codes, params, filter_csr=None, progress=None,
                   region_path: str | None = None, devices=None,
                   cpu_threads: int | None = None,
                   stats: dict | None = None):
    """Heterogeneous all-vs-all: the native C++ thread pool AND the device
    engine pop reference rows from ONE shared two-ended atomic queue,
    writing into one shared triples buffer.

    Scheduling:
      * Two-ended queue (lza_claim_head / lza_claim_tail): the CPU pool
        keeps the reference's longest-first schedule from the head; the
        device claims the short rows from the tail, one row at a time,
        so it can never capture an expensive head row and become the
        critical path.
      * Tail throttle: the device claims a row only while the CPU pool
        would not finish the remaining queue before the device could
        drain its own backlog (EMA of row service times); until the
        first row drains, one row is in flight.
      * Lazy asynchronous warm-up: the device side starts only once the
        native pool's early rate projects a queue over which the device
        repays the wall time its warm-up costs the pool (device_pays; at
        the device's measured rate, jobs of hours); the device joins
        the queue once a tiny pair has parsed on it; and the run returns
        as soon as the queue drains — a slow warm-up never gates
        completion (stats['warm_pending'] reports it).
      * LZANI_HYBRID_GREEDY=1 lifts the warm gate and the tail throttle,
        and reserves the shortest row for the device before the pool
        starts, so the device provably joins (tests and the chip smoke;
        the run then waits for the warm-up).

    Failures migrate, not lose, work: a device dead at warm-up degrades
    the run to pure-native (stats['warm_why'] says why); a device dying
    mid-run has its claimed-but-unfinished rows re-run on the host.

    cpu_threads=0 runs the device engine alone; an empty device list or a
    host without a GPU gives the native engine the whole run.
    """
    import copy
    import ctypes as ct
    import os
    import sys
    import threading
    import time
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..core import native_engine

    n = len(codes)
    if cpu_threads is None:
        # honor the caller's -t (params.no_threads); when unset (0), the
        # full pool: the device side's own thread mostly waits on the card
        cpu_threads = (getattr(params, "no_threads", 0)
                       or os.cpu_count() or 1)
    if cpu_threads <= 0:
        from .engine_jax import all2all_jax
        return all2all_jax(codes, params, filter_csr=filter_csr,
                           progress=progress, region_path=region_path,
                           device=devices[0] if devices else None)
    if devices is not None and not devices:
        out = native_engine.all2all(codes, params, filter_csr=filter_csr,
                                    region_path=region_path)
        if stats is not None:
            stats.update(device_pairs=0, cpu_pairs=int(out.size // 3),
                         warm_started=False, warm_why="no-device")
        return out

    if filter_csr is None:
        indptr = ids = None
        out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
        total_pairs = n * (n - 1)
    else:
        indptr, ids = filter_csr
        out = np.zeros((len(ids), 3), dtype=np.int32)
        total_pairs = len(ids)

    lib = native_engine.get_lib()
    # two-ended row queue packed as {tail:32|head:32}
    counter = np.array([n << 32], np.int64)
    cptr = counter.ctypes.data_as(ct.POINTER(ct.c_int64))

    def queue_rem():
        v = int(counter[0])
        return (v >> 32) - (v & 0xFFFFFFFF)

    rf = open(region_path + ".dev", "wb") if region_path else None
    rf_lock = threading.Lock()
    want_regions = rf is not None

    # ---- CPU side: the native pool claims rows from the shared queue ----
    p2 = copy.copy(params)
    p2.no_threads = cpu_threads
    nat_prog = np.zeros(2, np.int64)
    nat_exc: list[BaseException] = []

    def run_native():
        try:
            native_engine.all2all(codes, p2, filter_csr=filter_csr,
                                  region_path=region_path,
                                  progress=nat_prog,
                                  ext_counter=counter, out=out)
        except BaseException as e:  # surfaced after join
            nat_exc.append(e)

    # ---- device side ----------------------------------------------------
    _seq_len = getattr(codes, "seq_len", None) or (lambda r: len(codes[r]))

    def q_ids_of(r):
        if filter_csr is None:
            return [q for q in range(n) if q != r]
        return [int(q) for q in ids[indptr[r]:indptr[r + 1]]]

    longest = max((_seq_len(q) for q in range(n)), default=0)

    def max_query_len(r):
        if filter_csr is None:
            return longest  # a dense row's queries are all other genomes
        return max((_seq_len(q) for q in q_ids_of(r)), default=0)

    def slots_of(r, q_ids):
        if filter_csr is None:
            return (r, [q - 1 if q > r else q for q in q_ids])
        return slice(int(indptr[r]), int(indptr[r + 1]))

    dev_pairs = [0]     # pairs whose triples the device wrote
    dev_rows = [0]      # reference rows finished by the device side
    dev_lock = threading.Lock()

    def report():
        if progress is not None:
            progress(int(nat_prog[1]) + dev_pairs[0], total_pairs,
                     int(nat_prog[0]) + dev_rows[0], n)

    def native_row_track(r):
        # recovered rows run host-side but were claimed by the device
        # scheduler — count them for Sequences% when done
        q_ids = q_ids_of(r)
        _native_row(codes, params, r, q_ids, out, slots_of(r, q_ids),
                    rf, rf_lock)
        with dev_lock:
            dev_rows[0] += 1
        report()

    def finalize_row(r, q_ids, st, facs):
        # regions of a device row, from its factor stacks (host work)
        from .engine_jax import finalize_regions

        recs = []
        for k, q in enumerate(q_ids):
            regs = finalize_regions(codes[r], codes[q], params, st[k],
                                    facs[k])
            rec = native_engine.region_record(r, q, regs, _seq_len(q),
                                              params.output_filter)
            if rec is not None:
                recs.append(rec)
        with rf_lock:
            for rec in recs:
                rec.tofile(rf)

    greedy = bool(int(os.environ.get("LZANI_HYBRID_GREEDY", "0")))
    reserved: list[int] = []
    if greedy:
        got = ct.c_int64(0)
        start = int(lib.lza_claim_tail(cptr, 1, ct.byref(got)))
        if start >= 0:
            reserved.append(start)

    nat_thread = threading.Thread(target=run_native, daemon=True)
    t_run0 = time.perf_counter()
    nat_thread.start()

    pool = ThreadPoolExecutor(max_workers=2)
    pending = []
    verbosity = getattr(params, "verbosity_level", 1)

    def _warn(msg):
        if verbosity >= 1:
            print(msg, file=sys.stderr)

    # the device joins only after a tiny pair parsed on it end to end,
    # ASYNCHRONOUSLY: a cold compile must never gate a run the CPU pool
    # can finish by itself
    warm_state: dict = {"s": None, "ok": None, "why": None, "dev": None}

    def _warm():
        try:
            import jax  # noqa: F401  (part of the warm-up cost by design)

            if warm_state.get("cancel"):  # run drained during the import
                warm_state["ok"] = False
                warm_state["why"] = "cancelled-after-import"
                return
            dev, why = resolve_device(devices)
            if dev is None:
                warm_state["ok"] = False
                warm_state["why"] = why
                return
            from . import engine_jax

            t0 = time.perf_counter()
            budget = engine_jax.DeviceBudget.for_device(dev)
            h = engine_jax.dispatch_row(_warm_pair(), 0, [1], params, dev,
                                        budget)
            engine_jax.collect_row(h)
            warm_state["s"] = time.perf_counter() - t0
            warm_state["dev"] = dev
            warm_state["budget"] = budget
            warm_state["ok"] = True
        except Exception as e:  # device dead at startup: CPU owns the run
            warm_state["ok"] = False
            warm_state["why"] = f"{type(e).__name__}: {e}"[:200]
            _warn(f"lz-ani: device warm-up failed ({type(e).__name__}: "
                  f"{e}); hybrid run continues on the native pool alone")

    warm_thread = threading.Thread(target=_warm, daemon=True)
    # device seconds per symbol of a row's longest query (a batch runs as
    # long as its longest lane): the measured prior, then an EMA of rows
    sec_per_sym = [DEVICE_SEC_PER_SYM]
    t_row = [None]          # EMA of device row service time (s)
    inflight = deque()      # (handle, t_dispatch, estimated seconds)
    depth = 2               # rows dispatched ahead of the one draining
    failed_rows: set[int] = set()

    def claim_row():
        """Claim the shortest row from the tail while the device adds
        throughput (see the tail throttle in the docstring)."""
        if reserved:
            return reserved.pop()
        if queue_rem() <= 0:
            return None
        if not greedy:
            if t_row[0] is None and inflight:
                return None
            rows_done = int(nat_prog[0])
            el = time.perf_counter() - t_run0
            if rows_done <= 0 or el <= 0:
                return None
            # the row the tail would give next, and what it would cost
            r = (int(counter[0]) >> 32) - 1
            est = sec_per_sym[0] * max_query_len(r)
            backlog = sum(e for _, _, e in inflight)
            if queue_rem() / (rows_done / el) < backlog + est:
                return None
        got = ct.c_int64(0)
        start = int(lib.lza_claim_tail(cptr, 1, ct.byref(got)))
        return None if start < 0 else start

    def drain_one():
        from .engine_jax import collect_row

        handle, t0, _ = inflight[0]
        r, q_ids, st, facs = collect_row(handle, want_regions)
        inflight.popleft()
        out[slots_of(r, q_ids)] = st
        if want_regions:
            pending.append(pool.submit(finalize_row, r, q_ids, st, facs))
        dt = time.perf_counter() - t0
        t_row[0] = dt if t_row[0] is None else 0.5 * t_row[0] + 0.5 * dt
        sec_per_sym[0] = 0.5 * sec_per_sym[0] + 0.5 * dt / max(
            1, max_query_len(r))
        with dev_lock:
            dev_pairs[0] += len(q_ids)
            dev_rows[0] += 1
        report()

    warm_started = False
    try:
        while True:
            if not warm_started:
                # lazy warm-up gate: join only if the device repays its
                # warm-up over the queue's remaining time at the native
                # pool's own early rate (the projection can only shrink,
                # so one decision suffices)
                if not greedy and (queue_rem() <= 0
                                   or not nat_thread.is_alive()):
                    break
                el = time.perf_counter() - t_run0
                pdone = int(nat_prog[1])
                if greedy:
                    warm_started = True
                elif el >= 0.5 and pdone > 0:
                    rate = pdone / el
                    if not device_pays((total_pairs - pdone) / rate, rate,
                                       total_pairs / max(n, 1), longest):
                        break  # run too small to profit from the device
                    warm_started = True
                if warm_started:
                    warm_thread.start()
                else:
                    time.sleep(0.02)
                continue
            if warm_state["ok"] is None:
                # device still warming: the CPU owns the queue meanwhile
                if queue_rem() <= 0 and not reserved:
                    break
                time.sleep(0.05)
                continue
            if warm_state["ok"] is False:
                failed_rows.update(reserved)
                break
            from .engine_jax import dispatch_row

            r = claim_row() if len(inflight) < depth else None
            if r is not None:
                q_ids = q_ids_of(r)
                try:
                    if q_ids:
                        h = dispatch_row(codes, r, q_ids, params,
                                         warm_state["dev"],
                                         warm_state["budget"], want_regions)
                        inflight.append((h, time.perf_counter(),
                                         sec_per_sym[0] * max_query_len(r)))
                    else:
                        with dev_lock:
                            dev_rows[0] += 1
                except Exception:
                    failed_rows.add(r)
                    raise
                continue
            if inflight:
                drain_one()
            elif not reserved and (queue_rem() <= 0
                                   or not nat_thread.is_alive()):
                break
            else:
                time.sleep(0.02)  # throttled: the CPU owns the queue
    except Exception as e:
        # device failure mid-run: every claimed-but-unfinished row is
        # re-run on the host (slot writes are idempotent)
        failed_rows.update(h[0] for h, _, _ in inflight)
        failed_rows.update(reserved)
        _warn(f"lz-ani: device failed mid-run ({type(e).__name__}: {e}); "
              f"{len(failed_rows)} claimed rows recovered on the host, "
              f"run continues on the native pool")
    for r in sorted(failed_rows):
        pending.append(pool.submit(native_row_track, r))
    warm_state["cancel"] = True  # a still-pending warm-up stops at its
    #                              next step boundary
    if warm_started and warm_thread.is_alive():
        # bounded join; a thread stuck deeper (jax import, compile —
        # uninterruptible) is parked for an unbounded atexit join so
        # interpreter teardown never kills it mid-C++
        warm_thread.join(timeout=2.0)
        if warm_thread.is_alive():
            _park_warm_thread(warm_thread, warm_state)
    nat_thread.join()
    if nat_exc:
        raise nat_exc[0]
    for f in pending:
        f.result()
    pool.shutdown(wait=True)
    report()
    if stats is not None:
        stats["device_pairs"] = dev_pairs[0]
        stats["cpu_rows"] = int(nat_prog[0])
        stats["cpu_pairs"] = int(nat_prog[1])
        stats["warm_s"] = warm_state["s"]
        stats["warm_started"] = warm_started
        stats["warm_pending"] = warm_started and warm_state["ok"] is None
        stats["warm_why"] = warm_state.get("why")
        stats["t_row_s"] = t_row[0]
        stats["recovered_rows"] = len(failed_rows)
    if rf is not None:
        rf.close()
        # merge the device side's region records into the native file
        # (records are self-delimiting and order-independent)
        with open(region_path, "ab") as dst, \
                open(region_path + ".dev", "rb") as src:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                dst.write(chunk)
        os.remove(region_path + ".dev")
    return out


def _native_row(codes, params, r, q_ids, out, slots, rf, rf_lock):
    """Hybrid helper: run one reference row through the native engine
    (single worker, one index build) into the shared buffer."""
    import copy

    from ..core import native_engine

    n = len(codes)
    if not q_ids:
        return
    order = np.argsort(q_ids, kind="stable")
    qs = [q_ids[k] for k in order]
    indptr = np.zeros(n + 1, np.int64)
    indptr[r + 1:] = len(qs)
    csr = (indptr, np.array(qs, np.int32))
    p1 = copy.copy(params)
    p1.no_threads = 1
    sub = native_engine.all2all(codes, p1, filter_csr=csr)
    st = np.zeros((len(q_ids), 3), np.int32)
    st[order] = sub
    out[slots] = st
    if rf is not None:
        # regions for the row via per-pair native parses (rare path)
        recs = []
        for q in q_ids:
            _, regs = native_engine.parse_pair(codes[r], codes[q], params,
                                               want_regions=True)
            rec = native_engine.region_record(r, q, regs, len(codes[q]),
                                              params.output_filter)
            if rec is not None:
                recs.append(rec)
        with rf_lock:
            for rec in recs:
                rec.tofile(rf)
