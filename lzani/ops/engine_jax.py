"""Device engine: per-reference index + the vmapped pair automaton.

One reference row at a time: the anchor table is built on the host by the
oracle's own insertion code (the probe order decides tie-breaks, and the
insertion is a sequential walk that costs a device loop iteration per
reference position); k-mer streams and seed buckets are built on the
device; then the row's queries are parsed in batches, one pair per lane
of ``parse.batch_parser``.

Shapes are bucketed to powers of two so XLA compiles a small number of
variants; padding symbols are N codes, which can never match (the
reference's own masking trick, defs.h:24-30), and true lengths bound every
extension. Batches are sized from the bytes one pair keeps live on the
device against the memory the device reports, and a DeviceBudget bounds
the bytes of all batches dispatched and not yet fetched, across rows.
"""

from __future__ import annotations

from collections import deque
from functools import lru_cache

import jax
import numpy as np

from ..core import native_engine
from . import prep
from .parse import ParseCfg, batch_parser

MIN_BUCKET = 256

# Bytes one pair keeps live on the device per padded query symbol: the u8
# query buffer, two int64 k-mer streams and the int32[4] factor stack, the
# stack counted three times for the copies XLA keeps across the
# automaton's branches and loops. The compiled batch programs take
# 65.0-65.4 B (temporaries, outputs and query buffer) on an H100 at 1-32
# lanes of 32k-1M symbols (PERF.md).
PAIR_BYTES_PER_SYM = 1 + 2 * 8 + 3 * 16
# Share of the device's free memory that dispatched batches may hold at
# once; the rest is left to the reference indexes and XLA's own workspace.
BATCH_MEM_SHARE = 0.5
# Batches the budget holds at once at the largest batch size: one parsing
# while the next is queued behind it.
BATCHES_IN_FLIGHT = 2
# A device that reports no memory limit (the CPU backend) gets this budget.
HOST_BUDGET_BYTES = 1 << 30


def bucket_len(n: int) -> int:
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return b


def table_size_for(buf_len: int) -> int:
    return 2 * prep.pow2_floor(buf_len * 10)


def batch_budget_bytes(device) -> int:
    """Bytes the dispatched parse batches may occupy on ``device``."""
    stats = device.memory_stats() if device is not None else None
    if not stats or "bytes_limit" not in stats:
        return HOST_BUDGET_BYTES
    free = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
    return int(max(free, 0) * BATCH_MEM_SHARE)


def max_batch(Lq: int, budget: int) -> int:
    """Largest power-of-two batch of Lq-symbol queries within budget."""
    return prep.pow2_floor(max(1, budget // (Lq * PAIR_BYTES_PER_SYM)))


def batch_bytes(B: int, Lq: int) -> int:
    return B * Lq * PAIR_BYTES_PER_SYM


def plan_batches(q_lens, mrd: int, budget: int) -> list[list[int]]:
    """Group query indices by padded length, then cut each group into
    batches of at most ``budget`` bytes each. Returns lists of indices into
    q_lens, each batch sharing one length bucket."""
    groups: dict[int, list[int]] = {}
    for k in sorted(range(len(q_lens)), key=lambda k: q_lens[k]):
        groups.setdefault(bucket_len(q_lens[k] + mrd), []).append(k)
    out = []
    for Lq, ks in sorted(groups.items()):
        b = max_batch(Lq, budget)
        out.extend(ks[s:s + b] for s in range(0, len(ks), b))
    return out


class Batch:
    """One dispatched parse batch: the row's query slots it holds, its
    device outputs until fetched, then their host copies."""

    def __init__(self, sel, out, nbytes: int, want_factors: bool):
        self.sel, self.out, self.nbytes = sel, out, nbytes
        self.want_factors = want_factors
        self.stats = self.factors = None

    def fetch(self):
        """Copy the outputs to the host and drop the device buffers. Only
        each lane's used stack rows (fp) cross, rounded up to a power of
        two so that few slice shapes compile."""
        if self.out is None:
            return
        n = len(self.sel)
        if self.want_factors:
            st, fac, fp = self.out
            fp = np.asarray(fp)[:n]
            rows = min(prep.pow2_ceil(max(int(fp.max(initial=0)), 1)),
                       fac.shape[1])
            fac = np.asarray(fac[:, :rows])
            self.factors = [fac[k, :fp[k]] for k in range(n)]
        else:
            st = self.out
        self.stats = np.asarray(st)[:n]
        self.out = None


class DeviceBudget:
    """Bytes that dispatched parse batches may hold on the device at once,
    across rows. Admitting a batch past the budget first fetches the
    oldest live batches to the host, which frees their device buffers (an
    output factor stack stays resident until then)."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes
        self.live: deque = deque()
        self.used = 0
        self.peak = 0

    @classmethod
    def for_device(cls, device) -> "DeviceBudget":
        return cls(batch_budget_bytes(device))

    @property
    def batch_limit(self) -> int:
        """Bytes one batch may take."""
        return self.nbytes // BATCHES_IN_FLIGHT

    def admit(self, batch: Batch):
        while self.live and self.used + batch.nbytes > self.nbytes:
            self.release(self.live[0])
        self.live.append(batch)
        self.used += batch.nbytes
        self.peak = max(self.peak, self.used)

    def release(self, batch: Batch):
        batch.fetch()
        if batch in self.live:
            self.live.remove(batch)
            self.used -= batch.nbytes


@lru_cache(maxsize=64)
def _jit_seed_index(Lr: int, mal: int, msl: int):
    @jax.jit
    def build(refbuf):
        seeds = prep.kmer_stream(refbuf, msl)
        return prep.build_seed_buckets(seeds, msl)

    return build


@lru_cache(maxsize=64)
def _jit_parse_batch(cfg: ParseCfg, Lr: int, Lq: int, table_size: int,
                     want_factors: bool):
    parse = batch_parser(cfg, Lr, Lq, table_size, want_factors)

    @jax.jit
    def run(refbuf, ref_true, tab, tmask, bucket_pos, bucket_lo, bucket_cnt,
            qbufs, q_trues):
        seeds = jax.vmap(lambda b: prep.kmer_stream(b, cfg.msl))(qbufs)
        anchors = jax.vmap(lambda b: prep.kmer_stream(b, cfg.mal))(qbufs)
        return parse(refbuf, ref_true, tab, tmask, bucket_pos, bucket_lo,
                     bucket_cnt, qbufs, q_trues, seeds, anchors)

    return run


class RefIndexJax:
    """Device-resident index for one reference sequence."""

    def __init__(self, codes: np.ndarray, params, device=None):
        self.cfg = ParseCfg.from_params(params)
        self.device = device
        mrd = params.max_dist_in_ref
        true_len = 2 * len(codes) + 3 * mrd
        # guard band: the parse may read a few symbols past the semantic
        # end (reference tail-emission semantics); keep N padding there
        self.Lr = bucket_len(true_len + params.max_dist_in_query
                             + params.min_seed_len + 64)
        self.table_size = table_size_for(self.Lr)
        tab, mask = native_engine.anchor_table(codes, params,
                                               self.table_size)
        buf = prep.ref_buffer_np(codes, mrd, pad_to=self.Lr)
        self.refbuf = jax.device_put(buf, device)
        self.tab = jax.device_put(tab, device)
        self.tmask = jax.device_put(np.uint64(mask), device)
        self.ref_true = jax.device_put(np.int32(true_len), device)
        build = _jit_seed_index(self.Lr, self.cfg.mal, self.cfg.msl)
        self.bucket_pos, self.bucket_lo, self.bucket_cnt = build(self.refbuf)

    def parse_batch(self, qcodes: list[np.ndarray], params,
                    want_factors: bool = False, pad_to: int | None = None):
        """Dispatch one batch (asynchronously). Lanes past len(qcodes), up
        to pad_to, parse an empty query and are to be ignored."""
        mrd = params.max_dist_in_ref
        B = max(len(qcodes), pad_to or 0)
        true_lens = [len(q) + mrd for q in qcodes] + [mrd] * (B - len(qcodes))
        Lq = bucket_len(max(true_lens))
        qbufs = np.full((B, Lq), prep.SYM_N_SEQ, np.uint8)
        for k, q in enumerate(qcodes):
            qbufs[k] = prep.query_buffer_np(q, mrd, pad_to=Lq)
        qbufs = jax.device_put(qbufs, self.device)
        q_trues = jax.device_put(np.asarray(true_lens, np.int32),
                                 self.device)
        run = _jit_parse_batch(self.cfg, self.Lr, Lq, self.table_size,
                               want_factors)
        return run(self.refbuf, self.ref_true, self.tab, self.tmask,
                   self.bucket_pos, self.bucket_lo, self.bucket_cnt,
                   qbufs, q_trues)


def parse_pair_jax(ref_codes: np.ndarray, q_codes: np.ndarray, params,
                   want_factors: bool = False, device=None):
    """Single-pair entry point (tests / oracle diffing)."""
    idx = RefIndexJax(ref_codes, params, device)
    out = idx.parse_batch([q_codes], params, want_factors)
    if want_factors:
        stats, fac, fp = out
        n = int(fp[0])
        return tuple(int(x) for x in np.asarray(stats[0])), np.asarray(fac[0][:n])
    return tuple(int(x) for x in np.asarray(out[0]))


def seq_len(codes, i: int) -> int:
    """Length of item i without unpacking a packed store."""
    f = getattr(codes, "seq_len", None)
    return f(i) if f is not None else len(codes[i])


def dispatch_row(codes, r: int, q_ids: list[int], params, device,
                 budget: DeviceBudget, want_factors: bool = False):
    """Build reference r's index and dispatch every batch of its queries
    without waiting for the device, within ``budget``. Returns the handle
    collect_row takes."""
    idx = RefIndexJax(codes[r], params, device)
    mrd = params.max_dist_in_ref
    lens = [seq_len(codes, q) for q in q_ids]
    batches = []
    for sel in plan_batches(lens, mrd, budget.batch_limit):
        pad = prep.pow2_ceil(len(sel))
        nbytes = batch_bytes(pad, bucket_len(max(lens[k] for k in sel)
                                             + mrd))
        batch = Batch(sel, None, nbytes, want_factors)
        budget.admit(batch)
        batch.out = idx.parse_batch([codes[q_ids[k]] for k in sel], params,
                                    want_factors, pad_to=pad)
        batches.append(batch)
    return r, q_ids, batches, budget


def collect_row(handle, want_factors: bool = False):
    """Wait for a dispatched row. Returns (r, q_ids, stats int32[len(q_ids),
    3], factors) where factors[k] is query k's factor stack, int32[n, 4]
    {dpos, kind, rpos, len}, or None unless want_factors."""
    r, q_ids, batches, budget = handle
    stats = np.zeros((len(q_ids), 3), np.int32)
    facs = [None] * len(q_ids) if want_factors else None
    for b in batches:
        budget.release(b)
        stats[np.asarray(b.sel)] = b.stats
        if want_factors:
            for lane, k in enumerate(b.sel):
                facs[k] = b.factors[lane]
    return r, q_ids, stats, facs


def finalize_regions(ref, query, params, stats, factors):
    """Regions of one device-parsed pair from its factor stack. The stats
    the host derives from the factors must equal the device's."""
    host_stats, regs = native_engine.pseudo_finalize(
        ref, query, params, factors, want_regions=True)
    if tuple(int(x) for x in stats) != host_stats:
        raise RuntimeError(
            f"device stats {tuple(int(x) for x in stats)} disagree with "
            f"the stats of its own factors {host_stats}")
    return regs


def all2all_jax(codes: list[np.ndarray], params, filter_csr=None,
                progress=None, region_path: str | None = None,
                device=None) -> np.ndarray:
    """All-vs-all on the device engine. Output layout matches
    native_engine.all2all (dense (n, n-1, 3) or CSR-aligned (nnz, 3)).

    region_path: write the alignment-region dump there (the layout
    native_engine.all2all writes), from each pair's factor stack.
    progress: optional callable(pairs_done, total_pairs, seqs_done,
    total_seqs), invoked after each reference row — the two counters the
    reference prints at -V 2 (lz_matcher.cpp:187-264)."""
    n = len(codes)
    if device is None:
        device = jax.local_devices()[0]
    budget = DeviceBudget.for_device(device)
    if filter_csr is None:
        out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
        total_pairs = n * (n - 1)
    else:
        indptr, ids = filter_csr
        out = np.zeros((len(ids), 3), dtype=np.int32)
        total_pairs = len(ids)
    want = region_path is not None
    rf = open(region_path, "wb") if want else None
    done = {"pairs": 0, "rows": 0}

    def row_done(n_pairs):
        done["pairs"] += n_pairs
        done["rows"] += 1
        if progress is not None:
            progress(done["pairs"], total_pairs, done["rows"], n)

    def store(handle):
        r, q_ids, stats, facs = collect_row(handle, want)
        if filter_csr is None:
            out[r, [q - 1 if q > r else q for q in q_ids]] = stats
        else:
            out[int(indptr[r]):int(indptr[r + 1])] = stats
        if want:
            for k, q in enumerate(q_ids):
                regs = finalize_regions(codes[r], codes[q], params,
                                        stats[k], facs[k])
                rec = native_engine.region_record(
                    r, q, regs, seq_len(codes, q), params.output_filter)
                if rec is not None:
                    rec.tofile(rf)
        row_done(len(q_ids))

    try:
        prev = None
        for r in range(n):
            if filter_csr is None:
                q_ids = [q for q in range(n) if q != r]
            else:
                q_ids = [int(q) for q in ids[indptr[r]:indptr[r + 1]]]
            if not q_ids:
                row_done(0)
                continue
            # dispatch this row before collecting the previous one, so the
            # host's index build and uploads overlap the device's parse
            cur = dispatch_row(codes, r, q_ids, params, device, budget,
                               want)
            if prev is not None:
                store(prev)
            prev = cur
        if prev is not None:
            store(prev)
    finally:
        if rf is not None:
            rf.close()
    return out
