"""All-vs-all orchestration: load -> filter -> reorder -> match -> store.

The phase sequence mirrors the reference's ``CLZMatcher::run_all2all``
(/root/reference/src/lz_matcher.cpp:582-617); matching is dispatched to the
selected backend (native C++ host engine, the JAX device engine, or both on
one row queue).
"""

from __future__ import annotations

import os
import sys
import time

from .runtime import enable_compile_cache
from .io.fasta import SequenceStore, load_store
from .io.kmerdb_filter import PairFilter
from .output import (ResultMatrix, alignment_lines, derive_ids_path,
                     ids_file_lines, single_txt_lines)
from .params import Params


def _warm_verdict(hst: dict) -> str:
    """One phrase for how the hybrid's device side fared."""
    if hst.get("warm_why"):
        return f"refused: {hst['warm_why']}"
    if not hst.get("warm_started"):
        return "not started: the native pool was projected to finish first"
    if hst.get("warm_pending"):
        return "still pending when the queue drained"
    return f"done in {hst['warm_s']:.1f}s"


class Matcher:
    def __init__(self, params: Params):
        self.params = params
        self.store: SequenceStore | None = None
        self.filter: PairFilter | None = None
        self.times: list[tuple[float, str]] = []
        self.hybrid_stats: dict = {}  # the hybrid backend's last run

    def _log(self, msg: str, level: int = 1) -> None:
        if self.params.verbosity_level >= level:
            print(msg, file=sys.stderr)

    def _mark(self, label: str) -> None:
        self.times.append((time.perf_counter(), label))

    def run_all2all(self) -> bool:
        p = self.params
        p.adjust_threads()
        self._mark("")

        self._log("Loading sequences")
        self.store = load_store(p)
        self._mark("Loading sequences")

        if p.filter_file_name:
            self._log("Loading filter data")
            self.filter = PairFilter.load(p.filter_file_name, p.filter_thr)
            self._log(f"Filter size: {self.filter.total}")
        self._mark("Loading filter")

        if self.filter is not None:
            if self.filter.names != self.store.names:
                print("Input sequences and filter sequences are different!",
                      file=sys.stderr)
                return False
        self._mark("Comparing sequence and filter compatibility")

        self._log("Reordering sequences")
        remap = self.store.reorder()
        if self.filter is not None:
            self.filter.reorder(remap)
        self._mark("Reordering sequences")

        self._log("All2all sparse")
        triples, csr, region_path = self._do_matching()
        self._mark("LZ matching")

        self._log("Storing results")
        ok = self._store_results(triples, csr, region_path)
        self._mark("Storing results")

        if p.verbosity_level >= 2:
            self._show_timings()
        return ok

    # ------------------------------------------------------------------
    def _make_progress_cb(self):
        """Sequences%+Pairs% progress line for the device backends —
        same two counters the reference prints at -V 2
        (lz_matcher.cpp:187-264): Sequences = reference rows completed,
        Pairs = directed pairs completed."""
        if self.params.verbosity_level < 2:
            return None
        state = {"last": ""}

        def prog_cb(done, total, seqs_done=0, total_seqs=0):
            s = (f"Sequences: {100 * seqs_done // max(total_seqs, 1)}%    "
                 f"Pairs: {100 * done // max(total, 1)}%")
            if s != state["last"]:
                print(s + "       ", end="\r", file=sys.stderr, flush=True)
                state["last"] = s

        return prog_cb

    def _do_matching(self):
        p = self.params
        backend = p.backend
        if backend == "auto":
            # production default: the hybrid scheduler uses every piece
            # of silicon on the host; a run too small to profit never
            # pays any device cost (lazy warm-up), and without an
            # accelerator it degrades to the native pool — so auto is
            # never slower than native beyond the jax import. Falls back
            # outright if jax is unavailable.
            try:
                import jax  # noqa: F401
                backend = "hybrid"
            except ImportError:
                backend = "native"

        region_path = None
        if p.output_alignment_file_name:
            region_path = p.output_alignment_file_name + ".regions.tmp"

        csr = None
        if self.filter is not None:
            csr = self.filter.indptr_ids(len(self.store))

        # ---- multi-host launch (jax.distributed) ------------------------
        # When a coordinator is configured (JAX_COORDINATOR_ADDRESS), every
        # process computes its stride partition of reference rows with the
        # SELECTED backend, the per-pair triples (and alignment region
        # records) are all-gathered over the distributed transport, and
        # process 0 alone writes
        # outputs. Reference rows are longest-first, so the stride
        # balances cost skew (SURVEY §7 L4; the reference is single-host).
        mh_pid, mh_np = 0, 1
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            from .parallel.distributed import init_distributed
            mh_pid, mh_np = init_distributed()
        eng_csr, eng_region = csr, region_path
        mh_slots = mh_total = None
        if mh_np > 1:
            import numpy as np

            from .parallel.distributed import local_filter_csr, \
                partition_refs
            n = len(self.store)
            rows = partition_refs(n, mh_np, mh_pid)
            l_indptr, l_ids, mh_slots = local_filter_csr(rows, n, csr)
            eng_csr = (l_indptr, l_ids)
            mh_total = (n * (n - 1) if csr is None
                        else int(np.asarray(csr[0])[-1]))
            if region_path:
                eng_region = region_path + f".h{mh_pid}"
            self._log(f"multi-host: process {mh_pid}/{mh_np} owns "
                      f"{len(rows)} reference rows ({len(l_ids)} pairs)")

        if backend == "native":
            from .core import native_engine
            prog = None
            mon = None
            if p.verbosity_level >= 2:
                import threading

                import numpy as np

                n = len(self.store)
                total_pairs = ((self.filter.total if self.filter else 0)
                               or n * (n - 1))
                prog = np.zeros(2, dtype=np.int64)
                stop = threading.Event()

                def monitor():
                    last = ""
                    while not stop.is_set():
                        s = (f"Sequences: {100 * prog[0] // max(n, 1)}%    "
                             f"Pairs: {100 * prog[1] // max(total_pairs, 1)}%")
                        if s != last:
                            print(s + "       ", end="\r", file=sys.stderr,
                                  flush=True)
                            last = s
                        stop.wait(0.2)

                mon = threading.Thread(target=monitor, daemon=True)
                mon.start()
            try:
                triples = native_engine.all2all(
                    self.store.codes, p, filter_csr=eng_csr,
                    region_path=eng_region, progress=prog)
            finally:
                if mon is not None:
                    stop.set()
                    mon.join()
        elif backend == "hybrid":
            # native thread pool + device engine stealing rows from one
            # shared queue (every piece of silicon on the host)
            enable_compile_cache()
            # ops.hybrid is jax-free at import time: a run too small to
            # warm the device pays ~zero cost over --backend native
            from .ops.hybrid import all2all_hybrid
            prog_cb = self._make_progress_cb()
            hst = self.hybrid_stats = {}
            triples = all2all_hybrid(self.store.codes, p,
                                     filter_csr=eng_csr,
                                     region_path=eng_region,
                                     progress=prog_cb, stats=hst)
            self._log(f"hybrid: device pairs {hst['device_pairs']}, "
                      f"native pairs {hst['cpu_pairs']}, device warm-up "
                      f"{_warm_verdict(hst)}", level=2)
        elif backend == "jax":
            enable_compile_cache()
            from .ops.engine_jax import all2all_jax
            triples = all2all_jax(self.store.codes, p,
                                  filter_csr=eng_csr,
                                  region_path=eng_region,
                                  progress=self._make_progress_cb())
        else:
            raise ValueError(f"Unknown backend: {backend} (the device "
                             f"engine is 'jax')")

        if mh_np > 1:
            import numpy as np

            from .parallel.distributed import gather_merge
            blob = b""
            if eng_region and os.path.exists(eng_region):
                with open(eng_region, "rb") as fh:
                    blob = fh.read()
                os.remove(eng_region)
            flat, blob_all = gather_merge(mh_slots, triples, mh_total,
                                          blob)
            n = len(self.store)
            # the merge gathers to the output rank only: non-rank-0
            # processes get None (they never materialize the table, so
            # their peak RSS stays flat — the bounded-memory contract)
            triples = (None if flat is None
                       else flat if csr is not None
                       else flat.reshape(n, max(n - 1, 0), 3))
            if region_path and mh_pid == 0:
                with open(region_path, "wb") as fh:
                    fh.write(blob_all)
            self._log(f"multi-host: merged triples from {mh_np} "
                      f"processes")
            self._is_output_rank = mh_pid == 0

        return triples, csr, region_path

    # ------------------------------------------------------------------
    def _store_results(self, triples, csr, region_path) -> bool:
        p = self.params
        store = self.store
        if not getattr(self, "_is_output_rank", True):
            # multi-host: every process holds the merged result, but
            # outputs are written once (process 0). Do NOT touch
            # region_path here — this rank never created it, and on a
            # shared filesystem (the documented same-invocation launch)
            # it is the file rank 0 is about to read.
            self._log("multi-host: outputs written by process 0; "
                      "this process skips the store phase")
            return True

        if p.output_type == "single_txt":
            if csr is None:
                rm = ResultMatrix.from_dense(triples)
            else:
                rm = ResultMatrix.from_csr(len(store), csr[0], csr[1],
                                           triples)
            with open(p.output_file_name, "w", encoding="latin-1") as fh:
                fh.writelines(single_txt_lines(p, store, rm))
        else:
            ids_path = p.output_ids_file_name or derive_ids_path(p.output_file_name)
            with open(ids_path, "w", encoding="latin-1") as fh:
                fh.writelines(ids_file_lines(store, p.max_dist_in_ref))
            # threaded native formatter streams the TSV in ref-id order
            # (the P4 analog; byte-identical to output.results_tsv_lines)
            from .core.native_engine import format_results
            format_results(p.output_file_name, p, store, triples,
                           filter_csr=csr)

        if p.output_alignment_file_name:
            from .core.native_engine import read_region_dump
            from .output import ALN_HEADER
            with open(p.output_alignment_file_name, "w", encoding="latin-1") as fh:
                fh.write(ALN_HEADER)
                fh.writelines(
                    alignment_lines(p, store, read_region_dump(region_path)))
            os.unlink(region_path)

        return True

    def _show_timings(self) -> None:
        print("Timings", file=sys.stderr)
        for i in range(1, len(self.times)):
            dt = self.times[i][0] - self.times[i - 1][0]
            print(f"{self.times[i][1]} : {dt}s", file=sys.stderr)
        total = self.times[-1][0] - self.times[0][0]
        print(f"Total time: {total}s", file=sys.stderr)
