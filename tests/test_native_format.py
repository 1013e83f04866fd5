"""Differential test: the threaded native TSV formatter
(lza_format_results) must be byte-identical to the pure-Python reference
implementation (output.results_tsv_lines) across random result matrices,
column orders, filters, and percent mode."""

import os
import tempfile

import numpy as np

from lzani.core import native_engine as ne
from lzani.output import ResultMatrix, results_tsv_lines
from lzani.params import Params


class FakeStore:
    def __init__(self, names, lens, parts=None):
        self.names = names
        self.codes = [np.zeros(int(l), np.uint8) for l in lens]
        self.no_parts = parts or [1] * len(names)

    def __len__(self):
        return len(self.names)


def _run_native(p, store, triples, csr=None) -> bytes:
    fd, path = tempfile.mkstemp(suffix=".tsv")
    os.close(fd)
    try:
        ne.format_results(path, p, store, triples, filter_csr=csr)
        with open(path, "rb") as fh:
            return fh.read()
    finally:
        os.unlink(path)


def _python_bytes(p, store, rm) -> bytes:
    return "".join(results_tsv_lines(p, store, rm)).encode("latin-1")


def _rand_params(rng):
    p = Params()
    p.no_threads = int(rng.randint(1, 5))
    mode = rng.randint(4)
    if mode == 1:
        p.parse_output_format("complete")
    elif mode == 2:
        p.parse_output_format("lite")
    elif mode == 3:
        p.parse_output_format("qidx,ridx,tani,len_ratio,ani,query,nt_match")
    if rng.rand() < 0.4:
        p.output_in_percent = True
    if rng.rand() < 0.5:
        for col in rng.choice(["gani", "ani", "tani", "qcov", "rcov"],
                              rng.randint(1, 3), replace=False):
            p.set_output_filter(col, f"{rng.rand() * 0.9:.3f}")
    return p


def test_dense_formatter_matches_python():
    rng = np.random.RandomState(7)
    for trial in range(8):
        n = int(rng.randint(2, 10))
        lens = rng.randint(500, 60000, n)
        parts = [int(x) for x in rng.randint(1, 4, n)]
        names = [f"seq_{k}|trial{trial}" for k in range(n)]
        store = FakeStore(names, lens, parts)
        p = _rand_params(rng)
        mrd = p.max_dist_in_ref
        # corrected lens must stay positive
        lens = np.maximum(lens, 3 * mrd * np.array(parts))
        store.codes = [np.zeros(int(l), np.uint8) for l in lens]
        triples = np.zeros((n, n - 1, 3), np.int32)
        triples[:, :, 0] = rng.randint(0, 40000, (n, n - 1))
        triples[:, :, 1] = rng.randint(0, 8000, (n, n - 1))
        triples[:, :, 2] = rng.randint(0, 50, (n, n - 1))
        # sprinkle zero rows (ani denominator-0 path)
        z = rng.rand(n, n - 1) < 0.15
        triples[z] = 0

        rm = ResultMatrix.from_dense(triples)
        assert _run_native(p, store, triples) == _python_bytes(p, store, rm)


def test_csr_formatter_matches_python():
    rng = np.random.RandomState(11)
    for trial in range(8):
        n = int(rng.randint(3, 12))
        lens = rng.randint(1000, 40000, n)
        names = [f"g{k}" for k in range(n)]
        store = FakeStore(names, lens)
        p = _rand_params(rng)

        rows = [[] for _ in range(n)]
        for r in range(n):
            for q in range(r + 1, n):
                if rng.rand() < 0.6:
                    rows[r].append(q)
                    rows[q].append(r)
                    if rng.rand() < 0.2:  # duplicate entries survive
                        rows[r].append(q)
                        rows[q].append(r)
        for row in rows:
            rng.shuffle(row)
        indptr = np.zeros(n + 1, np.int64)
        ids = []
        for r in range(n):
            ids.extend(rows[r])
            indptr[r + 1] = len(ids)
        ids = np.array(ids, np.int32)
        E = len(ids)
        triples = np.zeros((E, 3), np.int32)
        if E:
            triples[:, 0] = rng.randint(0, 30000, E)
            triples[:, 1] = rng.randint(0, 6000, E)
            triples[:, 2] = rng.randint(0, 30, E)

        rm = ResultMatrix.from_csr(n, indptr, ids, triples)
        got = _run_native(p, store, triples, csr=(indptr, ids))
        assert got == _python_bytes(p, store, rm)


def test_formatter_extreme_values():
    """Tiny/huge ratios exercise the scientific and 0.000x layouts."""
    p = Params()
    p.parse_output_format("complete")
    n = 4
    lens = [10**9, 10**6, 1234, 777]
    store = FakeStore([f"x{k}" for k in range(n)], lens)
    triples = np.zeros((n, n - 1, 3), np.int32)
    triples[:, :, 0] = [[1, 2, 3], [2**31 - 1, 5, 0],
                        [7, 0, 1], [1, 1, 1]]
    triples[:, :, 1] = [[0, 1, 0], [3, 0, 2**30], [0, 0, 0], [9, 9, 9]]
    triples[:, :, 2] = 1
    rm = ResultMatrix.from_dense(triples)
    assert _run_native(p, store, triples) == _python_bytes(p, store, rm)
