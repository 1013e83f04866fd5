"""Differential test: the threaded native kmer-db tokenizer vs the
pure-Python reference loader. Entry order within a row is not part of the
contract (downstream output sorts stably by id and duplicate ids carry
identical results), so rows are compared as sorted multisets."""

import gzip
import os
import tempfile

import numpy as np
import pytest

from lzani.io.kmerdb_filter import PairFilter


def _write(path: str, text: str, gz: bool) -> None:
    data = text.encode("latin-1")
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def _compare(path: str, thr: float) -> None:
    a = PairFilter.load(path, thr)
    b = PairFilter.load_py(path, thr)
    assert a.names == b.names
    assert a.total == b.total
    assert np.array_equal(a.indptr, b.indptr)
    for i in range(len(a.names)):
        ra = sorted(a.ids[a.indptr[i]:a.indptr[i + 1]].tolist())
        rb = sorted(b.ids[b.indptr[i]:b.indptr[i + 1]].tolist())
        assert ra == rb, f"row {i}"


def _random_file(rng, n, path, gz):
    names = [f"n{k}" for k in range(n)]
    lines = ["kmer-length: 18," + ",".join(names)]
    for r in range(n):
        if rng.rand() < 0.1:
            lines.append(rng.choice(["", "x", "ab"]))  # skipped, no row id
        toks = [names[r]]
        for _ in range(rng.randint(0, 8)):
            other = rng.randint(1, n + 1)
            val = round(rng.rand(), 3)
            toks.append(f"{other}:{val}")
        if rng.rand() < 0.2:
            toks.append("")  # trailing comma
        if rng.rand() < 0.15:
            toks.insert(1, "weird:token:extra")  # two colons -> skipped
        lines.append(",".join(toks))
    _write(path, "\n".join(lines) + ("\n" if rng.rand() < 0.7 else ""), gz)


def test_native_kmerdb_random_files():
    rng = np.random.RandomState(17)
    for trial in range(12):
        n = int(rng.randint(3, 25))
        gz = bool(rng.rand() < 0.3)
        thr = float(rng.choice([0.0, 0.2, 0.5, 0.9]))
        fd, path = tempfile.mkstemp(suffix=".gz" if gz else ".txt")
        os.close(fd)
        try:
            _random_file(rng, n, path, gz)
            _compare(path, thr)
        finally:
            os.unlink(path)


def test_native_kmerdb_reorder_roundtrip():
    rng = np.random.RandomState(23)
    fd, path = tempfile.mkstemp(suffix=".txt")
    os.close(fd)
    try:
        _random_file(rng, 12, path, gz=False)
        a = PairFilter.load(path, 0.3)
        b = PairFilter.load_py(path, 0.3)
        remap = np.array(rng.permutation(12), np.int64)
        a.reorder(remap)
        b.reorder(remap)
        assert np.array_equal(a.indptr, b.indptr)
        for i in range(12):
            assert (sorted(a.ids[a.indptr[i]:a.indptr[i + 1]].tolist())
                    == sorted(b.ids[b.indptr[i]:b.indptr[i + 1]].tolist()))
    finally:
        os.unlink(path)


def test_native_kmerdb_bad_header():
    fd, path = tempfile.mkstemp(suffix=".txt")
    os.close(fd)
    try:
        _write(path, "only,two\n", gz=False)
        with pytest.raises(ValueError):
            PairFilter.load(path, 0.0)
    finally:
        os.unlink(path)


def test_native_kmerdb_scale():
    """A moderately large synthetic filter parses quickly and correctly."""
    rng = np.random.RandomState(5)
    n = 2000
    names = [f"g{k}" for k in range(n)]
    lines = ["h," + ",".join(names)]
    for r in range(n):
        toks = [names[r]]
        for other in rng.randint(1, n + 1, 40):
            toks.append(f"{other}:{rng.rand():.3f}")
        lines.append(",".join(toks))
    fd, path = tempfile.mkstemp(suffix=".txt")
    os.close(fd)
    try:
        _write(path, "\n".join(lines) + "\n", gz=False)
        flt = PairFilter.load(path, 0.5)
        ref = PairFilter.load_py(path, 0.5)
        assert flt.total == ref.total
        assert np.array_equal(flt.indptr, ref.indptr)
    finally:
        os.unlink(path)
