"""ctypes bindings for the native host engine (lzani_core.cpp).

The shared library is compiled on first use (g++ -O3) and cached next to the
source. The native engine is the CPU production backend and the bit-exact
oracle used to validate the JAX device engine.
"""

from __future__ import annotations

import ctypes as ct
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native", "lzani_core.cpp")
_LIB = os.path.join(_HERE, "native", "liblzani_core.so")

_lock = threading.Lock()
_lib = None


class LzaCfg(ct.Structure):
    _fields_ = [(f, ct.c_int32) for f in
                ("mal", "msl", "mrd", "mqd", "reg", "aw", "am", "ar")]


def _build_library() -> None:
    cmd = [
        "g++", "-O3", "-std=c++20", "-shared", "-fPIC", "-march=native",
        "-o", _LIB, _SRC, "-lpthread",
    ]
    subprocess.run(cmd, check=True, capture_output=True)


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            _build_library()
        lib = ct.CDLL(_LIB)

        lib.lza_abi_version.restype = ct.c_int32
        assert lib.lza_abi_version() == 5

        lib.lza_parse_pair.restype = ct.c_int64
        lib.lza_parse_pair.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_parse_factors.restype = ct.c_int64
        lib.lza_parse_factors.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_anchor_table.restype = ct.c_int64
        lib.lza_anchor_table.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64, ct.POINTER(LzaCfg),
            ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_pseudo_finalize.restype = ct.c_int64
        lib.lza_pseudo_finalize.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32), ct.c_int64,
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        lib.lza_expand_pseudo.restype = ct.c_int64
        lib.lza_expand_pseudo.argtypes = [
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(ct.c_uint8), ct.c_int64,
            ct.POINTER(LzaCfg), ct.POINTER(ct.c_int32), ct.c_int64,
            ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        _pairsig = [ct.POINTER(ct.c_uint8), ct.c_int64,
                    ct.POINTER(ct.c_uint8), ct.c_int64, ct.POINTER(LzaCfg)]
        lib.lza_replay_finalize.restype = ct.c_int64
        lib.lza_replay_finalize.argtypes = _pairsig + [
            ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int32),
            ct.POINTER(ct.c_int32), ct.c_int64]
        lib.lza_replay_factors.restype = ct.c_int64
        lib.lza_replay_factors.argtypes = _pairsig + [
            ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int32),
            ct.c_int64]
        lib.lza_parse_event_log.restype = ct.c_int64
        lib.lza_parse_event_log.argtypes = _pairsig + [
            ct.POINTER(ct.c_int32), ct.c_int64]
        lib.lza_all2all.restype = ct.c_int32
        lib.lza_all2all.argtypes = [
            ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
            ct.POINTER(LzaCfg), ct.c_int32, ct.POINTER(ct.c_int32),
            ct.c_char_p, ct.c_int32, ct.c_double, ct.c_double, ct.c_double,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ]
        lib.lza_all2all_packed.restype = ct.c_int32
        lib.lza_all2all_packed.argtypes = [
            ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_int64), ct.c_int64,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
            ct.POINTER(LzaCfg), ct.c_int32, ct.POINTER(ct.c_int32),
            ct.c_char_p, ct.c_int32, ct.c_double, ct.c_double, ct.c_double,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
        ]
        lib.lza_claim_head.restype = ct.c_int64
        lib.lza_claim_head.argtypes = [ct.POINTER(ct.c_int64)]
        lib.lza_claim_tail.restype = ct.c_int64
        lib.lza_claim_tail.argtypes = [
            ct.POINTER(ct.c_int64), ct.c_int64, ct.POINTER(ct.c_int64)]
        lib.lza_format_results.restype = ct.c_int32
        lib.lza_format_results.argtypes = [
            ct.POINTER(ct.c_int32), ct.c_int64, ct.POINTER(ct.c_int64),
            ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64), ct.c_char_p,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.c_int32,
            ct.c_int32, ct.c_int32, ct.c_double, ct.c_double, ct.c_double,
            ct.c_double, ct.c_double, ct.c_int32, ct.c_char_p, ct.c_char_p,
        ]
        lib.lza_parse_kmerdb.restype = ct.c_int64
        lib.lza_parse_kmerdb.argtypes = [
            ct.c_char_p, ct.c_int64, ct.c_double, ct.c_int64, ct.c_int32,
            ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32), ct.c_int64,
        ]
        _lib = lib
        return lib


def make_cfg(params) -> LzaCfg:
    return LzaCfg(
        params.min_anchor_len, params.min_seed_len,
        params.max_dist_in_ref, params.max_dist_in_query,
        params.min_region_len, params.approx_window,
        params.approx_mismatches, params.approx_run_len,
    )


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_uint8))


def parse_pair(ref: np.ndarray, query: np.ndarray, params,
               want_regions: bool = False):
    """Returns ((matches, literals, components), regions[None])."""
    lib = get_lib()
    cfg = make_cfg(params)
    stats = np.zeros(3, dtype=np.int32)
    if not want_regions:
        lib.lza_parse_pair(_u8p(ref), len(ref), _u8p(query), len(query),
                           ct.byref(cfg),
                           stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                           None, 0)
        return tuple(int(x) for x in stats), None
    cap = max(64, len(query) // max(params.min_region_len, 1) + 8)
    regs = np.zeros((cap, 6), dtype=np.int32)
    n = lib.lza_parse_pair(_u8p(ref), len(ref), _u8p(query), len(query),
                           ct.byref(cfg),
                           stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                           regs.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    if n > cap:  # retry with exact capacity
        regs = np.zeros((n, 6), dtype=np.int32)
        lib.lza_parse_pair(_u8p(ref), len(ref), _u8p(query), len(query),
                           ct.byref(cfg),
                           stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                           regs.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    return tuple(int(x) for x in stats), regs[:n]


def region_record(r: int, q: int, regs: np.ndarray, q_len: int,
                  output_filter: dict):
    """One pair's record of the region dump (the layout lza_all2all
    writes: {r, q, n_regions, n x 6 int32}), or None when the pair fails
    the gani/ani/qcov pre-filter (lz_matcher.cpp:115-138)."""
    if output_filter:
        m = int(regs[:, 4].sum()) if len(regs) else 0
        lit = int(regs[:, 5].sum()) if len(regs) else 0
        ani = m / (m + lit) if (m + lit) else 0.0
        if (m / q_len < output_filter.get("gani", 0.0)
                or ani < output_filter.get("ani", 0.0)
                or (m + lit) / q_len < output_filter.get("qcov", 0.0)):
            return None
    return np.concatenate([np.array([r, q, len(regs)], np.int32),
                           np.asarray(regs, np.int32).reshape(-1)])


def parse_factors(ref: np.ndarray, query: np.ndarray, params) -> np.ndarray:
    """Raw factor list {dpos, kind(0=lit,1=close,2=distant), rpos, len}."""
    lib = get_lib()
    cfg = make_cfg(params)
    cap = len(query) + params.max_dist_in_ref + 16
    out = np.zeros((cap, 4), dtype=np.int32)
    n = lib.lza_parse_factors(_u8p(ref), len(ref), _u8p(query), len(query),
                              ct.byref(cfg),
                              out.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    assert n <= cap, "factor buffer overflow"
    return out[:n]


def anchor_table(ref: np.ndarray, params, size: int):
    """The reference's anchor hash table, built by the oracle's own
    insertion code into an int32[size] array (-1 = empty slot). Returns
    (table, probe mask); the live region is mask + 1 <= size entries."""
    lib = get_lib()
    cfg = make_cfg(params)
    ref = np.ascontiguousarray(ref, dtype=np.uint8)
    out = np.full(size, -1, dtype=np.int32)
    n = lib.lza_anchor_table(_u8p(ref), len(ref), ct.byref(cfg),
                             out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                             size)
    if n < 0:
        raise ValueError(f"anchor table needs more than {size} slots")
    return out, n - 1


def pseudo_finalize(ref: np.ndarray, query: np.ndarray, params,
                    pseudo: np.ndarray, want_regions: bool = False):
    """Expand a device pseudo-factor stream and compute stats (+regions).

    pseudo: int32 (n, 4) records {dpos, kind, rpos, len}; kinds 0/1/2 are
    real factors, 3/4 aligned ranges, 5/6 a gap pair (see lzani_core.cpp).
    """
    lib = get_lib()
    cfg = make_cfg(params)
    pseudo = np.ascontiguousarray(pseudo, dtype=np.int32)
    stats = np.zeros(3, dtype=np.int32)
    pf = pseudo.ctypes.data_as(ct.POINTER(ct.c_int32))
    if not want_regions:
        rc = lib.lza_pseudo_finalize(_u8p(ref), len(ref), _u8p(query),
                                     len(query), ct.byref(cfg), pf,
                                     len(pseudo),
                                     stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                     None, 0)
        assert rc >= 0, "malformed pseudo-factor stream"
        return tuple(int(x) for x in stats), None
    cap = max(64, len(query) // max(params.min_region_len, 1) + 8)
    regs = np.zeros((cap, 6), dtype=np.int32)
    n = lib.lza_pseudo_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), pf, len(pseudo),
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                cap)
    assert n >= 0, "malformed pseudo-factor stream"
    if n > cap:
        regs = np.zeros((n, 6), dtype=np.int32)
        lib.lza_pseudo_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), pf, len(pseudo),
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    return tuple(int(x) for x in stats), regs[:n]


def expand_pseudo(ref: np.ndarray, query: np.ndarray, params,
                  pseudo: np.ndarray) -> np.ndarray:
    """Expand a pseudo-factor stream to the real factor list (debug)."""
    lib = get_lib()
    cfg = make_cfg(params)
    pseudo = np.ascontiguousarray(pseudo, dtype=np.int32)
    cap = len(query) + params.max_dist_in_ref + 64
    out = np.zeros((cap, 4), dtype=np.int32)
    n = lib.lza_expand_pseudo(_u8p(ref), len(ref), _u8p(query), len(query),
                              ct.byref(cfg),
                              pseudo.ctypes.data_as(ct.POINTER(ct.c_int32)),
                              len(pseudo),
                              out.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    assert 0 <= n <= cap
    return out[:n]


def parse_event_log(ref: np.ndarray, query: np.ndarray, params) -> np.ndarray:
    """Event log of the native parse: int32 (n, 8) records
    {i_ev, best_pos, best_len, bwd, ext, 0, 0, 0} — the decision stream the
    device kernel must reproduce."""
    lib = get_lib()
    cfg = make_cfg(params)
    cap = len(query) + 16
    out = np.zeros((cap, 8), dtype=np.int32)
    n = lib.lza_parse_event_log(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg),
                                out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                cap)
    assert 0 <= n <= cap
    return out[:n]


def replay_events(ref: np.ndarray, query: np.ndarray, params,
                  events: np.ndarray, want_regions: bool = False):
    """Replay a device event log into (stats, regions). Raises on an
    inconsistent log (bwd/ext cross-checked against reference scans)."""
    lib = get_lib()
    cfg = make_cfg(params)
    events = np.ascontiguousarray(events, dtype=np.int32)
    stats = np.zeros(3, dtype=np.int32)
    evp = events.ctypes.data_as(ct.POINTER(ct.c_int32))
    nev = len(events)
    if not want_regions:
        rc = lib.lza_replay_finalize(_u8p(ref), len(ref), _u8p(query),
                                     len(query), ct.byref(cfg), evp, nev,
                                     stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                     None, 0)
        if rc < 0:
            raise ValueError("inconsistent event log")
        return tuple(int(x) for x in stats), None
    cap = max(64, len(query) // max(params.min_region_len, 1) + 8)
    regs = np.zeros((cap, 6), dtype=np.int32)
    n = lib.lza_replay_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), evp, nev,
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                cap)
    if n < 0:
        raise ValueError("inconsistent event log")
    if n > cap:
        regs = np.zeros((n, 6), dtype=np.int32)
        lib.lza_replay_finalize(_u8p(ref), len(ref), _u8p(query), len(query),
                                ct.byref(cfg), evp, nev,
                                stats.ctypes.data_as(ct.POINTER(ct.c_int32)),
                                regs.ctypes.data_as(ct.POINTER(ct.c_int32)), n)
    return tuple(int(x) for x in stats), regs[:n]


def replay_factors(ref: np.ndarray, query: np.ndarray, params,
                   events: np.ndarray) -> np.ndarray:
    """Replay a device event log to the raw factor list (validation aid)."""
    lib = get_lib()
    cfg = make_cfg(params)
    events = np.ascontiguousarray(events, dtype=np.int32)
    cap = len(query) + params.max_dist_in_ref + 64
    out = np.zeros((cap, 4), dtype=np.int32)
    n = lib.lza_replay_factors(_u8p(ref), len(ref), _u8p(query), len(query),
                               ct.byref(cfg),
                               events.ctypes.data_as(ct.POINTER(ct.c_int32)),
                               len(events),
                               out.ctypes.data_as(ct.POINTER(ct.c_int32)),
                               cap)
    if n < 0:
        raise ValueError("inconsistent event log")
    assert n <= cap
    return out[:n]


def all2all(codes: list[np.ndarray], params, filter_csr=None,
            region_path: str | None = None,
            progress: np.ndarray | None = None,
            ext_counter: np.ndarray | None = None,
            out: np.ndarray | None = None) -> np.ndarray:
    """Run the threaded all-vs-all engine.

    Returns int32 triples: dense mode shape (n, n-1, 3) where row r column c
    holds the parse of query (c if c<r else c+1) against reference r; filter
    mode shape (nnz, 3) aligned to the CSR ids array.

    ext_counter: optional int64[1] two-ended row queue packed as
    {tail:32|head:32} (init n << 32) — workers pop longest-first rows
    from the head while a co-running scheduler (the device side of
    ops/hybrid.py) pops the short cheap rows from the tail. out: optional
    caller buffer to fill (hybrid mode shares one triples array across
    engines).
    """
    lib = get_lib()
    cfg = make_cfg(params)
    n = len(codes)
    from ..io.packing import PackedCodes
    packed = isinstance(codes, PackedCodes)
    if packed:
        # zero-copy: workers unpack per row/query inside lzani_core
        ptrs, slens = codes.ptrs, codes.slens
    else:
        offs = np.zeros(n + 1, dtype=np.int64)
        for i, c in enumerate(codes):
            offs[i + 1] = offs[i] + len(c)
        concat = np.concatenate(codes) if n else np.zeros(0, np.uint8)
        concat = np.ascontiguousarray(concat, dtype=np.uint8)

    if filter_csr is not None:
        indptr, ids = filter_csr
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        if out is None:
            out = np.zeros((len(ids), 3), dtype=np.int32)
        ip = indptr.ctypes.data_as(ct.POINTER(ct.c_int64))
        idp = ids.ctypes.data_as(ct.POINTER(ct.c_int32))
    else:
        if out is None:
            out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
        ip = None
        idp = None

    flt = params.output_filter
    flt_enabled = 1 if flt else 0
    common = (
        ip, idp, ct.byref(cfg), int(params.no_threads),
        out.ctypes.data_as(ct.POINTER(ct.c_int32)),
        region_path.encode() if region_path else None,
        flt_enabled, flt.get("gani", 0.0), flt.get("ani", 0.0),
        flt.get("qcov", 0.0),
        progress.ctypes.data_as(ct.POINTER(ct.c_int64))
        if progress is not None else None,
        ext_counter.ctypes.data_as(ct.POINTER(ct.c_int64))
        if ext_counter is not None else None,
    )
    if packed:
        rc = lib.lza_all2all_packed(
            ptrs.ctypes.data_as(ct.POINTER(ct.c_uint64)),
            slens.ctypes.data_as(ct.POINTER(ct.c_int64)), n, *common)
    else:
        rc = lib.lza_all2all(
            _u8p(concat), offs.ctypes.data_as(ct.POINTER(ct.c_int64)), n,
            *common)
    if rc != 0:
        raise RuntimeError(f"lza_all2all failed with code {rc}")
    return out


def parse_kmerdb_csr(body: bytes, thr: float, n_rows: int,
                     n_threads: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize a kmer-db CSV body (everything after the header line) on
    the native thread pool and return the symmetrized CSR (indptr, ids)."""
    lib = get_lib()
    cap = 2 * body.count(b":") + 2
    indptr = np.zeros(n_rows + 1, np.int64)
    ids = np.zeros(cap, np.int32)
    nt = n_threads or (os.cpu_count() or 1)
    rc = lib.lza_parse_kmerdb(
        body, len(body), float(thr), n_rows, nt,
        indptr.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ids.ctypes.data_as(ct.POINTER(ct.c_int32)), cap)
    if rc < 0:
        raise ValueError(f"Incorrect kmer-db filter file (code {rc})")
    return indptr, ids[:rc].copy()


# Column ids — must match lzfmt::COL_* in lzani_core.cpp.
COLUMN_IDS = {
    "ridx": 0, "qidx": 1, "reference": 2, "query": 3, "qcov": 4, "rcov": 5,
    "gani": 6, "rlen": 7, "qlen": 8, "len_ratio": 9, "ani": 10,
    "num_alns": 11, "nt_mismatch": 12, "nt_match": 13, "tani": 14,
}


def format_results(out_path: str, params, store, triples: np.ndarray,
                   filter_csr=None) -> None:
    """Stream the results TSV via the threaded native formatter — the
    parallel ordered-output analog of the reference's store_results
    (lz_matcher.cpp:371-567). Byte-identical to output.results_tsv_lines
    (pinned by tests/test_native_format.py)."""
    lib = get_lib()
    n = len(store)
    comps = params.output_components
    comp_ids = np.array([COLUMN_IDS[c] for c in comps], np.int32)
    header = ("\t".join(comps) + "\n").encode("latin-1")
    mrd = params.max_dist_in_ref
    slens = getattr(store, "lengths", None)
    if slens is None:
        slens = [len(c) for c in store.codes]
    lens = np.array(
        [sl - (p - 1) * mrd
         for sl, p in zip(slens, store.no_parts)], np.int64)
    name_bytes = [nm.encode("latin-1") for nm in store.names]
    names_blob = b"".join(name_bytes)
    name_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in name_bytes], out=name_offs[1:])

    if filter_csr is not None:
        indptr, ids = filter_csr
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        ids = np.ascontiguousarray(ids, dtype=np.int32)
        ip = indptr.ctypes.data_as(ct.POINTER(ct.c_int64))
        idp = ids.ctypes.data_as(ct.POINTER(ct.c_int32))
    else:
        ip = None
        idp = None
    t = np.ascontiguousarray(triples, dtype=np.int32)

    flt = params.output_filter
    rc = lib.lza_format_results(
        t.ctypes.data_as(ct.POINTER(ct.c_int32)), n, ip, idp,
        lens.ctypes.data_as(ct.POINTER(ct.c_int64)), names_blob,
        name_offs.ctypes.data_as(ct.POINTER(ct.c_int64)),
        comp_ids.ctypes.data_as(ct.POINTER(ct.c_int32)), len(comps),
        1 if params.output_in_percent else 0, 1 if flt else 0,
        flt.get("gani", 0.0), flt.get("ani", 0.0), flt.get("tani", 0.0),
        flt.get("qcov", 0.0), flt.get("rcov", 0.0),
        int(params.no_threads), out_path.encode(), header)
    if rc != 0:
        raise RuntimeError(f"lza_format_results failed with code {rc}")


def read_region_dump(path: str):
    """Parse the binary region dump written by lza_all2all.

    Yields (ref_id, q_id, regions[int32 (k,6)]).
    """
    raw = np.fromfile(path, dtype=np.int32)
    pos = 0
    while pos < len(raw):
        r, q, k = int(raw[pos]), int(raw[pos + 1]), int(raw[pos + 2])
        pos += 3
        yield r, q, raw[pos:pos + 6 * k].reshape(k, 6)
        pos += 6 * k
