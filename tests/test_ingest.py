"""FASTA ingest, encoding and reorder semantics."""

import numpy as np

from lzani.io.fasta import CODE_N_SEQ, SequenceStore, encode_dna
from lzani.params import Params


def test_encode_dna():
    codes = encode_dna(b"ACGTacgtNnX-")
    assert codes.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 5, 5, 5, 5]


def test_multifasta_names_cut_at_space(tmp_path):
    f = tmp_path / "x.fna"
    f.write_text(">seq one extra\nACGT\nACGT\n>seq_two\nTTTT\n")
    s = SequenceStore()
    s.load_multifasta([str(f)])
    assert s.names == ["seq", "seq_two"]
    assert s.codes[0].tolist() == [0, 1, 2, 3, 0, 1, 2, 3]
    assert s.codes[1].tolist() == [3, 3, 3, 3]


def test_per_file_mode_joins_contigs(tmp_path):
    f = tmp_path / "multi.fna"
    f.write_text(">a\nAC\n>b\nGT\n")
    s = SequenceStore()
    s.load_fasta_per_file([str(f)], sep_len=3)
    assert s.names == ["multi.fna"]
    assert s.codes[0].tolist() == [0, 1, CODE_N_SEQ, CODE_N_SEQ, CODE_N_SEQ, 2, 3]
    assert s.no_parts == [1]  # reference hardcodes no_parts=1 (seq_reservoir.cpp:86)


def test_reorder_longest_first_stable():
    s = SequenceStore()
    s.add("b", np.zeros(10, np.uint8))
    s.add("a", np.zeros(10, np.uint8))
    s.add("c", np.zeros(20, np.uint8))
    remap = s.reorder()
    assert s.names == ["c", "a", "b"]
    # remap[old_id] = new_id
    assert remap.tolist() == [2, 1, 0]


def test_gzip_roundtrip(tmp_path):
    import gzip
    f = tmp_path / "x.fna.gz"
    with gzip.open(f, "wt") as fh:
        fh.write(">g1\nACGT\n")
    s = SequenceStore()
    s.load_multifasta([str(f)])
    assert s.names == ["g1"]
    assert s.codes[0].tolist() == [0, 1, 2, 3]


def test_params_format_grammar():
    p = Params()
    assert p.output_components == [
        "qidx", "ridx", "query", "reference", "tani", "gani", "ani",
        "qcov", "num_alns", "len_ratio"]
    p.parse_output_format("lite,rlen")
    assert p.output_components[-1] == "rlen"
    import pytest
    from lzani.params import ParamError
    with pytest.raises(ParamError):
        p.parse_output_format("bogus")
    with pytest.raises(ParamError):
        p.set_output_filter("len_ratio", 0.5)
    p.set_output_filter("tani", "0.7")
    assert p.output_filter == {"tani": 0.7}


def test_packed_store_native_engine_identical():
    """U3: the packed-arena native path (lza_all2all_packed) must be
    byte-identical to the legacy unpacked path on the same random set."""
    import numpy as np
    from lzani.core import native_engine
    from lzani.io.packing import pack_items

    rng = np.random.RandomState(11)
    base = rng.randint(0, 4, 4000).astype(np.uint8)
    codes = []
    for _ in range(10):
        c = base.copy()
        idx = rng.choice(len(c), 200, replace=False)
        c[idx] = rng.randint(0, 4, 200)
        # sprinkle Ns (code 5) to exercise the 6-symbol alphabet
        c[rng.choice(len(c), 7, replace=False)] = 5
        codes.append(c[: rng.randint(3000, 4000)])
    p = Params()
    p.no_threads = 2
    dense_unpacked = native_engine.all2all(codes, p)
    dense_packed = native_engine.all2all(pack_items(codes), p)
    assert np.array_equal(dense_unpacked, dense_packed)
    # filter-CSR mode through both paths
    indptr = np.array([0, 3] + [3] * 9, np.int64)
    ids = np.array([1, 2, 3], np.int32)
    f_unpacked = native_engine.all2all(codes, p, filter_csr=(indptr, ids))
    f_packed = native_engine.all2all(pack_items(codes), p,
                                     filter_csr=(indptr, ids))
    assert np.array_equal(f_unpacked, f_packed)


def test_packed_codes_view_semantics():
    import numpy as np
    from lzani.io.packing import pack_items

    rng = np.random.RandomState(3)
    codes = [rng.randint(0, 6, int(n)).astype(np.uint8)
             for n in (1, 2, 3, 4, 1000, 0)]
    pc = pack_items(codes)
    assert len(pc) == 6
    for i, c in enumerate(codes):
        assert np.array_equal(pc[i], c)
        assert pc.seq_len(i) == len(c)
    # iteration and slicing
    for got, want in zip(pc, codes):
        assert np.array_equal(got, want)
    sub = pc[2:5]
    assert len(sub) == 3
    assert np.array_equal(sub[1], codes[3])
    # negative index
    assert np.array_equal(pc[-2], codes[4])
