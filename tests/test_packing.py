"""Three-in-byte packing codec (reference seq_reservoir.h:30-186 parity)."""

import numpy as np

from lzani.io.packing import PackedSeq, pack3, unpack3


def test_roundtrip_all_lengths():
    rng = np.random.RandomState(0)
    for n in [0, 1, 2, 3, 4, 7, 300, 1001]:
        codes = rng.randint(0, 6, n).astype(np.uint8)
        assert np.array_equal(unpack3(pack3(codes), n), codes)


def test_packed_accessor_and_size():
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 6, 1000).astype(np.uint8)
    ps = PackedSeq(codes)
    assert len(ps) == 1000
    assert ps.nbytes == (1000 + 2) // 3
    assert np.array_equal(ps.codes(), codes)
    for i in (0, 1, 2, 3, 500, 999):
        assert ps[i] == codes[i]


def test_byte_values_match_reference_radix():
    # c0*36 + c1*6 + c2 (seq_reservoir.cpp:33-56)
    codes = np.array([5, 4, 3, 2, 1, 0], np.uint8)
    packed = pack3(codes)
    assert packed[0] == 5 * 36 + 4 * 6 + 3
    assert packed[1] == 2 * 36 + 1 * 6 + 0
