"""Formatter semantics (reference: refresh::real_to_pchar,
numeric_conversions.h:229-300,341-388)."""

from lzani.utils.textnum import format_int, format_real


def test_zero_one_nan_inf():
    assert format_real(0.0, 6) == "0"
    assert format_real(1.0, 6) == "1"
    assert format_real(float("nan"), 6) == "nan"
    assert format_real(float("inf"), 6) == "inf"
    assert format_real(float("-inf"), 6) == "-inf"


def test_six_significant_digits():
    # values measured from the reference golden vir61.ani.tsv
    assert format_real(0.013809632, 6) == "0.0138096"
    assert format_real(0.5654888, 6) == "0.565489"
    assert format_real(0.02306972, 6) == "0.0230697"


def test_round_half_up():
    assert format_real(0.1234565, 6) == "0.123457"  # half rounds up
    assert format_real(0.1234564, 6) == "0.123456"
    # overflow digit carry: rounding zeros are kept (only dragonbox's own
    # trailing-zero removal applies, before rounding)
    assert format_real(0.9999995, 6) == "1.00000"


def test_len_ratio_four_digits():
    assert format_real(0.99082343, 4) == "0.9908"
    assert format_real(1.0, 4) == "1"


def test_scientific_layouts():
    # exponent > 0 -> scientific with trailing-zero removal (dragonbox pair)
    assert format_real(100.0, 6) == "1e+02"
    assert format_real(123.0, 6) == "123"        # exponent 0 -> plain digits
    assert format_real(12300.0, 6) == "1.23e+04"
    # -exp >= ndig+4 -> scientific
    assert format_real(1e-10, 6) == "1e-10"
    assert format_real(1.5e-11, 6) == "1.5e-11"
    # -exp < ndig -> dot insertion
    assert format_real(1.23456789, 6) == "1.23457"
    # ndig <= -exp < ndig+4 -> leading zeros
    assert format_real(0.000123456789, 6) == "0.000123457"


def test_negative():
    assert format_real(-0.5, 6) == "-0.5"


def test_precision_clamp():
    assert format_real(0.123456789123456789, 99) == "0.123456789123457"


def test_int():
    assert format_int(0) == "0"
    assert format_int(42084) == "42084"
