"""Port device string dictionary probe (kpw_tpu_torch.ops.strings), run here
on the CPU: on every case of the JAX package's own tests of
``kpw_tpu.ops.strings``, the port's ``prefix_keys`` and
``device_string_dictionary`` equal the JAX functions and
``core.encodings.dictionary_build`` exactly (the max_k abort included)."""

import numpy as np
import pytest
import torch

from kpw_tpu.core.bytecol import ByteColumn as JaxBytes
from kpw_tpu.core.encodings import dictionary_build
from kpw_tpu.core.schema import PhysicalType
from kpw_tpu.ops import strings as jax_strings
from kpw_tpu_torch.core.bytecol import ByteColumn
from kpw_tpu_torch.ops import strings

torch.set_num_threads(1)


def _cfg1_pool():
    rng = np.random.default_rng(0)
    pool = [b"cat_%03d" % j for j in range(100)]
    return [pool[k] for k in rng.integers(0, 100, 4096)], None


def _zero_padding():
    # b"a" < b"a\x00" < b"a\x00\x00": one zero-padded prefix, three lengths
    return [b"a", b"a\x00", b"a\x00\x00", b"", b"a", b"b"] * 10, None


def _long_shared_prefix():
    # len >= 8 with the same first 7 bytes: one key group, host suffix sort
    return [b"prefix_AAA", b"prefix_BBB", b"prefix_", b"prefix_A",
            b"prefix_AAA", b"prefix_ABC", b"prefixZ"] * 7, None


def _exact7_order():
    # a 7-byte string sorts before every 8+ byte extension of it
    return [b"abcdefg", b"abcdefgh", b"abcdefg!", b"abcdefg"] * 5, None


def _random_lengths():
    rng = np.random.default_rng(3)
    return [bytes(rng.integers(97, 123, rng.integers(0, 14)).astype(np.uint8))
            for _ in range(3000)], None


def _all_empty():
    return [b""] * 20, None


def _max_k_abort():
    return [b"v%06d" % i for i in range(100)], 10


def _max_k_kept():
    return [b"v%06d" % (i % 40) for i in range(100)], 40


def _thirteen_byte_ids():
    # the encodings corpus's uid column: every row takes the tie-break
    rng = np.random.default_rng(9)
    return [b"u%012d" % v for v in rng.integers(0, 10 ** 4, 2000)], None


CASES = {f.__name__[1:]: f for f in (
    _cfg1_pool, _zero_padding, _long_shared_prefix, _exact7_order,
    _random_lengths, _all_empty, _max_k_abort, _max_k_kept, _thirteen_byte_ids)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_string_dictionary_equals_jax_and_oracle(case):
    values, max_k = CASES[case]()
    timings: dict = {}
    got = strings.device_string_dictionary(ByteColumn.from_list(values),
                                           max_k=max_k, timings=timings, device="cpu")
    want = jax_strings.device_string_dictionary(JaxBytes.from_list(values), max_k=max_k)
    oracle_d, oracle_i = dictionary_build(values, PhysicalType.BYTE_ARRAY)
    if max_k is not None and len(oracle_d) > max_k:
        assert got is None and want is None
        return
    d, idx = got
    assert d == want[0] == list(oracle_d)
    assert idx.dtype == np.uint32
    np.testing.assert_array_equal(idx, want[1])
    np.testing.assert_array_equal(idx, oracle_i)
    assert [d[i] for i in idx] == values
    assert set(timings) == {"prefix_ms", "device_ms", "tiebreak_ms",
                            "tiebreak_row_fraction"}
    assert timings["tiebreak_row_fraction"] == round(
        sum(len(v) >= 8 for v in values) / len(values), 4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_keys_equal_jax(case):
    values, _ = CASES[case]()
    keys = strings.prefix_keys(ByteColumn.from_list(values))
    assert keys.dtype == np.uint64
    np.testing.assert_array_equal(keys, jax_strings.prefix_keys(JaxBytes.from_list(values)))


def test_prefix_keys_order_matches_bytes_order():
    rng = np.random.default_rng(5)
    vals = sorted(set(
        bytes(rng.integers(0, 256, rng.integers(0, 7)).astype(np.uint8))
        for _ in range(500)))
    keys = strings.prefix_keys(ByteColumn.from_list(vals))
    assert (keys[1:] > keys[:-1]).all()
    assert [strings._key_to_bytes(int(k)) for k in keys] == vals


def test_empty_column():
    d, idx = strings.device_string_dictionary(ByteColumn.from_list([]), device="cpu")
    assert d == [] and idx.dtype == np.uint32 and len(idx) == 0
