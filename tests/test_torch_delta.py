"""Port DELTA_BINARY_PACKED (kpw_tpu_torch.ops.delta), run here on the CPU
with the kernel's plain version: the device phase equal to the JAX
package's ``delta_pages_multi`` / ``delta_blocks_device`` output for
output, and every stream equal to the JAX package's device functions and
the ``core.encodings`` oracle, byte for byte, on the cases of the JAX
package's delta tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpw_tpu.core import encodings as enc
from kpw_tpu.core.bytecol import ByteColumn
from kpw_tpu.ops import delta as JD
from kpw_tpu_torch.core.bytecol import ByteColumn as PortBytes
from kpw_tpu_torch.ops import delta as TD

torch.set_num_threads(1)


def _signed_mins(mh, ml, bit_size):
    """The JAX package's (hi, lo) block minima as signed ints."""
    u = (np.asarray(mh).astype(np.uint64) << np.uint64(32)) | np.asarray(ml).astype(np.uint64)
    if bit_size == 32:
        return np.asarray(ml).astype(np.uint32).view(np.int32).astype(np.int64)
    return u.view(np.int64)


EDGES = [
    np.array([], np.int64),
    np.array([7], np.int64),
    np.array([0, (1 << 63) - 1, -(1 << 63), 17], np.int64),  # ring wraparound
    np.full(300, -5, np.int64),  # zero deltas
    np.arange(129, dtype=np.int64),  # one block + 1
]


@pytest.mark.parametrize("case", range(len(EDGES)))
def test_delta64_edges_equal_jax_and_oracle(case):
    v = EDGES[case]
    want = enc.delta_binary_packed_encode(v, 64)
    assert TD.delta_binary_packed_device(v, 64, "cpu") == want
    assert JD.delta_binary_packed_device(v, 64) == want


def test_delta64_random_counts():
    rng = np.random.default_rng(0)
    for n in (2, 127, 128, 129, 1000):
        v = rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64)
        assert TD.delta_binary_packed_device(v, 64, "cpu") == \
            enc.delta_binary_packed_encode(v, 64)


@pytest.mark.parametrize("range_bits,bit_size", [
    (5, 64), (12, 64), (20, 64), (28, 64), (40, 64), (60, 64),
    (5, 32), (12, 32), (20, 32), (28, 32)])
def test_every_width_bucket_equals_jax(range_bits, bit_size):
    """One case per width bucket: the blocks' device outputs equal the
    JAX package's, and the stream equals the oracle's."""
    rng = np.random.default_rng(range_bits * 64 + bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    v = (rng.integers(0, 1 << range_bits, 700) - (1 << (range_bits - 1))).astype(itype)
    span = int(v.max()) - int(v.min())
    max_bits = TD.delta_bits_bucket(span, bit_size)
    assert max_bits == JD.delta_bits_bucket(span, bit_size)
    assert max_bits == next(b for b in (8, 16, 24, 32, 48, 64)
                            if range_bits + 1 <= b <= bit_size)
    blocks = 8
    padded = np.zeros(1 + blocks * 128, itype)
    padded[: len(v)] = v
    hi, lo = JD._split64(padded)
    mh, ml, jw, jp = JD.delta_blocks_device(jnp.asarray(hi), jnp.asarray(lo),
                                            jnp.int32(len(v)), bit_size, max_bits)
    mins, widths, packed = TD.delta_blocks_device(torch.from_numpy(padded), len(v),
                                                  bit_size, max_bits)
    np.testing.assert_array_equal(mins.numpy(), _signed_mins(mh, ml, bit_size))
    np.testing.assert_array_equal(widths.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    assert TD.delta_binary_packed_device(v, bit_size, "cpu") == \
        enc.delta_binary_packed_encode(v, bit_size)


def test_delta32_wraps_at_32_bits():
    rng = np.random.default_rng(1)
    for v in (rng.integers(-(1 << 30), 1 << 30, 777).astype(np.int32),
              np.array([0, (1 << 31) - 1, -(1 << 31)], np.int32),
              np.cumsum(rng.integers(0, 9, 400)).astype(np.int32)):
        assert TD.delta_binary_packed_device(v, 32, "cpu") == \
            enc.delta_binary_packed_encode(v, 32) == JD.delta_binary_packed_device(v, 32)


def test_delta_length_byte_array_equals_jax():
    rng = np.random.default_rng(2)
    vals = [f"{v:024x}".encode()[: 3 + v % 20] for v in rng.integers(0, 1 << 60, 600)]
    want = enc.delta_length_byte_array_encode(vals)
    assert TD.delta_length_byte_array_device(vals, "cpu") == want
    assert TD.delta_length_byte_array_device(PortBytes.from_list(vals), "cpu") == want
    assert JD.delta_length_byte_array_device(ByteColumn.from_list(vals)) == want


@pytest.mark.parametrize("bit_size", [32, 64])
def test_delta_pages_multi_equals_jax(bit_size):
    """Stacked streams, one launch for every page of a (bucket, ring) group:
    ragged counts, unaligned starts, a window past its stream's end and
    pad blocks, output for output equal to the JAX function; each page
    assembled equals the oracle's stream of its window."""
    rng = np.random.default_rng(bit_size)
    itype = np.int64 if bit_size == 64 else np.int32
    info = np.iinfo(itype)
    streams = np.stack([
        np.resize(np.array([0, info.max, info.min, 17, -1], itype), 900),
        np.cumsum(rng.integers(0, 9, 900)).astype(itype),
        rng.integers(info.min, info.max, 900, dtype=itype, endpoint=True)])
    rows, starts, counts = [0, 1, 2, 1, 0, 2], [0, 3, 100, 0, 850, 7], [2, 127, 129, 900, 50, 512]
    bucket, max_bits = 1024, bit_size
    if bit_size == 64:
        u = streams.view(np.uint64)
        hi, lo = (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)
    else:
        hi, lo = np.zeros(streams.shape, np.uint32), streams.view(np.uint32)
    ids = [jnp.asarray(np.array(x, np.int32)) for x in (rows, starts, counts)]
    mh, ml, jw, jp = JD.delta_pages_multi(jnp.asarray(hi), jnp.asarray(lo), *ids,
                                          bucket, bit_size, max_bits)
    mins, widths, packed = TD.delta_pages_multi(torch.from_numpy(streams), rows, starts,
                                                counts, bucket, bit_size, max_bits)
    np.testing.assert_array_equal(mins.numpy(), _signed_mins(mh, ml, bit_size))
    np.testing.assert_array_equal(widths.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
    for p, (r, s, c) in enumerate(zip(rows, starts, counts)):
        window = np.zeros(c, itype)  # reads past the stream give 0
        part = streams[r, s:s + c]
        window[: len(part)] = part
        got = TD.assemble_delta_page(int(window[0]), c, mins.numpy()[p],
                                     widths.numpy()[p], packed.numpy()[p], bit_size,
                                     max_bits=max_bits)
        assert got == enc.delta_binary_packed_encode(window, bit_size)
        assert got == JD.assemble_delta_page(int(window[0]), c, np.asarray(mh)[p],
                                             np.asarray(ml)[p], np.asarray(jw)[p],
                                             np.asarray(jp)[p], bit_size, max_bits)


def test_width_budget_violation_is_loud():
    """A miniblock wider than the budget had its slot cut on the device:
    the host refuses the page instead of writing a short stream."""
    v = np.array([0, 1 << 40, 0, 5], np.int64)
    mins, widths, packed = TD.delta_blocks_device(torch.from_numpy(v), 4, 64, 16)
    assert int(widths[0].max()) > 16
    with pytest.raises(ValueError, match="exceeds the device pack's budget"):
        TD.assemble_delta_page(0, 4, mins.numpy()[:1], widths.numpy()[:1],
                               packed.numpy()[:1], 64, max_bits=16)


def test_wrapper_refuses_bad_inputs():
    s = torch.zeros((1, 300), dtype=torch.int64)
    table = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="64-bit ring"):
        TD.delta_pages(s.to(torch.int32), table, 256, 64, 8)
    with pytest.raises(ValueError, match="multiple of 128"):
        TD.delta_pages(s, table, 200, 64, 8)
    with pytest.raises(ValueError, match="max_bits"):
        TD.delta_pages(s.to(torch.int32), table, 256, 32, 48)
    with pytest.raises(ValueError, match="page table"):
        TD.delta_pages(s, table.to(torch.int64), 256, 64, 8)
