"""Port bit-pack (kpw_tpu_torch.ops.bitpack / ops.packing) against the JAX
package on the same numpy inputs.

On the CPU the wrapper runs the plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode, its XLA formulation, and the
``core.encodings.bitpack`` oracle.  Every comparison is exact (bytes and
integers), so no tolerance is involved.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kpw_tpu.core import encodings as enc
from kpw_tpu.ops import packing as jpacking
from kpw_tpu.ops.pallas_bitpack import LANE_TILE, bitpack_pages_pallas
from kpw_tpu_torch.ops import packing
from kpw_tpu_torch.ops.bitpack import (bitpack_pages, bitpack_pages_plain,
                                       pack_pages, pack_pages_plain)

# Small inputs: more intra-op threads would only contend for the CPU
# with the suite's other test workers.
torch.set_num_threads(1)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy values -> the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("width", [1, 2, 3, 5, 7, 8, 11, 13, 16, 20, 24, 31, 32])
def test_bitpack_pages_matches_pallas_and_oracle(width):
    rng = np.random.default_rng(width)
    P, bucket = 3, 512
    pages = rng.integers(0, 1 << min(width, 31), (P, bucket)).astype(np.uint32)
    if width == 32:
        pages |= np.uint32(0x8000_0000)  # top bit set must round-trip
    got = bitpack_pages(_t(pages), width).numpy()
    pallas = np.asarray(bitpack_pages_pallas(jnp.asarray(pages), width, True))
    np.testing.assert_array_equal(got, pallas)
    for p in range(P):
        np.testing.assert_array_equal(
            got[p], np.frombuffer(enc.bitpack(pages[p], width), np.uint8))


def test_bitpack_pages_non_power_of_two_bucket():
    """bucket/8 not a multiple of the TPU kernel's lane tile: every group
    must still be packed."""
    rng = np.random.default_rng(1)
    bucket = 8 * (LANE_TILE + LANE_TILE // 2)
    pages = rng.integers(0, 1 << 4, (2, bucket)).astype(np.uint32)
    got = bitpack_pages(_t(pages), 4).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(bitpack_pages_pallas(jnp.asarray(pages), 4, True)))


def test_bitpack_ignores_bits_above_width():
    pages = np.full((1, 16), 0xFFFF_FFF5, np.uint32)
    got = bitpack_pages(_t(pages), 3).numpy()[0]
    want = np.frombuffer(enc.bitpack(pages[0] & 7, 3), np.uint8)
    np.testing.assert_array_equal(got, want)


def test_bitpack_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        bitpack_pages(torch.zeros((1, 8), dtype=torch.int64), 3)
    with pytest.raises(ValueError):
        bitpack_pages(torch.zeros((1, 12), dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        bitpack_pages(torch.zeros((1, 8), dtype=torch.int32), 33)
    with pytest.raises(ValueError):
        bitpack_pages(torch.zeros((8,), dtype=torch.int32), 3)


def _pack_multi_inputs(runny: bool):
    rng = np.random.default_rng(5)
    C, N, width = 3, 4096, 6
    idx = rng.integers(0, 1 << width, (C, N)).astype(np.uint32)
    if runny:  # long runs: the long-run sum must match too
        idx[1] = np.repeat(rng.integers(0, 1 << width, N // 64), 64)
        idx[2, 100:900] = 7
    cols = np.array([0, 1, 2, 1], np.int32)
    starts = np.array([0, 512, 1024, 0], np.int32)
    counts = np.array([500, 512, 300, 4096], np.int32)
    return idx, cols, starts, counts, width


@pytest.mark.parametrize("pallas", ["0", "interpret"])
@pytest.mark.parametrize("runny", [False, True])
def test_pack_pages_multi_matches_jax(monkeypatch, pallas, runny):
    """Packed bytes and long_sum equal the JAX function's, on its XLA route
    and on its Pallas kernel (interpret mode)."""
    monkeypatch.setenv("KPW_PALLAS", pallas)
    idx, cols, starts, counts, width = _pack_multi_inputs(runny)
    want_packed, want_long = jpacking.pack_pages_multi(
        jnp.asarray(idx), jnp.asarray(cols), jnp.asarray(starts),
        jnp.asarray(counts), 4096, width)
    got_packed, got_long = packing.pack_pages_multi(
        _t(idx), cols, starts, counts, 4096, width)
    np.testing.assert_array_equal(got_packed.numpy(), np.asarray(want_packed))
    np.testing.assert_array_equal(got_long.numpy(), np.asarray(want_long))
    assert got_long.dtype == torch.int32


def _window_cases():
    """(C, ld) index batch with runs of 8..40 equal values, and a page table
    whose windows start unaligned, run past ``ld`` and hold counts of 0, 1,
    7, 9 and others that are not multiples of 8."""
    rng = np.random.default_rng(11)
    C, ld, width_max = 3, 1001, 32
    idx = rng.integers(0, 1 << width_max, (C, ld), dtype=np.uint64).astype(np.uint32)
    pos = 0
    while pos < ld:  # column 1: runs of 1..40 equal values
        n = int(rng.integers(1, 41))
        idx[1, pos:pos + n] = rng.integers(0, 1 << 32, dtype=np.uint64)
        pos += n
    idx[2, 250:290] = 5  # a 40-run straddling the 256-value window edge
    table = np.array([
        [0, 0, 256], [1, 1, 255], [1, 3, 0], [2, 250, 1], [2, 7, 7],
        [1, 517, 9], [2, 249, 100], [0, 900, 256],  # past ld: zeros, valid
        [1, 1000, 13], [2, 1001, 256], [1, 123, 200]], np.int32)
    return idx, table


@pytest.mark.parametrize("pallas", ["0", "interpret"])
@pytest.mark.parametrize("width", [1, 7, 13, 32])
def test_fused_pack_plain_matches_jax(monkeypatch, pallas, width):
    """The fused pack's plain version against the JAX ``pack_pages_multi``
    (its XLA route and its Pallas kernel in interpret mode): unaligned
    starts, windows past ``ld``, counts 0 / 1 / 7 / 9 / ragged."""
    monkeypatch.setenv("KPW_PALLAS", pallas)
    idx, table = _window_cases()
    vals = idx & np.uint32((1 << width) - 1 if width < 32 else 0xFFFF_FFFF)
    want_packed, want_long = jpacking.pack_pages_multi(
        jnp.asarray(vals), jnp.asarray(table[:, 0]), jnp.asarray(table[:, 1]),
        jnp.asarray(table[:, 2]), 256, width)
    got_packed, got_long, _ = pack_pages(_t(vals), torch.from_numpy(table), 256, width)
    np.testing.assert_array_equal(got_packed.numpy(), np.asarray(want_packed))
    np.testing.assert_array_equal(got_long.numpy(), np.asarray(want_long))
    # bits above the width are ignored: the unmasked batch packs the same
    again = pack_pages(_t(idx), torch.from_numpy(table), 256, width)[0]
    np.testing.assert_array_equal(again.numpy(), np.asarray(want_packed))


def test_fused_pack_identity_table_is_bitpack():
    """No page table: page p is row p, start 0, count bucket, exactly the
    plain bit-pack of the rows; no statistics asked, none returned."""
    rng = np.random.default_rng(2)
    pages = _t(rng.integers(0, 1 << 11, (3, 512)).astype(np.uint32))
    packed, long_sum, n_runs = pack_pages(pages, None, 512, 11, stats=False)
    assert long_sum is None and n_runs is None
    assert torch.equal(packed, bitpack_pages_plain(pages, 11))
    assert torch.equal(pack_pages_plain(pages, None, 512, 11)[0], packed)


def test_page_table_is_one_int32_upload():
    table = packing.page_table([2, 0], [5, 0], [7, 256], "cpu")
    assert table.dtype == torch.int32 and table.tolist() == [[2, 5, 7], [0, 0, 256]]
    assert packing.page_table([], [], [], "cpu").shape == (0, 3)
    with pytest.raises(ValueError):
        packing.page_table([0], [-1], [8], "cpu")
    with pytest.raises(ValueError):
        pack_pages(torch.zeros((1, 8), dtype=torch.int32),
                   torch.zeros((1, 2), dtype=torch.int32), 8, 3)


@pytest.mark.parametrize("start,count", [(0, 1000), (37, 256), (3000, 1096)])
def test_pack_page_host_matches_jax(start, count):
    rng = np.random.default_rng(start + count)
    width, bucket = 9, packing.pad_bucket(count)
    idx = rng.integers(0, 1 << width, 4096).astype(np.uint32)
    idx[start:start + 200] = 3  # one long run
    full = np.concatenate([idx, np.zeros(bucket, np.uint32)])
    got = packing.pack_page_host(_t(full), start, count, width, bucket)
    want = jpacking.pack_page_host(jnp.asarray(full), start, count, width, bucket)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_gather_index_slices_matches_jax():
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 1 << 20, (3, 1000)).astype(np.uint32)
    cols = np.array([2, 0, 1], np.int32)
    starts = np.array([990, 0, 400], np.int32)
    got = packing.gather_index_slices(_t(idx), cols, starts, 256)
    want = jpacking.gather_index_slices(jnp.asarray(idx), jnp.asarray(cols),
                                        jnp.asarray(starts), 256)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.asarray(want))


def test_pad_bucket_matches_jax():
    for n in (0, 1, 255, 256, 257, 5000, 65536, 65537):
        assert packing.pad_bucket(n) == jpacking.pad_bucket(n)


def test_plain_bitpack_is_the_cpu_path():
    """On a CPU tensor the wrapper is exactly its plain version."""
    rng = np.random.default_rng(3)
    pages = _t(rng.integers(0, 1 << 13, (4, 256)).astype(np.uint32))
    assert torch.equal(bitpack_pages(pages, 13), bitpack_pages_plain(pages, 13))
