"""Port flagship step (kpw_tpu_torch.parallel.sharded.encode_step_single)
against the JAX function on the same numpy inputs: packed bytes, the
unique counts k and the dictionary prefix ulo[:k] must be equal, and the
port's ulo padded with 0xFFFFFFFF after it.  The JAX side runs its Pallas
kernels in interpret mode (KPW_PALLAS=interpret), so its bounded cases
take the histogram + rank kernels as the port does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import __graft_entry__
from kpw_tpu.parallel import sharded as J
from kpw_tpu_torch.entry import entry
from kpw_tpu_torch.parallel import sharded as T

# Small inputs: more intra-op threads would only contend for the CPU
# with the suite's other test workers.
torch.set_num_threads(1)


def _compare(got, want):
    gp, gu, gk = got
    wp, wu, wk = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(gk.numpy(), wk)
    np.testing.assert_array_equal(gp.numpy(), wp)
    assert tuple(gu.shape) == wu.shape
    for c in range(len(wk)):
        np.testing.assert_array_equal(gu.numpy()[c, :wk[c]].astype(np.uint32),
                                      wu[c, :wk[c]])
        # the JAX pad is unspecified; the port's is 0xFFFFFFFF on both routes
        assert (gu.numpy()[c, wk[c]:] == 0xFFFF_FFFF).all()


@pytest.mark.parametrize("vb,n,c,count_off", [
    (1 << 13, 1 << 13, 2, 0),     # nhi bucket 128, full count
    (1 << 13, 1 << 13, 2, 37),    # ragged valid prefix
    (5001, 4096, 3, 0),           # non-power-of-two bound
    (266, 1024, 2, 1023),         # zone-range bound -> nhi 8, count 1
    (8, 512, 2, 0),               # id-range bound, k=8
    (None, 4096, 3, 5),           # sort route, full 32-bit values
    (1 << 16, 4096, 2, 100),      # sort route: bound above 2^13
])
def test_encode_step_single_matches_jax(monkeypatch, vb, n, c, count_off):
    monkeypatch.setenv("KPW_PALLAS", "interpret")
    rng = np.random.default_rng((vb or 3) * 7 + n)
    lo = rng.integers(0, vb or (1 << 32), (c, n), dtype=np.uint64).astype(np.uint32)
    if vb is None:
        lo[:, 1] = 0xFFFF_FFFF  # a valid value on the pad sentinel's pattern
    count = n - count_off
    want = J.encode_step_single(jnp.asarray(lo), jnp.int32(count), width=16,
                                value_bound=vb)
    got = T.encode_step_single(torch.from_numpy(lo.view(np.int32)), count,
                               width=16, value_bound=vb)
    _compare(got, want)


def test_encode_step_single_count_zero(monkeypatch):
    monkeypatch.setenv("KPW_PALLAS", "interpret")
    lo = np.arange(256, dtype=np.uint32)[None, :] % 100
    want = J.encode_step_single(jnp.asarray(lo), jnp.int32(0), width=16,
                                value_bound=100)
    got = T.encode_step_single(torch.from_numpy(lo.view(np.int32)), 0,
                               width=16, value_bound=100)
    assert int(got[2][0]) == 0 and not got[0].any()
    _compare(got, want)


@pytest.mark.parametrize("vb", [None, 270, 1 << 13])
@pytest.mark.parametrize("count_kind", ["int", "tensor"])
def test_int64_ragged_count_matches_jax(monkeypatch, vb, count_kind):
    """Both routes on int64 input (unsigned 32-bit values) with a ragged
    valid count, as an int and as a 0-d tensor, against the JAX function:
    the fused kernels take the unmasked values and zero the tail."""
    monkeypatch.setenv("KPW_PALLAS", "interpret")
    rng = np.random.default_rng(29)
    n, c, count = 1024, 3, 1000 - 7
    lo = rng.integers(0, vb or (1 << 32), (c, n), dtype=np.uint64).astype(np.uint32)
    lo[:, count:] = rng.integers(0, 1 << 32, (c, n - count), dtype=np.uint64)
    want = J.encode_step_single(jnp.asarray(lo), jnp.int32(count), width=16,
                                value_bound=vb)
    cnt = count if count_kind == "int" else torch.tensor(count, dtype=torch.int32)
    got = T.encode_step_single(torch.from_numpy(lo.astype(np.int64)), cnt,
                               width=16, value_bound=vb)
    _compare(got, want)


@pytest.mark.parametrize("vb", [270, None])
def test_routes_agree_with_each_other(vb):
    """Bounded and sort routes give the same output on the same input."""
    rng = np.random.default_rng(17)
    lo = torch.from_numpy(rng.integers(0, 270, (3, 1024)).astype(np.int32))
    a = T.encode_step_single(lo, 1000, width=16, value_bound=vb)
    b = T.encode_step_single(lo, 1000, width=16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_int64_input_is_read_as_unsigned_32_bit():
    vals = np.array([[0xFFFF_FFFF, 5, 0x8000_0000, 5] * 2], np.uint32)
    a = T.encode_step_single(torch.from_numpy(vals.astype(np.int64)), 8)
    b = T.encode_step_single(torch.from_numpy(vals.view(np.int32)), 8)
    assert torch.equal(a[0], b[0])
    assert a[1][0, :3].tolist() == [5, 0x8000_0000, 0xFFFF_FFFF]


def test_width_guard_and_buckets():
    for k in (1, 2, 1 << 16, (1 << 16) + 1, 1 << 20, 1 << 32):
        assert T.index_width_bucket(k) == J.index_width_bucket(k)
    with pytest.raises(ValueError):
        T.encode_step_single(torch.zeros((1, 1 << 17), dtype=torch.int32), 1,
                             width=16)


def test_entry_cpu_matches_graft_entry():
    fn, (lo, count) = entry(device="cpu")
    jfn, (jlo, jcount) = __graft_entry__.entry()
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), np.asarray(jlo))
    assert int(count) == int(jcount)
    _compare(fn(lo, count), jfn(jlo, jcount))
