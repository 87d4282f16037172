"""Port histogram / rank ops (kpw_tpu_torch.ops.rank) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

The JAX histogram returns f32 counts (exact below 2^24); the port returns
exact int32, so the two compare as integers.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kpw_tpu.ops import pallas_rank as J
from kpw_tpu_torch.ops import rank as T

# Small inputs: more intra-op threads would only contend for the CPU
# with the suite's other test workers.
torch.set_num_threads(1)


def _masked_values(nhi: int, C: int, N: int, count: int, seed: int):
    """(C, N) uint32 values below nhi*64, rows past ``count`` set to the
    sentinel nhi*64."""
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, nhi * 64, (C, N)).astype(np.uint32)
    vals[:, count:] = nhi * 64
    return vals


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


@pytest.mark.parametrize("nhi,N,count", [(8, 256, 256), (32, 512, 300),
                                         (128, 2048, 2048), (128, 256, 0)])
def test_hist_matches_pallas(nhi, N, count):
    vals = _masked_values(nhi, 2, N, count, nhi + N)
    want = np.asarray(J.hist_pages_core(jnp.asarray(vals), nhi, interpret=True))
    got = T.hist_pages(_t(vals), nhi)
    assert got.dtype == torch.int32 and got.shape == (2, nhi, 64)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_hist_counts_nothing_at_or_above_the_bound():
    nhi = 8
    vals = np.full((1, 128), 511, np.uint32)
    vals[0, :3] = [512, 513, 0xFFFF_FFFF]
    got = T.hist_pages(_t(vals), nhi).numpy().reshape(-1)
    assert got[511] == 125 and got.sum() == 125


@pytest.mark.parametrize("nhi,N,count", [(8, 256, 200), (32, 512, 512),
                                         (128, 1024, 1000)])
def test_rank_matches_pallas(nhi, N, count):
    vals = _masked_values(nhi, 2, N, count, 3 * nhi + N)
    counts = J.hist_pages_core(jnp.asarray(vals), nhi, interpret=True)
    rt_j, _, _ = J.presence_to_dict(counts, nhi)
    want = np.asarray(J.rank_pages_core(jnp.asarray(vals), rt_j, interpret=True))
    rt = torch.from_numpy(np.asarray(rt_j).astype(np.int32))
    got = T.rank_pages(_t(vals), rt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nhi", [8, 32, 128])
def test_presence_to_dict_matches_jax(nhi):
    rng = np.random.default_rng(nhi)
    counts = rng.integers(0, 3, (3, nhi, 64)).astype(np.int32)
    counts[2] = 0  # an empty column: k = 0
    rt_j, ulo_j, k_j = J.presence_to_dict(jnp.asarray(counts, jnp.float32), nhi)
    rt, ulo, k = T.presence_to_dict(torch.from_numpy(counts), nhi)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rt_j))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_j))
    # the whole dictionary row, pad included (0xFFFFFFFF past k)
    np.testing.assert_array_equal(ulo.numpy().astype(np.uint32), np.asarray(ulo_j))


def _ragged_values(nhi: int, C: int, N: int, seed: int):
    """(C, N) uint32: column 0 uniform below the bound, the others with 1..8
    distinct values, a few values at or above the bound anywhere."""
    rng = np.random.default_rng(seed)
    vb = nhi * 64
    vals = rng.integers(0, vb, (C, N)).astype(np.uint32)
    for c in range(1, C):
        few = rng.choice(vb, size=min(c, 8), replace=False)
        vals[c] = rng.choice(few, N)
    vals[:, 3] = vb
    vals[:, 9] = 0xFFFF_FFFF
    return vals


@pytest.mark.parametrize("nhi,N,count", [(8, 256, 200), (32, 512, 512),
                                         (128, 1024, 1000), (8, 384, 0),
                                         (128, 256, 1)])
def test_hist_dict_plain_matches_jax(nhi, N, count):
    """hist + dictionary over the first ``count`` rows equal the JAX
    ``hist_pages_core`` (interpret mode) on the masked batch followed by
    its ``presence_to_dict``: counts, rt (absent bins included), the whole
    dictionary row with its pad, and k."""
    vals = _ragged_values(nhi, 4, N, nhi + N + count)
    masked = vals.copy()
    masked[:, count:] = nhi * 64
    counts_j = J.hist_pages_core(jnp.asarray(masked), nhi, interpret=True)
    rt_j, ulo_j, k_j = J.presence_to_dict(counts_j, nhi)
    counts, rt, ulo, k = T.hist_dict(_t(vals), count, nhi)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j).astype(np.int64))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rt_j))
    np.testing.assert_array_equal(ulo.numpy().astype(np.uint32), np.asarray(ulo_j))
    np.testing.assert_array_equal(k.numpy(), np.asarray(k_j))
    # a 0-d tensor count gives the same; ulo cut or padded to ulo_cols
    same = T.hist_dict(_t(vals), torch.tensor(count), nhi, ulo_cols=N)
    assert all(torch.equal(a, b) for a, b in zip(same[:2], (counts, rt)))
    lim = min(nhi * 64, N)
    assert torch.equal(same[2][:, :lim], ulo[:, :lim])
    assert (same[2][:, lim:] == 0xFFFF_FFFF).all()


def test_rank_and_hist_plain_are_the_cpu_path():
    vals = _t(_masked_values(32, 3, 384, 300, 11))
    counts = T.hist_pages(vals, 32)
    assert torch.equal(counts, T.hist_pages_plain(vals, 32))
    assert all(torch.equal(a, b) for a, b in zip(
        T.hist_dict(vals, 300, 32), T.hist_dict_plain(vals, 300, 32)))
    rt, _, _ = T.presence_to_dict(counts, 32)
    assert torch.equal(T.rank_pages(vals, rt), T.rank_pages_plain(vals, rt))


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        T.hist_pages(torch.zeros((2, 100), dtype=torch.int32), 8)  # N % 128
    with pytest.raises(ValueError):
        T.hist_pages(torch.zeros((2, 128), dtype=torch.int32), 256)  # nhi
    with pytest.raises(TypeError):
        T.hist_pages(torch.zeros((2, 128), dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        T.rank_pages(torch.zeros((2, 128), dtype=torch.int32),
                     torch.zeros((3, 8, 64), dtype=torch.int32))
