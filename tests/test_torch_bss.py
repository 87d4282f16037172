"""Port BYTE_STREAM_SPLIT (kpw_tpu_torch.ops.bss), run here on the CPU:
the transpose equal to the JAX package's device function and the
``core.encodings`` oracle, byte for byte, for every fixed-width type."""

import numpy as np
import pytest
import torch

from kpw_tpu.core import encodings as enc
from kpw_tpu.core.schema import PhysicalType
from kpw_tpu.ops.bss import byte_stream_split_device as jax_bss
from kpw_tpu_torch.ops.bss import byte_stream_split_device

torch.set_num_threads(1)


@pytest.mark.parametrize("pt,dtype", [
    (PhysicalType.FLOAT, np.float32), (PhysicalType.DOUBLE, np.float64),
    (PhysicalType.INT32, np.int32), (PhysicalType.INT64, np.int64)])
@pytest.mark.parametrize("n", [0, 1, 7, 1000, 4099])
def test_bss_equals_jax_and_oracle(pt, dtype, n):
    rng = np.random.default_rng(n)
    if np.dtype(dtype).kind == "f":
        values = (100.0 + np.cumsum(rng.standard_normal(n))).astype(dtype)
        values[::97] = np.nan
    else:
        info = np.iinfo(dtype)
        values = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    want = enc.byte_stream_split_encode(values, pt)
    assert byte_stream_split_device(values, "cpu") == want
    assert jax_bss(values) == want


def test_bss_reads_a_strided_view():
    """A non-contiguous slice is transposed from its own values."""
    values = np.arange(4000, dtype=np.float64)[::3]
    assert byte_stream_split_device(values, "cpu") == \
        enc.byte_stream_split_encode(values, PhysicalType.DOUBLE)


def test_bss_entry_point_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        byte_stream_split_device(np.zeros(8, np.float32))
