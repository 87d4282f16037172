"""The port's shard mesh (``kpw_tpu_torch/parallel/{mesh,dict_merge,
sharded,mesh_encoder}.py``) against the JAX package's on its virtual
8-device CPU mesh (``tests/conftest.py``), case for case with
``tests/test_parallel.py``: the port runs on 8 CPU shards, and every
dictionary, index, packed byte, overflow, payload counter and file must be
equal to the JAX package's on the same seeded inputs (tolerance zero).
Also: the mesh and its collectives, route selection, the ``"mesh"``
backend through the port's ``Builder``, and stats exact under threads."""

import io
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import kpw_tpu as J
import kpw_tpu.core  # noqa: F401
import kpw_tpu_torch as P
import kpw_tpu_torch.core.pages  # noqa: F401
from kpw_tpu.parallel import dict_merge as jdm
from kpw_tpu.parallel import make_mesh as jmake_mesh
from kpw_tpu.parallel import mesh as jmesh
from kpw_tpu.parallel import sharded as jsh
from kpw_tpu.parallel.mesh_encoder import MeshChunkEncoder as JMesh
from kpw_tpu_torch.core import encodings as enc
from kpw_tpu_torch.parallel import dict_merge as pdm
from kpw_tpu_torch.parallel import mesh as pmesh
from kpw_tpu_torch.parallel import sharded as psh
from kpw_tpu_torch.parallel.mesh_encoder import MeshChunkEncoder as PMesh
from proto_helpers import sample_message_class

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh8():
    return jmake_mesh(8)


@pytest.fixture(scope="module")
def cpu8():
    return pmesh.make_mesh(8, device="cpu")


def same_encode(a, b):
    """Two (dictionary, indices) results equal, dictionaries by bit pattern."""
    assert a[0].dtype == b[0].dtype
    np.testing.assert_array_equal(a[0].view(np.uint8), b[0].view(np.uint8))
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts,shards", [(16, 8), (5, 3), (1, 4)])
def test_partition_assignment(parts, shards):
    a = pmesh.partition_assignment(parts, shards)
    assert a == jmesh.partition_assignment(parts, shards)
    assert sorted(p for shard in a for p in shard) == list(range(parts))


def test_make_mesh_devices_and_the_card_rule(monkeypatch):
    assert pmesh.make_mesh(8, device="cpu").devices == (torch.device("cpu"),) * 8
    assert pmesh.make_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="at least one shard"):
        pmesh.make_mesh(0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (None, 8):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pmesh.make_mesh(n)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PMesh(P.core.WriterProperties().encoder_options())


def test_collectives_on_cpu_shards(cpu8):
    parts = [torch.arange(3) + 10 * s for s in range(8)]
    assert torch.equal(pmesh.all_gather(cpu8, parts), torch.cat(parts))
    assert torch.equal(pmesh.psum(cpu8, parts), sum(parts))
    assert torch.equal(pmesh.pmax(cpu8, parts), parts[-1])
    with pytest.raises(ValueError, match="local shards"):
        pmesh.psum(cpu8, parts[:3])


# ---------------------------------------------------------------------------
# dict_merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
@pytest.mark.parametrize("two_phase", [True, False])
def test_global_dictionary_roundtrip(mesh8, cpu8, dtype, two_phase):
    """The port's merge (two-phase, its only form) against the JAX
    package's, run two-phase and one-phase: the same dictionary and
    indices either way, and the same payload counters as the JAX
    two-phase merge."""
    rng = np.random.default_rng(0)
    if np.issubdtype(dtype, np.floating):
        values = rng.choice(rng.normal(size=100), 10000).astype(dtype)
    else:
        values = rng.integers(0, 500, 10000).astype(dtype)
    js, ps = {}, {}
    got = pdm.global_dictionary_encode(values, cpu8, cap=2048, stats_out=ps)
    same_encode(got, jdm.global_dictionary_encode(values, mesh8, cap=2048,
                                                  two_phase=two_phase, stats_out=js))
    if two_phase:
        assert ps == js
    assert ps["columns"] == 1
    d, idx = got
    np.testing.assert_array_equal(d[idx], values)
    keys = d.view(np.uint32 if d.dtype.itemsize == 4 else np.uint64)
    assert (np.diff(keys.astype(np.uint64)) > 0).all()


def test_global_dictionary_negative_values_in_bit_pattern_order(mesh8, cpu8):
    """Negative int64 sort ABOVE the positives by bit pattern, as every
    single-device builder orders its dictionary."""
    rng = np.random.default_rng(1)
    values = rng.integers(-300, 300, 5000).astype(np.int64)
    got = pdm.global_dictionary_encode(values, cpu8, cap=2048)
    same_encode(got, jdm.global_dictionary_encode(values, mesh8, cap=2048))
    d = got[0]
    assert set(d.tolist()) == set(np.unique(values).tolist())
    assert d[0] == 0 and d[-1] == -1


@pytest.mark.parametrize("two_phase", [True, False])
def test_global_dictionary_overflow_raises(mesh8, cpu8, two_phase):
    """The port raises on exactly the inputs where the JAX package raises,
    with its two-phase and its one-phase merge."""
    values = np.arange(8 * 1024, dtype=np.int64)  # 1024 uniques per shard
    with pytest.raises(pdm.DictionaryOverflow, match="cap"):
        pdm.global_dictionary_encode(values, cpu8, cap=256)
    with pytest.raises(jdm.DictionaryOverflow, match="cap"):
        jdm.global_dictionary_encode(values, mesh8, cap=256, two_phase=two_phase)
    # exactly the cap of uniques on every shard: no overflow on either
    values = np.tile(np.arange(256, dtype=np.int64), 8)
    same_encode(pdm.global_dictionary_encode(values, cpu8, cap=256),
                jdm.global_dictionary_encode(values, mesh8, cap=256, two_phase=two_phase))


def test_two_phase_merge_identity_and_bounded_payload(mesh8, cpu8):
    rng = np.random.default_rng(41)
    n = 8 * 8192
    for dtype in (np.int64, np.int32):
        values = rng.integers(0, 300, n).astype(dtype)
        js, ps = {}, {}
        two = pdm.global_dictionary_encode(values, cpu8, cap=None, stats_out=ps)
        same_encode(two, jdm.global_dictionary_encode(values, mesh8, cap=None,
                                                      two_phase=False))
        same_encode(two, jdm.global_dictionary_encode(values, mesh8, cap=None,
                                                      two_phase=True, stats_out=js))
        assert ps == js and ps["gather_cap"] == 512


def test_two_phase_merge_overflow_and_skewed_shards(mesh8, cpu8):
    rng = np.random.default_rng(43)
    values = rng.integers(0, 100_000, 8 * 1024).astype(np.int64)
    with pytest.raises(pdm.DictionaryOverflow):
        pdm.global_dictionary_encode(values, cpu8, cap=256)
    skew = np.concatenate([np.arange(7000), rng.integers(0, 8, 8 * 1024 - 7000)])
    skew = skew.astype(np.int64)
    two = pdm.global_dictionary_encode(skew, cpu8, cap=None)
    same_encode(two, jdm.global_dictionary_encode(skew, mesh8, cap=None, two_phase=False))
    same_encode(two, jdm.global_dictionary_encode(skew, mesh8, cap=None, two_phase=True))


def test_rank_methods_agree():
    """The port's compaction and binary-search rank give the indices of
    both JAX rank methods ('search' and 'sortrank'), including max-key
    values colliding with the lifted pads and invalid value slots."""
    rng = np.random.default_rng(77)
    n, cap = 4096, 2048
    for has_hi in (False, True):
        lo = rng.integers(0, 500, n).astype(np.uint32)
        lo[::911] = 0xFFFFFFFF
        hi = (rng.integers(0, 3, n) if has_hi else np.zeros(n)).astype(np.uint32)
        if has_hi:
            hi[::911] = 0xFFFFFFFF
        valid = rng.random(n) > 0.1
        th, tl, tv = (torch.from_numpy(hi.astype(np.int64)),
                      torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(valid))
        uh, ul, uv, k = pdm._local_unique(th, tl, tv, cap, has_hi=has_hi)
        got = pdm._rank_against_dict(uh, ul, uv, th, tl, k=k, has_hi=has_hi)
        for method in ("search", "sortrank"):
            juh, jul, juv, jk = jdm._local_unique(jnp.asarray(hi), jnp.asarray(lo),
                                                  jnp.asarray(valid), cap, has_hi=has_hi,
                                                  method=method)
            assert int(k) == int(jk)
            np.testing.assert_array_equal(ul[:int(k)].numpy(), np.asarray(jul)[:int(jk)])
            np.testing.assert_array_equal(uh[:int(k)].numpy(), np.asarray(juh)[:int(jk)])
            want = np.asarray(jdm._rank_against_dict(juh, jul, juv, jnp.asarray(hi),
                                                     jnp.asarray(lo), jnp.asarray(valid),
                                                     k=jk, has_hi=has_hi,
                                                     method=method))[valid]
            np.testing.assert_array_equal(got.numpy()[valid], want)
    # fewer rows than the cap: the compaction pads the tail with the max key
    small = torch.from_numpy(lo[:1024].astype(np.int64))
    _, sl, _, sk = pdm._local_unique(torch.zeros_like(small), small,
                                     torch.from_numpy(valid[:1024]), 2048,
                                     has_hi=False)
    assert sl.shape == (2048,)
    np.testing.assert_array_equal(sl[:int(sk)].numpy(),
                                  np.unique(lo[:1024][valid[:1024]]))
    assert (sl[int(sk):] == pdm.U32_MAX).all()


def test_dispatch_lock_covers_only_device_section(cpu8, monkeypatch):
    class OwnerLock:
        def __init__(self):
            self._l = threading.Lock()
            self.owner = None
            self.acquisitions = 0

        def __enter__(self):
            self._l.acquire()
            self.owner = threading.get_ident()
            self.acquisitions += 1

        def __exit__(self, *exc):
            self.owner = None
            self._l.release()

    lock = OwnerLock()
    real_split = pdm.split_keys
    prep_outside = []

    def spying_split(values):
        prep_outside.append(lock.owner != threading.get_ident())
        return real_split(values)

    monkeypatch.setattr(pdm, "split_keys", spying_split)
    rng = np.random.default_rng(5)
    vals = [rng.integers(0, 1000, 20_000).astype(np.int64) for _ in range(4)]
    results = [None] * 4
    errs = []

    def worker(i):
        try:
            results[i] = pdm.global_dictionary_encode(vals[i], cpu8, cap=None,
                                                      dispatch_lock=lock)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and not any(t.is_alive() for t in threads)
    assert lock.acquisitions == 4 and prep_outside == [True] * 4
    for i in range(4):
        d, idx = results[i]
        np.testing.assert_array_equal(d[idx], vals[i])


# ---------------------------------------------------------------------------
# sharded: the gather step, the bounded steps
# ---------------------------------------------------------------------------

def _jax_sharded(mesh, vals, counts):
    row = NamedSharding(mesh, PS(None, "shard"))
    return (jax.device_put(jnp.zeros(vals.shape, jnp.uint32), row),
            jax.device_put(vals, row),
            jax.device_put(np.ascontiguousarray(counts), NamedSharding(mesh, PS("shard"))))


@pytest.mark.parametrize("has_hi", [True, False])
def test_sharded_encode_step(mesh8, cpu8, has_hi):
    """8 shards, 4 columns, ragged counts: packed bytes, dictionaries, k,
    rows and overflow equal to the JAX step's and to the numpy oracle."""
    rng = np.random.default_rng(2)
    C, per = 4, 512
    N = 8 * per
    vals = rng.integers(0, 200, (C, N)).astype(np.uint32)
    counts = np.array([512, 0, 17, 512, 1, 512, 100, 512], np.int32)
    want = jsh.sharded_encode_step(*_jax_sharded(mesh8, vals, counts), mesh=mesh8,
                                   cap=1024, width=16, has_hi=has_hi)
    lo = torch.from_numpy(vals.view(np.int32))
    packed, mhi, mlo, gk, rows, ovf = psh.sharded_encode_step(
        torch.zeros_like(lo), lo, counts, mesh=cpu8, cap=1024, width=16, has_hi=has_hi)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(want[3]))
    assert int(rows) == int(want[4]) == counts.sum() and int(ovf) == int(want[5]) == 0
    for c in range(C):
        k = int(gk[c])
        valid = np.concatenate([vals[c, s * per:s * per + counts[s]] for s in range(8)])
        d = np.unique(valid)
        assert k == len(d)
        np.testing.assert_array_equal(mlo[c, :k].numpy(), np.asarray(want[2])[c, :k])
        np.testing.assert_array_equal(mlo[c, :k].numpy(), d)
        assert not mhi[c, :k].any()
        idx = np.concatenate([np.concatenate([np.searchsorted(d, vals[c, s * per:s * per + n]),
                                              np.zeros(per - n, np.int64)])
                              for s, n in enumerate(counts)])
        assert packed[c].numpy().tobytes() == enc.bitpack(idx.astype(np.uint64), 16)


def test_sharded_encode_step_overflow_flag(mesh8, cpu8):
    """A shard holding more uniques than the cap, and a dictionary wider
    than the index width, both raise the overflow flag on both packages."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 5000, (2, 8 * 512)).astype(np.uint32)
    counts = np.full(8, 512, np.int32)
    lo = torch.from_numpy(vals.view(np.int32))
    for cap, width in ((64, 16), (1024, 8)):
        want = jsh.sharded_encode_step(*_jax_sharded(mesh8, vals, counts), mesh=mesh8,
                                       cap=cap, width=width, has_hi=False)
        got = psh.sharded_encode_step(torch.zeros_like(lo), lo, counts, mesh=cpu8,
                                      cap=cap, width=width, has_hi=False)
        assert int(got[5]) == 1 and int(want[5]) > 0


@pytest.mark.parametrize("route", ["xla", "interpret"])
def test_sharded_encode_step_bounded_psum_identity(mesh8, cpu8, route, monkeypatch):
    """The histogram-psum step equals the JAX package's (on either of its
    routes: the int8 matmul and the Pallas kernels in interpret mode) and
    the port's gather step, ragged counts included."""
    monkeypatch.setenv("KPW_PALLAS", "interpret" if route == "interpret" else "0")
    rng = np.random.default_rng(9)
    C, per = 3, 512
    N = 8 * per
    for vb, counts in ((266, np.full(8, per, np.int32)),
                       (5001, np.array([512, 0, 17, 512, 1, 512, 100, 512], np.int32)),
                       (1 << 13, np.full(8, per, np.int32))):
        vals = rng.integers(0, vb, (C, N)).astype(np.uint32)
        _, jlo, jcnt = _jax_sharded(mesh8, vals, counts)
        jp, jdict, jgk, jrows, jovf = jsh.sharded_encode_step_bounded(
            jlo, jcnt, mesh=mesh8, width=16, value_bound=vb)
        lo = torch.from_numpy(vals.view(np.int32))
        packed, gdict, gk, rows, ovf = psh.sharded_encode_step_bounded(
            lo, counts, mesh=cpu8, width=16, value_bound=vb)
        gp, _, gmlo, ggk, _, _ = psh.sharded_encode_step(
            torch.zeros_like(lo), lo, counts, mesh=cpu8, cap=N, width=16, has_hi=False)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(jp))
        assert torch.equal(packed, gp) and torch.equal(gk, ggk)
        np.testing.assert_array_equal(gk.numpy(), np.asarray(jgk))
        assert int(rows) == int(jrows) == counts.sum() and int(ovf) == int(jovf) == 0
        for c in range(C):
            k = int(gk[c])
            np.testing.assert_array_equal(gdict[c, :k].numpy(), np.asarray(jdict)[c, :k])
            assert torch.equal(gdict[c, :k], gmlo[c, :k])


def test_bounded_step_pads_shards_to_whole_lane_rows(cpu8):
    """Shards of 8 rows (not a multiple of the kernels' 128 lanes) are
    padded with the sentinel inside the step: equal to the gather step."""
    rng = np.random.default_rng(4)
    lo = torch.from_numpy(rng.integers(0, 90, (2, 64)).astype(np.int32))
    counts = np.array([8, 3, 0, 8, 8, 1, 8, 8])
    got = psh.sharded_encode_step_bounded(lo, counts, mesh=cpu8, value_bound=90)
    want = psh.sharded_encode_step(torch.zeros_like(lo), lo, counts, mesh=cpu8,
                                   cap=8, has_hi=False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[3])
    with pytest.raises(ValueError, match="multiple of 8"):
        psh.sharded_encode_step_bounded(lo[:, :40], counts, mesh=cpu8, value_bound=90)


@pytest.mark.parametrize("dtype,lo,hi,stride", [
    (np.int64, 0, 2000, 1),
    (np.int32, 5, 260, 1),
    (np.int64, 0, 3000, 25),
    (np.uint32, 0, 8192, 1),
    (np.int64, 7, 8, 1),
])
def test_bounded_psum_dictionary_identity(mesh8, cpu8, dtype, lo, hi, stride):
    rng = np.random.default_rng(int(lo) + int(hi))
    values = (rng.integers(lo, hi, 4099) * stride).astype(dtype)
    vmin = int(values.min())
    vb = (int(values.max()) - vmin) // stride + 1
    js, ps = {}, {}
    got = psh.bounded_global_dictionary_encode(values, cpu8, vmin=vmin, stride=stride,
                                               value_bound=vb, stats_out=ps)
    same_encode(got, jsh.bounded_global_dictionary_encode(
        values, mesh8, vmin=vmin, stride=stride, value_bound=vb, stats_out=js))
    same_encode(got, pdm.global_dictionary_encode(values, cpu8, cap=None))
    assert ps == js
    assert psh.bounded_psum_payload_bytes(vb) == jsh.bounded_psum_payload_bytes(vb)
    np.testing.assert_array_equal(got[0][got[1]], values)


def test_bounded_psum_rejections(mesh8, cpu8):
    """The ValueErrors of both packages: a bound past the design bound, a
    negative vmin, a stride that does not divide, a violated bound."""
    v = np.arange(100, dtype=np.int64)
    for fn, mesh in ((psh.bounded_global_dictionary_encode, cpu8),
                     (jsh.bounded_global_dictionary_encode, mesh8)):
        with pytest.raises(ValueError, match="design bound"):
            fn(v, mesh, vmin=0, stride=1, value_bound=(1 << 13) + 1)
        with pytest.raises(ValueError, match="vmin"):
            fn(v - 5, mesh, vmin=-5, stride=1, value_bound=100)
        with pytest.raises(ValueError, match="stride"):
            fn(v, mesh, vmin=0, stride=3, value_bound=40)
        with pytest.raises(ValueError, match="value_bound"):
            fn(v, mesh, vmin=0, stride=1, value_bound=50)
    with pytest.raises(ValueError, match="design bound"):
        psh.sharded_encode_step_bounded(torch.zeros((1, 8 * 256), dtype=torch.int32),
                                        np.full(8, 256), mesh=cpu8,
                                        value_bound=(1 << 13) + 1)


# ---------------------------------------------------------------------------
# MeshChunkEncoder
# ---------------------------------------------------------------------------

def _file(pkg, encoder, arrays, spec, **props):
    core = pkg.core
    schema = core.Schema([core.leaf(n, t) for n, t in spec])
    p = core.WriterProperties(**props)
    buf = io.BytesIO()
    w = core.ParquetFileWriter(buf, schema, p, encoder=encoder(p.encoder_options()))
    w.write_batch(core.columns_from_arrays(schema, arrays))
    w.close()
    return buf.getvalue()


def test_mesh_encoder_bounded_route_selection():
    rng = np.random.default_rng(3)
    cases = [rng.integers(0, 2000, 512).astype(np.int64),
             (rng.integers(0, 3000, 512) * 25 + 7).astype(np.int64),
             rng.integers(-5, 100, 512).astype(np.int64),
             rng.integers(0, 1 << 40, 512).astype(np.int64),
             rng.integers(0, 30, 512) / 4.0,
             np.full(512, 9, np.int32)]
    got = [PMesh._bounded_route(v) for v in cases]
    assert got == [JMesh._bounded_route(v) for v in cases]
    assert got[1][1] == 25 and got[2] is None and got[3] is None and got[4] is None


def test_mesh_encoder_files_byte_identical(mesh8, cpu8):
    """MeshChunkEncoder over 8 CPU shards writes the JAX MeshChunkEncoder's
    file on mesh8 and the CpuChunkEncoder's, with the same routing record
    and payload counters."""
    rng = np.random.default_rng(11)
    n = 4096
    arrays = {"a": rng.integers(0, 50, n).astype(np.int64),
              "b": rng.integers(-7, 7, n).astype(np.int32),
              "f": rng.integers(0, 30, n) / 4.0,
              "m": rng.integers(0, 2500, n).astype(np.int64),
              "s": [b"tag_%d" % (i % 9) for i in range(n)]}
    spec = [("a", "int64"), ("b", "int32"), ("f", "double"), ("m", "int64"),
            ("s", "string")]
    encs = {}

    def keep(name, cls, mesh):
        def make(opts):
            encs[name] = cls(opts, mesh=mesh)
            return encs[name]
        return make

    got = _file(P, keep("port", PMesh, cpu8), arrays, spec, row_group_size=1 << 16)
    assert got == _file(J, keep("jax", JMesh, mesh8), arrays, spec,
                        row_group_size=1 << 16)
    assert got == _file(P, P.core.pages.CpuChunkEncoder, arrays, spec,
                        row_group_size=1 << 16)
    assert list(encs["port"].route_log) == list(encs["jax"].route_log)
    assert encs["port"].ici_stats == encs["jax"].ici_stats


def test_mesh_encoder_overflow_falls_back_to_plain(mesh8, cpu8):
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 1 << 60, 4096).astype(np.int64)
    got = _file(P, lambda o: PMesh(o, mesh=cpu8, cap=256), {"v": vals}, [("v", "int64")])
    assert got == _file(J, lambda o: JMesh(o, mesh=mesh8, cap=256), {"v": vals},
                        [("v", "int64")])
    encs = pq.read_metadata(io.BytesIO(got)).row_group(0).column(0).encodings
    assert "PLAIN_DICTIONARY" not in encs and "RLE_DICTIONARY" not in encs
    np.testing.assert_array_equal(pq.read_table(io.BytesIO(got))["v"].to_numpy(), vals)


def test_mesh_string_dictionary_merge_identity(mesh8, cpu8):
    rng = np.random.default_rng(47)
    n = 4096
    pool = [b"cat_%03d" % j for j in range(200)]
    arrays = {"s": [pool[k] for k in rng.integers(0, 200, n)],
              "t": [b"x" * (1 + int(k)) for k in rng.integers(0, 5, n)],
              "u": [b"uuid-%032x" % int(v) for v in rng.integers(0, 1 << 62, n)],
              "i": rng.integers(0, 100, n).astype(np.int64)}
    spec = [("s", "string"), ("t", "string"), ("u", "string"), ("i", "int64")]
    encs = {}
    got = _file(P, lambda o: encs.setdefault("p", PMesh(o, mesh=cpu8)), arrays, spec,
                row_group_size=1 << 16)
    assert got == _file(J, lambda o: encs.setdefault("j", JMesh(o, mesh=mesh8)),
                        arrays, spec, row_group_size=1 << 16)
    assert got == _file(P, P.core.pages.CpuChunkEncoder, arrays, spec,
                        row_group_size=1 << 16)
    ps, js = (dict(encs[k].string_stats) for k in "pj")
    assert ps.pop("merge_ms") > 0 and js.pop("merge_ms") > 0
    assert ps == js and ps["overflow_columns"] == 1 and ps["columns"] == 3
    # a one-shard mesh takes the single-hash build: no merge, no stats
    one = PMesh(P.core.WriterProperties().encoder_options(),
                mesh=pmesh.make_mesh(1, device="cpu"))
    d, idx = one._mesh_string_dictionary(arrays["s"], None)
    assert list(d) == sorted(set(arrays["s"])) and one.string_stats == {}


def test_shared_encoder_stats_exact_under_threads(cpu8):
    from kpw_tpu_torch.core import Schema, WriterProperties, leaf
    from kpw_tpu_torch.core.bytecol import ByteColumn
    from kpw_tpu_torch.core.pages import ColumnChunkData

    schema = Schema([leaf("b", "int64"), leaf("w", "int64"), leaf("s", "string")])
    menc = PMesh(WriterProperties().encoder_options(), mesh=cpu8)
    PER_THREAD, THREADS = 3, 6
    errs = []

    def worker(seed):
        try:
            r = np.random.default_rng(seed)
            for _ in range(PER_THREAD):
                cols = (r.integers(0, 1500, 4096).astype(np.int64),
                        r.integers(-700, 700, 4096).astype(np.int64),
                        ByteColumn.from_list([b"v%d" % k
                                              for k in r.integers(0, 500, 4096)]))
                for i, arr in enumerate(cols):
                    chunk = ColumnChunkData(schema.columns[i], arr, num_rows=len(arr))
                    assert menc._try_dictionary(chunk) is not None
        except Exception as e:  # pragma: no cover - failure reporting
            errs.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(s,)) for s in range(THREADS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errs and not any(t.is_alive() for t in ts), errs
    total = THREADS * PER_THREAD
    assert menc.ici_stats["bounded_columns"] == total
    assert menc.ici_stats["columns"] == total
    assert menc.string_stats["columns"] == total
    assert menc.string_stats["k_global_max"] == 500
    routes = [e["route"] for e in menc.route_log]
    assert routes.count("bounded-psum") == routes.count("two-phase-gather") == total
    assert all(e["accepted"] for e in menc.route_log)


# ---------------------------------------------------------------------------
# the "mesh" backend: selection and the streaming writer
# ---------------------------------------------------------------------------

def test_mesh_backend_selection(monkeypatch):
    from kpw_tpu_torch.runtime import select as S

    opts = P.core.WriterProperties().encoder_options()
    enc_ = S.make_encoder(opts, "mesh", device="cpu")
    assert type(enc_) is PMesh and enc_.mesh.devices == (torch.device("cpu"),)
    assert S.check_backend("mesh", device="cpu") == "mesh"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.check_backend("mesh")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.make_encoder(opts, "mesh")


def _stream(backend_args, rows, parts, threads=1, q=40):
    broker = P.FakeBroker()
    broker.create_topic("t", parts)
    fs = P.MemoryFileSystem()
    cls = sample_message_class()
    for i in range(rows):
        broker.produce("t", cls(query=f"q-{i % q}", timestamp=i).SerializeToString(),
                       partition=i % parts)
    b = (P.Builder().broker(broker).topic("t").proto_class(cls).target_dir("/out")
         .filesystem(fs).instance_name("mesh").thread_count(threads)
         .max_file_open_duration_seconds(0.5))
    if callable(backend_args):
        b.encoder_backend(backend_args(b))
    else:
        b.encoder_backend(*backend_args)
    w = b.build()
    got = set()
    with w:
        deadline = time.time() + 60
        while got != set(range(rows)) and time.time() < deadline:
            time.sleep(0.05)
            got = set()
            for f in fs.list_files("/out", extension=".parquet"):
                with fs.open_read(f) as fh:
                    got.update(pq.read_table(io.BytesIO(fh.read()))["timestamp"]
                               .to_pylist())
    assert got == set(range(rows))


def test_writer_streams_through_mesh_backend(cpu8):
    """Records from several partitions share row groups whose dictionaries
    are merged over 8 CPU shards; the timestamp column rides the
    histogram-psum route."""
    made = []

    def mesh_encoder(b):
        made.append(PMesh(b.writer_properties().encoder_options(), mesh=cpu8))
        return made[0]

    _stream(mesh_encoder, 2000, 4)
    assert made[0].ici_stats.get("bounded_columns", 0) >= 1
    assert made[0].ici_stats.get("bounded_psum_bytes", 0) > 0


def test_mesh_backend_multi_worker_threads():
    """thread_count > 1 with the "mesh" string backend on the CPU: every
    worker builds its own encoder, content round-trips exactly."""
    _stream(("mesh", "cpu"), 3000, 4, threads=3, q=30)
