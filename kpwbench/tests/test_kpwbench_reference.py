"""The plain reference: the Parquet reader, Snappy, the protobuf decoder
and the generator's records, and the bit-pack work formula."""

import importlib.util
import os

import numpy as np
import pytest

from kpwbench import spec
from kpwbench.generators import flat
from kpwbench.reference import parquet as pq
from kpwbench.reference import proto


def _metric(name):
    path = os.path.join(spec.PACKAGE, "metrics", name + ".py")
    s = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


@pytest.mark.parametrize("config", ["taxi64", "replay12"])
def test_generator_records_decode_to_their_columns(config):
    cfg = spec._json("configs", config, spec.PACKAGE)
    pool = flat.Pool(cfg["schema"], 300, seed=2**33 + 5, partitions=16, block=128)
    assert len(pool.payloads) == 300
    for i in (0, 1, 127, 128, 299):
        rec = proto.decode(pool.payloads[i], cfg["schema"])
        for f in cfg["schema"]:
            want = pool.cols[f["name"]][i]
            if f["type"] == "string":
                want = pool.cols[f["name"] + ".dict"][want]
            assert rec[f["name"]] == want, (i, f["name"])


def test_pool_indices_cycle_and_count():
    cfg = spec._json("configs", "replay12", spec.PACKAGE)
    pool = flat.Pool(cfg["schema"], 64, seed=1, partitions=4)
    got = pool.records(3, 60, 10)
    assert got == [pool.payloads[int(pool.index(3, o))] for o in range(60, 70)]
    ends = [0, 5, 64 + 7, 200]
    want = np.zeros(64, np.int64)
    for p, e in enumerate(ends):
        np.add.at(want, pool.index(p, np.arange(e)), 1)
    assert (pool.counts(ends) == want).all()


def test_parquet_reader_matches_pyarrow(tmp_path):
    pa = pytest.importorskip("pyarrow")
    papq = pytest.importorskip("pyarrow.parquet")
    rng = np.random.default_rng(3)
    n = 50_000
    table = pa.table({
        "a": pa.array(rng.integers(0, 8, n), pa.int64()),
        "b": pa.array(rng.integers(1, 266, n).astype(np.int32), pa.int32()),
        "c": pa.array(rng.integers(0, 3000, n) / 100.0, pa.float64()),
        "d": pa.array(rng.integers(0, 10**6, n), pa.int64()),
        "s": pa.array([b"cat_%03d" % j for j in rng.integers(0, 100, n)], pa.binary()),
    })
    schema = pa.schema([f.with_nullable(False) for f in table.schema])
    table = table.cast(schema)
    for codec, version in (("none", "1.0"), ("snappy", "1.0"), ("snappy", "2.0")):
        path = str(tmp_path / f"{codec}{version}.parquet")
        papq.write_table(table, path, compression=codec, data_page_version=version,
                         use_dictionary=["a", "b", "c", "s"], row_group_size=20_000,
                         data_page_size=1 << 14)
        pf = pq.read_footer(path)
        assert pf.num_rows == n and pf.names == list(table.column_names)
        for name in pf.names:
            parts = [pf.column(dict(zip(pf.names, cols))[name], rows)
                     for rows, cols in pf.row_groups]
            got = pq._concat(parts, pf.types[pf.names.index(name)])
            want = table.column(name).to_pylist()
            assert (got if isinstance(got, list) else got.tolist()) == want, (codec, name)


def test_snappy_matches_pyarrow():
    pa = pytest.importorskip("pyarrow")
    rng = np.random.default_rng(4)
    for raw in (b"", b"a", b"abcd" * 5000, rng.integers(0, 10**6, 30_000).tobytes(),
                rng.integers(0, 256, 70_000).astype(np.uint8).tobytes()):
        comp = pa.compress(raw, codec="snappy", asbytes=True)
        assert pq.snappy_decompress(comp) == raw


def test_snappy_refuses_a_copy_before_the_start():
    with pytest.raises(pq.ParquetError):
        pq.snappy_decompress(bytes([8, 0b0000_0001 | (4 << 2), 9]))


class _Pages:
    """A file stand-in whose column chunks yield hand-made page headers."""

    def __init__(self, pages):
        self._pages = pages

    def pages(self, col):
        return iter(self._pages[col])


def test_bitpack_work_matches_hand_counts():
    m = _metric("bitpack.roofline")
    D, V1, V2 = pq.DICTIONARY_PAGE, pq.DATA_PAGE, pq.DATA_PAGE_V2
    pf = _Pages({
        "k8": [({1: D, 7: {1: 8}}, b""), ({1: V1, 5: {1: 1000, 2: pq.RLE_DICTIONARY}}, b"")],
        "k265": [({1: D, 7: {1: 265}}, b""), ({1: V2, 8: {1: 7, 4: pq.PLAIN_DICTIONARY}}, b"")],
        "k1": [({1: D, 7: {1: 1}}, b""), ({1: V1, 5: {1: 10, 2: pq.RLE_DICTIONARY}}, b"")],
        "plain": [({1: V1, 5: {1: 99, 2: pq.PLAIN}}, b"")],
        "k5000": [({1: D, 7: {1: 5000}}, b""),
                  ({1: V1, 5: {1: 299_593, 2: pq.RLE_DICTIONARY}}, b""),
                  ({1: V1, 5: {1: 3, 2: pq.RLE_DICTIONARY}}, b"")],
    })
    # k = 8: w = 3, 1,000 indices of 4 B in, 375 B out
    assert m.group_work(pf, ["k8"]) == 4000 + 375
    # k = 265: w = 9, 7 values: 28 B in, 63 bits -> 8 B out
    assert m.group_work(pf, ["k265"]) == 28 + 8
    # k = 1: w = 0, nothing packed
    assert m.group_work(pf, ["k1"]) == 40
    assert m.group_work(pf, ["plain"]) == 0
    # k = 5,000: w = 13 on each page: 299,593 * 13 bits = 486,839 B (rounded up)
    assert m.group_work(pf, ["k5000"]) == 4 * 299_596 + 486_839 + 5


def _bursts_run(bursts, partitions=2, w0=10.0, w1=20.0):
    """A ``Run`` whose commits come in the given bursts, each of
    (time, records) split over the partitions, its commits 1 ms apart."""
    from types import SimpleNamespace

    from kpwbench.harness import Run

    run = Run(SimpleNamespace(config={"partitions": partitions}, traffic={}), 0, w1 - w0,
              False)
    run.w0, run.w1 = w0, w1
    front = [0] * partitions
    for t, records in bursts:
        for p in range(partitions):
            front[p] += records // partitions
            run.commits.append((t + p * 1e-3, p, front[p]))
    return run


@pytest.mark.parametrize("name", ["records_per_s", "ack.records_per_s"])
def test_records_per_s_counts_whole_files_between_the_windows_bursts(name):
    m = _metric(name)
    # bursts at 9.5 and 20.5 lie outside the window [10, 20]; inside, the
    # first burst's records were made before it, so only those of the
    # later three count, over the 9 s from the first burst to the last
    run = _bursts_run([(9.5, 1000), (10.5, 1000), (13.5, 2000), (16.5, 1000),
                       (19.5, 1000), (20.5, 4000)])
    assert [round(t, 3) for t, _ in run.bursts()] == [9.501, 10.501, 13.501, 16.501,
                                                       19.501, 20.501]
    assert m.read(run) == pytest.approx((2000 + 1000 + 1000) / (19.501 - 10.501))


@pytest.mark.parametrize("name", ["records_per_s", "ack.records_per_s"])
@pytest.mark.parametrize("bursts", [[], [(12.0, 1000)], [(9.0, 1000), (15.0, 1000)],
                                    [(15.0, 1000), (25.0, 1000)]])
def test_records_per_s_reads_nothing_under_two_bursts_in_the_window(name, bursts):
    assert _metric(name).read(_bursts_run(bursts)) is None
