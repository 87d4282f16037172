"""The port's mesh across processes, the counterpart of
``tests/test_multihost.py``: two spawned processes, each holding 4 CPU
shards, joined by ``torch.distributed`` with the gloo backend over
localhost into one 8-shard mesh.  The collectives of the merges cross the
process boundary (``dist.all_gather`` / ``dist.all_reduce`` after the
in-process copies), and each process must see the GLOBAL dictionary: the
merged sorted unique set of the rows both processes hold (``np.unique``
over all of them), and its own rows' packed indices against it.

The worker is this file run as a script (``python test_torch_multihost.py
RANK WORLD PORT``); it imports the port only, never JAX."""

import os
import socket
import subprocess
import sys

import numpy as np

TIMEOUT_S = 120


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_mesh_steps_across_two_gloo_processes():
    port = _free_port()
    here = os.path.abspath(__file__)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(here)) + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, here, str(rank), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env=env, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"MULTIHOST-OK rank={rank}" in out, out


def _worker(rank: int, world: int, port: str) -> None:
    import torch
    import torch.distributed as dist

    assert "jax" not in sys.modules
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        from kpw_tpu_torch.core import encodings as enc
        from kpw_tpu_torch.parallel.dict_merge import global_dictionary_encode
        from kpw_tpu_torch.parallel.mesh import make_mesh
        from kpw_tpu_torch.parallel.sharded import (bounded_global_dictionary_encode,
                                                    sharded_encode_step,
                                                    sharded_encode_step_bounded)

        mesh = make_mesh(4, device="cpu")
        assert mesh.size == 8 and mesh.n_local == 4
        C, per = 4, 512
        N = 8 * per
        rng = np.random.default_rng(42)  # same seed in every process: full view
        vals = rng.integers(0, 300, (C, N)).astype(np.uint32)
        counts = np.array([512, 0, 17, 512, 1, 512, 100, 512])
        cols = N // world
        mine = slice(rank * cols, (rank + 1) * cols)
        lo = torch.from_numpy(np.ascontiguousarray(vals[:, mine]).view(np.int32))
        my_counts = counts[rank * 4:(rank + 1) * 4]
        for has_hi in (True, False):
            packed, mhi, mlo, gk, rows, ovf = sharded_encode_step(
                torch.zeros_like(lo), lo, my_counts, mesh=mesh, cap=1024, width=16,
                has_hi=has_hi)
            assert int(rows) == counts.sum() and int(ovf) == 0
            for c in range(C):
                valid = np.concatenate([vals[c, s * per:s * per + n]
                                        for s, n in enumerate(counts)])
                d = np.unique(valid)
                assert np.array_equal(mlo[c, :int(gk[c])].numpy(), d), c
                idx = np.concatenate([np.concatenate([
                    np.searchsorted(d, vals[c, s * per:s * per + n]),
                    np.zeros(per - n, np.int64)]) for s, n in enumerate(counts)])
                want = np.frombuffer(enc.bitpack(idx.astype(np.uint64), 16), np.uint8)
                nb = cols * 2  # this rank's rows' bytes at 16 bits
                assert np.array_equal(packed[c].numpy(),
                                      want[rank * nb:(rank + 1) * nb]), c
        bpacked, bdict, bgk, brows, bovf = sharded_encode_step_bounded(
            lo, my_counts, mesh=mesh, width=16, value_bound=300)
        assert torch.equal(bpacked, packed) and torch.equal(bgk, gk)
        assert int(brows) == counts.sum() and int(bovf) == 0
        # one column: each process passes its rows, gets their indices back
        # against the mesh's dictionary
        col = rng.integers(-50, 2000, 2 * 4096).astype(np.int64)
        half = col[rank * 4096:(rank + 1) * 4096]
        d, idx = global_dictionary_encode(half, mesh, cap=None)
        assert np.array_equal(d, np.unique(col.view(np.uint64)).view(np.int64))
        assert np.array_equal(d[idx], half)
        pos = np.abs(col)
        d, idx = bounded_global_dictionary_encode(
            pos[rank * 4096:(rank + 1) * 4096], mesh, vmin=0, stride=1,
            value_bound=int(pos.max()) + 1)
        assert np.array_equal(d, np.unique(pos))
        assert np.array_equal(d[idx], pos[rank * 4096:(rank + 1) * 4096])
        print(f"MULTIHOST-OK rank={rank} k={[int(x) for x in gk]}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
