"""The shard mesh and its collectives.

One logical axis, ``shard``: Kafka partitions are assigned round-robin to
mesh shards the way the reference assigns them to worker threads via the
shared consumer queue (KafkaProtoParquetWriter.java:175-179).

A :class:`ShardMesh` is an ordered list of torch devices, one per shard of
this process.  A device may repeat: eight shards on ``cuda:0`` run the
mesh's arithmetic on one card, and eight CPU shards are the CPU
counterpart of an eight-device mesh.  Each shard's rows live on its own
device; the collectives below take one tensor per shard of this process
and return the result once, on the mesh's first device.  In one process
they are copies onto that device followed by a ``torch.cat`` or a
reduction; when ``torch.distributed`` is initialised with a world size
above 1, the process's local result goes on through ``dist.all_gather`` /
``dist.all_reduce`` over the default process group, so the mesh spans
every process: the global shard order is rank by rank, each rank's shards
in the order of its ``devices``.  The tests run it with gloo between CPU
processes; NCCL between cards takes the same calls and has not been run.
"""

from __future__ import annotations

import dataclasses

import torch

@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """This process's shards: ``devices[s]`` holds shard s's rows."""

    devices: tuple

    @property
    def n_local(self) -> int:
        """Shards of this process."""
        return len(self.devices)

    @property
    def size(self) -> int:
        """Shards of the whole mesh, over every process."""
        return self.n_local * _world_size()

    @property
    def first(self) -> torch.device:
        """The device that holds the collectives' results."""
        return self.devices[0]

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in shard order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(n_shards: int | None = None, device="cuda") -> ShardMesh:
    """A mesh of ``n_shards`` shards on ``device``.

    With no count, one shard per visible card (``device="cuda"``) or one
    CPU shard.  A count with ``device="cuda"`` spreads the shards over the
    visible cards round-robin, so 8 shards on a one-card machine are 8
    shards on ``cuda:0``; ``device="cuda:1"`` (an index) puts every shard on
    that card.  Asked for the card with none, it raises: the mesh never
    runs on the CPU unless the caller asks for it."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if n_shards is not None and n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_shards}")
    if dev.type == "cpu" or dev.index is not None:
        return ShardMesh((dev,) * (n_shards or 1))
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = n_shards or len(cards)
    return ShardMesh(tuple(cards[s % len(cards)] for s in range(n)))


def partition_assignment(n_partitions: int, n_shards: int) -> list[list[int]]:
    """Round-robin Kafka-partition -> shard assignment (the mesh analog of
    threads polling a shared queue, KPW.java:93-94)."""
    out: list[list[int]] = [[] for _ in range(n_shards)]
    for p in range(n_partitions):
        out[p % n_shards].append(p)
    return out


# ---------------------------------------------------------------------------
# collectives: one tensor per local shard in, the mesh-wide result out (on
# the mesh's first device)
# ---------------------------------------------------------------------------

def _world_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _on_first(mesh: ShardMesh, parts) -> list:
    if len(parts) != mesh.n_local:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.n_local} "
                         "local shards")
    return [p.to(mesh.first) for p in parts]


def all_gather(mesh: ShardMesh, parts, dim: int = -1) -> torch.Tensor:
    """Every shard's tensor concatenated along ``dim`` in global shard
    order."""
    local = torch.cat(_on_first(mesh, parts), dim=dim)
    world = _world_size()
    if world == 1:
        return local
    import torch.distributed as dist

    out = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(out, local.contiguous())
    return torch.cat(out, dim=dim)


def _all_reduce(local: torch.Tensor, op: str) -> torch.Tensor:
    if _world_size() == 1:
        return local
    import torch.distributed as dist

    local = local.contiguous()
    dist.all_reduce(local, op=getattr(dist.ReduceOp, op))
    return local


def psum(mesh: ShardMesh, parts) -> torch.Tensor:
    """The elementwise sum of every shard's tensor."""
    local = torch.stack(_on_first(mesh, parts)).sum(0, dtype=parts[0].dtype)
    return _all_reduce(local, "SUM")


def pmax(mesh: ShardMesh, parts) -> torch.Tensor:
    """The elementwise maximum of every shard's tensor."""
    return _all_reduce(torch.stack(_on_first(mesh, parts)).amax(0), "MAX")


def psum_counts(mesh: ShardMesh, counts) -> torch.Tensor:
    """The sum of one host-known count per local shard over the whole mesh,
    as a 0-d CPU tensor: summed on the host, so no copy to a card stalls
    the caller, and reduced across processes only when there are several."""
    local = sum(int(c) for c in counts)
    if _world_size() > 1:
        local = int(_all_reduce(torch.tensor([local], device=mesh.first), "SUM"))
    return torch.tensor(local)


def replicate(mesh: ShardMesh, t: torch.Tensor) -> dict:
    """``t`` on every device of the mesh, once per device: device ->
    tensor (the collectives' results are replicated by construction; a
    shard reads its device's copy)."""
    return {d: t.to(d) for d in mesh.distinct_devices()}
