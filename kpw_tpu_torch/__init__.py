"""kpw_tpu_torch — the port of kpw_tpu to PyTorch and CUDA on an NVIDIA H100.

A package of its own beside ``kpw_tpu``: it imports neither JAX nor any
module of ``kpw_tpu`` and keeps its own copy of what it needs (``core``,
``utils``, the host C++ in ``native/src``, and the streaming writer's
``runtime``, ``ingest``, ``io`` and ``models`` layers).  The public API is
the reference's: ``Builder`` + ``start()`` / ``close()``, which consumes
protobuf records from a broker, shreds them from the wire, encodes row
groups with ``ops.backend.CudaChunkEncoder`` on the card, rotates and
publishes files atomically and acks offsets only after a file is
published.  Ported beneath it is the row-group encode path — the flagship
step (``parallel.sharded.encode_step_single``, ``entry.entry``) and the
writer's device backend, every column family the JAX package's TPU
encoder carries, and the shard mesh whose merged dictionaries let several
partitions share a row group (``parallel/``) — with the TPU kernels of
that path as hand-written CUDA kernels (``csrc/``, built at first use by
``ops/_build.py``), over the
port's own native host layer (``native/``: codecs, encode primitives, the
nogil page assembler and the wire shredders, built with g++ at first use
into ``_build/``).

Entry points run on the card unless the caller passes ``device="cpu"``
(or, on the ``Builder``, picks the ``"cpu"`` or ``"native"`` encoder);
ops run on the device of the tensors they are given (see ``device.py``).
"""

__version__ = "0.1.0"

from .runtime import Builder, MultiWriter  # noqa: E402,F401
from .io.compact import Compactor  # noqa: E402,F401
from .ingest import (  # noqa: E402,F401
    FakeBroker,
    FaultInjectingBroker,
    KafkaBrokerClient,
)
from .io import (  # noqa: E402,F401
    BandwidthBudget,
    EmulatedObjectStore,
    FailoverFileSystem,
    FaultInjectingFileSystem,
    FaultSchedule,
    HdfsFileSystem,
    InjectedFault,
    LocalFileSystem,
    MemoryFileSystem,
    ObjectStoreFileSystem,
    objectstore_persona,
)
