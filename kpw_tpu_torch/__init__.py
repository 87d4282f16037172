"""kpw_tpu_torch — the port of kpw_tpu to PyTorch and CUDA on an NVIDIA H100.

A package of its own beside ``kpw_tpu``: it imports neither JAX nor any
module of ``kpw_tpu`` and keeps its own copy of what it needs (``core``,
``utils.tracing``, and the host C++ in ``native/src``).  Ported so far is
the row-group encode path — the flagship step
(``parallel.sharded.encode_step_single``, ``entry.entry``) and the writer's
device backend (``ops.backend.CudaChunkEncoder``), every column family the
JAX package's TPU encoder carries, string dictionaries included — with the
TPU kernels of that path as hand-written CUDA kernels (``csrc/``, built at
first use by ``ops/_build.py``).  Beneath the device backend sits the
port's own native host layer (``native/``: codecs, encode primitives and
the nogil page assembler, built with g++ at first use into ``_build/``), as
the JAX package's TPU encoder sits on its native encoder.

Entry points run on the card unless the caller passes ``device="cpu"``;
ops run on the device of the tensors they are given (see ``device.py``).
"""

__version__ = "0.1.0"
