"""The port's native (C++) host library: codecs, page assembly, wire shred.

A copy of the JAX package's host C++ (``native/src``: a from-scratch Snappy
block codec, a libzstd wrapper, CRC32C, the dictionary / RLE / delta / BSS
encode primitives, the nogil page assembler and the protobuf wire
shredders), built by the port itself with g++ into ``kpw_tpu_torch/_build``
at first use (``native/build.py``).  A failed build warns and returns None,
so the port's pure-Python ``CpuChunkEncoder`` keeps working;
``CudaChunkEncoder`` refuses to run without the library and assembler
(``ops/backend.py``), and the proto bridge takes its wire path only with
the library and the shred extension (``models/proto_bridge.py``).
"""

from __future__ import annotations

import threading

_lock = threading.Lock()
_lib = None
_lib_tried = False
_assemble = None
_assemble_tried = False
_pyshred = None
_pyshred_tried = False
errors: dict[str, str] = {}  # artifact -> why it failed to build or load


def lib():
    """The ctypes :class:`~.build.NativeLib`, or None when the build
    failed (with a warning naming the error)."""
    global _lib, _lib_tried
    with _lock:
        if not _lib_tried:
            _lib_tried = True
            try:
                from .build import load

                _lib = load()
            except (OSError, RuntimeError) as e:
                import warnings

                errors["lib"] = repr(e)
                warnings.warn(f"kpw_tpu_torch native library unavailable "
                              f"({e!r}); using the Python codecs")
    return _lib


def assemble():
    """The nogil batch page-assembly extension (``src/assemble.cc``), or
    None when its build failed (with a warning naming the error): callers
    then take the Python page loop (``core.pages.CpuChunkEncoder.encode``)."""
    global _assemble, _assemble_tried
    with _lock:
        if not _assemble_tried:
            _assemble_tried = True
            try:
                from .build import load_assemble

                _assemble = load_assemble()
            except (OSError, ImportError, RuntimeError) as e:
                import warnings

                errors["assemble"] = repr(e)
                warnings.warn(f"kpw_tpu_torch assemble extension unavailable "
                              f"({e!r}); using the Python page loop")
    return _assemble



def pyshred():
    """The zero-copy wire shred extension (``src/pyshred.cc``), or None
    when its build failed (with a warning naming the error): the proto
    bridge then parses records in Python."""
    global _pyshred, _pyshred_tried
    with _lock:
        if not _pyshred_tried:
            _pyshred_tried = True
            try:
                from .build import load_pyshred

                _pyshred = load_pyshred()
            except (OSError, ImportError, RuntimeError) as e:
                import warnings

                errors["pyshred"] = repr(e)
                warnings.warn(f"kpw_tpu_torch pyshred extension unavailable "
                              f"({e!r}); records are parsed in Python")
    return _pyshred
