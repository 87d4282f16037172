"""Lazy g++ build and ctypes bindings of the port's native host library.

Three artifacts, all compiled from ``native/src`` into ``kpw_tpu_torch/_build``
at first use, never next to the sources:

- ``_kpw_torch_native.so`` (``codecs.cc`` + ``encode.cc`` + the wire
  shredders ``shred.cc`` + ``shred_nested.cc``), a plain C ABI loaded with
  ctypes (:class:`NativeLib`);
- ``_kpw_torch_assemble.so`` (``assemble.cc`` + ``encode.cc`` + ``codecs.cc``),
  the CPython extension ``_kpw_torch_assemble`` that assembles a column
  chunk's pages with the interpreter lock released;
- ``_kpw_torch_pyshred.so`` (``pyshred.cc`` + ``shred.cc`` +
  ``shred_nested.cc``), the CPython extension ``_kpw_torch_pyshred`` that
  shreds protobuf wire records in place, with the interpreter lock
  released.  The decoders compile into it and into the ctypes library from
  the same sources, so the two cannot drift.

Each build tries ``-O3 -march=native``, then ``-O3``, then both again without
zstd.  A cached artifact is reused only while it is newer than its sources
and its tag matches this host (``-march=native`` code is ISA-specific; the
extensions' tag also pins the CPython ABI).  Builds write a temp file and
rename it, under an ``fcntl.flock`` on ``_build/native.lock``, so that
parallel test workers compile each artifact once and never load a partial
one.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_NATIVE_DIR, "src")
BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "_build")
LIB_SRCS = [os.path.join(SRC_DIR, "codecs.cc"), os.path.join(SRC_DIR, "encode.cc"),
            os.path.join(SRC_DIR, "shred.cc"), os.path.join(SRC_DIR, "shred_nested.cc")]
LIB_SO = os.path.join(BUILD_DIR, "_kpw_torch_native.so")
ASSEMBLE_NAME = "_kpw_torch_assemble"
ASSEMBLE_SRCS = [os.path.join(SRC_DIR, "assemble.cc"),
                 os.path.join(SRC_DIR, "encode.cc"),
                 os.path.join(SRC_DIR, "codecs.cc")]
ASSEMBLE_SO = os.path.join(BUILD_DIR, ASSEMBLE_NAME + ".so")
PYSHRED_NAME = "_kpw_torch_pyshred"
PYSHRED_SRCS = [os.path.join(SRC_DIR, "pyshred.cc"),
                os.path.join(SRC_DIR, "shred.cc"),
                os.path.join(SRC_DIR, "shred_nested.cc")]
PYSHRED_SO = os.path.join(BUILD_DIR, PYSHRED_NAME + ".so")
_LOCK = os.path.join(BUILD_DIR, "native.lock")


def _host_tag() -> str:
    """Identifies the CPU a cached artifact was compiled for: a cache that
    travelled to another machine must rebuild, not SIGILL at first call."""
    import hashlib
    import platform

    tag = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    tag += "|" + line.strip()
                    break
    except OSError:
        pass
    return hashlib.sha256(tag.encode()).hexdigest()[:16]


def _extension_tag() -> str:
    """The host tag plus the CPython ABI tag: an extension is compiled
    against Python.h, so a build for another interpreter must not load."""
    import sys

    return f"{_host_tag()}:{sys.implementation.cache_tag}"


def _fresh(so: str, srcs: list, tag: str) -> bool:
    tag_path = so + ".hosttag"
    if not (os.path.exists(so) and os.path.exists(tag_path)):
        return False
    if any(os.path.getmtime(so) < os.path.getmtime(s) for s in srcs):
        return False
    with open(tag_path) as f:
        return f.read() == tag


def _compile(so: str, srcs: list, tag: str, extra: list) -> str:
    """Build ``so`` from ``srcs`` unless a fresh one exists; the caller
    holds the build lock."""
    if _fresh(so, srcs, tag):
        return so
    fast = ["-O3", "-march=native", "-funroll-loops"]
    plain = ["-O3"]
    tail = ["-fPIC", "-shared", "-std=c++17"] + extra + ["-o"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        last_err = b""
        for cflags, zstd in ((fast, True), (plain, True),
                             (fast, False), (plain, False)):
            # -ldl either way: the snappy runtime dispatch dlopens
            args = (["g++"] + cflags + tail + [tmp] + list(srcs)
                    + (["-lzstd", "-ldl"] if zstd else ["-DKPW_NO_ZSTD", "-ldl"]))
            try:
                subprocess.run(args, check=True, capture_output=True)
                break
            except subprocess.CalledProcessError as e:
                last_err = e.stderr or b""
        else:
            raise RuntimeError(
                f"{os.path.basename(so)} build failed at every flag level:\n"
                + last_err.decode(errors="replace"))
        os.replace(tmp, so)
        with open(so + ".hosttag", "w") as f:
            f.write(tag)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _locked_build(so: str, srcs: list, tag: str, extra: list) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(_LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return _compile(so, srcs, tag, extra)


def build_lib() -> str:
    """Path of an up-to-date ``_kpw_torch_native.so``, built if needed."""
    return _locked_build(LIB_SO, LIB_SRCS, _host_tag(), [])


def build_assemble() -> str:
    """Path of an up-to-date ``_kpw_torch_assemble`` extension, built if
    needed."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    return _locked_build(ASSEMBLE_SO, ASSEMBLE_SRCS, _extension_tag(), [f"-I{inc}"])


def build_pyshred() -> str:
    """Path of an up-to-date ``_kpw_torch_pyshred`` extension, built if
    needed."""
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    return _locked_build(PYSHRED_SO, PYSHRED_SRCS, _extension_tag(), [f"-I{inc}"])


class NestedShredResult:
    """Owner of one kpw_proto_shred_nested output; numpy views are COPIES
    (the C++ arena is freed on close / GC)."""

    def __init__(self, cdll, handle) -> None:
        self._c = cdll
        self._h = handle

    def _copy(self, ptr, n, dtype):
        import numpy as np

        if n == 0 or not ptr:
            return np.zeros(0, dtype)
        return np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
            shape=(n * np.dtype(dtype).itemsize,)).view(dtype).copy()

    def values(self, leaf: int, dtype):
        import numpy as np

        nbytes = self._c.kpw_nested_value_bytes(self._h, leaf)
        n = nbytes // np.dtype(dtype).itemsize
        return self._copy(self._c.kpw_nested_values(self._h, leaf), n, dtype)

    def spans(self, leaf: int):
        import numpy as np

        n = self._c.kpw_nested_nspans(self._h, leaf)
        return (self._copy(self._c.kpw_nested_spos(self._h, leaf), n, np.int64),
                self._copy(self._c.kpw_nested_slen(self._h, leaf), n, np.int32))

    def levels(self, leaf: int):
        import numpy as np

        n = self._c.kpw_nested_nlevels(self._h, leaf)
        return (self._copy(self._c.kpw_nested_defs(self._h, leaf), n, np.uint8),
                self._copy(self._c.kpw_nested_reps(self._h, leaf), n, np.uint8))

    def close(self) -> None:
        if self._h:
            self._c.kpw_nested_free(self._h)
            self._h = None

    def __del__(self) -> None:  # pragma: no cover - GC safety net
        try:
            self.close()
        # lint: swallowed-exceptions ok — __del__ runs at arbitrary GC
        # points (possibly interpreter teardown); raising here aborts the
        # process with an unraisable-exception warning, not a diagnosis
        except Exception:
            pass


class NativeLib:
    """bytes-in/bytes-out wrappers over the C ABI."""

    def __init__(self, cdll: ctypes.CDLL) -> None:
        self._c = cdll
        c_sz = ctypes.c_size_t
        c_p = ctypes.c_char_p
        for name, slot in (("kpw_int_stats_i64", ctypes.c_int64),
                           ("kpw_int_stats_i32", ctypes.c_int64),
                           ("kpw_int_stats_u64", ctypes.c_uint64),
                           ("kpw_int_stats_u32", ctypes.c_uint64)):
            fn = getattr(cdll, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, c_sz, ctypes.POINTER(slot),
                           ctypes.POINTER(slot),
                           ctypes.POINTER(ctypes.c_uint64)]
        cdll.kpw_snappy_max_compressed_length.restype = c_sz
        cdll.kpw_snappy_max_compressed_length.argtypes = [c_sz]
        cdll.kpw_snappy_compress.restype = ctypes.c_int
        cdll.kpw_snappy_compress.argtypes = [c_p, c_sz, c_p, ctypes.POINTER(c_sz)]
        cdll.kpw_snappy_uncompressed_length.restype = ctypes.c_int
        cdll.kpw_snappy_uncompressed_length.argtypes = [c_p, c_sz, ctypes.POINTER(c_sz)]
        cdll.kpw_snappy_compress_parts.restype = ctypes.c_int
        cdll.kpw_snappy_compress_parts.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(c_sz),
            ctypes.c_int, c_p, c_sz, ctypes.POINTER(c_sz)]
        cdll.kpw_snappy_uncompress.restype = ctypes.c_int
        cdll.kpw_snappy_uncompress.argtypes = [c_p, c_sz, c_p, c_sz, ctypes.POINTER(c_sz)]
        self.has_zstd = hasattr(cdll, "kpw_zstd_compress")
        if self.has_zstd:
            cdll.kpw_zstd_max_compressed_length.restype = c_sz
            cdll.kpw_zstd_max_compressed_length.argtypes = [c_sz]
            cdll.kpw_zstd_compress.restype = ctypes.c_int
            cdll.kpw_zstd_compress.argtypes = [c_p, c_sz, c_p, c_sz,
                                               ctypes.POINTER(c_sz), ctypes.c_int]
            cdll.kpw_zstd_uncompressed_length.restype = ctypes.c_int
            cdll.kpw_zstd_uncompressed_length.argtypes = [c_p, c_sz, ctypes.POINTER(c_sz)]
            cdll.kpw_zstd_uncompress.restype = ctypes.c_int
            cdll.kpw_zstd_uncompress.argtypes = [c_p, c_sz, c_p, c_sz, ctypes.POINTER(c_sz)]
            cdll.kpw_zstd_compress_parts.restype = ctypes.c_int
            cdll.kpw_zstd_compress_parts.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(c_sz),
                ctypes.c_int, c_p, c_sz, ctypes.POINTER(c_sz), ctypes.c_int]
        cdll.kpw_crc32c.restype = ctypes.c_uint32
        cdll.kpw_crc32c.argtypes = [c_p, c_sz, ctypes.c_uint32]
        cdll.kpw_byte_array_plain.restype = None
        cdll.kpw_byte_array_plain.argtypes = [
            c_p, ctypes.POINTER(ctypes.c_int64), c_sz, c_p]
        cdll.kpw_byte_array_gather.restype = None
        cdll.kpw_byte_array_gather.argtypes = [
            c_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), c_sz, c_p]
        c_u32p = ctypes.POINTER(ctypes.c_uint32)
        c_u64p = ctypes.POINTER(ctypes.c_uint64)
        cdll.kpw_dict_build_u32.restype = ctypes.c_int
        cdll.kpw_dict_build_u32.argtypes = [
            c_u32p, c_sz, c_u32p, c_u32p, ctypes.c_uint32, c_u32p]
        cdll.kpw_dict_build_u64.restype = ctypes.c_int
        cdll.kpw_dict_build_u64.argtypes = [
            c_u64p, c_sz, c_u64p, c_u32p, ctypes.c_uint32, c_u32p]
        c_i64p = ctypes.POINTER(ctypes.c_int64)
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        cdll.kpw_delta_bp_cap.restype = c_sz
        cdll.kpw_delta_bp_cap.argtypes = [c_sz]
        cdll.kpw_delta_bp32.restype = ctypes.c_int
        cdll.kpw_delta_bp32.argtypes = [c_i32p, c_sz, c_p, ctypes.POINTER(c_sz)]
        cdll.kpw_delta_bp64.restype = ctypes.c_int
        cdll.kpw_delta_bp64.argtypes = [c_i64p, c_sz, c_p, ctypes.POINTER(c_sz)]
        cdll.kpw_dict_build_bytes.restype = ctypes.c_int
        cdll.kpw_dict_build_bytes.argtypes = [
            c_p, c_i64p, c_sz, c_i64p, c_u32p, ctypes.c_uint32, c_u32p]
        cdll.kpw_bytes_min_max.restype = None
        cdll.kpw_bytes_min_max.argtypes = [c_p, c_i64p, c_sz,
                                           ctypes.POINTER(c_sz),
                                           ctypes.POINTER(c_sz)]
        cdll.kpw_rle_hybrid_cap.restype = c_sz
        cdll.kpw_rle_hybrid_cap.argtypes = [c_sz, ctypes.c_int]
        cdll.kpw_rle_hybrid_u32.restype = ctypes.c_int
        cdll.kpw_rle_hybrid_u32.argtypes = [
            c_u32p, c_sz, ctypes.c_int, c_p, ctypes.POINTER(c_sz)]
        cdll.kpw_byte_stream_split.restype = ctypes.c_int
        cdll.kpw_byte_stream_split.argtypes = [
            ctypes.c_void_p, c_sz, c_sz, c_p]
        c_vpp = ctypes.POINTER(ctypes.c_void_p)
        cdll.kpw_proto_shred.restype = ctypes.c_int64
        cdll.kpw_proto_shred.argtypes = [
            c_p, c_i64p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32), c_p, c_p,
            c_vpp, c_vpp, c_vpp, c_vpp]
        cdll.kpw_gather_spans.restype = None
        cdll.kpw_gather_spans.argtypes = [
            c_p, c_i64p, c_i32p, ctypes.c_int64, c_p]
        h_p = ctypes.c_void_p
        cdll.kpw_proto_shred_nested.restype = ctypes.c_int64
        cdll.kpw_proto_shred_nested.argtypes = (
            [c_p, c_i64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
             c_u32p, c_p, c_p] + [c_i32p] * 12 + [ctypes.POINTER(h_p)])
        for name in ("kpw_nested_value_bytes", "kpw_nested_nspans",
                     "kpw_nested_nlevels"):
            fn = getattr(cdll, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [h_p, ctypes.c_int32]
        for name, rt in (("kpw_nested_values", ctypes.c_void_p),
                         ("kpw_nested_spos", ctypes.POINTER(ctypes.c_int64)),
                         ("kpw_nested_slen", ctypes.POINTER(ctypes.c_int32)),
                         ("kpw_nested_defs", ctypes.POINTER(ctypes.c_uint8)),
                         ("kpw_nested_reps", ctypes.POINTER(ctypes.c_uint8))):
            fn = getattr(cdll, name)
            fn.restype = rt
            fn.argtypes = [h_p, ctypes.c_int32]
        cdll.kpw_nested_free.restype = None
        cdll.kpw_nested_free.argtypes = [h_p]

    # -- snappy ------------------------------------------------------------
    def snappy_compress(self, data: bytes) -> bytes:
        cap = self._c.kpw_snappy_max_compressed_length(len(data))
        out = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_snappy_compress(data, len(data), out, ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"kpw_snappy_compress rc={rc}")
        return out.raw[: out_len.value]

    def snappy_decompress(self, data: bytes) -> bytes:
        size = ctypes.c_size_t(0)
        rc = self._c.kpw_snappy_uncompressed_length(data, len(data), ctypes.byref(size))
        if rc != 0:
            raise RuntimeError("invalid snappy stream")
        out = ctypes.create_string_buffer(max(size.value, 1))
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_snappy_uncompress(data, len(data), out, size.value,
                                           ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"kpw_snappy_uncompress rc={rc}")
        return out.raw[: out_len.value]

    # -- zstd --------------------------------------------------------------
    def zstd_compress(self, data: bytes, level: int = 3) -> bytes | None:
        if not self.has_zstd:
            return None
        cap = self._c.kpw_zstd_max_compressed_length(len(data))
        out = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_zstd_compress(data, len(data), out, cap,
                                       ctypes.byref(out_len), level)
        if rc != 0:
            raise RuntimeError("zstd compress failed")
        return out.raw[: out_len.value]

    @staticmethod
    def _parts_pointers(parts: list):
        """(pointer array, length array, total bytes, views to keep alive)
        for discontiguous parts: bytes, memoryviews or ndarrays."""
        import numpy as np

        n = len(parts)
        ptrs = (ctypes.c_void_p * n)()
        lens = (ctypes.c_size_t * n)()
        keep = []  # frombuffer views, alive through the call
        total = 0
        for i, p in enumerate(parts):
            if isinstance(p, bytes):
                ptrs[i] = ctypes.cast(ctypes.c_char_p(p), ctypes.c_void_p)
                lens[i] = len(p)
                total += len(p)
            else:
                a = np.frombuffer(p, np.uint8)
                keep.append(a)
                ptrs[i] = a.ctypes.data
                lens[i] = a.nbytes
                total += a.nbytes
        return ptrs, lens, total, keep

    def snappy_compress_parts(self, parts: list, out=None):
        """Compress discontiguous parts (bytes / memoryview / ndarray) as
        one snappy stream into ``out`` (a uint8 ndarray scratch, grown as
        needed, NOT zeroed); returns (out, n_written).  The caller slices
        ``memoryview(out)[:n]`` and consumes it before the next call that
        reuses the same scratch."""
        import numpy as np

        ptrs, lens, total, keep = self._parts_pointers(parts)
        cap = self._c.kpw_snappy_max_compressed_length(total)
        if out is None or out.nbytes < cap:
            out = np.empty(cap, np.uint8)
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_snappy_compress_parts(
            ptrs, lens, len(parts), out.ctypes.data_as(ctypes.c_char_p),
            out.nbytes, ctypes.byref(out_len))
        del keep
        if rc != 0:
            raise RuntimeError(f"kpw_snappy_compress_parts rc={rc}")
        return out, out_len.value

    def zstd_compress_parts(self, parts: list, level: int = 3, out=None):
        """As :meth:`snappy_compress_parts`, one zstd frame; None without
        zstd in this build."""
        if not self.has_zstd:
            return None
        import numpy as np

        ptrs, lens, total, keep = self._parts_pointers(parts)
        cap = self._c.kpw_zstd_max_compressed_length(total)
        if out is None or out.nbytes < cap:
            out = np.empty(cap, np.uint8)
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_zstd_compress_parts(
            ptrs, lens, len(parts), out.ctypes.data_as(ctypes.c_char_p),
            out.nbytes, ctypes.byref(out_len), level)
        del keep
        if rc != 0:
            raise RuntimeError(f"kpw_zstd_compress_parts rc={rc}")
        return out, out_len.value

    def zstd_decompress(self, data: bytes) -> bytes | None:
        if not self.has_zstd:
            return None
        size = ctypes.c_size_t(0)
        rc = self._c.kpw_zstd_uncompressed_length(data, len(data), ctypes.byref(size))
        if rc != 0:
            raise RuntimeError("zstd: unknown content size")
        out = ctypes.create_string_buffer(max(size.value, 1))
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_zstd_uncompress(data, len(data), out, size.value,
                                         ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError("zstd decompress failed")
        return out.raw[: out_len.value]

    # -- misc --------------------------------------------------------------
    def crc32c(self, data: bytes, crc: int = 0) -> int:
        return self._c.kpw_crc32c(data, len(data), crc)

    def byte_array_plain(self, data: bytes, offsets) -> bytes:
        import numpy as np

        offs = np.ascontiguousarray(offsets, np.int64)
        count = len(offs) - 1
        total = int(offs[-1] - offs[0]) + 4 * count
        out = ctypes.create_string_buffer(max(total, 1))
        self._c.kpw_byte_array_plain(
            data, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), count, out)
        return out.raw[:total]

    def byte_array_gather(self, dict_data: bytes, dict_offsets, indices) -> bytes:
        import numpy as np

        offs = np.ascontiguousarray(dict_offsets, np.int64)
        idx = np.ascontiguousarray(indices, np.int32)
        lens = offs[1:] - offs[:-1]
        total = int(lens[idx].sum()) + 4 * len(idx)
        out = ctypes.create_string_buffer(max(total, 1))
        self._c.kpw_byte_array_gather(
            dict_data, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(idx), out)
        return out.raw[:total]

    # -- encoding primitives ----------------------------------------------
    def dict_build(self, keys, max_k: int | None = None):
        """Ascending bit-pattern dictionary + uint32 indices for a uint32 or
        uint64 key array (``core.encodings.dictionary_build`` semantics).
        Returns None when the unique count exceeds ``max_k`` (early abort:
        the dictionary would be rejected anyway)."""
        import numpy as np

        arr = np.ascontiguousarray(keys)
        n = len(arr)
        cap = n if max_k is None else min(n, max_k)
        idx = np.empty(n, np.uint32)
        dict_out = np.empty(cap, arr.dtype)
        k = ctypes.c_uint32(0)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        if arr.dtype.itemsize == 8:
            u64p = ctypes.POINTER(ctypes.c_uint64)
            rc = self._c.kpw_dict_build_u64(
                arr.ctypes.data_as(u64p), n, dict_out.ctypes.data_as(u64p),
                idx.ctypes.data_as(u32p), cap, ctypes.byref(k))
        else:
            rc = self._c.kpw_dict_build_u32(
                arr.ctypes.data_as(u32p), n, dict_out.ctypes.data_as(u32p),
                idx.ctypes.data_as(u32p), cap, ctypes.byref(k))
        if rc == 1:
            return None
        if rc != 0:
            raise RuntimeError(f"kpw_dict_build rc={rc}")
        return dict_out[: k.value].copy(), idx

    def dict_build_bytes(self, data: bytes, offsets, max_k: int | None = None):
        """Byte-array dictionary over a concatenated buffer + int64 offsets
        (n+1 entries).  Returns (uniq_pos int64 (k,), the index of each
        unique value's first occurrence in ascending lexicographic order,
        and idx uint32 (n,)), or None when uniques exceed ``max_k``."""
        import numpy as np

        offs = np.ascontiguousarray(offsets, np.int64)
        n = len(offs) - 1
        cap = n if max_k is None else min(n, max_k)
        uniq_pos = np.empty(max(cap, 1), np.int64)
        idx = np.empty(max(n, 1), np.uint32)
        k = ctypes.c_uint32(0)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        rc = self._c.kpw_dict_build_bytes(
            data, offs.ctypes.data_as(i64p), n,
            uniq_pos.ctypes.data_as(i64p), idx.ctypes.data_as(u32p),
            cap, ctypes.byref(k))
        if rc == 1:
            return None
        if rc != 0:
            raise RuntimeError(f"kpw_dict_build_bytes rc={rc}")
        return uniq_pos[: k.value].copy(), idx[:n]

    def int_stats(self, values) -> tuple[int, int, int] | None:
        """(min, max, gcd_of_offsets) of an int32/int64/uint32/uint64 array
        in one fused C++ pass.  gcd is gcd{v - min} (0 for a constant
        column).  Returns None for other dtypes and for an empty array."""
        import numpy as np

        v = np.ascontiguousarray(values)
        fn = {np.dtype(np.int64): ("kpw_int_stats_i64", ctypes.c_int64),
              np.dtype(np.int32): ("kpw_int_stats_i32", ctypes.c_int64),
              np.dtype(np.uint64): ("kpw_int_stats_u64", ctypes.c_uint64),
              np.dtype(np.uint32): ("kpw_int_stats_u32", ctypes.c_uint64),
              }.get(v.dtype)
        if fn is None or not len(v):
            return None
        name, slot = fn
        mn, mx, g = slot(0), slot(0), ctypes.c_uint64(0)
        getattr(self._c, name)(
            v.ctypes.data_as(ctypes.c_void_p), len(v),
            ctypes.byref(mn), ctypes.byref(mx), ctypes.byref(g))
        return mn.value, mx.value, g.value

    def bytes_min_max(self, data: bytes, offsets) -> tuple[int, int]:
        """(min_idx, max_idx) of the lexicographically smallest/largest
        value; offsets must have >= 2 entries (n >= 1)."""
        import numpy as np

        offs = np.ascontiguousarray(offsets, np.int64)
        mn = ctypes.c_size_t(0)
        mx = ctypes.c_size_t(0)
        self._c.kpw_bytes_min_max(
            data, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(offs) - 1, ctypes.byref(mn), ctypes.byref(mx))
        return mn.value, mx.value

    def delta_binary_packed(self, values, bit_size: int = 64) -> bytes:
        """DELTA_BINARY_PACKED stream, byte-identical to
        ``core.encodings.delta_binary_packed_encode``."""
        import numpy as np

        itype = np.int64 if bit_size == 64 else np.int32
        v = np.ascontiguousarray(values, itype)
        cap = self._c.kpw_delta_bp_cap(len(v))
        out = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(0)
        if bit_size == 64:
            rc = self._c.kpw_delta_bp64(
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(v),
                out, ctypes.byref(out_len))
        else:
            rc = self._c.kpw_delta_bp32(
                v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(v),
                out, ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"kpw_delta_bp rc={rc}")
        return out.raw[: out_len.value]

    def byte_stream_split(self, values) -> bytes:
        """BYTE_STREAM_SPLIT byte-plane transpose, byte-identical to
        ``core.encodings.byte_stream_split_encode`` (``values`` must already
        be a fixed-width ndarray in the column's PLAIN dtype)."""
        import numpy as np

        v = np.ascontiguousarray(values)
        n, width = len(v), v.dtype.itemsize
        if n == 0:
            return b""
        out = ctypes.create_string_buffer(n * width)
        rc = self._c.kpw_byte_stream_split(
            v.ctypes.data_as(ctypes.c_void_p), n, width, out)
        if rc != 0:
            raise RuntimeError(f"kpw_byte_stream_split rc={rc}")
        return out.raw[: n * width]

    def proto_shred(self, buf: bytes, rec_offsets, n_fields: int,
                    fnum, kinds, flags, out_vals, out_pos, out_len,
                    out_pres) -> int:
        """Batch wire-format decode (kpw_proto_shred).  ``out_*`` are lists
        (len n_fields) of numpy arrays or None; returns the first failing
        record index, or -1 when the whole batch decoded clean."""
        import numpy as np

        offs = np.ascontiguousarray(rec_offsets, np.int64)
        n_rec = len(offs) - 1

        def ptr_array(arrs):
            a = (ctypes.c_void_p * n_fields)()
            for i, arr in enumerate(arrs):
                a[i] = arr.ctypes.data if arr is not None else None
            return ctypes.cast(a, ctypes.POINTER(ctypes.c_void_p))

        rc = self._c.kpw_proto_shred(
            buf, offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_rec, n_fields,
            np.ascontiguousarray(fnum, np.uint32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint32)),
            bytes(np.ascontiguousarray(kinds, np.uint8)),
            bytes(np.ascontiguousarray(flags, np.uint8)),
            ptr_array(out_vals), ptr_array(out_pos), ptr_array(out_len),
            ptr_array(out_pres))
        if rc == -2:
            raise RuntimeError("kpw_proto_shred: field number table overflow")
        return rc

    def proto_shred_nested(self, buf: bytes, rec_offsets, plan):
        """Batch nested wire-format decode (kpw_proto_shred_nested).
        ``plan`` carries the node-table arrays (models.proto_bridge
        _NestedPlan).  Returns a :class:`NestedShredResult` on success or
        the failing record index (int) when the batch needs the Python
        fallback."""
        import numpy as np

        offs = np.ascontiguousarray(rec_offsets, np.int64)
        n_rec = len(offs) - 1
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        keep = []  # anchor temporaries across the C call

        def ip(a):
            arr = np.ascontiguousarray(a, np.int32)
            keep.append(arr)
            return arr.ctypes.data_as(i32p)

        fnum = np.ascontiguousarray(plan.fnum, np.uint32)
        keep.append(fnum)
        handle = ctypes.c_void_p()
        rc = self._c.kpw_proto_shred_nested(
            buf, offs.ctypes.data_as(i64p), n_rec,
            plan.n_nodes, plan.n_leaves,
            fnum.ctypes.data_as(u32p),
            bytes(np.ascontiguousarray(plan.kind, np.uint8)),
            bytes(np.ascontiguousarray(plan.flags, np.uint8)),
            ip(plan.child_begin), ip(plan.child_end), ip(plan.leaf_idx),
            ip(plan.ftab), ip(plan.ftab_off), ip(plan.max_fn),
            ip(plan.enum_vals), ip(plan.enum_off), ip(plan.enum_len),
            ip(plan.null_leaves), ip(plan.null_off), ip(plan.null_len),
            ctypes.byref(handle))
        del keep
        if rc >= 0:
            return int(rc)
        return NestedShredResult(self._c, handle)

    def gather_spans(self, src: bytes, pos, lens) -> bytes:
        """Concatenate spans (pos[i], lens[i]) of ``src`` — the string-column
        payload assembly after proto_shred."""
        import numpy as np

        p = np.ascontiguousarray(pos, np.int64)
        ln = np.ascontiguousarray(lens, np.int32)
        total = int(ln.sum(dtype=np.int64))
        out = ctypes.create_string_buffer(max(total, 1))
        self._c.kpw_gather_spans(
            src, p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(p), out)
        return out.raw[:total]

    def rle_hybrid(self, values, width: int) -> bytes:
        """RLE/bit-pack hybrid stream, byte-identical to
        ``core.encodings.rle_hybrid_encode``."""
        import numpy as np

        v = np.ascontiguousarray(values, np.uint32)
        cap = self._c.kpw_rle_hybrid_cap(len(v), width)
        out = ctypes.create_string_buffer(cap)
        out_len = ctypes.c_size_t(0)
        rc = self._c.kpw_rle_hybrid_u32(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(v), width,
            out, ctypes.byref(out_len))
        if rc != 0:
            raise RuntimeError(f"kpw_rle_hybrid rc={rc}")
        return out.raw[: out_len.value]


def _prefer_bundled_zstd() -> None:
    """Point the library's runtime zstd dispatch (``KPW_ZSTD_LIB``, read by
    codecs.cc) at the newest libzstd in the environment: the ``zstandard``
    package may bundle a newer build than the system's.  An operator-set
    value is respected; without ``zstandard`` nothing changes and the
    linked system libzstd serves."""
    if "KPW_ZSTD_LIB" in os.environ:
        return
    try:
        import glob

        import zstandard
    except ImportError:
        return
    try:
        system_ver = ctypes.CDLL("libzstd.so.1").ZSTD_versionNumber()
    except (OSError, AttributeError):
        system_ver = 0
    for so in glob.glob(os.path.join(os.path.dirname(zstandard.__file__),
                                     "_cffi*.so")):
        try:
            if ctypes.CDLL(so).ZSTD_versionNumber() > system_ver:
                os.environ["KPW_ZSTD_LIB"] = so
                return
        except (OSError, AttributeError):
            continue


def load() -> NativeLib:
    _prefer_bundled_zstd()
    return NativeLib(ctypes.CDLL(build_lib()))


def _load_extension(name: str, path: str):
    import importlib.machinery
    import importlib.util

    loader = importlib.machinery.ExtensionFileLoader(name, path)
    spec = importlib.util.spec_from_loader(name, loader, origin=path)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    return mod


def load_assemble():
    """The ``_kpw_torch_assemble`` extension module, built if needed."""
    return _load_extension(ASSEMBLE_NAME, build_assemble())


def load_pyshred():
    """The ``_kpw_torch_pyshred`` extension module, built if needed."""
    return _load_extension(PYSHRED_NAME, build_pyshred())
