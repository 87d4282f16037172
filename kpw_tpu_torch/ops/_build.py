"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
which the op modules load with ctypes.  Libraries land in
``kpw_tpu_torch/_build/`` under a name that carries a hash of the source and
the flags, so an edited source rebuilds and a stale library is never
loaded.  The build runs at first use — the first launch of a kernel on a
CUDA tensor — or up front through :func:`build`, which starts one ``nvcc``
per source, all at once.  Builds hold an ``fcntl.flock`` on
``_build/cuda.lock``, so that processes sharing the checkout (process
workers, parallel test workers) compile each source once: the others wait
and then load the finished library.  Nothing here runs at import time: a
machine without the CUDA toolkit can import every module.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
SOURCES = ("bitpack", "hist", "rank", "delta")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> str:
    """Where source ``csrc/<name>.cu`` builds to, keyed by its content."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build_locked(names) -> dict[str, float]:
    """Build ``names`` under the thread lock (held by the caller) and the
    cross-process file lock: a process that waited finds the libraries
    built and compiles nothing, so no two builds write one log."""
    if all(os.path.exists(library_path(n)) for n in names):
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "cuda.lock"), "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        return _compile([n for n in names if not os.path.exists(library_path(n))])


def _compile(todo) -> dict[str, float]:
    if not todo:
        return {}
    nvcc = nvcc_path()
    running = []
    for name in todo:
        so = library_path(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        log_path = os.path.join(BUILD_DIR, f"{name}.log")
        log = open(log_path, "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
        running.append((name, so, tmp, log, log_path, proc, time.perf_counter()))
    seconds: dict[str, float] = {}
    failed = []
    for name, so, tmp, log, log_path, proc, t0 in running:
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc:
            with open(log_path) as f:
                failed.append(f"{name}.cu (nvcc exit {rc}):\n{f.read()}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return seconds


def build(names=SOURCES) -> dict[str, float]:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` process per source, all running together.  Returns the seconds
    each build took (empty when everything was already built); raises with
    the compiler's output when a build fails.  ``_build/<name>.log`` keeps
    each build's output, register and shared-memory use included."""
    with _lock:
        return _build_locked(names)


def function(name: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of library ``name``, built if needed, with
    its argument types set (``c_void_p`` for every pointer and the stream:
    without them ctypes passes 32-bit ints and cuts pointers)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _build_locked((name,))
            lib = _libs[name] = ctypes.CDLL(library_path(name))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
