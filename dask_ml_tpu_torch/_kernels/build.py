"""Build and load the port's hand-written CUDA kernels, and its host C
libraries.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``_build/<name>-<hash>.so`` beside this file (the hash covers the source
and the flags, so an edited source rebuilds) and loaded with ``ctypes``.
No PyTorch header is compiled, which keeps a build to seconds. Nothing is
compiled or loaded when this module is imported: the CPU tests import
every module of the port on machines without ``nvcc``.

A ``csrc/<name>.c`` (:data:`HOST_SOURCES`: the wire's CRC-32C engine) is
host code, built the same way with the host C compiler (``cc -O3 -shared
-fPIC``) instead of ``nvcc``, so it builds and loads on a machine without
a card too. Its entry points run without the library lock: they touch no
device state, and ``ctypes`` releases the GIL around them.

Every pointer argument and the stream are declared ``c_void_p``, every
C entry point returns ``cudaGetLastError()``, and :func:`check` turns a
non-zero code into an exception. A library's entry points run one at a
time (a lock per library): a launch first sets its kernel's
dynamic-shared-memory attribute to what this launch needs, and that
attribute belongs to the kernel, not to the calling thread, so another
thread's launch of the same kernel between the two would fail with an
invalid-value error (the search driver launches from several threads;
``spmv``'s plans only ever raise a kernel's attribute, once, and keep
what they asked the driver).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
CC_FLAGS = ["-std=c99", "-O3", "-shared", "-fPIC"]
#: libraries built from ``csrc/<name>.c`` with the host C compiler
HOST_SOURCES = frozenset({"crc32c"})
#: entry points that set no kernel attribute, called without the
#: library's lock (the L2 forward: at the served shapes a launch's host
#: work is most of a call)
UNLOCKED = frozenset({"dml_spmv"})

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32, _SZ = ctypes.c_uint32, ctypes.c_size_t
# C signatures: name -> {function: (argtypes, restype)}
SIGNATURES = {
    "crc32c": {
        "dml_crc32c_init": ([], None),
        "dml_crc32c_update": ([_U32, _P, _SZ], _U32),
    },
    "fused_distance": {
        "dml_fused_rows_per_block": ([], _I),
        "dml_fused_distance": (
            [_I, _P, _I, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
             _P, _P, _P],
            _I),
    },
    "lloyd": {
        "dml_lloyd_max_partials": ([], _I),
        "dml_lloyd_supported": ([_I, _I, _I], _I),
        "dml_lloyd_iter": ([_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _P], _I),
    },
    "spmv": {
        "dml_spmv_lanes": ([_I], _I),
        "dml_spmv_tile_rows": ([_I], _I),
        "dml_spmv": ([_P, _I, _P, _P, _L, _I, _P, _P], _I),
        "dml_spmv_smem": (
            [_P, _I, _P, _P, _L, _I, _I, _I, _P, _P, _P], _I),
        "dml_spmv_pullback_clusters": ([_L, _I, _I, _I, _I], _I),
        "dml_spmv_absmax": ([_P, _I, _L, _P, _P], _I),
        "dml_spmv_pullback_smem": (
            [_P, _I, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P],
            _I),
        "dml_spmv_pullback_rings": ([_P, _I, _P, _P, _I, _I, _I], _I),
        "dml_spmv_pullback_atomic": (
            [_P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P], _I),
    },
}

_libs: dict = {}
_lock = threading.Lock()

#: nvcc compilations this process started (and their wall seconds), the
#: host C compilations (``cc``), and the libraries it loaded (and the
#: seconds of each first load): a search reads them around each rung, the
#: serving loop around its warmup, to show that no kernel is built or
#: loaded once traffic runs
builds = {"nvcc": 0, "nvcc_seconds": 0.0, "cc": 0, "cc_seconds": 0.0,
          "loads": 0, "load_seconds": 0.0}
_builds_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (searched PATH, $CUDA_HOME and /usr/local/cuda); "
        "the port's CUDA kernels are built at first use on the card's "
        "machine")


def _cc() -> str:
    for name in (os.environ.get("CC"), "cc", "gcc", "clang"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no host C compiler found (searched $CC, cc, gcc, clang on PATH); "
        "the port's host C libraries are built at first use")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.c" if name in HOST_SOURCES else f"{name}.cu")


def _target(name: str) -> Path:
    flags = CC_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    src = _source(name).read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build_all(names=None, verbose: bool = False) -> float:
    """Compile every missing library, one compiler process per source (``cc``
    for :data:`HOST_SOURCES`, ``nvcc`` for the rest), all started
    together. Returns the wall seconds spent. Raises with the compiler's
    output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in todo:
            host = name in HOST_SOURCES
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            if host:
                cmd = [_cc(), *CC_FLAGS]
            else:
                cmd = [_nvcc(), *NVCC_FLAGS]
                if verbose:
                    cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(_source(name))]
            with _builds_lock:
                builds["cc" if host else "nvcc"] += 1
            procs.append((name, host, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for name, host, out, tmp, proc in procs:
            log, _ = proc.communicate()
            text = log.decode(errors="replace")
            what = f"{'cc' if host else 'nvcc'} {_source(name).name}"
            if proc.returncode != 0:
                failures.append(f"{what} failed:\n{text}")
                tmp.unlink(missing_ok=True)
                continue
            if verbose and text.strip():
                print(f"[{what}]\n{text}", flush=True)
            os.replace(tmp, out)
        dt = time.perf_counter() - t0
        with _builds_lock:
            # the compilers run together: a batch's wall counts once, as
            # nvcc's when it ran any nvcc (the longer by far), else cc's
            if any(not host for _, host, *_ in procs):
                builds["nvcc_seconds"] += dt
            else:
                builds["cc_seconds"] += dt
        if failures:
            raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


class Library:
    """A loaded library: each entry point of ``SIGNATURES[name]`` as an
    attribute, called under the library's lock (but those of
    :data:`UNLOCKED`); ``cdll`` is the ``ctypes`` handle."""

    def __init__(self, name: str, cdll: ctypes.CDLL):
        self.cdll = cdll
        lock = threading.Lock()
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = restype
            setattr(self, fn, f if name in HOST_SOURCES or fn in UNLOCKED
                    else self._serialized(f, lock))

    @staticmethod
    def _serialized(f, lock):
        def call(*args):
            with lock:
                return f(*args)

        return call


def load(name: str) -> Library:
    """The loaded library ``name`` (built first if needed), with
    ``argtypes``/``restype`` set for every entry point."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _target(name)
            if not path.exists():
                build_all([name])
            t0 = time.perf_counter()
            lib = Library(name, ctypes.CDLL(str(path)))
            init = getattr(lib, f"dml_{name}_init", None)
            if init is not None:
                init()
            _libs[name] = lib
            with _builds_lock:
                builds["loads"] += 1
                builds["load_seconds"] += time.perf_counter() - t0
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(
            f"{what}: CUDA error {code} at launch (cudaGetLastError)")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device (a
    CUDA tensor), without making a ``torch.cuda.Stream`` object: at the
    served shapes a launch's host work is most of a call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.get_device())
