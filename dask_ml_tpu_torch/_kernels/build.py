"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``_build/<name>-<hash>.so`` beside this file (the hash covers the source
and the flags, so an edited source rebuilds) and loaded with ``ctypes``.
No PyTorch header is compiled, which keeps a build to seconds. Nothing is
compiled or loaded when this module is imported: the CPU tests import
every module of the port on machines without ``nvcc``.

Every pointer argument and the stream are declared ``c_void_p``, every
C entry point returns ``cudaGetLastError()``, and :func:`check` turns a
non-zero code into an exception. A library's entry points run one at a
time (a lock per library): a launch first sets its kernel's
dynamic-shared-memory attribute to what this launch needs, and that
attribute belongs to the kernel, not to the calling thread, so another
thread's launch of the same kernel between the two would fail with an
invalid-value error (the search driver launches from several threads).
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: name -> {function: (argtypes, restype)}
SIGNATURES = {
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
            [_P, _I, _P, _P, _L, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
            _I),
        "dml_spmv_pullback_atomic": (
            [_P, _I, _P, _P, _L, _I, _I, _P, _P, _P, _P, _P], _I),
    },
}

_libs: dict = {}
_lock = threading.Lock()

#: nvcc compilations this process started (and their wall seconds), and
#: the kernel libraries it loaded (and the seconds of each first load): a
#: search reads them around each rung, the serving loop around its
#: warmup, to show that no kernel is built or loaded once traffic runs
builds = {"nvcc": 0, "nvcc_seconds": 0.0, "loads": 0, "load_seconds": 0.0}
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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:16]}.so"


def build_all(names=None, verbose: bool = False) -> float:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns the wall seconds spent. Raises with the compiler's
    output if any build fails."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [(n, _target(n)) for n in names if not _target(n).exists()]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        with _builds_lock:
            builds["nvcc"] += len(todo)
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            cmd += ["-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            text = log.decode(errors="replace")
            if proc.returncode != 0:
                failures.append(f"nvcc {name}.cu failed:\n{text}")
                tmp.unlink(missing_ok=True)
                continue
            if verbose and text.strip():
                print(f"[nvcc {name}.cu]\n{text}", flush=True)
            os.replace(tmp, out)
        with _builds_lock:
            builds["nvcc_seconds"] += time.perf_counter() - t0
        if failures:
            raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


class Library:
    """A loaded library: each entry point of ``SIGNATURES[name]`` as an
    attribute, called under the library's lock; ``cdll`` is the
    ``ctypes`` handle."""

    def __init__(self, name: str, cdll: ctypes.CDLL):
        self.cdll = cdll
        lock = threading.Lock()
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = restype
            setattr(self, fn, self._serialized(f, lock))

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
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
