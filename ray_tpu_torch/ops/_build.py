"""Build the port's CUDA kernels and bind them with ctypes.

Every `csrc/<name>.cu` compiles with nvcc for Hopper (`sm_90a`) into a
shared library with a plain C interface, `build/ray_tpu_torch/lib<name>-
<hash>.so` under the repository root.  The hash is of the source and of
the shared headers (`csrc/*.cuh`), so an edited kernel rebuilds and an
unchanged one is reused.  Building happens at
first use, from the sources in this package only; nothing is imported or
compiled when the module is imported.

Wrappers pass pointers as `c_void_p` (`tensor.data_ptr()`) and the stream
as `torch.cuda.current_stream().cuda_stream`.  Each C entry point returns
the launch's `cudaGetLastError()`; `check()` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _target(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of the source, the
    shared headers (csrc/*.cuh) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every named source (default: all of csrc/*.cu) that has no
    up-to-date library yet, one nvcc per source, all started together.
    Returns {name: compiler output}; raises with nvcc's output on failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with _lock:
        todo = [n for n in names if not _target(n).exists()]
        if not todo:
            return {n: _logs.get(n, "(cached)") for n in names}
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            _logs[n] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{n}.cu "
                              f"(exit {proc.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _target(n))
        if failed:
            raise RuntimeError("\n".join(failed))
        return {n: _logs.get(n, "(cached)") for n in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu's library, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                lib.rtt_cuda_error_string.argtypes = [ctypes.c_int]
                lib.rtt_cuda_error_string.restype = ctypes.c_char_p
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib.rtt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
