"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles, on first use, into its own shared library
with a plain C interface (``-gencode arch=compute_90a,code=sm_90a``), under
``maskplanner_tpu_torch/_build/`` (git-ignored). The file name carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is rebuilt and a stale library is never loaded. :func:`build_all` starts one ``nvcc`` per source,
all at once. A failed build raises with ``nvcc``'s output.

Pointers and the stream are passed as ``ctypes.c_void_p`` (a plain int would
be cut to 32 bits). Every C entry point returns ``cudaGetLastError()`` after
its launch; :func:`check` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def _sources() -> list[str]:
    return sorted(n[:-3] for n in os.listdir(SRC_DIR) if n.endswith(".cu"))


def _lib_path(name: str, defines: tuple = ()) -> str:
    h = hashlib.sha256()
    # the source and every shared header of csrc/ (included or not)
    headers = sorted(n for n in os.listdir(SRC_DIR) if n.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(SRC_DIR, fname), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS + defines).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all(variants: dict | None = None) -> dict[str, str]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, one
    ``nvcc`` process per source, concurrently. Returns ``{name: path}``.
    ``variants`` instead builds ``{key: (source name, (-D flags...))}``,
    copies of a source under other macro settings (timing studies)."""
    jobs = variants or {name: (name, ()) for name in _sources()}
    with _lock:
        os.makedirs(BUILD_DIR, exist_ok=True)
        paths = {key: _lib_path(name, defines)
                 for key, (name, defines) in jobs.items()}
        todo = {n: p for n, p in paths.items() if not os.path.isfile(p)}
        if not todo:
            return paths
        nvcc = _nvcc()
        procs = {}
        for key, path in todo.items():
            name, defines = jobs[key]
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", tmp,
                   os.path.join(SRC_DIR, f"{name}.cu")]
            procs[key] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu "
                              f"(exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        with _lock:
            lib = _libs.setdefault(name, ctypes.CDLL(path))
    return lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
