"""Lazy ``nvcc`` build of the port's CUDA kernels into one shared library.

The sources under ``repro_torch/csrc/`` have a plain C interface (pointers,
ints and the stream in, ``cudaError_t`` out), so they compile with ``nvcc``
alone, without PyTorch's headers, and load with ``ctypes``. Each ``.cu``
compiles to an object in its own ``nvcc`` process, all started together,
and the objects link into ``build/repro_torch/<hash>/librepro_kernels.so``
at the repository root. The hash covers the sources and the flags, so a
changed source builds anew and an unchanged one loads the library already
built. Nothing builds on import: the first kernel launch on a CUDA tensor
calls ``library()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_kernels.so"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# C signature of every entry point, checked by ctypes on each call
SIGNATURES = {
    "repro_exit_decision": (_P, _I, _I, _I, _LL, _I, _I, _P, _P, _P, _F, _P,
                            _P, _P, _P),
    "repro_gather_compact": (_P, _P, _I, _LL, _I, _P, _P, _P, _P, _P),
    "repro_scatter_merge": (_P, _I, _P, _P, _LL, _P),
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels build on first use on a "
            "machine with the CUDA toolkit")
    return found


def _compile(out_dir: Path) -> Path:
    """Compile every .cu in parallel, link one .so, return its path."""
    nvcc = nvcc_path()
    procs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    objs, errors = [], []
    for cmd, obj, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out.decode(errors='replace')}")
        objs.append(str(obj))
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    lib = out_dir / LIB_NAME
    link = [nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(lib)]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n$ {' '.join(link)}\n"
                           f"{res.stdout.decode(errors='replace')}")
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _lib
    if _lib is not None:
        return _lib
    target = BUILD_ROOT / source_hash()
    lib_path = target / LIB_NAME
    if not lib_path.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        # build in a private directory, then rename it into place: a
        # concurrent build of the same hash finds either nothing or a
        # complete library
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
        try:
            _compile(tmp)
            try:
                tmp.rename(target)
            except OSError:
                if not lib_path.exists():
                    raise
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def require_cuda(t, what: str) -> None:
    """A kernel wrapper takes CUDA tensors only; the plain version serves
    the CPU (see ``kernels/dispatch.py``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors, got "
                         f"one on {t.device}")


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the C entry points
    take."""
    import torch
    return torch.cuda.current_stream().cuda_stream
