"""Build and load the port's CUDA kernels.

``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together) and linked into one shared library with a
plain C interface, loaded with ``ctypes``. The library is built at first use
into ``_build/`` beside this file (listed in ``.gitignore``), named by a
digest of the sources, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import: the CPU tests import every
module of the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_ln.cu", "select.cu", "flash_attention.cu", "flash_attention_train.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def source_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libvar_tpu_torch_kernels_{source_digest()}.so"


def build() -> tuple:
    """Compile the kernels if the library for these sources is missing.
    Returns (library path, compiler log, seconds spent building)."""
    so = library_path()
    if so.exists():
        return so, "", 0.0
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        procs = []
        for src in SOURCES:
            obj = tmp / f"{src}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, proc in procs:  # wait for every compiler before judging
            out, _ = proc.communicate()
            logs.append(f"== nvcc {src} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_so = tmp / "lib.so"
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp_so),
                               *[str(obj) for _, obj, _ in procs]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)  # atomic: a concurrent builder sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return so, log, time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so, _, _ = build()
        cdll = ctypes.CDLL(str(so))
        P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        cdll.var_modulated_layernorm.argtypes = [P, P, P, P, LL, I, I, LL, LL, F, I, I, P]
        cdll.var_topk_topp_bound.argtypes = [P, P, LL, I, I, F, I, P]
        cdll.var_decode_attention.argtypes = [P, LL, LL, P, P, LL, LL, P, LL, LL, P,
                                              I, I, I, I, I, F, I, I, P]
        ENDS = ctypes.POINTER(ctypes.c_int)
        cdll.var_ptrain_fwd.argtypes = [P, P, P, P, P, I, I, I, I, I, ENDS, I, I, I, P]
        cdll.var_ptrain_bwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, ENDS, I, I,
                                        I, P]
        for fn in (cdll.var_modulated_layernorm, cdll.var_topk_topp_bound,
                   cdll.var_decode_attention, cdll.var_ptrain_fwd, cdll.var_ptrain_bwd):
            fn.restype = I
        cdll.var_cuda_error_string.argtypes = [I]
        cdll.var_cuda_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launch function reported a CUDA error (its return value is
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        msg = lib().var_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
