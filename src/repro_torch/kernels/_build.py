"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C entry points. It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library and loaded with
``ctypes``: a build of a few seconds, where an extension that includes
PyTorch's headers takes minutes. The library is named after a hash of
its source and flags, so an edited source rebuilds at first use and an
unchanged one is loaded as it is.

Pointers and the stream go to C as ``c_void_p``; every entry returns
``cudaGetLastError()`` and ``check`` raises on anything but 0 (a launch
refused for its shared memory or block size never runs, and no later
synchronise would report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/repro_torch_kernels (listed in .gitignore)
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong

# C signature of every entry point, by source file
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "gmm_loglik": {
        # x, const, lin, P_flat, out, F, C, D, device, stream
        "gmm_loglik_f32": (PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                           PTR),
    },
    "gmm_rescore": {
        # x, sel, A, out, F, K, D, E, device, stream
        "gmm_rescore_f32": (PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT,
                            PTR),
    },
    "packed_matmul": {
        # a, b, out, M, K, N, a_stride_m, a_stride_k, device, stream
        "packed_matmul_f32": (PTR, PTR, PTR, INT, INT, INT, I64, I64, INT,
                              PTR),
        "packed_matmul_bf16": (PTR, PTR, PTR, INT, INT, INT, I64, I64, INT,
                               PTR),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library is built; returns
    (process or None, final path, temporary path)."""
    out = library_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: Path, tmp) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or none


def build_all() -> None:
    """Build every kernel library, one nvcc per source, all at once."""
    started = {n: _start(n) for n in SIGNATURES}
    for n, (proc, out, tmp) in started.items():
        _finish(n, proc, out, tmp)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, *_start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def launch_args(t: torch.Tensor):
    """(device index, PyTorch's current stream on it) for a launch: the
    kernels run on the caller's stream and never synchronise."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
