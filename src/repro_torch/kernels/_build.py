"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C entry points. It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library and loaded with
``ctypes``: a build of a few seconds, where an extension that includes
PyTorch's headers takes minutes. The library is named after a hash of
its source, the ``csrc/`` headers it includes and the flags, so an edited
source or header rebuilds at first use and an unchanged one is loaded as
it is.

Pointers and the stream go to C as ``c_void_p``; every entry returns
``cudaGetLastError()`` and ``check`` raises on anything but 0 (a launch
refused for its shared memory or block size never runs, and no later
synchronise would report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# <checkout>/build/repro_torch_kernels (listed in .gitignore)
BUILD_DIR = (Path(__file__).resolve().parents[3] / "build"
             / "repro_torch_kernels")
# -Xptxas -v: ptxas reports each kernel's registers and spills into the
# build's log (``build_log``), so that no second compile is needed to read
# them
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR = ctypes.c_void_p
INT = ctypes.c_int
I64 = ctypes.c_longlong

# C signature of every entry point, by source file
SIGNATURES: Dict[str, Dict[str, Sequence]] = {
    "bw_stats": {
        # gamma, x, pair table, partial sums, flags, frame lists, counts
        # (the last three NULL: every frame), n, f, S, F, Fp, C, D, Ep,
        # nsplit, device, stream
        "bw_stats_f32": (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                         INT, INT, INT, INT, INT, INT, INT, PTR),
        # D, out[5]: pairs form?, a block's shared-memory bytes, its
        # components, the columns, blocks an SM
        "bw_stats_geometry": (INT, PTR),
    },
    "flash_attention": {
        # q, k, v, o, lse (or NULL), the staging scratch (or NULL), B, S,
        # H, KVH, hd, o's column slices (0: the default), device, stream
        "flash_attention_f32": (PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                INT, INT, INT, INT, PTR),
        # the same without the slices
        "flash_attention_bf16": (PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                 INT, INT, INT, PTR),
        # bf16?, head dim, out[4]: route, width, query rows, shared memory
        "flash_attention_geometry": (INT, INT, PTR),
    },
    "flash_attention_bwd": {
        # q, k, v, o, lse, dout, dq, dk, dv, delta scratch, the dK/dV
        # workspace and the staging scratch (or NULL), B, S, H, KVH, hd,
        # the dK/dV pass's splits, device, stream
        "flash_attention_bwd_f32": (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                    PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                    INT, INT, INT, PTR),
        # the same
        "flash_attention_bwd_bf16": (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR,
                                     PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                                     INT, INT, INT, PTR),
        # bf16?, head dim, out[4]: route, width, key rows of a dK/dV block,
        # its shared memory
        "flash_attention_bwd_geometry": (INT, INT, PTR),
    },
    "gmm_align": {
        # x, dconst, dlin, dquad, A2, pair table (gmm_align.pair_table, or
        # NULL), spill scratch (gmm_align.spill_words, or NULL), ll, sel, F,
        # C, D, K, E2, device, stream
        "gmm_align_f32": (PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT,
                          INT, INT, INT, INT, INT, PTR),
        # x, sel, A2, pair table (or NULL), ll, F, C, D, K, E2, device,
        # stream
        "gmm_rescore_fused_f32": (PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                  INT, INT, INT, PTR),
        # C, D, K, rescore alone, out[5]
        "gmm_align_geometry": (INT, INT, INT, INT, PTR),
        # device, out[1]: the card's shared memory a block may opt in to
        "device_smem_optin": (INT, PTR),
    },
    "gmm_loglik": {
        # x, W (gmm_loglik.packed_weights, or row_weights for the rows
        # form), const (the rows form's; NULL for the narrow form), out, F,
        # C, D, W's positions, Cp, device, stream
        "gmm_loglik_f32": (PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
                           PTR),
        # D, out[4]: frames a block, rows form?, shared-memory bytes, the
        # rows form's W positions
        "gmm_loglik_geometry": (INT, PTR),
        # P_flat, lin, the position tables (first, second, factor), Wr, C,
        # Cp, D, K, device, stream
        "gmm_loglik_pack_f32": (PTR, PTR, PTR, PTR, PTR, PTR, INT, INT, INT,
                                INT, INT, PTR),
    },
    "gmm_rescore": {
        # x, sel, A, out, scratch, F, K, C, D, E, then the geometry
        # (max_items, scratch_words, smem, strip), device, stream
        "gmm_rescore_f32": (PTR, PTR, PTR, PTR, PTR, INT, INT, INT, INT,
                            INT, I64, I64, I64, I64, INT, PTR),
        # F, K, C, D, out[6]
        "gmm_rescore_geometry": (I64, I64, I64, INT, PTR),
    },
    "packed_matmul": {
        # a, b, out, M, K, N, a_stride_m, a_stride_k, b_row_stride, form
        # (tvm_estep.FORMS), device, stream
        "packed_matmul_f32": (PTR, PTR, PTR, INT, INT, INT, I64, I64, I64,
                              INT, INT, PTR),
        "packed_matmul_bf16": (PTR, PTR, PTR, INT, INT, INT, I64, I64, I64,
                               INT, INT, PTR),
    },
    "selective_scan": {
        # dt, dx, A, Bc, Cc, h0 (or NULL), y, the other state groups'
        # partial y (NULL up to 64 states, else [groups - 1, B, T, di]),
        # h_last, hs (or NULL), B, T, di, ds, form (selective_scan.FORMS),
        # device, stream
        "selective_scan_f32": (PTR,) * 10 + (INT,) * 6 + (PTR,),
        # d_state -> lanes a channel
        "selective_scan_lanes": (INT,),
        # d_state, out[5]: the instance, its groups and its tree geometry
        "selective_scan_geometry": (INT, PTR),
    },
    "selective_scan_bwd": {
        # dt, dx, A, Bc, Cc, hs, dy, dh_last (or NULL), ddt, ddx, the other
        # state groups' partial d(dt) and d(dx) (NULL up to 64 states, else
        # [groups - 1, 2, B, T, di]), lcarry, decay, dA_part, dB_part,
        # dC_part, dA, dB, dC, dh0 (or NULL), B, T, di, ds, seg_chunks,
        # form, device, stream
        "selective_scan_bwd_f32": (PTR,) * 20 + (INT,) * 7 + (PTR,),
        # d_state, out[5]: the instance, its groups and its backward
        # geometry
        "selective_scan_bwd_geometry": (INT, PTR),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    return str(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
               / "bin" / "nvcc")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def includes(name: str) -> list:
    """The ``csrc/`` headers that ``csrc/<name>.cu`` includes, directly or
    through another header, sorted."""
    found, todo = set(), [CSRC / f"{name}.cu"]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            header = inc.decode()
            if header not in found:
                found.add(header)
                todo.append(CSRC / header)
    return sorted(found)


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in includes(name):
        h.update(header.encode() + b"\0" + (CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str) -> Path:
    """nvcc's output for the library of ``csrc/<name>.cu`` (ptxas' report
    of each kernel), written beside it when it is built."""
    return library_path(name).with_suffix(".log")


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
    out.with_suffix(".log").write_text(log)
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


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary (a view into a larger tensor): kernels that read rows with
    16-byte copies take their operands through this."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous tensors on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
