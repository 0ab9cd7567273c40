"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

The sources under ``repro_torch/csrc/`` have a plain C interface (pointers,
sizes and the stream in, ``cudaGetLastError()`` out), so they need none of
PyTorch's headers: each ``.cu`` compiles in seconds.  All sources are
compiled at once, one ``nvcc`` process each, then linked into one shared
library named by a hash of the sources and flags.  The library lands in
``build/repro_torch/`` at the repository root (listed in ``.gitignore``) and
is built at first use, never at import.
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("gas_gather_combine.cu", "gas_scatter_reschedule.cu",
           "segment_sum_sorted.cu", "embedding_bag.cu", "flash_attention.cu",
           "flash_attention_sm90.cu")
HEADERS = ("row_reduce.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_int64, ctypes.c_float
# C signatures: every pointer and the stream as c_void_p (a 64-bit value).
SIGNATURES = {
    # feat, w, snd, row_ids, row_seg, seg_beg, seg_row, block_active,
    # tile_beg, tile_end, multi_rows, partial, out, n_rows, row_block,
    # n_tiles, n_partial, n_multi, tile_cap, tile_segs, stream
    "gas_gather_combine": (_P,) * 13 + (_I,) * 7 + (_P,),
    # feat, w, snd, row_ids, row_seg, seg_beg, seg_row, block_active, items,
    # multi_rows, partial, counter, out, n_rows, n_seg, d, row_block,
    # n_items, n_multi, stage_floats, copy, stream
    "gas_gather_combine_cols": (_P,) * 13 + (_I,) * 8 + (_P,),
    # contrib, prio, consume, w, snd, row_ids, row_seg, seg_beg, seg_row,
    # tile_beg, tile_end, multi_rows, partial, out, n_rows, n_tiles,
    # n_partial, n_multi, tile_cap, tile_segs, stream
    "gas_scatter_reschedule": (_P,) * 14 + (_I,) * 6 + (_P,),
    # msgs, row_ids, row_seg, seg_beg, seg_row, tile_beg, tile_end,
    # multi_rows, partial, out, n_rows, n_listed, n_seg, d, f64, n_tiles,
    # n_partial, n_multi, chunk, tile_segs, stream
    "segment_sum_sorted": (_P,) * 10 + (_I,) * 10 + (_P,),
    # table, ids, out, n_bags, bag, d, rows, fields, bf16, vec_ok, stream
    "embedding_bag": (_P,) * 3 + (_L, _I, _I, _L) + (_I,) * 3 + (_P,),
    # q, k, v, out, B, S, T, H, KV, d, causal, window, scale, bf16, stream
    "flash_attention": (_P,) * 4 + (_I,) * 8 + (_F, _I, _P),
}

_lib: Optional[ctypes.CDLL] = None
#: ptxas's report (registers, spills) of the build this process made
build_log = ""


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "",
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compiles and links the kernels unless this exact build exists."""
    global build_log
    lib_path = BUILD_DIR / f"librepro_torch_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                failed.append(name)
        build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", *objs, "-ldl", "-o",
             str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raises on a nonzero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def require(name: str, t, dtype, device, shape=None) -> None:
    """Raises unless ``t`` is a contiguous ``dtype`` tensor on ``device``
    (a CUDA device) with ``shape`` (None entries match any size)."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, "
                         f"got {tuple(t.shape)}")


def require_segments(seg, device) -> None:
    """Raises unless the segment tables ``seg`` (a ``csr.RowSegments``)
    are int32 tensors on ``device`` of consistent sizes."""
    require("row_ids", seg.row_ids, torch.int32, device, (seg.n_listed,))
    require("row_seg", seg.row_seg, torch.int32, device, (seg.n_listed + 1,))
    require("seg_beg", seg.seg_beg, torch.int32, device,
            (seg.n_segments + 1,))
    require("seg_row", seg.seg_row, torch.int32, device, (seg.n_segments,))


def require_edges(name: str, t, seg) -> None:
    """Raises unless the per-edge array ``t`` covers every edge the segment
    tables ``seg`` read (the kernels index it up to ``seg.n_edges``)."""
    if t.shape[0] < seg.n_edges:
        raise ValueError(f"{name}: {t.shape[0]} rows for {seg.n_edges} "
                         f"edges")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the C functions take it."""
    return torch.cuda.current_stream(device).cuda_stream
