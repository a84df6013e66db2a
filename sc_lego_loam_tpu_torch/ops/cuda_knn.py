"""Scan-to-map 5-NN and ICP 1-NN on the card: the hand-written CUDA kernel in
``csrc/knn.cu`` (the counterpart of ``sc_lego_loam_tpu/ops/pallas_knn.py``).

``make_knn`` is what the engine calls.  It routes by the device of the
tensors it is given: CUDA tensors go to the kernel, CPU tensors to the
plain version (``ops/knn.py``, same contract).  There is no other switch
and no fallback: on a CUDA tensor the kernel builds and launches, or the
call raises.

The kernel is compiled with ``nvcc`` into a plain-C shared library on
first use, in ``_build/`` next to the package and keyed by a hash of the
source, and loaded with ctypes.  ``launches[k]`` counts the kernel launches
of each instantiation (k=5: scan-to-map, k=1: ICP).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

from . import knn as plain
from .compact import compact_indices

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "knn.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
KS = (1, 5)                   # the K the library instantiates

launches = dict.fromkeys(KS, 0)   # kernel launches per k since the reset


def reset_launches():
    for k in KS:
        launches[k] = 0


_lib = None


class BuildInfo(NamedTuple):
    path: str
    seconds: float            # 0.0 when the library was already built
    log: str                  # nvcc's output (ptxas register report)


_build_info: BuildInfo | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return path


def build() -> BuildInfo:
    """Compile ``csrc/knn.cu`` (once per source hash) and load it."""
    global _lib, _build_info
    if _build_info is not None:
        return _build_info
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libknn_{tag}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{log}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    lib.knn_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.knn_launch.restype = ctypes.c_int
    lib.knn_error_string.argtypes = [ctypes.c_int]
    lib.knn_error_string.restype = ctypes.c_char_p
    _lib = lib
    _build_info = BuildInfo(out, seconds, log)
    return _build_info


class PreparedTargets(NamedTuple):
    """Loop-invariant target side: prefix-compacted targets, the valid
    count and the compacted-slot -> original-index map."""

    tgt: torch.Tensor    # (T,3) float32, valid targets first
    cnt: torch.Tensor    # (1,) int32 number of valid targets
    perm: torch.Tensor   # (T,) int64 compacted slot -> original index


def prepare_targets(target: torch.Tensor,
                    target_mask: torch.Tensor) -> PreparedTargets:
    """Prefix-compact the targets on the device (hoisted out of LM loops)."""
    T = target.shape[0]
    perm, ok = compact_indices(target_mask, T)
    tgt = torch.where(ok[:, None], target[perm], 0.0).contiguous()
    return PreparedTargets(tgt=tgt, cnt=ok.sum(dtype=torch.int32).reshape(1),
                           perm=perm)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def knn_prepared(query: torch.Tensor, prep: PreparedTargets, k: int,
                 max_sq_dist: float, qcnt: torch.Tensor | None = None):
    """Launch the kernel: query (Q,3) float32 on a CUDA device, ``qcnt``
    (1,) int32 on the same device (None: all Q rows live).
    Returns (idx (Q,k) int64, sqd (Q,k) float32)."""
    if k not in KS:
        raise ValueError(f"k={k}: the kernel is built for k in {KS}")
    dev = query.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kNN needs CUDA tensors, got {dev}")
    Q, T = query.shape[0], prep.tgt.shape[0]
    if qcnt is None:
        qcnt = torch.full((1,), Q, dtype=torch.int32, device=dev)
    _check("query", query, torch.float32, (Q, 3), dev)
    _check("targets", prep.tgt, torch.float32, (T, 3), dev)
    _check("target count", prep.cnt, torch.int32, (1,), dev)
    _check("perm", prep.perm, torch.int64, (T,), dev)
    _check("qcnt", qcnt, torch.int32, (1,), dev)
    build()
    idx = torch.empty((Q, k), dtype=torch.int64, device=dev)
    sqd = torch.empty((Q, k), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib.knn_launch(query.data_ptr(), prep.tgt.data_ptr(),
                          prep.perm.data_ptr(), prep.cnt.data_ptr(),
                          qcnt.data_ptr(), Q, k, float(max_sq_dist),
                          idx.data_ptr(), sqd.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("knn kernel launch failed: "
                           + _lib.knn_error_string(err).decode())
    launches[k] += 1
    return idx, sqd


def make_knn(target: torch.Tensor, target_mask: torch.Tensor, k: int,
             max_sq_dist: float):
    """k-NN closure ``knn(q, qcnt) -> (idx, sqd)`` over a fixed target set,
    with the target prep hoisted: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if target.device.type == "cuda":
        prep = prepare_targets(target, target_mask)
        return lambda q, qcnt=None: knn_prepared(q, prep, k, max_sq_dist,
                                                 qcnt)
    return lambda q, qcnt=None: plain.knn(q, target, target_mask, k,
                                          max_sq_dist, qcnt)
