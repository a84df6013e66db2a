"""Scan-to-map 5-NN and ICP 1-NN on the card: the hand-written CUDA kernel in
``csrc/knn.cu`` (the counterpart of ``sc_lego_loam_tpu/ops/pallas_knn.py``).

``make_knn`` is what the engine calls.  It prepares the targets and calls
the custom op ``sc_lego_loam_tpu_torch::knn``, which routes by the device
of the tensors it is given: CUDA tensors go to the kernel, CPU tensors to
the plain version (``ops/knn.py``, same contract).  There is no other
switch and no fallback: on a CUDA tensor the kernel builds and launches,
or the call raises.

The op has a batch axis, as ``jax.vmap`` gives the Pallas kernel a grid
axis: under ``torch.func.vmap`` its batching rule moves the vmapped
dimension to the front and makes ONE call over all B items (one launch of
each kernel on the card; on the CPU the plain version item by item).  The
outputs equal B separate calls in every slot.

The kernel is compiled with ``nvcc`` into a plain-C shared library on
first use, in ``_build/`` next to the package and keyed by a hash of the
sources, and loaded with ctypes.  The library is every ``csrc/*.cu`` in one
``nvcc`` call (``ops/symeig.py`` launches the other kernel in it).  One
call is two device kernels on the current stream: ``knn_partial`` on a
grid of query tiles x target splits, and ``knn_merge``, which merges the
splits' partial lists exactly.  The
number of splits S is chosen here from the static shapes (``plan``); the
outputs and the (B,S,k,Q) scratch are allocated here, nothing in the C
call.  ``launches[k]`` counts the calls of each instantiation (k=5:
scan-to-map, k=1: ICP); a batched call counts once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from typing import NamedTuple

import torch

from . import knn as plain
from .compact import compact_indices

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = tuple(sorted(glob.glob(os.path.join(_PKG, "csrc", "*.cu"))))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]
KS = (1, 5)                   # the K the library instantiates

KERNELS_PER_CALL = 2          # knn_partial + knn_merge
# How many warps per SM the grid of knn_partial should offer before the
# targets are split no further, and the fewest targets a split is worth
# (measured on the card by tools/knn_tune.py).
WARPS_PER_SM = {1: 11, 5: 64}
MIN_SPLIT_TARGETS = 256

launches = dict.fromkeys(KS, 0)   # kernel calls per k since the reset


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


class KernelConfig(NamedTuple):
    """What one instantiation of ``knn_partial`` was compiled with."""

    R: int                    # queries per thread
    U: int                    # targets per guarded batch
    threads: int              # threads per block
    min_blocks: int           # blocks per SM asked of ptxas
    tile: int                 # targets per shared-memory tile
    stages: int               # tiles in the ring
    queue: int                # batches a lane can note (0: insert in place)


def compile_library(defines: tuple[str, ...] = ()) -> BuildInfo:
    """``nvcc`` the sources into one library in ``_build/`` (once per hash
    of sources, flags and ``defines``, e.g. ``("-DKNN_K5_R=2",)``); raises
    with the compiler's output when it fails."""
    flags = [*NVCC_FLAGS, *defines]
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libkernels_{tag}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, *SOURCES],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {SOURCES}:\n{log}")
        os.replace(tmp, out)
    return BuildInfo(out, seconds, log)


def load_library(path: str):
    """The library's C interface, and what each k was compiled with."""
    lib = ctypes.CDLL(path)
    lib.knn_launch_batched.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_void_p] * 5
    lib.knn_launch_batched.restype = ctypes.c_int
    lib.knn_config.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.knn_config.restype = ctypes.c_int
    lib.knn_error_string.argtypes = [ctypes.c_int]
    lib.knn_error_string.restype = ctypes.c_char_p
    lib.symeig_launch.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lib.symeig_launch.restype = ctypes.c_int
    lib.graph_node_count.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_node_count.restype = ctypes.c_int
    configs = {}
    for k in KS:
        out = (ctypes.c_int * len(KernelConfig._fields))()
        if lib.knn_config(k, out) != 0:
            raise RuntimeError(f"{path} has no instantiation for k={k}")
        configs[k] = KernelConfig(*out)
    return lib, configs


_configs: dict[int, KernelConfig] = {}


def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` (once per source hash) and load the library."""
    global _lib, _build_info
    if _build_info is None:
        info = compile_library()
        _lib, configs = load_library(info.path)
        _configs.update(configs)
        _build_info = info
    return _build_info


class Plan(NamedTuple):
    """The launch of one call, from static shapes alone."""

    splits: int               # S: contiguous ranges of compacted targets
    query_tiles: int          # blocks along the query axis
    blocks: int               # items * query_tiles * splits
    kernels: int              # device kernels per call


def choose_splits(Q: int, T: int, cfg: KernelConfig, sm_count: int,
                  warps_per_sm: int, items: int = 1) -> Plan:
    """S such that the grid (``items`` x query tiles x S blocks) offers
    ``warps_per_sm`` warps to every SM, but no split shorter than
    ``MIN_SPLIT_TARGETS`` of the pad: a batch of items needs fewer splits.
    The kernel cuts the *valid* targets into S ranges, so every split has
    work."""
    tiles = -(-Q // (cfg.threads * cfg.R))
    want = -(-sm_count * warps_per_sm // (cfg.threads // 32))
    S = min(-(-want // max(tiles * items, 1)), T // MIN_SPLIT_TARGETS)
    S = max(1, min(S, 65535))
    return Plan(S, tiles, items * tiles * S, KERNELS_PER_CALL)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(k: int, Q: int, T: int, device, items: int = 1) -> Plan:
    """The plan a call of ``items`` items of this shape uses on this card."""
    build()
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return choose_splits(Q, T, _configs[k], _sm_count(index), WARPS_PER_SM[k],
                         items)


def kernel_config(k: int) -> KernelConfig:
    build()
    return _configs[k]


class PreparedTargets(NamedTuple):
    """Loop-invariant target side: prefix-compacted targets, the valid
    count and the compacted-slot -> original-index map."""

    tgt: torch.Tensor    # (T,4) float32 records (x,y,z,0), valid first
    cnt: torch.Tensor    # (1,) int32 number of valid targets
    perm: torch.Tensor   # (T,) int64 compacted slot -> original index


def prepare_targets(target: torch.Tensor,
                    target_mask: torch.Tensor) -> PreparedTargets:
    """Prefix-compact the targets on the device (hoisted out of LM loops).
    Out of place throughout, so that it runs under ``torch.func.vmap``."""
    T = target.shape[0]
    perm, ok = compact_indices(target_mask, T)
    xyz = torch.where(ok[:, None], target[perm], 0.0)
    tgt = torch.cat([xyz, torch.zeros_like(xyz[:, :1])], 1)
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


def launch_with(lib, query: torch.Tensor, prep: PreparedTargets, k: int,
                max_sq_dist: float, qcnt: torch.Tensor, splits: int):
    """The C call on checked tensors of B items: query (B,Q,3), prep.tgt
    (B,T,4), prep.perm (B,T), prep.cnt and qcnt (B,).  Allocates the
    outputs (B,Q,k) and the scratch, puts both kernels on the current
    stream, raises if a launch is refused."""
    dev = query.device
    B, Q = query.shape[:2]
    T, S = prep.tgt.shape[1], splits
    idx = torch.empty((B, Q, k), dtype=torch.int64, device=dev)
    sqd = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
    part_d = torch.empty((B, S, k, Q), dtype=torch.float32, device=dev)
    part_i = torch.empty((B, S, k, Q), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.knn_launch_batched(
        query.data_ptr(), prep.tgt.data_ptr(), prep.perm.data_ptr(),
        prep.cnt.data_ptr(), qcnt.data_ptr(), B, Q, T, k, S,
        float(max_sq_dist), part_d.data_ptr(), part_i.data_ptr(),
        idx.data_ptr(), sqd.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("knn kernel launch failed: "
                           + lib.knn_error_string(err).decode())
    return idx, sqd


def _kernel(query, tgt, perm, cnt, qcnt, k, max_sq_dist, splits):
    """The op on CUDA tensors of B items: check, plan, launch, count."""
    dev = query.device
    B, Q = query.shape[:2]
    T = tgt.shape[1]
    _check("query", query, torch.float32, (B, Q, 3), dev)
    _check("targets", tgt, torch.float32, (B, T, 4), dev)
    _check("target count", cnt, torch.int32, (B,), dev)
    _check("perm", perm, torch.int64, (B, T), dev)
    _check("qcnt", qcnt, torch.int32, (B,), dev)
    build()
    S = plan(k, Q, T, dev, B).splits if splits < 1 else splits
    if S > 65535:
        raise ValueError(f"splits={S}: the grid takes 1..65535")
    out = launch_with(_lib, query, PreparedTargets(tgt, cnt, perm), k,
                      max_sq_dist, qcnt, S)
    launches[k] += 1
    return out


def _plain(query, tgt, perm, cnt, qcnt, k, max_sq_dist):
    """The op on CPU tensors: the plain version item by item, over the
    prepared targets (compaction keeps index order, so ties still go to the
    lower original index), mapped back through perm."""
    slot = torch.arange(tgt.shape[1], device=tgt.device)
    idx, sqd = [], []
    for b in range(query.shape[0]):
        i, d = plain.knn(query[b], tgt[b, :, :3], slot < cnt[b], k,
                         max_sq_dist, qcnt[b:b + 1])
        idx.append(torch.where(d < max_sq_dist, perm[b][i], 0))
        sqd.append(d)
    return torch.stack(idx), torch.stack(sqd)


@torch.library.custom_op("sc_lego_loam_tpu_torch::knn", mutates_args=())
def knn_op(query: torch.Tensor, tgt: torch.Tensor, perm: torch.Tensor,
           cnt: torch.Tensor, qcnt: torch.Tensor, k: int,
           max_sq_dist: float, splits: int) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """k-NN of B items: query (B,Q,3), prepared targets tgt (B,T,4), perm
    (B,T), cnt (B,) int32, qcnt (B,) int32.  Returns (idx (B,Q,k) int64,
    sqd (B,Q,k) float32).  CUDA tensors launch the kernel once for all B
    items (``splits`` < 1: the planned S); CPU tensors take the plain
    version."""
    if query.device.type == "cuda":
        return _kernel(query, tgt, perm, cnt, qcnt, k, max_sq_dist, splits)
    return _plain(query, tgt, perm, cnt, qcnt, k, max_sq_dist)


@knn_op.register_fake
def _knn_fake(query, tgt, perm, cnt, qcnt, k, max_sq_dist, splits):
    B, Q = query.shape[:2]
    return (query.new_empty((B, Q, k), dtype=torch.int64),
            query.new_empty((B, Q, k)))


def _knn_vmap(info, in_dims, query, tgt, perm, cnt, qcnt, k, max_sq_dist,
              splits):
    """Batching rule: the vmapped dimension goes to the front and is merged
    with the op's own item axis, so a vmap of n sequences is one call of
    n * B items."""
    n = info.batch_size

    def items(x, d):
        x = x.movedim(d, 0) if d is not None else x.expand(n, *x.shape)
        return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()

    args = [items(x, d) for x, d in zip((query, tgt, perm, cnt, qcnt),
                                        in_dims)]
    idx, sqd = knn_op(*args, k, max_sq_dist, splits)
    shape = (n, -1) + idx.shape[1:]
    return (idx.reshape(shape), sqd.reshape(shape)), (0, 0)


torch.library.register_vmap(knn_op, _knn_vmap)


def _call(query, prep: PreparedTargets, k, max_sq_dist, qcnt, splits):
    """One item through the op (a vmapped caller makes it a batch)."""
    if qcnt is None:
        qcnt = torch.full((1,), query.shape[0], dtype=torch.int32,
                          device=query.device)
    idx, sqd = knn_op(query[None], prep.tgt[None], prep.perm[None], prep.cnt,
                      qcnt, k, float(max_sq_dist),
                      -1 if splits is None else int(splits))
    return idx[0], sqd[0]


def knn_prepared(query: torch.Tensor, prep: PreparedTargets, k: int,
                 max_sq_dist: float, qcnt: torch.Tensor | None = None,
                 splits: int | None = None):
    """Launch the kernel: query (Q,3) float32 on a CUDA device, ``qcnt``
    (1,) int32 on the same device (None: all Q rows live).
    Returns (idx (Q,k) int64, sqd (Q,k) float32).  ``splits`` overrides the
    planned S (tests and tuning)."""
    if k not in KS:
        raise ValueError(f"k={k}: the kernel is built for k in {KS}")
    if query.device.type != "cuda":
        raise ValueError(f"the CUDA kNN needs CUDA tensors, got "
                         f"{query.device}")
    if splits is not None and not 1 <= splits <= 65535:
        raise ValueError(f"splits={splits}: the grid takes 1..65535")
    return _call(query, prep, k, max_sq_dist, qcnt, splits)


def make_knn(target: torch.Tensor, target_mask: torch.Tensor, k: int,
             max_sq_dist: float):
    """k-NN closure ``knn(q, qcnt) -> (idx, sqd)`` over a fixed target set,
    with the target prep hoisted: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Runs under ``torch.func.vmap``."""
    prep = prepare_targets(target, target_mask)
    return lambda q, qcnt=None: _call(q, prep, k, max_sq_dist, qcnt, None)
