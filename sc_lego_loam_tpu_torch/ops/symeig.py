"""Batched eigendecomposition of small symmetric matrices (n <= 8): the
hand-written CUDA kernel in ``csrc/symeig.cu`` on the card, its plain
version on the CPU.

What it replaces: ``jnp.linalg.eigh`` inside the JAX package's jitted steps
(``sc_lego_loam_tpu/ops/solver.py:156``, the degeneracy guard of both LM
solves, 6x6 jointly and 3x3 per stage of the two-stage odometry), and the
3x3 ``jnp.linalg.svd`` of the ICP rigid fit (``sc_lego_loam_tpu/utils/
se3.py:195,221``), which the port computes by Horn's quaternion method from
a 4x4 eigenvector (``utils/se3.best_fit_transform``).  Those are XLA code
with no Pallas counterpart.  ``torch.linalg.eigh`` and ``torch.linalg.svd``
on a CUDA tensor read their status on the host: each call stalls the
stream, and a step that makes one cannot be captured in a CUDA graph.  The
kernel reads nothing back.

Bound: neither bytes nor operations.  A call at B=1 moves a few hundred
bytes and does ~1e4 fp64 operations, nanoseconds at the card's rates; it
costs its launch and one thread's chain of dependent fp64 steps (one
kernel, one matrix per thread, fp64 in registers).

``symeig`` is the custom op ``sc_lego_loam_tpu_torch::symeig``, routed by
the device of its input: a CUDA tensor launches the kernel (or the call
raises), a CPU tensor takes the plain version, ``torch.linalg.eigh``.  Its
batching rule makes a ``torch.func.vmap`` of it one launch over all items.
``launches[n]`` counts the kernel's launches at each size n.
"""

from __future__ import annotations

import torch

from . import cuda_knn

MAX_N = 8

launches = dict.fromkeys(range(1, MAX_N + 1), 0)


def reset_launches():
    for n in launches:
        launches[n] = 0


def symeig_plain(A: torch.Tensor):
    """The plain version: ``torch.linalg.eigh`` (lower triangle)."""
    return torch.linalg.eigh(A)


def launch(A: torch.Tensor, with_sweeps: bool = False):
    """The kernel on a CUDA tensor ``A`` (..., n, n) float32: returns (w
    (..., n) ascending, V (..., n, n) eigenvectors as columns, sweeps (B,)
    int32 or None).  Allocates the outputs, puts one kernel on the current
    stream, raises if it is refused."""
    if A.device.type != "cuda":
        raise ValueError(f"the symeig kernel needs a CUDA tensor, got "
                         f"{A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"symeig takes float32, got {A.dtype}")
    n = A.shape[-1]
    if A.ndim < 2 or A.shape[-2] != n or not 1 <= n <= MAX_N:
        raise ValueError(f"symeig takes (..., n, n) with n <= {MAX_N}, got "
                         f"{tuple(A.shape)}")
    mats = A.reshape(-1, n, n).contiguous()
    B = mats.shape[0]
    w = torch.empty((B, n), dtype=torch.float32, device=A.device)
    V = torch.empty((B, n, n), dtype=torch.float32, device=A.device)
    sweeps = torch.empty(B, dtype=torch.int32, device=A.device) \
        if with_sweeps else None
    cuda_knn.build()
    err = cuda_knn._lib.symeig_launch(
        mats.data_ptr(), w.data_ptr(), V.data_ptr(),
        None if sweeps is None else sweeps.data_ptr(), B, n,
        torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError("symeig kernel launch failed: "
                           + cuda_knn._lib.knn_error_string(err).decode())
    launches[n] += 1
    return w.reshape(A.shape[:-1]), V.reshape(A.shape), sweeps


@torch.library.custom_op("sc_lego_loam_tpu_torch::symeig", mutates_args=())
def symeig(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues ascending (..., n) and unit eigenvectors as columns
    (..., n, n) of the symmetric ``A`` (..., n, n), from its lower
    triangle.  CUDA tensors launch the kernel, CPU tensors take
    ``torch.linalg.eigh``."""
    if A.device.type == "cuda":
        w, V, _ = launch(A)
        return w, V
    if A.device.type != "cpu":
        raise ValueError(f"symeig runs on CUDA or CPU tensors, got "
                         f"{A.device}")
    w, V = symeig_plain(A)
    return w, V.contiguous()


@symeig.register_fake
def _symeig_fake(A):
    return A.new_empty(A.shape[:-1]), A.new_empty(A.shape)


def _symeig_vmap(info, in_dims, A):
    (d,) = in_dims
    A = A.movedim(d, 0) if d is not None else A.expand(
        info.batch_size, *A.shape)
    return symeig(A), (0, 0)


torch.library.register_vmap(symeig, _symeig_vmap)
