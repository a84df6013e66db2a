"""Point-to-point ICP for loop-closure verification (port of
``sc_lego_loam_tpu/ops/icp.py``; replaces pcl::IterativeClosestPoint used at
mapOptmization.cpp:1006-1011,1054-1059).

Fixed-shape loop: 1-NN correspondences (the CUDA kNN kernel at k=1 on the
card), closed-form SVD rigid fit per iteration (the estimator PCL uses
internally), convergence on the increment twist norm.  Fitness matches
pcl::Registration::getFitnessScore, the mean squared nearest-neighbour
distance of the aligned source (mO.cpp:1020,1071 gate it at < 1.5), with
the kernel's contract: a distance saturates at ``NN_MAX_SQ_DIST`` and a
source point with no target in range reads exactly that, never inf.
"""

from __future__ import annotations

import torch

from ..config import PipelineConfig
from ..utils import se3
from . import cuda_knn, solver
from .compact import compact

NN_MAX_SQ_DIST = 64.0     # the 1-NN search range (8 m), squared


def _make_nn1(dst, dst_mask):
    """1-NN closure ``nn(p, qcnt) -> (idx (Q,), sqd (Q,))`` with the target
    prep hoisted out of the ICP loop: ``csrc/knn.cu`` at k=1 for CUDA
    tensors, the plain ``ops/knn.py`` for CPU tensors."""
    knn1 = cuda_knn.make_knn(dst, dst_mask, 1, NN_MAX_SQ_DIST)

    def nn(p, qcnt=None):
        idx, sqd = knn1(p, qcnt)
        return idx[:, 0], sqd[:, 0]

    return nn


def align(config: PipelineConfig, src: torch.Tensor, src_mask: torch.Tensor,
          dst: torch.Tensor, dst_mask: torch.Tensor,
          T0: torch.Tensor | None = None):
    """Align src onto dst. Returns (T (4,4), fitness (), inlier_ratio ())
    with dst ~ T @ src for matched points.

    ``inlier_ratio`` = fraction of valid source points whose aligned NN
    distance is below ``loop.inlier_sq_dist``: the overlap statistic the
    acceptance gate uses beside mean-square fitness (a mean can be dragged
    under the threshold by easy ground points while walls misalign).

    The iteration count is fixed; a converged state is kept with
    ``torch.where`` (the JAX package skips the remaining iterations under
    ``lax.cond``: same numbers, and here no host read)."""
    lcfg = config.loop
    if T0 is None:
        T0 = torch.eye(4, dtype=torch.float32, device=src.device)
    # Prefix-compact the source once: the kernel skips query rows past the
    # live count (loop.keyframe_cloud pads run ~30-60 %).
    src, src_mask = compact(src, src_mask, src.shape[0])
    qcnt = src_mask.sum(dtype=torch.int32).reshape(1)
    w = src_mask.to(torch.float32)
    nn = _make_nn1(dst, dst_mask)

    T = T0
    done = torch.zeros((), dtype=torch.bool, device=src.device)
    for _ in range(lcfg.icp_max_iterations):
        p = se3.transform_points(T, src)
        idx, _ = nn(p, qcnt)
        dT = se3.best_fit_transform(p, dst[idx], w)
        new_done = torch.linalg.vector_norm(se3.se3_log(dT)) < lcfg.icp_eps
        (T,) = solver.freeze(done, (T,), (dT @ T,))
        done = done | new_done

    p = se3.transform_points(T, src)
    _, sqd = nn(p, qcnt)
    denom = torch.clamp(w.sum(), min=1.0)
    fitness = (sqd * w).sum() / denom
    inlier_ratio = ((sqd < lcfg.inlier_sq_dist) * w).sum() / denom
    return T, fitness, inlier_ratio
