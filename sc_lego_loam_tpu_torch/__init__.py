"""sc_lego_loam_tpu_torch — the PyTorch / CUDA port of ``sc_lego_loam_tpu``.

Same module layout as the JAX package (``ops/projection.py`` here is the
counterpart of ``ops/projection.py`` there), plain functions on tensors,
``NamedTuple``s of tensors for state.  The scan-to-map 5-NN and the ICP
1-NN run in a hand-written CUDA kernel (``csrc/knn.cu``) for CUDA tensors;
everything else is eager torch.

The engine runs odometry, scan-to-map and loop closure (Scan Context and
radius detection, ICP through the CUDA kNN at k=1, pose-graph re-solve);
the IMU path is not ported and ``SlamEngine`` refuses it.  The package has
its own ``config`` and ``utils/synthetic`` and imports nothing of the JAX
package, and no module of it imports jax.
"""

from .config import (  # noqa: F401
    PipelineConfig, default_config, tiny_test_config,
)
