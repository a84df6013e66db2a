"""sc_lego_loam_tpu_torch — the PyTorch / CUDA port of ``sc_lego_loam_tpu``.

Same module layout as the JAX package (``ops/projection.py`` here is the
counterpart of ``ops/projection.py`` there), plain functions on tensors,
``NamedTuple``s of tensors for state.  The scan-to-map k-NN runs in a
hand-written CUDA kernel (``csrc/knn.cu``) for CUDA tensors; everything
else is eager torch.

This first slice covers the odometry + scan-to-map engine with loop
closure and IMU off (``SlamEngine`` refuses either).  Configuration is
shared with the JAX package (``sc_lego_loam_tpu.config`` is framework-free).
No module of this package imports jax.
"""

from sc_lego_loam_tpu.config import (  # noqa: F401
    PipelineConfig, default_config, tiny_test_config,
)
