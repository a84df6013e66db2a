"""``ops/symeig`` (the small symmetric eigendecomposition: ``csrc/symeig.cu``
on the card, ``torch.linalg.eigh`` on the CPU) and its two callers against
the JAX package: ``solver.degeneracy_projector`` (the LM degeneracy guard,
``jnp.linalg.eigh`` there) and ``se3.best_fit_transform`` (Horn's
quaternion method here, the SVD with the reflection fix there).

Tolerances: projectors at 1e-5 (fp32 eigenvectors of well-separated
eigenvalues on both sides; the projector does not depend on their signs),
the rigid fit's R and t at 1e-5 (fp32 covariance sums; the two methods give
the same proper rotation)."""

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.ops import solver as tsolver, symeig as tsymeig
from sc_lego_loam_tpu_torch.utils import se3 as tse3

torch.set_num_threads(1)


def _jax():
    """The JAX package's solver and se3 modules and jax.numpy, imported by
    the parity tests only: the card's test command has no jax."""
    import jax.numpy as jnp
    from sc_lego_loam_tpu.ops import solver as jsolver
    from sc_lego_loam_tpu.utils import se3 as jse3
    return jnp, jsolver, jse3


THRESHOLD = 100.0


def _hessian(rng, evals):
    """V diag(evals) V^T with a random orthonormal V, float32."""
    n = len(evals)
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (Q * np.asarray(evals)) @ Q.T


@pytest.mark.parametrize("n", [3, 6])
def test_degeneracy_projector_matches_jax(n):
    """Well-conditioned (no degenerate direction), one eigenvalue 10x under
    the threshold and one 10x over it, and two under: the projector within
    1e-5 and the same degeneracy flag as the JAX package's."""
    jnp, jsolver, _ = _jax()
    rng = np.random.default_rng(n)
    spreads = [np.geomspace(5e3, 5e4, n),
               np.concatenate([[THRESHOLD / 10, THRESHOLD * 10],
                               np.geomspace(3e3, 3e4, n - 2)]),
               np.concatenate([[THRESHOLD / 10, THRESHOLD / 20],
                               np.geomspace(3e3, 3e4, n - 2)])]
    flags = []
    for evals in spreads:
        H = _hessian(rng, evals).astype(np.float32)
        Pj, dj = jsolver.degeneracy_projector(jnp.asarray(H), THRESHOLD)
        Pt, dt = tsolver.degeneracy_projector(torch.from_numpy(H), THRESHOLD)
        np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), atol=1e-5)
        assert bool(dt) == bool(dj)
        flags.append(bool(dt))
    assert flags == [False, True, True]


def _fit_case(name, rng):
    """(src, dst, weights or None) of one rigid-fit case."""
    w = None
    if name == "near_planar":       # a wall: z spread of a millimetre
        src = rng.uniform(-5, 5, (200, 3))
        src[:, 2] = rng.normal(0, 1e-3, 200)
    elif name == "reflection":      # dst mirrored: the SVD's det fix decides
        src = rng.normal(size=(150, 3)) * [4.0, 1.5, 0.4]
    else:
        src = rng.uniform(-5, 5, (300, 3))
    ang = rng.normal(size=3)
    ang *= 0.5 / np.linalg.norm(ang)
    R = tse3.so3_exp(torch.from_numpy(ang.astype(np.float32))).numpy()
    dst = src @ R.T + rng.normal(0, 1.0, 3)
    if name == "reflection":
        dst[:, 2] *= -1.0
    dst = dst + rng.normal(0, 0.02, dst.shape)          # not an exact motion
    if name == "zero_weights":
        w = (rng.random(len(src)) < 0.6).astype(np.float32)
        dst[w == 0] += rng.uniform(-40, 40, (int((w == 0).sum()), 3))
    return src.astype(np.float32), dst.astype(np.float32), w


def test_horn_fit_matches_jax_svd():
    """Random, weighted with zero weights (the weight-0 points far off), a
    mirrored target (the unconstrained fit is a reflection) and near-planar
    points: R and t within 1e-5 of the JAX package's SVD fit, and a proper
    rotation."""
    jnp, _, jse3 = _jax()
    rng = np.random.default_rng(7)
    for name in ("random", "zero_weights", "reflection", "near_planar"):
        src, dst, w = _fit_case(name, rng)
        Tj = np.asarray(jse3.best_fit_transform(
            jnp.asarray(src), jnp.asarray(dst),
            None if w is None else jnp.asarray(w)))
        Tt = tse3.best_fit_transform(
            torch.from_numpy(src), torch.from_numpy(dst),
            None if w is None else torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-5,
                                   err_msg=name)
        assert np.linalg.det(Tt[:3, :3]) == pytest.approx(1.0, abs=1e-5)


def test_vmap_is_one_batched_call():
    """Under ``torch.func.vmap`` the batching rule hands the op the whole
    batch: equal, item by item, to single calls."""
    rng = np.random.default_rng(1)
    A = torch.from_numpy(np.stack([_hessian(rng, rng.uniform(1, 9, 4))
                                   for _ in range(5)]).astype(np.float32))
    w, V = torch.func.vmap(tsymeig.symeig)(A)
    for b in range(5):
        wb, Vb = tsymeig.symeig(A[b])
        torch.testing.assert_close(w[b], wb, rtol=0, atol=0)
        torch.testing.assert_close(V[b], Vb, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_tensor_launches_the_kernel_or_raises():
    """A CUDA tensor never takes the plain version: without a card the
    call raises; on a card it launches the kernel (counted) and agrees
    with the plain version on a CPU copy at n = 3, 4, 6.  Runs on the card
    with ``python -m pytest --noconftest tests/test_torch_symeig.py -m
    cuda`` (this file imports jax only inside the parity tests)."""
    with pytest.raises(ValueError):
        tsymeig.launch(torch.eye(3))
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tsymeig.symeig(torch.eye(3, device="cuda"))
        return
    rng = np.random.default_rng(2)
    for n in (3, 4, 6):
        A = _hessian(rng, np.geomspace(1e-3, 1e3, n)).astype(np.float32)
        before = tsymeig.launches[n]
        w, V = tsymeig.symeig(torch.from_numpy(A).cuda())
        assert tsymeig.launches[n] == before + 1
        wp, _ = torch.linalg.eigh(torch.from_numpy(A))
        np.testing.assert_allclose(w.cpu().numpy(), wp.numpy(),
                                   atol=1e-5 * float(wp.abs().max()))
        Vc = V.cpu().numpy().astype(np.float64)
        np.testing.assert_allclose(Vc.T @ Vc, np.eye(n), atol=1e-5)
