"""The port's exact k-NN (``ops/knn.py``, the CUDA kernel's plain version)
against the JAX package's exact XLA k-NN and its Pallas kernel run in
interpret mode, plus the contract's mask / ``qcnt`` / saturation / tie
rules and the wrapper's device routing.  The CUDA kernel itself runs only
on a card: tests/test_torch_cuda_knn.py, and ``chip_smoke.py`` at full
size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sc_lego_loam_tpu.ops import knn as jknn
from sc_lego_loam_tpu.ops.pallas_knn import knn_pallas
from sc_lego_loam_tpu_torch.ops import cuda_knn, knn as tknn

torch.set_num_threads(1)


def T(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, Q, Tn, valid=0.9, scale=5.0):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, scale, (Q, 3)).astype(np.float32)
    t = rng.normal(0, scale, (Tn, 3)).astype(np.float32)
    return q, t, rng.random(Tn) < valid


def _exact(q, t, mask, k):
    d = ((q[:, None].astype(np.float64) - t[None]) ** 2).sum(-1)
    d = np.where(mask[None], d, np.inf)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, 1)


def test_plain_matches_jax_exact_knn():
    """Against knn.knn, exact below T=32768.  knn.knn reports every valid
    target's distance; the port reports only d < max_sq_dist, so slots are
    compared where the reference distance is inside the range."""
    q, t, mask = _cloud(0, 512, 4096)
    max_sq = 16.0
    ji, jd = jknn.knn(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask), 5)
    ti, td = tknn.knn(T(q), T(t), T(mask), 5, max_sq)
    ji, jd, ti, td = map(np.asarray, (ji, jd, ti.numpy(), td.numpy()))
    _, ref_d = _exact(q, t, mask, 6)
    inside = jd < max_sq - 1e-3
    # knn.knn uses the norm expansion (error ~1e-6 of |q|^2 ~ 100).
    np.testing.assert_allclose(td[inside], jd[inside], atol=1e-3)
    # Indices agree wherever the exact distances of neighbouring slots are
    # not tied within the expansion's error.
    gap = np.diff(ref_d, axis=1)
    untied = np.ones_like(inside)
    untied[:, :] &= gap[:, :5] > 1e-3
    untied[:, 1:] &= gap[:, :4] > 1e-3
    sel = inside & untied
    assert sel.sum() > 0.9 * inside.sum()
    np.testing.assert_array_equal(ti[sel], ji[sel])
    assert (td[~inside] >= max_sq - 1e-3).all()


def test_plain_vs_pallas_interpret():
    """Against the Pallas kernel as tests/test_pallas_knn.py runs it: top-1
    equal, deeper slots within the kernel's distance quantization."""
    q, t, mask = _cloud(1, 256, 8192)
    max_sq = 16.0
    pi, pd = knn_pallas(jnp.asarray(q), jnp.asarray(t), jnp.asarray(mask),
                        k=5, max_sq_dist=max_sq, tile_q=128, block_t=1024,
                        interpret=True)
    pi, pd = np.asarray(pi), np.asarray(pd)
    ti, td = tknn.knn(T(q), T(t), T(mask), 5, max_sq)
    ti, td = ti.numpy(), td.numpy()
    ref_i, ref_d = _exact(q, t, mask, 5)
    rows = ref_d[:, 0] < 15.0
    np.testing.assert_array_equal(ti[rows, 0], pi[rows, 0])
    np.testing.assert_array_equal(ti[rows, 0], ref_i[rows, 0])
    # Pallas quantizes distances to max_sq / 2^12 and may swap a deeper
    # neighbour for the next one (chunk collisions): compare its distances
    # with the exact ones the port returns, slot by slot, for the slots
    # it got right.
    live = (pd < max_sq * 0.99) & (pi == ti)
    np.testing.assert_allclose(pd[live], td[live], atol=max_sq / 2 ** 12)
    assert live.mean() > 0.9
    full = ref_d[:, -1] < 15.0
    np.testing.assert_array_equal(ti[full], ref_i[full])


def test_saturation_mask_qcnt_and_ties():
    Q, Tn, max_sq = 8, 16, 4.0
    q = np.zeros((Q, 3), np.float32)
    t = np.full((Tn, 3), 100.0, np.float32)     # out of range
    t[3] = [0.1, 0, 0]
    t[9] = [0, 0.5, 0]
    t[11] = [0, 0.5, 0]                         # tie with 9 -> 9 first
    t[12] = [0, 0.2, 0]                         # masked out
    mask = np.ones(Tn, bool)
    mask[12] = False
    qcnt = torch.full((1,), 5, dtype=torch.int32)
    idx, sqd = tknn.knn(T(q), T(t), T(mask), 5, max_sq, qcnt)
    idx, sqd = idx.numpy(), sqd.numpy()
    np.testing.assert_array_equal(idx[:5, :3], [[3, 9, 11]] * 5)
    np.testing.assert_allclose(sqd[:5, :3], [[0.01, 0.25, 0.25]] * 5,
                               rtol=1e-6)
    # Fewer than k targets in range, and rows >= qcnt: empty slots hold
    # sqd = max_sq_dist and index 0.
    assert (sqd[:5, 3:] == max_sq).all() and (idx[:5, 3:] == 0).all()
    assert (sqd[5:] == max_sq).all() and (idx[5:] == 0).all()
    # k larger than the target count.
    idx, sqd = tknn.knn(T(q[:2]), T(t[:3]), T(mask[:3]), 5, 1e6)
    assert idx.shape == (2, 5) and (sqd.numpy()[:, 3:] == 1e6).all()


def test_make_knn_routes_cpu_to_plain_version():
    q, t, mask = _cloud(2, 64, 512)
    before = dict(cuda_knn.launches)
    fn = cuda_knn.make_knn(T(t), T(mask), 5, 4.0)
    qcnt = torch.full((1,), 40, dtype=torch.int32)
    idx, sqd = fn(T(q), qcnt)
    ri, rd = tknn.knn(T(q), T(t), T(mask), 5, 4.0, qcnt)
    assert torch.equal(idx, ri) and torch.equal(sqd, rd)
    assert cuda_knn.launches == before          # no kernel on the CPU
    prep = cuda_knn.prepare_targets(T(t), T(mask))
    assert int(prep.cnt) == int(mask.sum())
    np.testing.assert_array_equal(prep.perm.numpy()[:int(mask.sum())],
                                  np.nonzero(mask)[0])
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_prepared(T(q), prep, 5, 4.0)

