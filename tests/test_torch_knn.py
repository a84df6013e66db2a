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



def _cloud_with_copies(seed, Q, Tn, valid):
    """A cloud whose second half repeats its first half, so that every
    target has an equal-distance twin many slots away."""
    q, t, mask = _cloud(seed, Q, Tn, valid, scale=2.0)
    t[Tn // 2:] = t[:Tn - Tn // 2]
    return q, t, mask


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("splits", [1, 3, 16])
@pytest.mark.parametrize("case,Tn,valid,max_sq", [
    ("copies across every range boundary", 2048, 0.7, 4.0),
    ("fewer valid targets than ranges", 12, 0.6, 1e6),
    ("fewer than k targets in range", 512, 0.9, 0.05),
    ("no valid target", 64, 0.0, 4.0),
])
def test_split_merge_equals_plain(k, splits, case, Tn, valid, max_sq):
    """The kernel's two stages in plain torch (partial top-k per contiguous
    range of valid targets, lexicographic merge by (distance, slot)) give
    the plain version's indices and distances, bit for bit."""
    q, t, mask = _cloud_with_copies(len(case), 200, Tn, valid)
    qcnt = torch.full((1,), 170, dtype=torch.int32)
    want_i, want_d = tknn.knn(T(q), T(t), T(mask), k, max_sq, qcnt)
    got_i, got_d = tknn.split_merge(T(q), T(t), T(mask), k, max_sq, splits,
                                    qcnt)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d), case
    if case.startswith("copies"):
        # Ties really occur: some query has two slots at one distance.
        assert (want_d[:170, 1:] == want_d[:170, :-1]).any() or k == 1
    if case.startswith("fewer than k"):
        assert (want_d[:170, -1] == max_sq).any()


def test_prepare_targets_emits_padded_records():
    """The kernel reads 16-byte records: the compacted (T,3) layout of
    before, a zero in the fourth column, the same count and slot map."""
    q, t, mask = _cloud(5, 8, 700, valid=0.6)
    prep = cuda_knn.prepare_targets(T(t), T(mask))
    n = int(mask.sum())
    assert prep.tgt.shape == (700, 4) and prep.tgt.is_contiguous()
    assert prep.tgt.dtype == torch.float32 and int(prep.cnt) == n
    np.testing.assert_array_equal(prep.tgt[:n, :3].numpy(), t[mask])
    assert (prep.tgt[n:] == 0).all() and (prep.tgt[:, 3] == 0).all()
    np.testing.assert_array_equal(prep.perm.numpy()[:n], np.nonzero(mask)[0])


@pytest.mark.parametrize("k,Q,Tn,blocks_at_least", [
    (5, 12288, 65536, 2 * 132 * 2),     # scan-to-map surf
    (5, 2048, 16384, 2 * 132),          # scan-to-map corner: few query tiles
    (1, 8192, 32768, 2 * 132),          # ICP
])
def test_choose_splits_fills_the_card_at_the_path_shapes(k, Q, Tn,
                                                        blocks_at_least):
    cfg = cuda_knn.KernelConfig(R=2, U=4, threads=128, min_blocks=8,
                                tile=512, stages=2, queue=16)
    plan = cuda_knn.choose_splits(Q, Tn, cfg, 132, cuda_knn.WARPS_PER_SM[k])
    assert plan.query_tiles == -(-Q // 256)
    assert plan.blocks == plan.query_tiles * plan.splits >= blocks_at_least
    assert plan.blocks * 4 >= 8 * 132            # >= 8 warps for every SM
    assert Tn // plan.splits >= cuda_knn.MIN_SPLIT_TARGETS
    assert plan.kernels == 2


def test_choose_splits_never_cuts_a_small_set():
    cfg = cuda_knn.KernelConfig(R=2, U=4, threads=128, min_blocks=8,
                                tile=512, stages=2, queue=16)
    for Tn in (0, 3, 255, 511):
        assert cuda_knn.choose_splits(300, Tn, cfg, 132, 64).splits == \
            max(1, Tn // cuda_knn.MIN_SPLIT_TARGETS)
    assert cuda_knn.choose_splits(10 ** 6, 4096, cfg, 132, 64).splits == 1


# ---- the batch axis under torch.func.vmap (the CPU rule) ----------------

def _batch(seed, B, Q, Tn):
    """B clouds with valid-target shares 0.6, 0 and 0.95 (cycled) and mixed
    live query counts, one of them 0."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 3.0, (B, Q, 3)).astype(np.float32)
    t = rng.normal(0, 3.0, (B, Tn, 3)).astype(np.float32)
    share = np.resize([0.6, 0.0, 0.95], B)
    mask = rng.random((B, Tn)) < share[:, None]
    live = np.resize([Q, Q // 3, 0], B).astype(np.int32)[:, None]
    return T(q), T(t), T(mask), T(live)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("shared_targets", [False, True])
def test_op_under_vmap_equals_the_item_loop(k, shared_targets):
    """``make_knn`` under ``torch.func.vmap`` (batched or shared targets,
    valid counts including 0) equals the plain version item by item, in
    every slot, and never launches a kernel on the CPU."""
    from torch.func import vmap
    q, t, mask, live = _batch(k, 3, 90, 400)
    before = dict(cuda_knn.launches)
    if shared_targets:
        t, mask = t[0], mask[0]
        fn = vmap(lambda q, c: cuda_knn.make_knn(t, mask, k, 4.0)(q, c))
        idx, sqd = fn(q, live)
    else:
        fn = vmap(lambda q, t, m, c: cuda_knn.make_knn(t, m, k, 4.0)(q, c))
        idx, sqd = fn(q, t, mask, live)
    assert cuda_knn.launches == before
    for b in range(3):
        tb_, mb = (t, mask) if shared_targets else (t[b], mask[b])
        ri, rd = tknn.knn(q[b], tb_, mb, k, 4.0, live[b])
        assert torch.equal(idx[b], ri) and torch.equal(sqd[b], rd), b


def test_knn_op_items_and_nested_vmap():
    """The op's own item axis and a vmap over it merge into one call: a
    (2, 3)-batch through vmap of the 3-item op equals the loop."""
    from torch.func import vmap
    q, t, mask, live = _batch(7, 6, 40, 300)
    preps = [cuda_knn.prepare_targets(t[b], mask[b]) for b in range(6)]
    tgt = torch.stack([p.tgt for p in preps]).reshape(2, 3, 300, 4)
    perm = torch.stack([p.perm for p in preps]).reshape(2, 3, 300)
    cnt = torch.cat([p.cnt for p in preps]).reshape(2, 3)
    idx, sqd = vmap(lambda *a: cuda_knn.knn_op(*a, 5, 4.0, -1))(
        q.reshape(2, 3, 40, 3), tgt, perm, cnt, live.reshape(2, 3))
    for b in range(6):
        ri, rd = tknn.knn(q[b], t[b], mask[b], 5, 4.0, live[b])
        assert torch.equal(idx.reshape(6, 40, 5)[b], ri)
        assert torch.equal(sqd.reshape(6, 40, 5)[b], rd)


def test_prepare_targets_and_compact_indices_under_vmap():
    """Both run under ``torch.func.vmap`` (out of place) and equal the item
    loop; no per-sample fallback."""
    import warnings
    from torch.func import vmap
    from sc_lego_loam_tpu_torch.ops.compact import compact_indices
    _, t, mask, _ = _batch(9, 3, 1, 500)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        prep = vmap(cuda_knn.prepare_targets)(t, mask)
        idx, ok = vmap(lambda m: compact_indices(m, 320))(mask)
    assert not [w for w in caught if "performance drop" in str(w.message)]
    for b in range(3):
        one = cuda_knn.prepare_targets(t[b], mask[b])
        for got, want in zip(prep, one):
            assert torch.equal(got[b], want)
        i, o = compact_indices(mask[b], 320)
        assert torch.equal(idx[b], i) and torch.equal(ok[b], o)
