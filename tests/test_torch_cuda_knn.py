"""The hand-written CUDA k-NN (``csrc/knn.cu`` via ``ops/cuda_knn.py``)
against its plain torch version on the same card tensors.  Card-only:
every test here is marked ``cuda`` and skips without a card.  The file
imports no jax, so it runs on a machine that has only the port:

    python -m pytest --noconftest tests/test_torch_cuda_knn.py -m cuda
"""

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.ops import cuda_knn, knn as tknn

pytestmark = pytest.mark.cuda
TIE_REL = 1e-5      # neighbouring slots this close are ties


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(seed, Q, Tn, valid, device):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 5.0, (Q, 3)).astype(np.float32)
    t = rng.normal(0, 5.0, (Tn, 3)).astype(np.float32)
    mask = rng.random(Tn) < valid
    return (torch.from_numpy(x).to(device) for x in (q, t, mask))


@pytest.mark.parametrize("k,Q,Tn,max_sq,valid,live", [
    (5, 1024, 8192, 4.0, 0.5, 924),      # scan-to-map rule, 4 target tiles
    (1, 1024, 8192, 64.0, 0.5, 924),     # the ICP 1-NN
    (5, 1000, 3000, 4.0, 0.9, 1000),     # ragged last block and last tile
    (5, 300, 3, 1e6, 1.0, 300),          # fewer targets than k
    (5, 256, 4096, 4.0, 0.0, 256),       # no valid target
    (1, 256, 4096, 64.0, 0.5, 0),        # no live query
])
def test_kernel_matches_plain_on_card(card, k, Q, Tn, max_sq, valid, live):
    q, t, mask = _cloud(3, Q, Tn, valid, card)
    qcnt = torch.full((1,), live, dtype=torch.int32, device=card)
    before = dict(cuda_knn.launches)
    idx, sqd = cuda_knn.make_knn(t, mask, k, max_sq)(q, qcnt)
    torch.cuda.synchronize()
    assert cuda_knn.launches == {**before, k: before[k] + 1}
    _assert_matches_plain(idx, sqd, q, t, mask, k, max_sq, qcnt, live)


def _assert_matches_plain(idx, sqd, q, t, mask, k, max_sq, qcnt, live):
    ri, rd = tknn.knn(q, t, mask, k + 1, max_sq, qcnt)
    # One FMA chain against three rounded adds: an ulp of d.
    torch.testing.assert_close(sqd, rd[:, :k], atol=1e-4, rtol=0)
    # Indices agree in every slot not tied with a neighbouring slot;
    # empty slots (sqd = max_sq, index 0) are never ties.
    tied_next = ((rd[:, 1:] - rd[:, :-1]).abs()
                 <= TIE_REL * rd[:, :-1]) & (rd[:, :-1] < max_sq)
    tied = tied_next.clone()
    tied[:, 1:] |= tied_next[:, :-1]
    assert torch.equal(idx[~tied], ri[:, :k][~tied])
    assert (idx[live:] == 0).all() and (sqd[live:] == max_sq).all()


@pytest.mark.parametrize("k,Q,Tn,max_sq,valid,live,splits", [
    (5, 1024, 8192, 4.0, 0.5, 924, 3),     # Tn/2 not a multiple of S
    (5, 1024, 8192, 4.0, 0.5, 924, 7),     # nor of the tile
    (1, 1024, 8192, 64.0, 0.5, 924, 5),
    (5, 600, 4099, 4.0, 0.9, 600, 16),     # Q no multiple of a block's rows
    (5, 512, 4096, 1e6, 0.001, 512, 16),   # fewer valid targets than S
    (1, 512, 4096, 64.0, 0.001, 512, 64),
    (5, 512, 4096, 4.0, 0.5, 37, 4),       # live < one tile, odd
    (1, 512, 4096, 64.0, 0.5, 3, None),
    (5, 12288, 65536, 4.0, 0.5, 11059, None),   # scan-to-map surf
    (5, 2048, 16384, 4.0, 0.5, 1843, None),     # scan-to-map corner
    (1, 8192, 32768, 64.0, 0.5, 7372, None),    # ICP
])
def test_splits_and_merge_on_card(card, k, Q, Tn, max_sq, valid, live,
                                  splits):
    """The target split and the merge: forced S (None: the planned one)
    against the plain version, and every S against S=1, bit for bit."""
    q, t, mask = _cloud(7, Q, Tn, valid, card)
    qcnt = torch.full((1,), live, dtype=torch.int32, device=card)
    prep = cuda_knn.prepare_targets(t, mask)
    idx, sqd = cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt, splits=splits)
    one_i, one_d = cuda_knn.knn_prepared(q, prep, k, max_sq, qcnt, splits=1)
    torch.cuda.synchronize()
    assert torch.equal(idx, one_i) and torch.equal(sqd, one_d)
    _assert_matches_plain(idx, sqd, q, t, mask, k, max_sq, qcnt, live)
    if Q <= 1024:
        si, sd = tknn.split_merge(q, t, mask, k, max_sq, splits or 4, qcnt)
        torch.testing.assert_close(sqd, sd, atol=1e-4, rtol=0)


@pytest.mark.parametrize("k", [1, 5])
def test_duplicates_across_splits_come_back_lower_slot_first(card, k):
    """One point copied into slots of different splits and tiles: all at
    one distance, so the order is the tie rule's alone."""
    tile = cuda_knn.kernel_config(k).tile
    Tn, S = 9 * tile + 77, 3
    rng = np.random.default_rng(11)
    t = rng.uniform(-20, 20, (Tn, 3)).astype(np.float32)
    mask = np.arange(Tn) % 3 != 1
    index_of = np.nonzero(mask)[0]
    length = -(-len(index_of) // S)
    slots = [3, tile + 5, length - 1, length, length + tile, 2 * length + 1,
             len(index_of) - 1]
    t[index_of[slots]] = [100.0, 100.0, 100.0]
    q = (100.0 + rng.normal(0, 0.1, (200, 3))).astype(np.float32)
    q, t, mask = (torch.from_numpy(x).to(card) for x in (q, t, mask))
    want = torch.from_numpy(index_of[slots][:k]).to(card).expand(200, k)
    for splits in (S, None, 1, 64):
        idx, _ = cuda_knn.knn_prepared(
            q, cuda_knn.prepare_targets(t, mask), k, 4.0, splits=splits)
        assert torch.equal(idx, want), splits
    assert torch.equal(tknn.knn(q, t, mask, k, 4.0)[0], want)


def test_a_call_is_capturable_in_a_cuda_graph(card):
    """Static grid, no host read, nothing allocated in the C call."""
    q, t, mask = _cloud(9, 1024, 8192, 0.5, card)
    qcnt = torch.full((1,), 900, dtype=torch.int32, device=card)
    prep = cuda_knn.prepare_targets(t, mask)
    want = cuda_knn.knn_prepared(q, prep, 5, 4.0, qcnt)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_knn.knn_prepared(q, prep, 5, 4.0, qcnt)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # The counts are read on the device at replay: fewer live rows, same graph.
    qcnt.fill_(10)
    graph.replay()
    torch.cuda.synchronize()
    assert (got[0][10:] == 0).all() and torch.equal(got[0][:10], want[0][:10])


def test_equal_distances_go_to_the_lower_index(card):
    t = torch.tensor([[9.0, 0, 0], [1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0],
                      [0, 0, 1.0]], device=card)
    mask = torch.tensor([True, True, True, True, False], device=card)
    q = torch.zeros((3, 3), device=card)
    idx, sqd = cuda_knn.make_knn(t, mask, 5, 4.0)(q)
    assert idx.tolist() == [[1, 2, 3, 0, 0]] * 3
    assert sqd.tolist() == [[1.0, 1.0, 1.0, 4.0, 4.0]] * 3


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, t, mask = _cloud(4, 64, 512, 0.5, card)
    prep = cuda_knn.prepare_targets(t, mask)
    with pytest.raises(ValueError, match="k=3"):
        cuda_knn.knn_prepared(q, prep, 3, 4.0)
    with pytest.raises(TypeError, match="dtype"):
        cuda_knn.knn_prepared(q.double(), prep, 5, 4.0)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_knn.knn_prepared(q.t().contiguous().t(), prep, 5, 4.0)
    with pytest.raises(ValueError, match="qcnt is on cpu"):
        cuda_knn.knn_prepared(q, prep, 5, 4.0,
                              torch.full((1,), 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="splits=0"):
        cuda_knn.knn_prepared(q, prep, 5, 4.0, splits=0)


# ---- the batch axis: B items in one call --------------------------------

def _batch(seed, B, Q, Tn, valid, device):
    """B independent clouds; item 1 (when B > 1) has no valid target, and
    every item's second half of targets repeats its first half, so equal
    distances fall across splits."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 2.0, (B, Q, 3)).astype(np.float32)
    t = rng.normal(0, 2.0, (B, Tn, 3)).astype(np.float32)
    t[:, Tn // 2:] = t[:, :Tn - Tn // 2]
    mask = rng.random((B, Tn)) < valid
    if B > 1:
        mask[1] = False
    live = rng.integers(Q // 2, Q + 1, B).astype(np.int32)
    return (torch.from_numpy(x).to(device) for x in (q, t, mask, live))


def _items(q, t, mask, live, k, max_sq, splits):
    """The batched op over B items: query (B,Q,3) and prepared targets."""
    preps = [cuda_knn.prepare_targets(t[b], mask[b]) for b in range(len(q))]
    tgt = torch.stack([p.tgt for p in preps])
    perm = torch.stack([p.perm for p in preps])
    cnt = torch.cat([p.cnt for p in preps])
    return preps, cuda_knn.knn_op(q, tgt, perm, cnt, live, k, max_sq,
                                  -1 if splits is None else splits)


@pytest.mark.parametrize("k,B,Q,Tn,max_sq,splits", [
    (5, 3, 1000, 3000, 4.0, None),
    (5, 3, 1000, 3000, 4.0, 7),
    (1, 3, 700, 4099, 64.0, None),
    (1, 8, 700, 4099, 64.0, 5),
    (5, 8, 300, 1024, 1e6, 1),
])
def test_batch_equals_separate_calls_in_every_slot(card, k, B, Q, Tn, max_sq,
                                                   splits):
    """B items in one call equal B single calls bit for bit (ties across
    splits included; item 1 has no valid target), and the plain version."""
    q, t, mask, live = _batch(B + k, B, Q, Tn, 0.7, card)
    before = cuda_knn.launches[k]
    preps, (idx, sqd) = _items(q, t, mask, live, k, max_sq, splits)
    assert cuda_knn.launches[k] == before + 1
    for b in range(B):
        qcnt = live[b:b + 1]
        one_i, one_d = cuda_knn.knn_prepared(q[b], preps[b], k, max_sq, qcnt,
                                             splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(idx[b], one_i) and torch.equal(sqd[b], one_d), b
        _assert_matches_plain(idx[b], sqd[b], q[b], t[b], mask[b], k, max_sq,
                              qcnt, int(live[b]))
    assert (idx[1] == 0).all() and (sqd[1] == max_sq).all()


@pytest.mark.parametrize("k", [1, 5])
def test_batch_of_one_is_the_single_call(card, k):
    """The B=1 batched launch is bit-equal to the single call, and so is
    the C entry called directly with B=1 (``knn_launch_batched``)."""
    q, t, mask, live = _batch(3, 1, 1024, 8192, 0.5, card)
    preps, (idx, sqd) = _items(q, t, mask, live, k, 4.0, None)
    one = cuda_knn.knn_prepared(q[0], preps[0], k, 4.0, live)
    cuda_knn.build()
    S = cuda_knn.plan(k, 1024, 8192, card).splits
    Q, T = 1024, 8192
    oi = torch.empty((Q, k), dtype=torch.int64, device=card)
    od = torch.empty((Q, k), dtype=torch.float32, device=card)
    pd = torch.empty((S, k, Q), dtype=torch.float32, device=card)
    pi = torch.empty((S, k, Q), dtype=torch.int32, device=card)
    p = preps[0]
    err = cuda_knn._lib.knn_launch_batched(
        q[0].data_ptr(), p.tgt.data_ptr(), p.perm.data_ptr(),
        p.cnt.data_ptr(), live.data_ptr(), 1, Q, T, k, S, 4.0, pd.data_ptr(),
        pi.data_ptr(), oi.data_ptr(), od.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    for i, d in (one, (oi, od)):
        assert torch.equal(idx[0], i) and torch.equal(sqd[0], d)


def test_vmap_makes_one_batched_call(card):
    """``torch.func.vmap`` of ``make_knn`` is one kernel call of B items,
    equal to the per-item calls."""
    from torch.func import vmap
    q, t, mask, live = _batch(5, 3, 600, 2048, 0.7, card)
    before = cuda_knn.launches[5]
    idx, sqd = vmap(lambda q, t, m, c: cuda_knn.make_knn(t, m, 5, 4.0)(
        q, c.reshape(1)))(q, t, mask, live)
    assert cuda_knn.launches[5] == before + 1
    for b in range(3):
        i, d = cuda_knn.make_knn(t[b], mask[b], 5, 4.0)(q[b], live[b:b + 1])
        torch.cuda.synchronize()
        assert torch.equal(idx[b], i) and torch.equal(sqd[b], d)


def test_plan_with_items_needs_fewer_splits(card):
    cfg = cuda_knn.kernel_config(5)
    one = cuda_knn.plan(5, 2048, 16384, card)
    three = cuda_knn.plan(5, 2048, 16384, card, items=3)
    assert three.splits <= one.splits and three.splits >= one.splits // 3
    assert three.blocks == 3 * three.query_tiles * three.splits
    assert three == cuda_knn.choose_splits(
        2048, 16384, cfg, torch.cuda.get_device_properties(card)
        .multi_processor_count, cuda_knn.WARPS_PER_SM[5], 3)
