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
