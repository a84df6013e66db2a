"""The symeig kernel (``csrc/symeig.cu``): one warp per matrix running a
parallel-ordered (round-robin) two-sided Jacobi in fp64.

CPU tests: a float64 numpy model of the kernel's algorithm (its schedule,
the lane partner formula, the stopping rule and the sweep cap), kept
here, rehearses what the ``.cu`` does where no card can run it: every
pair (p, q) turns once a sweep, the rotations of a round are disjoint,
and on the conditioned batch of ``chip_smoke.py`` every matrix converges
below the cap with eigenvalues and projectors within 1e-5 of the plain
version.

Card tests (marked ``cuda``; they skip without a card): the kernel
against the plain version at every n from 1 to 8 and B in {1, 3, 16,
4096}, two launches bit-equal, and NaN input returning within the cap.
The file imports no jax; on the card:

    python -m pytest --noconftest tests/test_torch_symeig_kernel.py -m cuda
"""

import numpy as np
import pytest
import torch

from sc_lego_loam_tpu_torch.ops import symeig as tsymeig

torch.set_num_threads(1)

MAX_SWEEPS = 20          # kMaxSweeps
TOL = 1e-15              # kTol
SYMEIG_TOL = 1e-5        # eigenvalues (x max|lambda|), projectors
BATCHES = (1, 3, 16, 4096)


def schedule(n):
    """The kernel's rounds for an n x n matrix: M = n rounded up to even
    (index n is a dummy when n is odd), rounds r = 0 .. M-2, round r pairs
    (r, M-1) and ((r+k) mod (M-1), (r-k) mod (M-1)) for k = 1 .. M/2-1,
    lower index first (``pair_p`` / ``pair_q``)."""
    M = n + n % 2
    rounds = []
    for r in range(M - 1):
        pairs = []
        for k in range(M // 2):
            a = r if k == 0 else (r + k) % (M - 1)
            b = M - 1 if k == 0 else (r - k + M - 1) % (M - 1)
            pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return rounds


def partner(M, r, j):
    """Lane j's partner in round r, as the kernel computes it."""
    if j >= M:
        return j
    if j == M - 1:
        return r
    if j == r:
        return M - 1
    x = 2 * r - j
    x += M - 1 if x < 0 else 0
    x -= M - 1 if x >= M - 1 else 0
    return x


def jacobi_model(A):
    """The kernel's algorithm in float64 on a batch (B, n, n) (lower
    triangle read): a sweep runs while the off-diagonal mass of both
    triangles exceeds 2 kTol^2 of the squared Frobenius norm, at most
    MAX_SWEEPS; a sweep is the schedule's rounds, a round's rotations
    applied at once (A <- J^T A J, V <- V J) with each pair's 2x2 block set
    exactly.  Returns (w ascending, V, sweeps)."""
    B, n, _ = A.shape
    a = np.tril(A.astype(np.float64))
    a = a + np.tril(a, -1).transpose(0, 2, 1)
    v = np.broadcast_to(np.eye(n), (B, n, n)).copy()
    stop = 2.0 * TOL * TOL * (a * a).sum((1, 2))
    sweeps = np.zeros(B, np.int64)
    rows = np.arange(B)
    eye = np.eye(n, dtype=bool)
    for _ in range(MAX_SWEEPS):
        off = np.where(eye, 0.0, a * a).sum((1, 2))
        live = off > stop
        if not live.any():
            break
        sweeps += live
        for pairs in schedule(n):
            J = np.broadcast_to(np.eye(n), (B, n, n)).copy()
            blocks = []
            for p, q in pairs:
                if q >= n:                       # the dummy: no rotation
                    continue
                app, aqq, apq = a[:, p, p], a[:, q, q], a[:, q, p]
                h, g = aqq - app, 2.0 * apq
                r2 = h * h + g * g
                rot = live & (g != 0.0) & (r2 > 0.0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    rho = 1.0 / np.sqrt(r2)
                    c2 = 0.5 * np.abs(h) * rho + 0.5
                    ic = 1.0 / np.sqrt(c2)
                    c = np.where(rot, c2 * ic, 1.0)
                    s = np.where(rot, np.copysign(0.5, h) * g * rho * ic, 0.0)
                    t = np.where(rot, s * ic, 0.0)
                J[:, p, p], J[:, q, q] = c, c
                J[:, p, q], J[:, q, p] = s, -s
                blocks.append((p, q, app - t * apq, aqq + t * apq, live))
            a = J.transpose(0, 2, 1) @ a @ J
            v = v @ J
            for p, q, new_p, new_q, on in blocks:
                a[rows[on], p, p], a[rows[on], q, q] = new_p[on], new_q[on]
                a[rows[on], p, q], a[rows[on], q, p] = 0.0, 0.0
    d = np.diagonal(a, axis1=1, axis2=2)
    order = np.argsort(d, axis=1, kind="stable")
    return (np.take_along_axis(d, order, 1),
            np.take_along_axis(v, order[:, None, :], 2), sweeps)


def test_every_pair_turns_once_a_sweep():
    """For n = 1 .. 8 the rounds of a sweep turn every pair (p, q), p < q
    < n, exactly once, and no other (pairs with the dummy index turn
    nothing)."""
    for n in range(1, 9):
        turned = [pq for pairs in schedule(n) for pq in pairs if pq[1] < n]
        want = [(p, q) for p in range(n) for q in range(p + 1, n)]
        assert sorted(turned) == want, n
        assert len(schedule(n)) == n + n % 2 - 1


def test_rounds_are_disjoint_and_lanes_agree():
    """Within a round the rotations touch disjoint indices that cover all
    M, and the partner each lane computes (lanes 0 .. 31, the idle ones
    their own) is the other index of its pair."""
    for n in range(1, 9):
        M = n + n % 2
        for r, pairs in enumerate(schedule(n)):
            idx = [i for pq in pairs for i in pq]
            assert sorted(idx) == list(range(M)), (n, r)
            mate = {p: q for p, q in pairs} | {q: p for p, q in pairs}
            for j in range(32):
                assert partner(M, r, j) == mate.get(j, j), (n, r, j)


def test_model_converges_on_the_conditioned_batch():
    """``chip_smoke.py``'s conditioned batch (4096 SPD 6x6, condition
    numbers log-uniform up to 1e8, its generator and seed): every matrix
    converges below the cap, and eigenvalues, reconstruction,
    orthogonality and the degeneracy projectors at its gap thresholds are
    within 1e-5 of the plain version (``torch.linalg.eigh``)."""
    import chip_smoke as cs
    rng = np.random.default_rng(21)
    for n in cs.SYMEIG_SIZES:                # the phase's B=1 draws first
        cs.spd_batch(rng, 2, n, 1e3)
    A = cs.spd_batch(rng, cs.SYMEIG_BATCH, 6, cs.SYMEIG_COND)
    w, V, sweeps = jacobi_model(A)
    assert sweeps.max() < MAX_SWEEPS
    assert sweeps.min() >= 3
    wp, Vp = tsymeig.symeig_plain(torch.from_numpy(A))
    wp, Vp = wp.double().numpy(), Vp.double().numpy()
    top = np.abs(wp).max(1)
    assert (np.abs(w - wp).max(1) / top).max() <= SYMEIG_TOL
    A64 = A.astype(np.float64)
    recon = (V * w[:, None, :]) @ V.transpose(0, 2, 1) - A64
    assert (np.linalg.norm(recon, axis=(1, 2))
            / np.linalg.norm(A64, axis=(1, 2))).max() <= SYMEIG_TOL
    assert np.abs(V.transpose(0, 2, 1) @ V - np.eye(6)).max() <= SYMEIG_TOL
    thr = cs.gap_thresholds(A).astype(np.float64)

    def projector(w_, V_):
        keep = (w_ > thr[:, None]).astype(np.float64)
        return (V_ * keep[:, None, :]) @ V_.transpose(0, 2, 1)

    assert np.abs(projector(w, V) - projector(wp, Vp)).max() <= SYMEIG_TOL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(rng, B, n):
    """B symmetric n x n float32: random orthonormal eigenvectors,
    eigenvalues of both signs spread over up to 1e6, scales 1e-2 .. 1e4."""
    Q, _ = np.linalg.qr(rng.normal(size=(B, n, n)))
    mag = 10.0 ** (rng.uniform(-2, 4, (B, 1)) - rng.uniform(0, 6, (B, n)))
    evals = mag * np.where(rng.random((B, n)) < 0.25, -1.0, 1.0)
    A = (Q * evals[:, None, :]) @ Q.transpose(0, 2, 1)
    return ((A + A.transpose(0, 2, 1)) / 2).astype(np.float32)


@pytest.mark.cuda
def test_kernel_matches_plain_every_n_and_batch(card):
    """Every n from 1 to 8 at B = 1, 3, 16 and 4096: eigenvalues (x
    max|lambda|), reconstruction and orthogonality within 1e-5 of the
    plain version on CPU copies, ascending, below the sweep cap, and the
    launch counted."""
    rng = np.random.default_rng(3)
    for n in range(1, 9):
        for B in BATCHES:
            A = _batch(rng, B, n)
            before = tsymeig.launches[n]
            w, V, sweeps = tsymeig.launch(torch.from_numpy(A).to(card),
                                          with_sweeps=True)
            torch.cuda.synchronize()
            assert tsymeig.launches[n] == before + 1
            w, V = w.cpu().double().numpy(), V.cpu().double().numpy()
            wp, _ = tsymeig.symeig_plain(torch.from_numpy(A))
            wp = wp.double().numpy()
            top = np.abs(wp).max(1)
            assert (np.abs(w - wp).max(1) / top).max() <= SYMEIG_TOL, (n, B)
            A64 = A.astype(np.float64)
            recon = (V * w[:, None, :]) @ V.transpose(0, 2, 1) - A64
            assert (np.linalg.norm(recon, axis=(1, 2))
                    / np.linalg.norm(A64, axis=(1, 2))).max() <= SYMEIG_TOL
            assert np.abs(V.transpose(0, 2, 1) @ V
                          - np.eye(n)).max() <= SYMEIG_TOL, (n, B)
            assert (np.diff(w, axis=1) >= 0).all()
            assert int(sweeps.max()) < MAX_SWEEPS


@pytest.mark.cuda
def test_two_launches_are_bit_equal(card):
    """The order of every shuffle and sum is fixed: two launches on the
    same input give the same bits (B = 1 and 4096, n = 4 and 6)."""
    rng = np.random.default_rng(4)
    for n in (4, 6):
        for B in (1, 4096):
            A = torch.from_numpy(_batch(rng, B, n)).to(card)
            first = tsymeig.launch(A, with_sweeps=True)
            second = tsymeig.launch(A, with_sweeps=True)
            for x, y in zip(first, second):
                assert torch.equal(x, y), (n, B)


@pytest.mark.cuda
def test_nan_input_returns_within_the_cap(card):
    """A matrix of NaN and one with a NaN in its lower triangle return
    (no hang) with a sweep count within the cap, and the next call on a
    finite matrix is right."""
    rng = np.random.default_rng(5)
    A = _batch(rng, 3, 6)
    A[0] = np.nan
    A[1, 4, 2] = np.nan
    _, _, sweeps = tsymeig.launch(torch.from_numpy(A).to(card),
                                  with_sweeps=True)
    torch.cuda.synchronize()
    assert int(sweeps.max()) <= MAX_SWEEPS
    w, _ = tsymeig.symeig(torch.from_numpy(A[2:]).to(card))
    wp, _ = tsymeig.symeig_plain(torch.from_numpy(A[2:]))
    np.testing.assert_allclose(w.cpu().numpy(), wp.numpy(),
                               atol=SYMEIG_TOL * float(wp.abs().max()))
