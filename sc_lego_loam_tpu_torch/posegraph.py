"""Pose-graph optimization on SE(3) (port of ``sc_lego_loam_tpu/posegraph.py``;
reference: the GTSAM/iSAM2 layer, mapOptmization.cpp:241-244, 1525-1664).

Robust Gauss-Newton in place of gtsam::ISAM2:
- nodes: keyframe poses (fixed-capacity bank, masked by count);
- factors: one prior on node 0 (mO.cpp:1544-1551), between factors linking
  consecutive keyframes (mO.cpp:1552-1560), and Cauchy-robust loop factors
  (mO.cpp:990-997 robustNoiseModel with Cauchy(1), variance 0.5);
- residual of a between factor (i,j,Z): log(Z^-1 Xi^-1 Xj); 6x12 Jacobians
  by ``torch.func.jacfwd`` through the se(3) exponential, batched over the
  factors;
- IRLS: Cauchy weights recomputed from the current residual each iteration;
- batch re-solve on loop closure (without loops the odometry chain is
  already the exact solution, and ``correctPoses`` only fires after a loop,
  mO.cpp:1642-1664).

Each GN step is solved in RELATIVE (edge) coordinates: the stiff odometry
part of the normal equations is then exactly diagonal and inverted
analytically per element (variances 1e-6/1e-8 give the node-space Hessian a
~1e8 condition number no fp32 factorization survives), and the loop factors
are a rank-6L correction handled by the Woodbury identity with one dense
(6L x 6L) solve.  The node<->edge map needs the prefix products
Phi_k = A_k ... A_0 of 6x6 blocks, computed by a log-depth doubling scan.

Multi-chain graphs (``parallel.batch.merge_solve``): ``node_mask`` and
``free_edges``, as in the JAX package.  ``gn_step`` is one GN iteration;
``solve`` drives it for one graph and ``solve_batched`` for a batch of
graphs under ``torch.func.vmap``, each iteration after the first gated on
convergence by ``graphs.cond`` (a host read eagerly, a CUDA-graph
conditional node in a captured step).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from . import graphs
from .config import PipelineConfig
from .parallel import mesh as mesh_mod
from .utils import se3


class LoopFactors(NamedTuple):
    """Fixed-capacity loop-factor store."""

    i: torch.Tensor        # (L,) int32 — newer keyframe index
    j: torch.Tensor        # (L,) int32 — older keyframe index
    z: torch.Tensor        # (L,4,4) measured Xi^-1 Xj
    count: torch.Tensor    # () int32


def init_loops(config: PipelineConfig, device) -> LoopFactors:
    max_loops = config.posegraph.max_loops
    return LoopFactors(
        i=torch.zeros(max_loops, dtype=torch.int32, device=device),
        j=torch.zeros(max_loops, dtype=torch.int32, device=device),
        z=torch.eye(4, device=device).repeat(max_loops, 1, 1),
        count=torch.zeros((), dtype=torch.int32, device=device))


def _between_residual(Xi, Xj, Z):
    """log(Z^-1 Xi^-1 Xj), batched over leading dims."""
    return se3.se3_log(se3.mat_inv(Z) @ se3.mat_inv(Xi) @ Xj)


def add_loop(loops: LoopFactors, i, j, z,
             poses6: torch.Tensor | None = None) -> LoopFactors:
    """Append a loop factor (a new bank; the old one is untouched).  Past
    capacity a slot must be evicted: ``solve`` is a full batch re-solve in
    which the poses are only the initialization, so an evicted factor's
    constraint does not persist.  With ``poses6`` (the current keyframe
    estimates) the overwritten slot is the factor with the largest residual
    under the current solution, the most Cauchy-downweighted one; without,
    the slot index ring-wraps (oldest out).  ``count`` keeps growing:
    active factors = min(count, L), and count > L tells of overflow."""
    L = loops.i.shape[0]
    k = loops.count % L
    if poses6 is not None:
        K = poses6.shape[0]
        li = torch.clamp(loops.i.long(), 0, K - 1)
        lj = torch.clamp(loops.j.long(), 0, K - 1)
        r = _between_residual(se3.pose6_to_mat(poses6[li]),
                              se3.pose6_to_mat(poses6[lj]), loops.z)
        worst = torch.argmax(torch.linalg.vector_norm(r, dim=-1))
        k = torch.where(loops.count >= L, worst.to(torch.int32), k)
    at_k = torch.arange(L, device=loops.i.device) == k
    i = torch.as_tensor(i, device=loops.i.device).to(torch.int32)
    j = torch.as_tensor(j, device=loops.i.device).to(torch.int32)
    return LoopFactors(
        i=torch.where(at_k, i, loops.i), j=torch.where(at_k, j, loops.j),
        z=torch.where(at_k[:, None, None], z, loops.z),
        count=loops.count + 1)


def _factor_residual(dij, Xi, Xj, Z):
    """Residual of between factors with local updates dij = [di, dj]
    (shared by the batch: the Jacobian is taken at dij = 0)."""
    Xi2 = se3.se3_exp(dij[:6]) @ Xi
    Xj2 = se3.se3_exp(dij[6:]) @ Xj
    return _between_residual(Xi2, Xj2, Z)


def _factor_jacobian(Xi, Xj, Z):
    """(N,6,12) Jacobians of N between factors at the zero update."""
    zero12 = torch.zeros(12, dtype=Xi.dtype, device=Xi.device)
    return jacfwd(lambda d: _factor_residual(d, Xi, Xj, Z))(zero12)


def prefix_products(A: torch.Tensor) -> torch.Tensor:
    """Phi_k = A_k @ A_{k-1} @ ... @ A_0 over the leading axis of (K,n,n),
    by a doubling scan: ceil(log2 K) steps of batched products (the JAX
    package's ``lax.associative_scan`` with combine (a, b) -> b @ a; the
    product tree differs, so fp32 results agree to rounding only)."""
    K = A.shape[0]
    Phi = A
    d = 1
    while d < K:
        Phi = torch.cat([Phi[:d], Phi[d:] @ Phi[:-d]], 0)
        d *= 2
    return Phi


def _const(values, device) -> torch.Tensor:
    """1-D float32 tensor of Python numbers made by fill kernels (a
    ``torch.tensor(..., device="cuda")`` is a host-to-device copy, which
    synchronizes)."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


def _inv(A):
    """Batched inverse without the host-side status check of
    ``torch.linalg.inv`` (a singular block gives inf/nan, which the
    finite-guard on the update turns into a zero step)."""
    return torch.linalg.inv_ex(A).inverse


def _spd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M^-1 b for a symmetric positive definite M: Cholesky factor and two
    triangular solves.  (cuSOLVER's LU and Cholesky solves, getrs / potrs,
    and its LU of a large matrix allocate stream-ordered memory, which a
    CUDA-graph conditional body may not hold; the factor and cuBLAS's
    triangular solves do not.  The JAX package's ``jnp.linalg.solve`` is
    an LU: the same solution to rounding.)  A failed factor gives a
    non-finite solution, as a singular LU does."""
    L = torch.linalg.cholesky_ex(M).L
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[:, 0]


def gn_step(config: PipelineConfig, X: torch.Tensor, odom_z: torch.Tensor,
            loops: LoopFactors, node_ok: torch.Tensor,
            free_edges: torch.Tensor | None = None):
    """One robust GN iteration of ``solve`` from the node poses X (K,4,4).
    Returns (converged () bool, X).  Reads nothing on the host, so a batch
    of graphs runs it under ``torch.func.vmap`` (``solve_batched``).

    With w_0 = Jp u_0 and w_k = Ji_k u_{k-1} + Jj_k u_k (the linearized
    odometry-factor increments) the chain part of the normal equations is
    Lambda = diag(per-dim factor weights); the node<->edge map is
    u_k = Phi_k sum_{m<=k} Phi_m^{-1} Jtil_m w_m.  The loop rows G are never
    materialized: every contraction with G uses its prefix structure
    G_l x = Qi_l sum_{k<=li} P_k x_k + Qj_l sum_{k<=lj} P_k x_k, so the work
    is O(36 K + 144 L^2) memory per iteration.

    ``free_edges`` (F,) lists nodes that begin a new chain: their incoming
    odometry factor carries no information (it only parametrizes the
    chain's placement, which loop factors determine) and is solved as an
    explicit unknown of the capacitance system, not through 1/lambda."""
    pg = config.posegraph
    K = X.shape[0]
    L = loops.i.shape[0]
    dev = X.device
    f32 = dict(dtype=torch.float32, device=dev)
    F = 0 if free_edges is None else free_edges.shape[0]

    w_prior = 1.0 / torch.sqrt(_const(pg.prior_var, dev))
    w_odom = 1.0 / torch.sqrt(_const(pg.odom_var, dev))
    w_loop = 1.0 / torch.sqrt(_const([config.loop.loop_noise_var], dev))[0]
    c2 = float(config.loop.cauchy_k) ** 2

    odom_ok = node_ok[1:]                 # factor k-1 valid iff node k is
    chain_ok = odom_ok
    if F:
        chain_start = torch.zeros(K, dtype=torch.bool, device=dev
                                  ).index_fill(0, free_edges, True)
        chain_ok = odom_ok & ~chain_start[1:]
    loop_ok = (torch.arange(L, device=dev) < loops.count).to(torch.float32)
    li = torch.clamp(loops.i.long(), 0, K - 1)
    lj = torch.clamp(loops.j.long(), 0, K - 1)
    z0_inv = se3.mat_inv(odom_z[0])
    eye6 = torch.eye(6, **f32)
    eyeL = torch.eye(6 * L, **f32)
    zero6 = torch.zeros(6, **f32)
    scales = _const([0.0, 0.1, 0.25, 0.5, 1.0], dev)

    # Diagonal edge-space information (per-dim weights squared); inactive
    # edges are frozen by a moderate weight.
    lam = torch.cat([(w_prior ** 2)[None, :],
                     torch.where(odom_ok[:, None], (w_odom ** 2)[None, :],
                                 1e3)], 0) + pg.damping          # (K,6)
    inv_lam = 1.0 / lam
    if F:
        inv_lam = torch.where(chain_start[:, None], 0.0, inv_lam)

    def chain_residual(X):
        """(..., K, 6): prior row, then the masked odometry rows."""
        r = _between_residual(X[..., :-1, :, :], X[..., 1:, :, :], odom_z[1:])
        rp = se3.se3_log(z0_inv @ X[..., 0, :, :])
        return torch.cat([rp[..., None, :], r * chain_ok[:, None]], -2)

    def total_cost(X):
        rh = chain_residual(X)
        c_odom = (lam * rh * rh).sum((-1, -2))
        rll = _between_residual(X[..., li, :, :], X[..., lj, :, :], loops.z)
        e2l = ((rll * w_loop) ** 2).sum(-1)
        c_loop = (c2 * torch.log1p(e2l / c2) * loop_ok).sum(-1)
        return c_odom + c_loop

    # ---- linearize: odometry chain (factor f couples nodes f, f+1) ------
    r_hat = chain_residual(X)                        # (K,6)
    J = _factor_jacobian(X[:-1], X[1:], odom_z[1:])  # (K-1,6,12)
    Ji, Jj = J[:, :, :6], J[:, :, 6:]
    # Prior on node 0 (anchors the gauge, mO.cpp:1544-1551).
    # (A batch of one: under jacfwd a 0-d tensor times a Python number
    # takes a float64 tangent, and so3_log's trace is 0-d on a lone
    # matrix.)
    Jp = jacfwd(lambda d: se3.se3_log(
        z0_inv @ se3.se3_exp(d) @ X[:1]))(zero6)[0]

    # ---- edge coordinates: A_k = -Jj_k^{-1} Ji_k, Psi_m = Phi_m^{-1}
    # Jtil_m.
    Jj_inv = _inv(Jj)                                # (K-1,6,6)
    A = torch.cat([eye6[None], -(Jj_inv @ Ji)], 0)   # (K,6,6)
    Jtil = torch.cat([_inv(Jp)[None], Jj_inv], 0)
    Phi = prefix_products(A)
    Psi = _inv(Phi) @ Jtil                           # (K,6,6)

    # ---- loop factors: Cauchy-robust rows in edge space -----------------
    rl = _between_residual(X[li], X[lj], loops.z)    # (L,6)
    Jl = _factor_jacobian(X[li], X[lj], loops.z)     # (L,6,12)
    e2 = ((rl * w_loop) ** 2).sum(-1)
    w_c = torch.sqrt(c2 / (c2 + e2)) * loop_ok * w_loop      # (L,)
    rlw = rl * w_c[:, None]
    Qi = (Jl[:, :, :6] * w_c[:, None, None]) @ Phi[li]
    Qj = (Jl[:, :, 6:] * w_c[:, None, None]) @ Phi[lj]

    # ---- normal equations in w, solved in the loop-residual variable
    # v = rlw + G w (every quantity stays O(residual)):
    #   w = -r_hat - Lambda^{-1} G^T v,
    #   (I + G Lambda^{-1} G^T) v = rlw - G r_hat.
    Pinv = Psi * inv_lam[:, None, :]                 # P_k invL_k
    W = torch.cumsum(torch.einsum("kab,kcb->kac", Pinv, Psi), 0)
    C = torch.cumsum(torch.einsum("kab,kb->ka", Psi, r_hat), 0)
    rhs1 = (rlw - torch.einsum("lab,lb->la", Qi, C[li])
            - torch.einsum("lab,lb->la", Qj, C[lj])).reshape(-1)

    def term(Qa, ia, Qb, ib):
        Wg = W[torch.minimum(ia[:, None], ib[None, :])]     # (L,L,6,6)
        return torch.einsum("lab,lmbc,mdc->lamd", Qa, Wg, Qb)

    M11 = (term(Qi, li, Qi, li) + term(Qi, li, Qj, lj)
           + term(Qj, lj, Qi, li) + term(Qj, lj, Qj, lj)
           ).reshape(6 * L, 6 * L) + eyeL
    if F:
        # Gf[:, f] = Qi_l P_f [f<=li] + Qj_l P_f [f<=lj]   (6L, 6F)
        Pf = Psi[free_edges]                         # (F,6,6)
        mi = (free_edges[None, :] <= li[:, None]).to(torch.float32)
        mj = (free_edges[None, :] <= lj[:, None]).to(torch.float32)
        Gf = (torch.einsum("lab,fbc->lafc", Qi, Pf) * mi[:, None, :, None]
              + torch.einsum("lab,fbc->lafc", Qj, Pf) * mj[:, None, :, None]
              ).reshape(6 * L, 6 * F)
        aug = torch.cat([
            torch.cat([M11, -Gf], 1),
            torch.cat([Gf.T, pg.damping * torch.eye(6 * F, **f32)], 1)], 0)
        sol = torch.linalg.solve_ex(
            aug, torch.cat([rhs1, torch.zeros(6 * F, **f32)])).result
        v, wf = sol[:6 * L], sol[6 * L:]
    else:
        v = _spd_solve(M11, rhs1)

    # (G^T v)_k = P_k^T * suffix-sum_k( scatter(Q^T v at li/lj) ).  An
    # accumulating index_put sums the factors of one node in index order
    # on the card too (float index_add there sums in the atomics' order).
    vL = v.reshape(L, 6)
    u = torch.zeros((K, 6), **f32).index_put(
        (li,), torch.einsum("lba,lb->la", Qi, vL), accumulate=True).index_put(
        (lj,), torch.einsum("lba,lb->la", Qj, vL), accumulate=True)
    S = torch.flip(torch.cumsum(torch.flip(u, (0,)), 0), (0,))
    Gtv = torch.einsum("kba,kb->ka", Psi, S)
    w_sol = -r_hat - inv_lam * Gtv
    if F:
        w_sol = w_sol.index_copy(0, free_edges, wf.reshape(F, 6))

    # ---- back to node space: u_k = Phi_k cumsum(Psi_m w_m) ---------------
    t = torch.cumsum(torch.einsum("kab,kb->ka", Psi, w_sol), 0)
    upd = torch.einsum("kab,kb->ka", Phi, t)
    upd = torch.where(torch.isfinite(upd), upd, 0.0)
    upd = upd * node_ok[:, None]

    # Backtracking on the robust cost: GN + IRLS can overshoot and
    # oscillate when a loop factor demands a large rigid correction (the
    # Cauchy weight swings with the residual); take the best of a few step
    # scales, 0 included, so every iteration is monotone.
    costs = total_cost(
        se3.se3_exp(scales[:, None, None] * upd) @ X)            # (5,)
    upd = scales[torch.argmin(costs).reshape(1)] * upd
    X = se3.se3_exp(upd) @ X
    return torch.linalg.vector_norm(upd) <= 1e-4, X


def solve(config: PipelineConfig, poses6: torch.Tensor, count: torch.Tensor,
          odom_z: torch.Tensor, loops: LoopFactors,
          node_mask: torch.Tensor | None = None,
          free_edges: torch.Tensor | None = None, mesh=None) -> torch.Tensor:
    """Robust GN re-solve of the full graph.

    poses6: (K,6) current keyframe pose estimates (initialization);
    odom_z: (K,4,4), odom_z[k] = measured X_{k-1}^-1 X_k for k >= 1 and
    odom_z[0] the prior pose of node 0.  Returns optimized poses6 (K,6).
    ``node_mask`` (K,) overrides the count-prefix active set and
    ``free_edges`` (F,) lists chain starts (see ``gn_step``): the
    multi-chain graph of ``parallel.batch.merge_solve``.

    Iterations stop at convergence (``_iterate``): eagerly by one host
    read of a device flag per iteration, in a captured step by one
    conditional node per iteration, as the JAX package gates its unrolled
    iterations with ``lax.cond``.  A re-solve runs only on a loop tick that
    accepted a factor, and an iteration over a full bank is hundreds of
    launches, so the gate spares them once the graph has converged.

    ``mesh`` (a ``DeviceMesh`` with a 'kf' axis, or its ``mesh.Shard``):
    every rank solves the whole graph, and the first rank's result is
    broadcast once (``mesh.share``), since the scatter-add of the update
    rounds run to run on the card.  The loop factors are replicated, so
    splitting their rows over the ranks, as the JAX package does, would
    save neither memory nor work."""
    K = poses6.shape[0]
    node_ok = node_mask if node_mask is not None else \
        torch.arange(K, device=poses6.device) < count
    X = _iterate(config, se3.pose6_to_mat(poses6),
                 lambda X: gn_step(config, X, odom_z, loops, node_ok,
                                   free_edges),
                 torch.zeros((), dtype=torch.bool, device=poses6.device))
    (X,) = mesh_mod.share((X,), mesh)
    return torch.where(node_ok[:, None], se3.mat_to_pose6(X), poses6)


def solve_batched(config: PipelineConfig, poses6: torch.Tensor,
                  count: torch.Tensor, odom_z: torch.Tensor,
                  loops: LoopFactors, active: torch.Tensor) -> torch.Tensor:
    """``solve`` over a batch of S graphs (a leading S axis on every
    argument; ``active`` (S,) bool selects the graphs to re-solve).  Each
    iteration is ``gn_step`` under ``torch.func.vmap``; a graph that has
    converged, or is not active, is frozen with ``torch.where`` (what the
    JAX package's ``lax.cond`` gate becomes under ``jax.vmap``), and each
    iteration after the first is gated on ``~done.all()`` as in ``solve``.
    An inactive graph comes back bit-identical."""
    K = poses6.shape[1]
    node_ok = torch.arange(K, device=poses6.device)[None, :] < count[:, None]
    step = vmap(lambda X, z, lo, ok: gn_step(config, X, z, lo, ok))
    X = _iterate(config, se3.pose6_to_mat(poses6),
                 lambda X: step(X, odom_z, loops, node_ok), ~active)
    return torch.where((node_ok & active[:, None])[..., None],
                       se3.mat_to_pose6(X), poses6)


def _iterate(config: PipelineConfig, X: torch.Tensor, step,
             done: torch.Tensor) -> torch.Tensor:
    """GN iterations ``(converged, X) = step(X)`` until every graph is
    done; a graph already done (``done`` () or (S,)) is frozen with
    ``torch.where``.  Every iteration after the first is gated on
    ``~done.all()`` by ``graphs.cond``, the JAX package's ``lax.cond``-gated
    unrolled iterations (``sc_lego_loam_tpu/posegraph.py:323-332``): one
    host read an iteration eagerly (the early exit), one conditional node
    an iteration in a captured step, the same numbers either way."""

    def iteration(X, done):
        converged, X_new = step(X)
        X = torch.where(done[..., None, None, None], X, X_new)
        done = done | converged
        graphs.probe("loop.gn_iter", done if done.dim() == 0 else None)
        return X, done

    X, done = iteration(X, done)
    for _ in range(config.posegraph.max_gn_iterations - 1):
        go = graphs.gate(~done.all())
        if go is False:                 # read on the host: converged
            break
        X, done = graphs.cond(go, lambda: iteration(X, done), (X, done))
    return X
