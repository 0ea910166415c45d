"""Batched nonlinear least-squares solvers for factor graphs.

Port of ``mvslam_tpu/backend/solvers.py``: robust losses with per-factor
IRLS weights, a thread-safe ``SolverRegistry`` pre-registered with
``"gauss_newton"`` and ``"scipy"`` (host fallback), per-iteration
``IterationDiagnostics``, a ``ResidualHistogram`` and conditioning
diagnostics.

The Gauss-Newton core runs ``max_iterations`` steps — linearize every
factor (vmapped ``jacfwd``), IRLS reweight, assemble, solve, retract, keep
the step only where the cost falls — as a Python loop with ``torch.where``
masking and no host read inside it; the result comes back in one packed
fetch. Two linear solves: dense Cholesky (``cholesky_ex`` +
``cholesky_solve``; a factorisation that fails yields NaN, as the
reference's does) and matrix-free block-Jacobi-preconditioned CG. Every
assembly is a deterministic segment sum (``backend.segments``) over tables
built once per solve from the host's copy of the edges; with a
``factor_sharding`` each slot of a mesh assembles its block of factors
and the partials are added in slot order. The reference's
power-of-two bucket padding exists to avoid XLA recompiles and is not
ported.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from mvslam_tpu_torch.backend.factor_graph import (
    MODELS,
    GraphProblem,
    make_linearize_fn,
    make_residual_fn,
)
from mvslam_tpu_torch.backend.segments import segment_sum, segment_table
from mvslam_tpu_torch.core.sharding import NamedSharding, add_in_order, blocks, concat


@dataclass(frozen=True)
class RobustLoss:
    """ρ(s) on squared residual norms and the IRLS weight ρ'(s)."""

    name: str = "trivial"
    scale: float = 1.0

    def rho(self, s: torch.Tensor) -> torch.Tensor:
        c2 = self.scale * self.scale
        z = s / c2
        if self.name == "trivial":
            return s
        if self.name == "huber":
            return c2 * torch.where(z <= 1.0, z, 2.0 * torch.sqrt(torch.maximum(z, torch.ones_like(z))) - 1.0)
        if self.name == "cauchy":
            return c2 * torch.log1p(z)
        if self.name == "tukey":
            return c2 / 3.0 * torch.where(z <= 1.0, 1.0 - (1.0 - z) ** 3, torch.ones_like(z))
        raise ValueError(f"unknown loss {self.name!r}")

    def weight(self, s: torch.Tensor) -> torch.Tensor:
        """IRLS weight = dρ/ds."""
        c2 = self.scale * self.scale
        z = s / c2
        if self.name == "trivial":
            return torch.ones_like(s)
        if self.name == "huber":
            return torch.where(z <= 1.0, torch.ones_like(z), 1.0 / torch.sqrt(torch.maximum(z, torch.ones_like(z))))
        if self.name == "cauchy":
            return 1.0 / (1.0 + z)
        if self.name == "tukey":
            return torch.where(z <= 1.0, (1.0 - z) ** 2, torch.zeros_like(z))
        raise ValueError(f"unknown loss {self.name!r}")


@dataclass(frozen=True)
class SolverConfig:
    max_iterations: int = 20
    damping: float = 1e-6
    loss: str = "huber"
    loss_scale: float = 1.0
    method: str = "cholesky"  # "cholesky" | "cg"
    cg_iterations: int = 50
    cg_tolerance: float = 1e-8
    step_tolerance: float = 1e-8
    gradient_tolerance: float = 1e-10
    histogram_bins: int = 10


@dataclass
class IterationDiagnostics:
    iteration: int
    cost: float
    gradient_norm: float
    step_norm: float


@dataclass
class ResidualHistogram:
    edges: List[float]
    counts: List[int]

    def to_dict(self) -> Dict:
        return {"edges": self.edges, "counts": self.counts}


@dataclass
class SolverResult:
    x: np.ndarray  # (N, d)
    initial_cost: float
    final_cost: float
    iterations: int
    converged: bool
    status: int  # 0 converged, 1 max-iter, -2 conditioning fallback
    diagnostics: List[IterationDiagnostics] = field(default_factory=list)
    residual_histogram: Optional[ResidualHistogram] = None


class _IterationOutputs(NamedTuple):
    cost: torch.Tensor
    grad_norm: torch.Tensor
    step_norm: torch.Tensor
    active: torch.Tensor


class _EdgeTables(NamedTuple):
    """Segment tables of one edge set: ``node`` over the 2E endpoints
    (ei then ej), ``pair`` over the 4E (row, column) blocks of the dense
    Hessian (ii, ij, ji, jj), ``pair_ids`` the flat block ids it sums into."""

    node: torch.Tensor
    pair: Optional[torch.Tensor]
    pair_ids: Optional[torch.Tensor]


def _edge_tables(edges: torch.Tensor, n: int, dense: bool) -> _EdgeTables:
    e = edges.detach().cpu().numpy().astype(np.int64)
    ei, ej = e[:, 0], e[:, 1]
    node = segment_table(np.concatenate([ei, ej]), n, edges.device)
    if not dense:
        return _EdgeTables(node, None, None)
    uniq, inverse = np.unique(np.concatenate([ei * n + ei, ei * n + ej, ej * n + ei, ej * n + ej]), return_inverse=True)
    return _EdgeTables(node, segment_table(inverse, len(uniq), edges.device), torch.from_numpy(uniq).to(edges.device))


def _dense_partial(tables: _EdgeTables, Ji, Jj, res, w_irls):
    """One edge block's JᵀWJ blocks, summed per (row, column) pair id of
    ``tables.pair_ids``, and its per-node JᵀWr (n, d)."""
    A = Ji * w_irls[:, None, None]
    B = Jj * w_irls[:, None, None]
    blocks = torch.cat(
        [
            torch.einsum("eri,erj->eij", Ji, A),
            torch.einsum("eri,erj->eij", Ji, B),
            torch.einsum("eri,erj->eij", Jj, A),
            torch.einsum("eri,erj->eij", Jj, B),
        ]
    )
    g = torch.cat([torch.einsum("eri,er->ei", A, res), torch.einsum("eri,er->ei", B, res)])
    return segment_sum(blocks, tables.pair), segment_sum(g, tables.node)


def _dense_finish(pair_ids, pair_sums, g_nodes, anchor_free, damping, n, d):
    """The damped normal equations with anchors projected out, from each
    edge block's pair sums (added into one (n·n, d, d) buffer in block
    order; each block's ids are unique) and the summed JᵀWr."""
    H = pair_sums[0].new_zeros((n * n, d, d))
    if len(pair_sums) == 1:
        H[pair_ids[0]] = pair_sums[0]  # unique ids: plain writes
    else:
        for ids, sums in zip(pair_ids, pair_sums):
            ids = ids.to(H.device)
            H[ids] = H[ids] + sums.to(H.device)
    H = H.reshape(n, n, d, d).permute(0, 2, 1, 3).reshape(n * d, n * d)
    b = -g_nodes.reshape(-1)
    free = anchor_free
    H = H * free[:, None] * free[None, :]
    H = H + torch.diag(torch.where(free > 0.5, torch.full_like(free, damping), torch.ones_like(free)))
    return H, b * free


def _scatter_dense(tables: _EdgeTables, Ji, Jj, res, w_irls, anchor_free, damping, n, d):
    """Assemble the dense damped normal equations with anchors projected out."""
    pair_sums, g_nodes = _dense_partial(tables, Ji, Jj, res, w_irls)
    return _dense_finish([tables.pair_ids], [pair_sums], g_nodes, anchor_free, damping, n, d)


def _solve_pos(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cholesky solve of a symmetric positive definite system; NaN where
    the factorisation fails (no host check, no sync)."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.where(info[..., None] == 0, x, torch.full_like(x, float("nan")))


def _cg_solve(matvec, b, precond, iterations: int, tol: float):
    """Preconditioned CG for a fixed trip count, frozen once converged."""
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    tiny = torch.full_like(rz, 1e-30)
    for _ in range(iterations):
        Ap = matvec(p)
        pAp = (p * Ap).sum()
        alpha = rz / torch.where(pAp.abs() < 1e-30, tiny, pAp)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = precond(r_new)
        rz_new = (r_new * z_new).sum()
        beta = rz_new / torch.where(rz.abs() < 1e-30, tiny, rz)
        p_new = z_new + beta * p
        stop = torch.linalg.vector_norm(r) < tol
        x, r, z, p, rz = (torch.where(stop, old, new) for new, old in
                          ((x_new, x), (r_new, r), (z_new, z), (p_new, p), (rz_new, rz)))
    return x


class _EdgeBlock(NamedTuple):
    """One slot's factors on its device, with tables built over them alone."""

    edges: torch.Tensor
    measurements: torch.Tensor
    weights: torch.Tensor
    tables: _EdgeTables


def gauss_newton_core(x0, edges, measurements, weights, anchor_mask, model_name: str, config: SolverConfig,
                      factor_sharding: Optional[NamedSharding] = None):
    """The whole GN/LM optimisation on the inputs' device: returns
    (x_final, final_cost, per-iteration outputs, histogram edges, counts).

    ``factor_sharding`` splits the factors over its mesh (their count must
    divide by its size): slot s linearizes its block on its device and
    assembles partial normal equations with tables built over the block;
    the partials are added in slot order on x0's device, where the solve
    runs."""
    model = MODELS[model_name]
    d = model.dim
    n = x0.shape[0]
    home = x0.device
    residual_all = make_residual_fn(model)
    linearize_all = make_linearize_fn(model)
    loss = RobustLoss(config.loss, config.loss_scale)
    dense = config.method == "cholesky"
    if factor_sharding is None:
        parts = [_EdgeBlock(edges, measurements, weights, _edge_tables(edges, n, dense))]
    else:
        mesh = factor_sharding.mesh
        parts = []
        for (lo, hi), dev in zip(blocks(edges.shape[0], mesh.size, "factor count"), mesh.devices):
            e = edges[lo:hi].to(dev)
            parts.append(_EdgeBlock(e, measurements[lo:hi].to(dev), weights[lo:hi].to(dev), _edge_tables(e, n, dense)))
    anchor_free = torch.where(anchor_mask.repeat_interleave(d), 0.0, 1.0).to(x0.dtype)
    free_nd = anchor_free.reshape(n, d)

    def add(values):
        return add_in_order(values, home)

    def cost_of(x):
        return 0.5 * add([
            loss.rho((r * r).sum(dim=-1)).sum()
            for r in (residual_all(x.to(p.edges.device), p.edges, p.measurements, p.weights) for p in parts)
        ])

    x = x0
    done = torch.zeros((), dtype=torch.bool, device=x0.device)
    outs = []
    for _ in range(config.max_iterations):
        lin = []
        for p in parts:
            res, Ji, Jj = linearize_all(x.to(p.edges.device), p.edges, p.measurements, p.weights)
            s = (res * res).sum(dim=-1)
            lin.append((res, Ji, Jj, loss.weight(s), loss.rho(s).sum()))
        cost = 0.5 * add([rho for *_, rho in lin])
        if dense:
            dense_parts = [_dense_partial(p.tables, Ji, Jj, res, w) for p, (res, Ji, Jj, w, _) in zip(parts, lin)]
            H, b = _dense_finish([p.tables.pair_ids for p in parts], [h for h, _ in dense_parts],
                                 add([g for _, g in dense_parts]), anchor_free, config.damping, n, d)
            delta = _solve_pos(H, b)
        else:
            diag_parts, g_parts = [], []
            for p, (res, Ji, Jj, w, _) in zip(parts, lin):
                A = Ji * w[:, None, None]
                B = Jj * w[:, None, None]
                diag_parts.append(segment_sum(
                    torch.cat([torch.einsum("eri,erj->eij", Ji, A), torch.einsum("eri,erj->eij", Jj, B)]), p.tables.node
                ))
                g_parts.append(segment_sum(
                    torch.cat([torch.einsum("eri,er->ei", A, res), torch.einsum("eri,er->ei", B, res)]), p.tables.node
                ))
            D = add(diag_parts)
            Dinv = torch.linalg.inv_ex(D + config.damping * torch.eye(d, dtype=x.dtype, device=x.device))[0]

            def matvec(v_flat):
                v = (v_flat * anchor_free).reshape(n, d)
                ys = []
                for p, (_, Ji, Jj, w, _) in zip(parts, lin):
                    vp = v.to(p.edges.device)
                    ei, ej = p.edges[:, 0], p.edges[:, 1]
                    Jv = torch.einsum("erj,ej->er", Ji, vp[ei]) + torch.einsum("erj,ej->er", Jj, vp[ej])
                    Jv = Jv * w[:, None]
                    ys.append(segment_sum(
                        torch.cat([torch.einsum("eri,er->ei", Ji, Jv), torch.einsum("eri,er->ei", Jj, Jv)]),
                        p.tables.node,
                    ))
                y = add(ys) * free_nd + config.damping * v
                return (y + v_flat.reshape(n, d) * (1.0 - free_nd)).reshape(-1)  # anchors act as identity

            def precond(r_flat):
                r = r_flat.reshape(n, d)
                z = torch.einsum("nij,nj->ni", Dinv, r)
                return (z * free_nd + r * (1.0 - free_nd)).reshape(-1)

            b = (-add(g_parts) * free_nd).reshape(-1)
            delta = _cg_solve(matvec, b, precond, config.cg_iterations, config.cg_tolerance)

        grad_norm = torch.linalg.vector_norm(b)
        step_vec = (delta * anchor_free).reshape(n, d)
        x_new = model.retract(x, step_vec)
        take = (cost_of(x_new) < cost) & ~done  # keep the step only where the cost falls
        step_norm = torch.linalg.vector_norm(step_vec) * take
        outs.append((cost, grad_norm, step_norm, ~done))
        x = torch.where(take, x_new, x)
        done = done | (step_norm < config.step_tolerance) | (grad_norm < config.gradient_tolerance)
    final_cost = cost_of(x)
    stacked = _IterationOutputs(*(torch.stack(col) for col in zip(*outs)))

    res = concat([residual_all(x.to(p.edges.device), p.edges, p.measurements, p.weights) for p in parts], home)
    rn = torch.linalg.vector_norm(res, dim=-1)
    bins = config.histogram_bins
    stop = torch.maximum(rn.max(), torch.full_like(rn[0], 1e-12)) * (1.0 + 1e-6)
    steps = torch.arange(bins + 1, dtype=x.dtype, device=x.device)
    bin_edges = torch.cat([(stop / bins) * steps[:-1], stop[None]])  # jnp.linspace's form
    bin_idx = (torch.searchsorted(bin_edges, rn, right=True) - 1).clamp(0, bins - 1)
    counts = (bin_idx[None, :] == torch.arange(bins, device=x.device)[:, None]).sum(dim=1).to(x.dtype)
    return x, final_cost, stacked, bin_edges, counts


def gauss_newton_core_packed(x0, edges, measurements, weights, anchor_mask, model_name: str, config: SolverConfig,
                             factor_sharding: Optional[NamedSharding] = None):
    """:func:`gauss_newton_core` with every host-bound output in ONE flat
    float32 tensor: ``[final_cost, x(n·d), cost(I), grad(I), step(I),
    active(I), bin_edges(B+1), counts(B)]`` with I = max_iterations and
    B = histogram_bins."""
    x_final, final_cost, outs, bin_edges, counts = gauss_newton_core(
        x0, edges, measurements, weights, anchor_mask, model_name, config, factor_sharding
    )
    parts = [final_cost.reshape(1), x_final.reshape(-1), outs.cost, outs.grad_norm, outs.step_norm,
             outs.active, bin_edges, counts]
    return torch.cat([p.to(torch.float32) for p in parts])


def solve_problem(
    problem: GraphProblem, config: SolverConfig, factor_sharding: Optional[NamedSharding] = None
) -> SolverResult:
    """Run the core on the problem's device and package the diagnostics
    (one device→host copy). ``factor_sharding`` splits the factors over its
    mesh (see :func:`gauss_newton_core`); the solve then runs on slot 0's
    device (:func:`mvslam_tpu_torch.parallel.mesh.solve_problem_sharded`
    pads the factors to a mesh multiple)."""
    if problem.num_factors == 0 or problem.num_variables == 0:
        return SolverResult(problem.x0.detach().cpu().numpy(), 0.0, 0.0, 0, True, 0)
    x0, anchor_mask = problem.x0, problem.anchor_mask
    if factor_sharding is not None:
        home = factor_sharding.mesh.devices[0]
        x0, anchor_mask = x0.to(home), anchor_mask.to(home)
    buf = gauss_newton_core_packed(
        x0, problem.edges, problem.measurements, problem.weights, anchor_mask,
        problem.model_name, config, factor_sharding,
    ).cpu().numpy()
    n, d = problem.x0.shape
    I, B = config.max_iterations, config.histogram_bins
    final_cost = buf[0]
    off = 1
    x_final = buf[off : off + n * d].reshape(n, d)
    off += n * d
    cost = buf[off : off + I]; off += I  # noqa: E702
    grad = buf[off : off + I]; off += I  # noqa: E702
    step = buf[off : off + I]; off += I  # noqa: E702
    active = buf[off : off + I] > 0.5; off += I  # noqa: E702
    bin_edges = buf[off : off + B + 1]; off += B + 1  # noqa: E702
    counts = buf[off : off + B]
    iters = int(active.sum())
    converged = iters < config.max_iterations
    return SolverResult(
        x=x_final,
        initial_cost=float(cost[0]) if len(cost) else 0.0,
        final_cost=float(final_cost),
        iterations=iters,
        converged=converged,
        status=0 if converged else 1,
        diagnostics=[
            IterationDiagnostics(i, float(cost[i]), float(grad[i]), float(step[i]))
            for i in range(len(cost)) if active[i]
        ],
        residual_histogram=ResidualHistogram(
            edges=[float(v) for v in bin_edges], counts=[int(v) for v in counts]
        ),
    )


def conditioning_stats(problem: GraphProblem, damping: float = 0.0) -> Dict[str, float]:
    """Condition number and min diagonal of the Gauss-Newton Hessian at x0."""
    model = MODELS[problem.model_name]
    d = model.dim
    n = problem.num_variables
    if problem.num_factors == 0 or n == 0:
        return {"condition_number": 1.0, "min_diagonal": 1.0}
    res, Ji, Jj = make_linearize_fn(model)(problem.x0, problem.edges, problem.measurements, problem.weights)
    anchor_free = torch.where(problem.anchor_mask.repeat_interleave(d), 0.0, 1.0).to(problem.x0.dtype)
    w = torch.ones(problem.num_factors, dtype=problem.x0.dtype, device=problem.x0.device)
    H, _ = _scatter_dense(_edge_tables(problem.edges, n, True), Ji, Jj, res, w, anchor_free, damping, n, d)
    Hn = H.cpu().numpy()
    diag = np.diag(Hn)
    try:
        cond = float(np.linalg.cond(Hn))
    except np.linalg.LinAlgError:
        cond = float("inf")
    return {"condition_number": cond, "min_diagonal": float(diag.min()) if diag.size else 0.0}


class Solver:
    name = "base"

    def solve(self, problem: GraphProblem, config: SolverConfig) -> SolverResult:
        raise NotImplementedError


class GaussNewtonSolver(Solver):
    """Batched GN/LM on the problem's device."""

    name = "gauss_newton"

    def solve(self, problem: GraphProblem, config: SolverConfig) -> SolverResult:
        return solve_problem(problem, config)


class ScipyLeastSquaresSolver(Solver):
    """Host fallback via ``scipy.optimize.least_squares``; the residuals are
    evaluated in float32 on CPU tensors, as the reference evaluates them."""

    name = "scipy"

    def solve(self, problem: GraphProblem, config: SolverConfig) -> SolverResult:
        from scipy.optimize import least_squares

        model = MODELS[problem.model_name]
        d = model.dim
        n = problem.num_variables
        residual_all = make_residual_fn(model)
        edges, meas, weights = (t.detach().cpu() for t in (problem.edges, problem.measurements, problem.weights))
        anchor = problem.anchor_mask.cpu().numpy()
        x0 = problem.x0.detach().cpu().numpy().astype(np.float64)
        free_idx = np.where(~np.repeat(anchor, d))[0]

        def unpack(z):
            x = x0.reshape(-1).copy()
            x[free_idx] = z
            return x.reshape(n, d)

        def fun(z):
            res = residual_all(torch.as_tensor(unpack(z), dtype=torch.float32), edges, meas, weights)
            return res.numpy().astype(np.float64).reshape(-1)

        z0 = x0.reshape(-1)[free_idx]
        initial = fun(z0)
        out = least_squares(
            fun,
            z0,
            loss="huber" if config.loss == "huber" else "linear",
            f_scale=config.loss_scale,
            max_nfev=config.max_iterations * 10,
        )
        return SolverResult(
            x=unpack(out.x),
            initial_cost=0.5 * float(initial @ initial),
            final_cost=float(out.cost),
            iterations=int(out.nfev),
            converged=bool(out.success),
            status=0 if out.success else 1,
        )


class SolverRegistry:
    """Thread-safe name → solver registry."""

    def __init__(self) -> None:
        self._solvers: Dict[str, Solver] = {}
        self._lock = threading.Lock()

    def register(self, solver: Solver, name: Optional[str] = None) -> None:
        with self._lock:
            self._solvers[name or solver.name] = solver

    def get(self, name: str) -> Solver:
        with self._lock:
            if name not in self._solvers:
                raise KeyError(f"unknown solver {name!r}; known: {sorted(self._solvers)}")
            return self._solvers[name]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._solvers)


DEFAULT_REGISTRY = SolverRegistry()
DEFAULT_REGISTRY.register(GaussNewtonSolver())
DEFAULT_REGISTRY.register(ScipyLeastSquaresSolver())
