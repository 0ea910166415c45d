"""Deterministic factor graphs with exact forward-mode Jacobians.

Port of ``mvslam_tpu/backend/factor_graph.py``: variables, anchored ids and
deterministically ordered between-factors for SE(2)/SE(3)/Sim(3), stacked
into arrays (edges (E, 2), measurements (E, d)) so that residuals and
Jacobians of ALL factors evaluate at once: ``torch.func.vmap`` over the
rows of ``torch.func.jacfwd``, with ``x[edges]`` gathered outside the vmap.
Anchoring is an exact projection in the solvers, not a soft prior.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from mvslam_tpu_torch.core.integrity import stable_hash
from mvslam_tpu_torch.geometry.lie import (
    se2_matrix,
    se2_params,
    se3_inverse,
    se3_log,
    se3_matrix,
    sim3_inverse,
    sim3_matrix,
    sim3_params,
    so3_exp,
    so3_log,
    wrap_angle,
)


class GroupModel:
    """Interface: parameter-vector group for between-factor graphs.
    ``residual`` takes one factor's rows (it runs under ``vmap``)."""

    name: str = "base"
    dim: int = 0

    def residual(self, xi: torch.Tensor, xj: torch.Tensor, meas: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def compose(self, xi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
        """xj = xi ∘ delta (used by pose-graph chain building)."""
        raise NotImplementedError

    def retract(self, x: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
        """Apply a solver step in parameter space (default: additive)."""
        return x + step


class SE2Model(GroupModel):
    """[x, y, theta]."""

    name = "se2"
    dim = 3

    def residual(self, xi, xj, meas):
        Ti = se2_matrix(xi)
        Tj = se2_matrix(xj)
        dt = Ti[:2, :2].T @ (Tj[:2, 2] - Ti[:2, 2])
        pred = torch.cat([dt, wrap_angle(xj[2] - xi[2])[None]])
        err = pred - meas
        return torch.cat([err[:2], wrap_angle(err[2])[None]])

    def compose(self, xi, delta):
        return se2_params(se2_matrix(xi) @ se2_matrix(delta))

    def retract(self, x, step):
        out = x + step
        return torch.cat([out[..., :2], wrap_angle(out[..., 2:3])], dim=-1)


class SE3Model(GroupModel):
    """[t(3), rvec(3)], with the right-invariant log residual."""

    name = "se3"
    dim = 6

    @staticmethod
    def params_to_matrix(x: torch.Tensor) -> torch.Tensor:
        return se3_matrix(so3_exp(x[..., 3:6]), x[..., :3])

    @staticmethod
    def matrix_to_params(T: torch.Tensor) -> torch.Tensor:
        return torch.cat([T[..., :3, 3], so3_log(T[..., :3, :3])], dim=-1)

    def residual(self, xi, xj, meas):
        Ti = self.params_to_matrix(xi)
        Tj = self.params_to_matrix(xj)
        Tm = self.params_to_matrix(meas)
        return se3_log(se3_inverse(Tm) @ (se3_inverse(Ti) @ Tj))

    def compose(self, xi, delta):
        return self.matrix_to_params(self.params_to_matrix(xi) @ self.params_to_matrix(delta))


class Sim3Model(GroupModel):
    """[t(3), rvec(3), log_s]."""

    name = "sim3"
    dim = 7

    def residual(self, xi, xj, meas):
        err = sim3_inverse(sim3_matrix(meas)) @ (sim3_inverse(sim3_matrix(xi)) @ sim3_matrix(xj))
        return sim3_params(err)

    def compose(self, xi, delta):
        return sim3_params(sim3_matrix(xi) @ sim3_matrix(delta))


MODELS: Dict[str, GroupModel] = {"se2": SE2Model(), "se3": SE3Model(), "sim3": Sim3Model()}


class GraphProblem(NamedTuple):
    """Array-form factor graph, ready for the batched solvers (tensors on
    one device)."""

    x0: torch.Tensor  # (N, d) initial variable values
    edges: torch.Tensor  # (E, 2) int64
    measurements: torch.Tensor  # (E, d)
    weights: torch.Tensor  # (E,) per-factor scalar weights (1/sigma)
    anchor_mask: torch.Tensor  # (N,) bool — True = variable fixed
    model_name: str

    @property
    def num_variables(self) -> int:
        return self.x0.shape[0]

    @property
    def num_factors(self) -> int:
        return self.edges.shape[0]


def make_residual_fn(model: GroupModel):
    """(x (N,d), edges, meas, weights) → (E, d) stacked residuals, weights applied."""

    def residual_all(x, edges, meas, weights):
        res = vmap(model.residual)(x[edges[:, 0]], x[edges[:, 1]], meas)
        return res * weights[:, None]

    return residual_all


def make_linearize_fn(model: GroupModel):
    """(x, edges, meas, w) → (res (E,d), Ji (E,d,d), Jj (E,d,d)) via jacfwd."""

    def single(xi, xj, meas, w):
        res = model.residual(xi, xj, meas) * w
        Ji = jacfwd(lambda a: model.residual(a, xj, meas) * w)(xi)
        Jj = jacfwd(lambda b: model.residual(xi, b, meas) * w)(xj)
        return res, Ji, Jj

    def linearize_all(x, edges, meas, weights):
        return vmap(single)(x[edges[:, 0]], x[edges[:, 1]], meas, weights)

    return linearize_all


@dataclass
class FactorGraph:
    """Host-side graph assembly with deterministic ordering and stable digests
    (the reference's digest strings, from the same payload)."""

    model_name: str = "se3"
    variables: Dict[int, np.ndarray] = field(default_factory=dict)
    anchors: set = field(default_factory=set)
    factors: List[Tuple[int, int, np.ndarray, float]] = field(default_factory=list)

    @property
    def model(self) -> GroupModel:
        return MODELS[self.model_name]

    def add_variable(self, vid: int, value: np.ndarray) -> None:
        self.variables[int(vid)] = np.asarray(value, dtype=np.float64).reshape(self.model.dim)

    def anchor(self, vid: int) -> None:
        if vid not in self.variables:
            raise KeyError(f"cannot anchor unknown variable {vid}")
        self.anchors.add(int(vid))

    def add_factor(self, i: int, j: int, measurement: np.ndarray, weight: float = 1.0) -> None:
        if i not in self.variables or j not in self.variables:
            raise KeyError(f"factor references unknown variables ({i}, {j})")
        meas = np.asarray(measurement, dtype=np.float64).reshape(self.model.dim)
        self.factors.append((int(i), int(j), meas, float(weight)))

    def ordered_ids(self) -> List[int]:
        return sorted(self.variables)

    def ordered_factors(self) -> List[Tuple[int, int, np.ndarray, float]]:
        """Deterministic sort with a stable-hash tiebreaker."""
        return sorted(self.factors, key=lambda f: (f[0], f[1], stable_hash({"m": f[2], "w": f[3]})))

    def digest(self) -> str:
        return stable_hash(
            {
                "model": self.model_name,
                "variables": {str(k): self.variables[k] for k in self.ordered_ids()},
                "anchors": sorted(self.anchors),
                "factors": [{"i": i, "j": j, "meas": m, "w": w} for i, j, m, w in self.ordered_factors()],
            }
        )

    def build_problem(self, dtype=torch.float32, device="cuda") -> GraphProblem:
        """Array form of the graph, on ``device`` (the card unless the
        caller asks for the CPU)."""
        ids = self.ordered_ids()
        index = {vid: k for k, vid in enumerate(ids)}
        x0 = np.stack([self.variables[v] for v in ids]) if ids else np.zeros((0, self.model.dim))
        factors = self.ordered_factors()
        if factors:
            edges = np.asarray([[index[i], index[j]] for i, j, _, _ in factors], dtype=np.int64)
            meas = np.stack([m for _, _, m, _ in factors])
            weights = np.asarray([w for _, _, _, w in factors])
        else:
            edges = np.zeros((0, 2), dtype=np.int64)
            meas = np.zeros((0, self.model.dim))
            weights = np.zeros((0,))
        anchor_mask = np.asarray([vid in self.anchors for vid in ids], dtype=bool)
        return GraphProblem(
            x0=torch.as_tensor(x0, dtype=dtype, device=device),
            edges=torch.as_tensor(edges, device=device),
            measurements=torch.as_tensor(meas, dtype=dtype, device=device),
            weights=torch.as_tensor(weights, dtype=dtype, device=device),
            anchor_mask=torch.as_tensor(anchor_mask, device=device),
            model_name=self.model_name,
        )
