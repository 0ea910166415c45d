"""Pose-graph optimisation over SE(2) / SE(3) / Sim(3).

Port of ``mvslam_tpu/backend/pose_graph.py``: chain building with
``add_pose`` (compose the last pose with an odometry delta and add a
between-factor), ``add_loop``, deterministic edge ordering with a
stable-hash tiebreaker (``FactorGraph``), and ``optimize()`` running the
(optionally supervised) solver on ``device`` and writing back the corrected
poses. Chain building composes on the host (``geometry.lie_np``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from mvslam_tpu_torch.backend.factor_graph import MODELS, FactorGraph
from mvslam_tpu_torch.backend.solvers import DEFAULT_REGISTRY, SolverConfig, SolverResult
from mvslam_tpu_torch.geometry import lie_np


@dataclass
class PoseGraphSnapshot:
    """Digest-carrying snapshot."""

    model: str
    num_poses: int
    num_edges: int
    digest: str

    def to_dict(self) -> Dict:
        return self.__dict__.copy()


_HOST_COMPOSE = {
    "se2": lambda x, d: lie_np.se2_params(lie_np.se2_matrix(x) @ lie_np.se2_matrix(d)),
    "se3": lambda x, d: lie_np.se3_matrix_to_params(
        lie_np.se3_params_to_matrix(x) @ lie_np.se3_params_to_matrix(d)
    ),
    "sim3": lambda x, d: lie_np.sim3_params(lie_np.sim3_matrix(x) @ lie_np.sim3_matrix(d)),
}


class PoseGraphBase:
    """Common chain/loop/optimize machinery; subclasses pick the group.
    The solve runs on ``device`` (the card unless the caller asks for the
    CPU)."""

    model_name = "se3"

    def __init__(self, solver: str = "gauss_newton", supervisor=None, device="cuda") -> None:
        self.model = MODELS[self.model_name]
        self._params: List[np.ndarray] = [np.zeros(self.model.dim)]
        self._odometry: List[tuple] = []  # (i, j, measurement, weight)
        self._loops: List[tuple] = []
        self.solver_name = solver
        self.supervisor = supervisor
        self.device = device
        self.last_result: Optional[SolverResult] = None

    def __len__(self) -> int:
        return len(self._params)

    @property
    def num_edges(self) -> int:
        return len(self._odometry) + len(self._loops)

    def add_pose(self, delta: np.ndarray, weight: float = 1.0) -> int:
        """Compose the last pose with an odometry delta and add a between edge."""
        delta = np.asarray(delta, dtype=np.float64).reshape(self.model.dim)
        new = np.asarray(_HOST_COMPOSE[self.model_name](self._params[-1], delta), dtype=np.float64)
        i = len(self._params) - 1
        self._params.append(new)
        self._odometry.append((i, i + 1, delta, float(weight)))
        return i + 1

    def add_loop(self, i: int, j: int, measurement: np.ndarray, weight: float = 1.0) -> None:
        measurement = np.asarray(measurement, dtype=np.float64).reshape(self.model.dim)
        self._loops.append((int(i), int(j), measurement, float(weight)))

    @property
    def params(self) -> np.ndarray:
        return np.stack(self._params)

    def _build_graph(self) -> FactorGraph:
        graph = FactorGraph(model_name=self.model_name)
        for vid, value in enumerate(self._params):
            graph.add_variable(vid, value)
        graph.anchor(0)
        for i, j, meas, w in self._odometry + self._loops:
            graph.add_factor(i, j, meas, w)
        return graph

    def snapshot(self) -> PoseGraphSnapshot:
        return PoseGraphSnapshot(
            model=self.model_name,
            num_poses=len(self._params),
            num_edges=self.num_edges,
            digest=self._build_graph().digest(),
        )

    def optimize(self, config: Optional[SolverConfig] = None) -> SolverResult:
        """Solve and write the corrected poses back."""
        config = config or SolverConfig()
        problem = self._build_graph().build_problem(device=self.device)
        if self.supervisor is not None:
            result = self.supervisor.run(problem, self.solver_name, config)
        else:
            result = DEFAULT_REGISTRY.get(self.solver_name).solve(problem, config)
        if result.status >= 0:  # not a conditioning fallback
            self._params = [np.asarray(result.x[k], dtype=np.float64) for k in range(result.x.shape[0])]
        self.last_result = result
        return result


class PoseGraph(PoseGraphBase):
    """SE(2) pose graph — params [x, y, theta]."""

    model_name = "se2"

    def poses(self) -> np.ndarray:
        """(N, 3, 3) homogeneous transforms."""
        return lie_np.se2_matrix(self.params)


class PoseGraph3D(PoseGraphBase):
    """SE(3) pose graph — params [t(3), rvec(3)]."""

    model_name = "se3"

    @classmethod
    def from_pose_matrices(cls, poses, weight: float = 1.0, **kwargs) -> "PoseGraph3D":
        """Build an odometry chain from (N, 4, 4) absolute poses."""
        graph = cls(**kwargs)
        poses = [np.asarray(p, dtype=np.float64) for p in poses]
        if poses:
            graph._params = [lie_np.se3_matrix_to_params(poses[0])]
            for a, b in zip(poses[:-1], poses[1:]):
                graph.add_pose_matrix(np.linalg.inv(a) @ b, weight)
        return graph

    def poses(self) -> np.ndarray:
        return lie_np.se3_params_to_matrix(self.params)

    def add_pose_matrix(self, T_delta: np.ndarray, weight: float = 1.0) -> int:
        return self.add_pose(lie_np.se3_matrix_to_params(T_delta), weight)

    def add_loop_matrix(self, i: int, j: int, T_meas: np.ndarray, weight: float = 1.0) -> None:
        self.add_loop(i, j, lie_np.se3_matrix_to_params(T_meas), weight)


class PoseGraphSim3D(PoseGraphBase):
    """Sim(3) pose graph — params [t, rvec, log_s]."""

    model_name = "sim3"

    def poses(self) -> np.ndarray:
        return lie_np.sim3_matrix(self.params)
