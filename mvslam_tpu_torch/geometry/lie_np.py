"""Host (numpy) evaluation of the Lie-group maps in :mod:`geometry.lie`.

The pose-graph chain building calls these per node and per edge in Python
loops, where a device op per call would cost a launch (and a copy back)
each. One source of truth: each function here evaluates the SAME torch code
as :mod:`geometry.lie`, on float64 CPU tensors behind a numpy-in, numpy-out
wrapper, so the numerically subtle parts (``so3_log`` near π) are written
once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mvslam_tpu_torch.geometry import lie as _lie


def _on_host(fn):
    @functools.wraps(fn)
    def wrapper(*arrays):
        tensors = [torch.as_tensor(np.asarray(a, dtype=np.float64)) for a in arrays]
        out = fn(*tensors)
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()

    return wrapper


hat = _on_host(_lie.hat)
_sinc_coeffs = _on_host(_lie._sinc_coeffs)
so3_exp = _on_host(_lie.so3_exp)
so3_log = _on_host(_lie.so3_log)
se3_matrix = _on_host(_lie.se3_matrix)
se3_inverse = _on_host(_lie.se3_inverse)
se2_matrix = _on_host(_lie.se2_matrix)
se2_params = _on_host(_lie.se2_params)
wrap_angle = _on_host(_lie.wrap_angle)
sim3_matrix = _on_host(_lie.sim3_matrix)
sim3_params = _on_host(_lie.sim3_params)
sim3_inverse = _on_host(_lie.sim3_inverse)


def se3_params_to_matrix(x: np.ndarray) -> np.ndarray:
    """[t(3), rvec(3)] → (4, 4); host twin of SE3Model.params_to_matrix."""
    x = torch.as_tensor(np.asarray(x, dtype=np.float64))
    return _lie.se3_matrix(_lie.so3_exp(x[..., 3:6]), x[..., :3]).numpy()


def se3_matrix_to_params(T: np.ndarray) -> np.ndarray:
    """(4, 4) → [t(3), rvec(3)]; host twin of SE3Model.matrix_to_params."""
    T = torch.as_tensor(np.asarray(T, dtype=np.float64))
    return torch.cat([T[..., :3, 3], _lie.so3_log(T[..., :3, :3])], dim=-1).numpy()
