"""mvslam_tpu_torch — the PyTorch/CUDA port of ``mvslam_tpu``.

The port mirrors the JAX package's module names (``ops``, ``geometry``,
``frontend``, ``slam``, ``core``) so each function's reference is easy to
find, and is tested against it on identical numpy inputs. It imports
``torch`` and never ``jax``.

It covers the ``SLAMSystem`` entry point (``slam.api``), the tracking step
(``slam.tracking``: FAST-9 detection, steered BRIEF, Hamming matching,
dual-model RANSAC and the pose estimator), flow-first tracking with
pyramidal Lucas-Kanade (``ops.lk``), the back end (``geometry.lie``,
``backend``: factor graphs, Gauss-Newton solvers, pose graphs, the
optimization supervisor and window bundle adjustment, which ``SLAMSystem``
runs by default), and the numpy host modules these use (``core``,
``backend.keyframes``, ``runtime.frame_stream``, ``eval``,
``data.synthetic``). The two Pallas kernels of the reference run as
hand-written CUDA kernels (``csrc/``) on CUDA tensors; CPU tensors take
each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and the RANSAC solvers need true-f32 products (the reference
# forces ``jax_default_matmul_precision="highest"`` for the same reason):
# TF32 keeps ~10 mantissa bits, which breaks the 9x9 null-space solves.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

del _torch
