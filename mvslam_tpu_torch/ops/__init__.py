"""Detection, description, matching and RANSAC ops (port of ``mvslam_tpu.ops``).

``cuda_fast`` and ``cuda_patches`` hold the hand-written CUDA kernels K1
and K2 with their plain PyTorch versions."""
