"""CUDA kernels K1 and K2 against their plain PyTorch versions, on the card,
alone and inside LK and ``SLAMSystem``.

Every test here needs an NVIDIA GPU and nvcc (marker ``cuda``); without a
card they skip. This file imports no JAX, so it also runs on a machine
without it, where the JAX-importing ``conftest.py`` must be left out::

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from mvslam_tpu_torch.ops import cuda_fast, cuda_patches

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run only on the card)")
    return torch.device("cuda", 0)


def _textured(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 40, size=(b, h, w)).astype(np.float32)
    for _ in range(b * h * w // 400):
        i, y, x = rng.integers(0, b), rng.integers(0, h - 8), rng.integers(0, w - 8)
        s = rng.integers(3, 8)
        img[i, y : y + s, x : x + s] = rng.uniform(120, 255)
    return img


@pytest.mark.parametrize("dtype", ["uint8", "float32", "float32_frac"])
@pytest.mark.parametrize("shape", [(2, 45, 77), (3, 96, 160), (1, 370, 1226)])
def test_fast_detect_kernel_matches_plain(cuda, dtype, shape):
    img = _textured(*shape)
    if dtype == "uint8":
        x = torch.from_numpy(img.astype(np.uint8))
    elif dtype == "float32":
        x = torch.from_numpy(np.round(img))
    else:
        x = torch.from_numpy(img)  # non-integral values: the f32 path
    x = x.to(cuda)
    before = cuda_fast.fast_detect.launches
    det_k, raw_k = cuda_fast.fast_detect(x, 20.0, margin=19)
    det_p, raw_p = cuda_fast.fast_detect_plain(x, 20.0, margin=19)
    torch.cuda.synchronize()
    assert cuda_fast.fast_detect.launches == before + 1
    assert torch.equal(det_k, det_p)
    assert torch.equal(raw_k, raw_p)  # same zero taps everywhere


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 37, 2048])
def test_extract_patches_kernel_matches_plain(cuda, out_dtype, n):
    b, h, w = 3, 70, 101
    image = torch.from_numpy(_textured(b, h, w)).to(cuda)
    rng = np.random.default_rng(n)
    xy = rng.uniform(-20, [w + 20, h + 20], size=(b, n, 2)).astype(np.float32)
    xy[:, : n // 2] = np.round(xy[:, : n // 2]) + 0.5  # round half to even
    xy = torch.from_numpy(xy).to(cuda)
    before = cuda_patches.extract_patches.launches
    got = cuda_patches.extract_patches(image, xy, out_dtype=out_dtype)
    ref = cuda_patches.extract_patches_plain(image, xy, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert cuda_patches.extract_patches.launches == before + 1
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), ref.view(bits))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    with pytest.raises(ValueError):
        cuda_fast.fast_detect(torch.zeros((40, 40), device=cuda), 20.0, margin=19)
    with pytest.raises(ValueError):
        cuda_fast.fast_detect(torch.zeros((1, 40, 40), device=cuda), 20.0, margin=2)
    image = torch.zeros((1, 40, 40), device=cuda)
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(image.double(), torch.zeros((1, 4, 2), device=cuda))
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(image, torch.zeros((1, 4, 2)))  # xy on the CPU
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(image, torch.zeros((1, 4, 2), device=cuda), out_dtype=torch.float16)


@pytest.mark.parametrize("shape", [(128, 160), (130, 170)])
def test_lk_track_with_kernel_matches_plain(cuda, shape):
    """LK on the card: every window from K2 (30 launches for 3 levels of 8
    iterations), bit-equal to LK with K2's plain version."""
    from unittest import mock

    from mvslam_tpu_torch.ops import lk

    h, w = shape
    prev = torch.from_numpy(_textured(1, h, w)[0]).to(cuda)
    nxt = torch.roll(prev, shifts=(2, -3), dims=(0, 1))
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.uniform(-10, [w + 10, h + 10], size=(300, 2)).astype(np.float32)).to(cuda)
    mask = torch.ones(300, dtype=torch.bool, device=cuda)
    before = cuda_patches.extract_patches.launches
    got = lk.lk_track(prev, nxt, pts, mask)
    assert cuda_patches.extract_patches.launches == before + 3 * (8 + 2)
    with mock.patch.object(cuda_patches, "extract_patches", cuda_patches.extract_patches_plain):
        ref = lk.lk_track(prev, nxt, pts, mask)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got[2].sum() > 50


def test_slam_system_on_the_card_launches_both_kernels(cuda, tmp_path):
    from mvslam_tpu_torch.data.synthetic import render_scene
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=6, h=240, w=320, seed=1)
    cfg = SLAMSystemConfig(
        output_root=tmp_path, fx=fx, fy=fy, cx=cx, cy=cy, pose_source="flow_first",
        feature=FeaturePipelineConfig(num_features=256, max_matches=128),
        pose=RobustPoseEstimatorConfig(num_hypotheses=128),
        enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False,
    )
    k1, k2 = cuda_fast.fast_detect.launches, cuda_patches.extract_patches.launches
    diags = SLAMSystem(cfg, device=cuda).run_sequence(frames, window=1)
    assert sum(d.pose_success for d in diags) >= 5
    assert cuda_fast.fast_detect.launches - k1 == 6
    assert cuda_patches.extract_patches.launches - k2 >= 6 + 5 * 30
