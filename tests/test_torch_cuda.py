"""CUDA kernels K1 and K2 against their plain PyTorch versions, on the card.

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
