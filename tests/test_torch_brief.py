"""Steered BRIEF, kernel K2's plain version and detect_and_describe against
the JAX reference (K2 as ``tests/test_ops.py`` runs it: interpret mode)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import desc_u32, t, textured_image, to_np

from mvslam_tpu.ops import brief as jbrief
from mvslam_tpu.ops import detect as jdetect
from mvslam_tpu.ops import fast as jfast
from mvslam_tpu.ops import image as jimage
from mvslam_tpu.ops.pallas_patches import extract_patches_pallas
from mvslam_tpu_torch.ops import brief as tbrief
from mvslam_tpu_torch.ops import cuda_patches
from mvslam_tpu_torch.ops import detect as tdetect
from mvslam_tpu_torch.ops import fast as tfast
from mvslam_tpu_torch.ops import image as timage


def test_tables_equal_reference():
    assert np.array_equal(tbrief._PATTERN, jbrief._PATTERN)
    assert np.array_equal(tbrief._MOMENTS, jbrief._MOMENTS)
    assert np.array_equal(tbrief._COMPARISON_BANK, jbrief._COMPARISON_BANK)
    assert np.array_equal(tfast._CIRCLE, jfast._CIRCLE)
    assert np.array_equal(timage._gaussian_kernel(2.0, 4), jimage._gaussian_kernel(2.0, 4))


def test_load_reference_tables_installs_the_arrays():
    saved = (tbrief._PATTERN, tbrief._MOMENTS, tbrief._COMPARISON_BANK)
    try:
        tbrief.load_reference_tables(jbrief._PATTERN, jbrief._MOMENTS, 2.0 * jbrief._COMPARISON_BANK)
        _, bank = tbrief._tables("cpu")
        assert torch.equal(bank.float(), t(2.0 * jbrief._COMPARISON_BANK))
    finally:
        tbrief.load_reference_tables(*saved)
    _, bank = tbrief._tables("cpu")
    assert torch.equal(bank.float(), t(jbrief._COMPARISON_BANK))


@pytest.mark.parametrize("sigma,radius", [(2.0, 4), (1.0, 2)])
def test_blur_equals_reference(sigma, radius):
    img = textured_image(seed=1)
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma=sigma, radius=radius))
    assert np.array_equal(to_np(timage.gaussian_blur(t(img), sigma=sigma, radius=radius)), ref)


def test_gray_and_downsample_equal_reference():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(2, 24, 30, 3)).astype(np.uint8)
    gray = np.asarray(jimage.rgb_to_gray(jnp.asarray(rgb)))
    assert np.allclose(to_np(timage.rgb_to_gray(t(rgb))), gray, rtol=0, atol=1e-4)
    img = rng.uniform(0, 255, size=(24, 31)).astype(np.float32)
    assert np.array_equal(to_np(timage.downsample2(t(img))), np.asarray(jimage.downsample2(jnp.asarray(img))))


def _keypoints_for_k2(h, w, n, seed):
    """Clamped (outside the image), exact .5 and ordinary coordinates."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, [w + 10, h + 10], size=(n, 2)).astype(np.float32)
    xy[: n // 3] = np.round(xy[: n // 3]) + 0.5
    xy[-4:] = [[-30.0, -30.0], [w + 30.0, h + 30.0], [14.5, 15.5], [w - 15.5, h - 16.5]]
    return xy


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_k2_plain_equals_pallas_interpret(out_dtype):
    """Bit-equal, with a keypoint count that is no multiple of the Pallas
    kernel's 256-keypoint chunk."""
    img = textured_image(h=70, w=150, seed=2)
    xy = _keypoints_for_k2(70, 150, 300, seed=4)
    jdt = None if out_dtype == "float32" else jnp.bfloat16
    tdt = None if out_dtype == "float32" else torch.bfloat16
    ref = np.asarray(extract_patches_pallas(jnp.asarray(img), jnp.asarray(xy), out_dtype=jdt, interpret=True))
    got = cuda_patches.extract_patches(t(img)[None], t(xy)[None], out_dtype=tdt)[0]
    bits = np.uint16 if out_dtype == "bfloat16" else np.uint32
    got_np = to_np(got.view(torch.int16) if tdt is not None else got.view(torch.int32))
    assert np.array_equal(got_np.view(bits), ref.view(bits))


def test_k2_wrapper_uses_plain_version_only_for_cpu_tensors():
    before = cuda_patches.extract_patches.launches
    cuda_patches.extract_patches(torch.zeros((1, 40, 40)), torch.zeros((1, 3, 2)))
    assert cuda_patches.extract_patches.launches == before
    with pytest.raises(ValueError):
        cuda_patches.extract_patches(torch.zeros((1, 40, 40), device="meta"), torch.zeros((1, 3, 2), device="meta"))


def test_pack_unpack_bits_equal_reference():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(17, 256)).astype(bool)
    ref = np.asarray(jbrief._pack_bits(jnp.asarray(bits)))
    packed = tbrief._pack_bits(t(bits))
    assert packed.dtype == torch.int32
    assert np.array_equal(desc_u32(packed), ref)
    assert np.array_equal(to_np(tbrief.unpack_bits(packed)), np.asarray(jbrief.unpack_bits(jnp.asarray(ref))))


def _describe_both(seed):
    img = textured_image(h=96, w=160, seed=seed, n_blobs=60)
    blurred = np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma=2.0, radius=4))
    jxy, _, jvalid = jfast.detect_keypoints(jnp.asarray(img), 256, jfast.FastConfig(grid_cells=4))
    jdesc, jang = jbrief.describe_keypoints(jnp.asarray(blurred), jxy, jvalid)
    desc, ang = tbrief.describe_keypoints(t(blurred), t(jxy), t(jvalid))
    return np.asarray(jvalid), np.asarray(jdesc), np.asarray(jang), desc_u32(desc), to_np(ang)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_descriptors_equal_where_angle_bins_agree(seed):
    """The moment product is bf16 with f32 sums whose order differs between
    XLA:CPU and torch, so an angle may land in the neighbouring bin — only
    ever within 1e-3 rad of a bin edge. Wherever the bins agree, every bit
    agrees."""
    valid, jdesc, jang, desc, ang = _describe_both(seed)
    assert valid.sum() > 50
    step = 2 * math.pi / 32

    def bins(a):
        return np.round(np.mod(a, 2 * np.pi) / (2 * np.pi) * 32).astype(np.int64) % 32

    same = bins(ang) == bins(jang)
    assert same[valid].mean() >= 0.99
    for a in ang[valid & ~same]:
        edge_dist = abs((np.mod(a, 2 * np.pi) / step) % 1.0 - 0.5) * step
        assert edge_dist < 1e-3
    assert np.array_equal(desc[valid & same], jdesc[valid & same])
    assert np.abs(ang - jang).max() < 1e-4
    assert not desc[~valid].any()


@pytest.mark.parametrize("num_levels", [1, 2])
def test_detect_and_describe_equals_reference(num_levels):
    """Including the uint8 score-image route at level 0."""
    img = textured_image(h=128, w=192, seed=7, n_blobs=80)
    frame = img.astype(np.uint8)
    gray = frame.astype(np.float32)
    ref = jdetect.detect_and_describe(
        jnp.asarray(gray), 256, jfast.FastConfig(grid_cells=4), jbrief.BriefConfig(),
        num_levels=num_levels, score_image=jnp.asarray(frame),
    )
    got = tdetect.detect_and_describe(
        t(gray), 256, tfast.FastConfig(grid_cells=4), tbrief.BriefConfig(),
        num_levels=num_levels, score_image=t(frame),
    )
    jxy, jscores, jdesc, jang, jvalid = (np.asarray(a) for a in ref)
    xy, scores, desc, ang, valid = got
    assert np.array_equal(to_np(valid), jvalid)
    assert np.abs(to_np(xy) - jxy).max() <= 1e-6
    assert np.array_equal(to_np(scores), jscores)
    assert np.array_equal(desc_u32(desc), jdesc)
    assert np.abs(to_np(ang) - jang).max() < 1e-4


def test_detect_and_describe_too_small_image_is_all_invalid():
    xy, scores, desc, ang, valid = tdetect.detect_and_describe(
        torch.zeros((2, 30, 30)), 16, tfast.FastConfig(), tbrief.BriefConfig()
    )
    assert xy.shape == (2, 16, 2) and desc.shape == (2, 16, 8) and not valid.any()


def test_offline_scene_blur_rounding_flips_one_descriptor_bit():
    """Frame 0 of the offline benchmark's out-and-back scene (1226x370,
    400 quads, noise 6, seed 2, as ``chip_smoke.py::offline_scene`` writes
    it): the one descriptor bit in which the packages differ there.

    Inside a jitted program XLA:CPU contracts the blur's multiply-adds into
    fused multiply-adds (an order that the compiler chooses per fused
    loop; op by op it rounds as the port does), where the port,
    on either device, rounds each product and each sum as written: a third
    of the blurred pixels differ by 1-4 ulp. Rounded to bf16 (the
    descriptor's pixel type) only two differ, one of them a tie: 142.5 in
    the port rounds to even (142), 142.500015 in the reference up (143).
    That pixel lies in keypoint 1995's patch and flips one comparison, so
    one of 2048 descriptors differs by one bit. No port reproduces the
    compiler's contraction, so the count, not equality, is pinned."""
    from mvslam_tpu.data.synthetic import render_scene
    from mvslam_tpu.slam import tracking as jtrack
    from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFC
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.slam import tracking as ttrack

    frames, *_ = render_scene(num_frames=1, h=370, w=1226, seed=2, n_pts=400, noise=6.0,
                              traj_fn=lambda i: (np.eye(3), np.zeros(3)))
    frame = np.asarray(frames[0]).astype(np.uint8)
    gray = frame.astype(np.float32)

    import jax

    ours = to_np(timage.gaussian_blur(t(gray), sigma=2.0, radius=4))
    # Op by op, the reference rounds as the port does; fused under jit (as
    # inside its tracking step) it does not.
    assert np.array_equal(np.asarray(jimage.gaussian_blur(jnp.asarray(gray), sigma=2.0, radius=4)), ours)
    ref = np.asarray(jax.jit(lambda g: jimage.gaussian_blur(g, sigma=2.0, radius=4))(jnp.asarray(gray)))
    # The port: each product and sum rounded in the written order.
    k, plain = timage._gaussian_kernel(2.0, 4), gray
    for axis in (0, 1):
        acc = np.float32(k[4]) * plain
        for i in range(1, 5):
            acc = acc + np.float32(k[4 + i]) * np.roll(plain, -i, axis=axis)
            acc = acc + np.float32(k[4 - i]) * np.roll(plain, i, axis=axis)
        plain = acc
    assert np.array_equal(ours, plain)
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - ref.view(np.int32))
    assert 0.25 < (ulps > 0).mean() < 0.45 and ulps.max() <= 4
    bf = lambda a: to_np(torch.from_numpy(a).to(torch.bfloat16).float())  # noqa: E731
    assert (bf(ours) != bf(ref)).sum() == 2
    assert ours[292, 743] == np.float32(142.5) and ref[292, 743] == np.nextafter(np.float32(142.5), np.float32(143))
    assert bf(ours)[292, 743] == 142.0 and bf(ref)[292, 743] == 143.0

    fs = ttrack.bootstrap_frame(t(frame), FeaturePipelineConfig())
    jfs = jtrack.bootstrap_frame(jnp.asarray(frame), JFC())
    assert np.array_equal(to_np(fs.valid), np.asarray(jfs.valid)) and np.array_equal(to_np(fs.xy), np.asarray(jfs.xy))
    desc, jdesc = desc_u32(fs.descriptors), np.asarray(jfs.descriptors)
    rows = np.nonzero((desc != jdesc).any(axis=1))[0]
    assert rows.tolist() == [1995]
    assert np.unpackbits((desc[1995] ^ jdesc[1995]).view(np.uint8)).sum() == 1
    np.testing.assert_allclose(to_np(fs.xy)[1995], [743.0285, 290.95746], atol=1e-4)
