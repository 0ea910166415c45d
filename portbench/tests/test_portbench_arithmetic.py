"""Percentiles, spreads, the idle-share union and the kernels' work."""

import math

import numpy as np
import pytest

import torch

from portbench import roofline, stats
from portbench.reference import geometry
from portbench.trace import DeviceTracer, Trace, idle_gaps, union_seconds


def test_failed_frames_count_as_later_than_any_limit():
    lat = [float(i) for i in range(1, 10)] + [math.inf]
    assert stats.percentile(lat, 50) == 5.0
    assert stats.percentile(lat, 90) == 9.0
    assert stats.percentile(lat, 95) == math.inf
    assert stats.percentile([math.inf, 1.0], 50) == 1.0
    assert stats.percentile([], 50) == math.inf


def test_spread_is_the_quartile_distance_over_the_median():
    assert stats.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx((4.5 - 1.5) / 3.0)


def test_union_and_idle_gaps_on_synthetic_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert union_seconds(iv) == pytest.approx(4.0)
    assert idle_gaps(iv, 0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0), (7.0, 8.0)]
    t = Trace(window_s=8.0, ops=[("k", s, e) for s, e in iv])
    assert 1.0 - t.busy_s() / t.window_s == pytest.approx(0.5)


# The kernel table's bounds (PERF.md, bring-up table): (kernel, shape, µs).
ROWS = [
    ("k1", ("torch.uint8", 16, 370, 1226), 19.5),
    ("k1", ("torch.uint8", 8, 370, 1226), 9.75),
    ("k1", ("torch.uint8", 4, 370, 1226), 4.87),
    ("k1", ("torch.uint8", 2, 370, 1226), 2.44),
    ("k1", ("torch.uint8", 1, 370, 1226), 1.22),
    ("k1", ("torch.float32", 16, 370, 1226), 26.0),
    ("k1", ("torch.float32", 1, 370, 1226), 1.62),
    ("k1", ("torch.uint8", 8, 240, 320), 1.65),
    ("k2", ("torch.bfloat16", 16, 370, 1226, 2048), 28.7),
    ("k2", ("torch.bfloat16", 8, 370, 1226, 2048), 14.3),
    ("k2", ("torch.bfloat16", 4, 370, 1226, 2048), 7.16),
    ("k2", ("torch.bfloat16", 2, 370, 1226, 2048), 3.58),
    ("k2", ("torch.bfloat16", 1, 370, 1226, 2048), 1.79),
    ("k2", ("torch.bfloat16", 8, 240, 320, 2048), 10.8),
    ("k2", ("torch.bfloat16", 1, 240, 320, 2048), 1.35),
    ("k2", ("torch.bfloat16", 8, 240, 320, 512), 3.25),
    ("k2", ("torch.bfloat16", 1, 240, 320, 512), 0.406),
]


@pytest.mark.parametrize("kernel,shape,bound_us", ROWS)
def test_kernel_work_matches_the_kernel_table(kernel, shape, bound_us):
    work = roofline.k1_work if kernel == "k1" else roofline.k2_work
    got = roofline.least_seconds(*work(*shape)) * 1e6
    # K2's table counted the pixels its tiles covered; counting the frame
    # whole reads at most 1% more at 1,000-2,048 points a frame.
    assert got == pytest.approx(bound_us, rel=0.01)
    assert got >= bound_us * 0.995


def _two_views(n=200, seed=3):
    rng = np.random.default_rng(seed)
    K = np.array([[700.0, 0, 600], [0, 700.0, 180], [0, 0, 1]])
    X = np.c_[rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(6, 40, n)]
    a = 0.02
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.1, 0.0, -1.0])
    X2 = X @ R.T + t

    def px(Y):
        return torch.tensor(np.c_[K[0, 0] * Y[:, 0] / Y[:, 2] + K[0, 2], K[1, 1] * Y[:, 1] / Y[:, 2] + K[1, 2]], dtype=torch.float32)

    return px(X), px(X2), K, torch.tensor(R), torch.tensor(t)


def test_the_recount_holds_a_pose_to_its_matches():
    p1, p2, K, R, t = _two_views()
    assert geometry.recount(R, t, p1, p2, K, 1.5) == len(p1)
    assert geometry.recount(R, 3.0 * t, p1, p2, K, 1.5) == len(p1)  # scale-free
    assert geometry.recount(torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64), p1, p2, K, 1.5) == 0
    wrong = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    assert geometry.recount(R, wrong, p1, p2, K, 1.5) < len(p1) // 2


def test_the_device_trace_needs_the_cuda_activity():
    if torch.cuda.is_available():
        pytest.skip("the refusal is for a machine with no card")
    with pytest.raises(RuntimeError):
        DeviceTracer({}).start()
