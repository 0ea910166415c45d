"""Synthetic multi-view scene renderer (egress-free demo/benchmark data).

The reference downloads sample videos for its demos/benchmarks
(``demo_utils.py:19-35``); this environment has no egress, so the
framework ships a perspective renderer producing geometrically-exact
multi-view sequences instead: textured planar quads anchored to fixed 3-D
points, rendered through the induced homography per view. Used by the
accuracy tests (``tests/test_accuracy.py``) and the full-pipeline
benchmark (``benchmarks/benchmark_offline_pipeline.py``).

Copied verbatim from ``mvslam_tpu/data/synthetic.py`` (numpy only): the
port renders the same frames without importing the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["render_scene", "write_kitti_sequence"]


def render_scene(num_frames=10, h=240, w=320, seed=0, traj_fn=None, planar=False,
                 n_pts=250, noise=0.0, depth_range=(4.0, 12.0)):
    """Perspective-render a field of textured planar quads from a moving camera.

    Each 3-D point carries a FIXED random texture on a small world-space
    planar quad (normal facing the cameras), rendered by projecting the quad
    corners and inverse-warping the texture through the induced homography
    with bilinear sampling. Every texture corner is therefore a TRUE fixed
    3-D point: multi-view geometry (tracks, BA, wide-baseline loops) is
    exactly consistent, and patches rotate/scale correctly with the view —
    unlike an axis-aligned splat, which quantises positions and breaks
    multi-view consistency at wide baselines.

    ``traj_fn(i) -> (R_wc, t_w)`` gives the world-from-camera pose per
    frame (default: pure translation, R = I).  ``planar=True`` puts every
    point on the z = 8 world plane (homography-degenerate geometry).
    Returns (frames, gt_positions (N,3), intrinsics, gt_poses (N,4,4)).
    """
    rng = np.random.default_rng(seed)
    fx = fy = 350.0
    cx, cy = w / 2, h / 2
    xs = rng.uniform(-3, 10, n_pts)
    ys = rng.uniform(-3, 3, n_pts)
    depth = np.full(n_pts, 8.0) if planar else rng.uniform(*depth_range, n_pts)
    pts3d = np.stack([xs, ys, depth], axis=1)
    if traj_fn is None:
        traj_fn = lambda i: (np.eye(3), np.array([0.2 * i, 0.0, 0.04 * i]))
    # Texture span must dominate the 31px BRIEF patch: at 7px quads the
    # descriptor is mostly black background whose parallax shimmer breaks
    # matching (~30% gt-correct matches); at 25px it reaches ~69%.
    patch_size = 25
    tex = rng.uniform(40, 255, size=(n_pts, patch_size, patch_size)).astype(np.float32)
    # World-space quad half-size: appears ~patch_size px at the point's
    # initial depth, then scales naturally with perspective.
    half_side = 0.5 * patch_size * depth / fx  # (n_pts,)
    # Quad corners in world space: point + half_side * (±x̂ ± ŷ).
    corner_signs = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float64)
    # Texture coords of those corners (u_tex, v_tex) in [0, P-1].
    tex_corners = np.array(
        [[0, 0], [patch_size - 1, 0], [patch_size - 1, patch_size - 1], [0, patch_size - 1]],
        dtype=np.float64,
    )

    def homography_from_4pts(src, dst):
        """Exact 4-point homography src→dst via an 8x8 DLT solve."""
        A = np.zeros((8, 8))
        b = np.zeros(8)
        for r, ((sx, sy), (dx, dy)) in enumerate(zip(src, dst)):
            A[2 * r] = [sx, sy, 1, 0, 0, 0, -dx * sx, -dx * sy]
            A[2 * r + 1] = [0, 0, 0, sx, sy, 1, -dy * sx, -dy * sy]
            b[2 * r] = dx
            b[2 * r + 1] = dy
        hvec = np.linalg.solve(A, b)
        return np.array(
            [[hvec[0], hvec[1], hvec[2]], [hvec[3], hvec[4], hvec[5]], [hvec[6], hvec[7], 1.0]]
        )

    gt_poses = []
    frames = []
    for i in range(num_frames):
        R, t = traj_fn(i)
        pose = np.eye(4)
        pose[:3, :3] = R
        pose[:3, 3] = t
        gt_poses.append(pose)
        cam_centers = (pts3d - t) @ R
        img = np.zeros((h, w), dtype=np.float32)
        order = np.argsort(-cam_centers[:, 2])  # far first, near overwrites
        for k in order:
            if cam_centers[k, 2] < 1.5:
                continue
            quad_world = pts3d[k] + np.concatenate(
                [half_side[k] * corner_signs, np.zeros((4, 1))], axis=1
            )
            quad_cam = (quad_world - t) @ R
            if quad_cam[:, 2].min() < 0.5:
                continue
            quad_px = np.stack(
                [
                    fx * quad_cam[:, 0] / quad_cam[:, 2] + cx,
                    fy * quad_cam[:, 1] / quad_cam[:, 2] + cy,
                ],
                axis=1,
            )
            x0 = int(np.floor(quad_px[:, 0].min()))
            x1 = int(np.ceil(quad_px[:, 0].max())) + 1
            y0 = int(np.floor(quad_px[:, 1].min()))
            y1 = int(np.ceil(quad_px[:, 1].max())) + 1
            x0c, x1c = max(x0, 0), min(x1, w)
            y0c, y1c = max(y0, 0), min(y1, h)
            if x0c >= x1c or y0c >= y1c:
                continue
            H_img_to_tex = homography_from_4pts(quad_px, tex_corners)
            gy, gx = np.mgrid[y0c:y1c, x0c:x1c]
            ones = np.ones_like(gx, dtype=np.float64)
            mapped = np.einsum(
                "ij,jyx->iyx", H_img_to_tex, np.stack([gx, gy, ones])
            )
            tu = mapped[0] / mapped[2]
            tv = mapped[1] / mapped[2]
            inside = (tu >= 0) & (tu <= patch_size - 1) & (tv >= 0) & (tv <= patch_size - 1)
            if not inside.any():
                continue
            tu = np.clip(tu, 0, patch_size - 1 - 1e-9)
            tv = np.clip(tv, 0, patch_size - 1 - 1e-9)
            iu, iv = tu.astype(int), tv.astype(int)
            au, av = tu - iu, tv - iv
            T = tex[k]
            sample = (
                T[iv, iu] * (1 - au) * (1 - av)
                + T[iv, np.minimum(iu + 1, patch_size - 1)] * au * (1 - av)
                + T[np.minimum(iv + 1, patch_size - 1), iu] * (1 - au) * av
                + T[np.minimum(iv + 1, patch_size - 1), np.minimum(iu + 1, patch_size - 1)] * au * av
            )
            region = img[y0c:y1c, x0c:x1c]
            img[y0c:y1c, x0c:x1c] = np.where(inside, sample, region)
        if noise > 0:
            img = np.clip(img + rng.normal(0.0, noise, size=img.shape), 0, 255)
        frames.append(img.astype(np.float32))
    gt = np.stack(gt_poses)
    return frames, gt[:, :3, 3], (fx, fy, cx, cy), gt


def write_kitti_sequence(root, frames, gt_positions, intrinsics, sequence="00"):
    """Write rendered frames as a KITTI odometry layout + gt poses file.

    Returns ``(dataset_root, gt_path)`` for the offline entry point /
    evaluation harness.
    """
    from pathlib import Path

    from PIL import Image

    root = Path(root)
    fx, fy, cx, cy = intrinsics
    seq_dir = root / "sequences" / sequence
    img_dir = seq_dir / "image_0"
    img_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(np.asarray(f).astype(np.uint8), mode="L").save(
            img_dir / f"{i:06d}.png"
        )
    (seq_dir / "times.txt").write_text(
        "\n".join(f"{0.1 * i:.6f}" for i in range(len(frames)))
    )
    (seq_dir / "calib.txt").write_text(f"P0: {fx} 0 {cx} 0 0 {fy} {cy} 0 0 0 1 0\n")
    gt_path = root / "gt.txt"
    gt_path.write_text(
        "\n".join(f"1 0 0 {p[0]} 0 1 0 {p[1]} 0 0 1 {p[2]}" for p in gt_positions)
    )
    return root, gt_path
