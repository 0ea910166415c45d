"""Rendered camera streams with ground truth, made from a seed on the device.

The scene model is the port's renderer's (``data/synthetic.py::render_scene``):
a field of textured planar quads anchored to fixed 3-D points, each quad
facing the world's z axis and carrying a fixed random 25 x 25 texture,
drawn through the exact plane-induced mapping with bilinear sampling,
nearest quad in front. Every texture corner is a true 3-D point, so the
geometry of any two views is exact. What differs from that renderer:

- it runs on the device, all quads of a chunk of frames at once (a
  z-buffer of per-quad depth keys replaces the far-to-near loop), instead
  of a numpy loop per quad and frame;
- it takes the camera of a configuration (image size, intrinsics) and a
  path: ``drive`` (forward at a fixed speed with a gentle sinusoidal yaw,
  quads laid on both sides of the route) or ``handheld`` (sinusoidal
  rotations and translations in front of a field of quads, scaled to a
  mean translational and angular speed);
- sensor noise and the final rounding to uint8 frames.

The seed fixes the quads, their textures and the noise. The path is the
configuration's own, the same for every seed, so every seed makes the
same amount of work.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

TEXELS = 25  # texture side, as render_scene's patch_size


@dataclass
class Scene:
    frames: torch.Tensor  # (F, H, W) uint8 on the device
    gt_poses: np.ndarray  # (F, 4, 4) float64, world from camera
    intrinsics: np.ndarray  # (3, 3) float64
    quads: Dict[str, np.ndarray]  # centres (Q, 3), half sides (Q,), textures (Q, T, T)
    seconds: float = 0.0


def _rot_x(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _rot_y(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rot_z(a):
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def drive_path(num_frames: int, motion: dict) -> np.ndarray:
    """(F, 4, 4) poses of a forward drive: ``speed_m_per_frame`` along the
    heading, the heading a sine of ``yaw_amplitude_deg`` over
    ``yaw_period_frames``; the camera looks along +z, y points down."""
    speed = float(motion["speed_m_per_frame"])
    amp = math.radians(float(motion["yaw_amplitude_deg"]))
    period = float(motion["yaw_period_frames"])
    poses = np.zeros((num_frames, 4, 4))
    pos = np.zeros(3)
    for i in range(num_frames):
        heading = amp * math.sin(2.0 * math.pi * i / period)
        poses[i, :3, :3] = _rot_y(heading)
        poses[i, :3, 3] = pos
        poses[i, 3, 3] = 1.0
        pos = pos + speed * np.array([math.sin(heading), 0.0, math.cos(heading)])
    return poses


def handheld_path(num_frames: int, rate_hz: float, motion: dict) -> np.ndarray:
    """(F, 4, 4) poses of a hand-held camera: three rotations and three
    translations, each a sine of its own period, then scaled so the mean
    angular and translational speeds are the configuration's."""
    t = np.arange(num_frames + 1) / rate_hz
    rot_periods = motion["rotation_periods_s"]
    rot_weights = motion["rotation_weights"]
    tr_periods = motion["translation_periods_s"]
    tr_weights = motion["translation_weights"]
    angles = np.stack([w * np.sin(2 * np.pi * t / p) for w, p in zip(rot_weights, rot_periods)], 1)
    trans = np.stack([w * np.sin(2 * np.pi * t / p) for w, p in zip(tr_weights, tr_periods)], 1)

    def rotations(a):
        return np.stack([_rot_y(y) @ _rot_x(x) @ _rot_z(z) for y, x, z in a])

    def mean_angular_speed(a):
        rs = rotations(a)
        steps = [np.arccos(np.clip((np.trace(rs[i].T @ rs[i + 1]) - 1) / 2, -1, 1)) for i in range(len(rs) - 1)]
        return float(np.mean(steps)) * rate_hz

    omega = math.radians(float(motion["mean_angular_speed_deg_s"]))
    angles = angles * (omega / mean_angular_speed(angles))
    angles = angles * (omega / mean_angular_speed(angles))  # a second pass: the map is near-linear
    speed = np.linalg.norm(np.diff(trans, axis=0), axis=1).mean() * rate_hz
    trans = trans * (float(motion["mean_speed_m_s"]) / speed)
    poses = np.zeros((num_frames, 4, 4))
    poses[:, :3, :3] = rotations(angles[:num_frames])
    poses[:, :3, 3] = trans[:num_frames]
    poses[:, 3, 3] = 1.0
    return poses


def camera_path(config: dict) -> np.ndarray:
    motion = config["motion"]
    n = int(config["sequence"]["num_frames"])
    if motion["kind"] == "drive":
        return drive_path(n, motion)
    if motion["kind"] == "handheld":
        return handheld_path(n, float(config["camera"]["rate_hz"]), motion)
    raise ValueError(f"unknown motion kind {motion['kind']!r}")


def make_quads(config: dict, poses: np.ndarray, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Quad centres, half sides and textures of the configuration's field.

    ``corridor``: quads beside the route, at a lateral offset from the
    path of ``lateral_m`` (either side) and a height in ``height_m``,
    along the route from its start to ``ahead_m`` past its end.
    ``field``: quads in a box in front of the start pose."""
    field = config["scene"]
    q = int(field["num_quads"])
    half = rng.uniform(*field["half_side_m"], q)
    if field["kind"] == "corridor":
        route = poses[:, :3, 3]
        length = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(route, axis=0), axis=1))])
        s = rng.uniform(0.0, length[-1] + float(field["ahead_m"]), q)
        # Position and heading along the route; past its end, straight on.
        heading = np.arctan2(np.diff(route[:, 0]), np.diff(route[:, 2]))
        heading = np.concatenate([heading, heading[-1:]])
        idx = np.clip(np.searchsorted(length, s) - 1, 0, len(length) - 1)
        base = route[idx] + (s - length[idx])[:, None] * np.stack(
            [np.sin(heading[idx]), np.zeros(q), np.cos(heading[idx])], 1
        )
        side = np.where(rng.uniform(size=q) < 0.5, -1.0, 1.0)
        lateral = side * rng.uniform(*field["lateral_m"], q)
        normal = np.stack([np.cos(heading[idx]), np.zeros(q), -np.sin(heading[idx])], 1)
        centres = base + lateral[:, None] * normal
        centres[:, 1] = rng.uniform(*field["height_m"], q)
    elif field["kind"] == "field":
        centres = np.stack([rng.uniform(*field[k], q) for k in ("x_m", "y_m", "z_m")], 1)
    else:
        raise ValueError(f"unknown scene kind {field['kind']!r}")
    textures = rng.uniform(40.0, 255.0, size=(q, TEXELS, TEXELS)).astype(np.float32)
    return {"centres": centres, "half": half, "textures": textures}


def intrinsics(config: dict) -> np.ndarray:
    cam = config["camera"]
    return np.array([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]], [0.0, 0.0, 1.0]])


def _render_chunk(poses, quads, K, h, w, near, device):
    """Render float32 images of the poses in one pass over all quads."""
    f = poses.shape[0]
    R = torch.as_tensor(poses[:, :3, :3], dtype=torch.float64, device=device)
    C = torch.as_tensor(poses[:, :3, 3], dtype=torch.float64, device=device)
    P = torch.as_tensor(quads["centres"], dtype=torch.float64, device=device)
    half = torch.as_tensor(quads["half"], dtype=torch.float64, device=device)
    nq = P.shape[0]
    fx, fy, cx, cy = float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])
    signs = torch.tensor([[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0]], dtype=torch.float64, device=device)
    corners = P[:, None, :].repeat(1, 4, 1)
    corners[..., :2] += half[:, None, None] * signs  # (Q, 4, 3)
    # Camera coordinates: X_c = R^T (X_w - C).
    cam_c = torch.einsum("fji,fqj->fqi", R, P[None] - C[:, None])  # (F, Q, 3)
    cam_k = torch.einsum("fji,fqkj->fqki", R, corners[None] - C[:, None, None])  # (F, Q, 4, 3)
    ok = (cam_c[..., 2] >= near) & (cam_k[..., 2].amin(-1) >= 0.5 * near)
    zk = cam_k[..., 2].clamp_min(1e-6)
    u = fx * cam_k[..., 0] / zk + cx
    v = fy * cam_k[..., 1] / zk + cy
    x0 = torch.floor(u.amin(-1)).clamp(0, w).long()
    x1 = (torch.ceil(u.amax(-1)) + 1).clamp(0, w).long()
    y0 = torch.floor(v.amin(-1)).clamp(0, h).long()
    y1 = (torch.ceil(v.amax(-1)) + 1).clamp(0, h).long()
    ok &= (x1 > x0) & (y1 > y0)
    fi, qi = torch.nonzero(ok, as_tuple=True)
    img = torch.zeros(f * h * w, dtype=torch.float32, device=device)
    if fi.numel() == 0:
        return img.view(f, h, w)
    bx0, bx1, by0, by1 = x0[fi, qi], x1[fi, qi], y0[fi, qi], y1[fi, qi]
    # Depth keys: the quad centre's camera depth (positive float bits order
    # as integers), then the quad id; the smallest key is the nearest quad.
    depth = cam_c[fi, qi, 2].to(torch.float32)
    key = (depth.view(torch.int32).to(torch.int64) << 21) | qi
    zbuf = torch.full((f * h * w,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=device)
    tex = torch.as_tensor(quads["textures"], device=device).reshape(nq, TEXELS * TEXELS)
    size = torch.maximum(bx1 - bx0, by1 - by0)
    bucket = torch.ceil(torch.log2(size.clamp_min(8).to(torch.float32))).long()
    Rf = R.to(torch.float32)
    Cf = C.to(torch.float32)
    Pf = P.to(torch.float32)
    hf = half.to(torch.float32)

    def pixels(sel, s):
        oy, ox = torch.meshgrid(torch.arange(s, device=device), torch.arange(s, device=device), indexing="ij")
        px = bx0[sel, None, None] + ox
        py = by0[sel, None, None] + oy
        m = (px < bx1[sel, None, None]) & (py < by1[sel, None, None])
        # Ray through the pixel centre, in the world; meet the quad's plane.
        d_c = torch.stack(
            [(px.to(torch.float32) - cx) / fx, (py.to(torch.float32) - cy) / fy, torch.ones_like(px, dtype=torch.float32)],
            -1,
        )
        ff, qq = fi[sel], qi[sel]
        d_w = torch.einsum("eij,eyxj->eyxi", Rf[ff], d_c)
        c = Cf[ff][:, None, None, :]
        pc = Pf[qq][:, None, None, :]
        hh = hf[qq][:, None, None]
        dz = d_w[..., 2]
        dz = torch.where(dz.abs() < 1e-9, torch.full_like(dz, 1e-9), dz)
        t = (pc[..., 2] - c[..., 2]) / dz
        X = c + t[..., None] * d_w
        tu = (X[..., 0] - (pc[..., 0] - hh)) / (2 * hh) * (TEXELS - 1)
        tv = (X[..., 1] - (pc[..., 1] - hh)) / (2 * hh) * (TEXELS - 1)
        inside = m & (t > 0) & (tu >= 0) & (tu <= TEXELS - 1) & (tv >= 0) & (tv <= TEXELS - 1)
        pix = (ff[:, None, None] * h + py.clamp(max=h - 1)) * w + px.clamp(max=w - 1)
        return inside, pix, tu, tv, qq

    budget = 1 << 23
    for b in torch.unique(bucket).tolist():
        s = 1 << b
        members = torch.nonzero(bucket == b, as_tuple=True)[0]
        step = max(1, budget // (s * s))
        for start in range(0, members.numel(), step):
            sel = members[start : start + step]
            inside, pix, _, _, _ = pixels(sel, s)
            k = key[sel, None, None].expand_as(pix)
            zbuf.scatter_reduce_(0, pix[inside], k[inside], reduce="amin")
    for b in torch.unique(bucket).tolist():
        s = 1 << b
        members = torch.nonzero(bucket == b, as_tuple=True)[0]
        step = max(1, budget // (s * s))
        for start in range(0, members.numel(), step):
            sel = members[start : start + step]
            inside, pix, tu, tv, qq = pixels(sel, s)
            k = key[sel, None, None].expand_as(pix)
            win = inside & (zbuf[pix] == k)
            tu = tu.clamp(0, TEXELS - 1 - 1e-6)
            tv = tv.clamp(0, TEXELS - 1 - 1e-6)
            iu, iv = tu.long(), tv.long()
            au, av = tu - iu, tv - iv
            iu1, iv1 = (iu + 1).clamp(max=TEXELS - 1), (iv + 1).clamp(max=TEXELS - 1)
            T = tex[qq][:, None, None, :].expand(*pix.shape, TEXELS * TEXELS)

            def at(r, c):
                return torch.gather(T, -1, (r * TEXELS + c)[..., None])[..., 0]

            sample = (
                at(iv, iu) * (1 - au) * (1 - av)
                + at(iv, iu1) * au * (1 - av)
                + at(iv1, iu) * (1 - au) * av
                + at(iv1, iu1) * au * av
            )
            img[pix[win]] = sample[win]
    return img.view(f, h, w)


def render(config: dict, seed: int, device, chunk: int = 8) -> Scene:
    """Render the configuration's sequence from ``seed`` on ``device``."""
    started = time.perf_counter()
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5CE4E]))
    poses = camera_path(config)
    quads = make_quads(config, poses, rng)
    K = intrinsics(config)
    h, w = int(config["camera"]["height"]), int(config["camera"]["width"])
    near = float(config["scene"]["near_m"])
    noise = float(config["scene"]["noise_sigma"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(0, 2**62)))
    frames = torch.empty((len(poses), h, w), dtype=torch.uint8, device=device)
    for start in range(0, len(poses), chunk):
        img = _render_chunk(poses[start : start + chunk], quads, K, h, w, near, device)
        if noise > 0:
            img = img + noise * torch.randn(img.shape, generator=gen, device=device)
        frames[start : start + chunk] = torch.round(img).clamp(0, 255).to(torch.uint8)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return Scene(frames, poses, K, quads, time.perf_counter() - started)


def ping_pong(index: int, length: int) -> int:
    """Frame of a sequence of ``length`` that stream position ``index``
    shows when the sequence plays forward, then backward, and so on,
    without repeating the frame at either end."""
    if length < 2:
        return 0
    period = 2 * (length - 1)
    k = index % period
    return k if k < length else period - k
