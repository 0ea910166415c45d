"""Plain reference of the feature front end: FAST-9 corners, 3x3 non-maximum
suppression, a border margin, cell-balanced top-K with subpixel peaks;
Gaussian blur; steered BRIEF on 32x32 tiles; brute-force Hamming matching
with cross-check and the best-K selection.

Written from the pipeline's published description (FAST-9 on a radius-3
circle, ORB-style intensity-centroid steering over 32 angle bins, 256
Gaussian point pairs) with the selection rules the configuration's
pipeline states: ties broken towards the lower index, descriptors from
bfloat16 tiles of the blurred frame. Plain PyTorch, one frame at a time,
no kernels. ``dtype=torch.bfloat16`` computes every float stage in
bfloat16: the lower-precision control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
BORDER = 19  # clear of the 31-pixel BRIEF patch and the blur
RADIUS = 15
TILE = 32
PAIRS = 256
BINS = 32


def fast_scores(frame: torch.Tensor, threshold: float, dtype=torch.float32) -> torch.Tensor:
    """FAST-9 response of an (H, W) frame: where 9 contiguous circle taps
    are all brighter (or all darker) than the centre by more than the
    threshold, the sum over that polarity's taps of ``|tap - centre| - t``
    (the larger polarity wins); 0 elsewhere. Taps outside the image read
    0. Integer frames score in integers, exactly."""
    exact = dtype == torch.float32 and not frame.dtype.is_floating_point and float(threshold).is_integer()
    img = frame.to(torch.int32 if exact else dtype)
    t = int(threshold) if exact else float(threshold)
    h, w = img.shape
    pad = F.pad(img[None], (3, 3, 3, 3))[0]
    bright = torch.zeros_like(img)
    dark = torch.zeros_like(img)
    over = torch.zeros((16, h, w), dtype=torch.bool, device=img.device)
    under = torch.zeros_like(over)
    for i, (dy, dx) in enumerate(CIRCLE):
        diff = pad[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - img
        over[i] = diff > t
        under[i] = diff < -t
        excess = diff.abs() - t
        bright = bright + torch.where(over[i], excess, torch.zeros_like(excess))
        dark = dark + torch.where(under[i], excess, torch.zeros_like(excess))

    def arc(bits):
        ring = torch.cat([bits, bits[:8]], 0)
        run = torch.ones_like(bits)
        for k in range(9):
            run = run & ring[k : k + 16]
        return run.any(0)

    is_b, is_d = arc(over), arc(under)
    zero = torch.zeros((), dtype=torch.float32, device=img.device)
    score = torch.maximum(
        torch.where(is_b, bright.to(torch.float32), zero), torch.where(is_d, dark.to(torch.float32), zero)
    )
    return score


def suppress(score: torch.Tensor, margin: int = BORDER) -> torch.Tensor:
    """Keep a score that is the largest of its 3x3 window (equal counts),
    then zero the border."""
    h, w = score.shape
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    kept = torch.where(score >= pooled, score, torch.zeros_like(score))
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    inner = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return torch.where(inner, kept, torch.zeros_like(kept))


def _top(x: torch.Tensor, k: int):
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def select(score: torch.Tensor, num: int, cells: int):
    """Cell-balanced selection: the best ``2 * ceil(num / cells²)`` of each
    of the cells x cells cells, then the best ``num`` of those. Returns
    (scores, linear pixel indices), ``num`` long, zero-padded."""
    h, w = score.shape
    ch, cw = -(-h // cells), -(-w // cells)
    padded = F.pad(score, (0, cw * cells - w, 0, ch * cells - h))
    tiles = padded.reshape(cells, ch, cells, cw).transpose(1, 2).reshape(cells * cells, ch * cw)
    per_cell = min(max(1, -(-num // (cells * cells)) * 2), ch * cw)
    cs, ci = _top(tiles, per_cell)
    ids = torch.arange(cells * cells, device=score.device)[:, None]
    lin = ((ids // cells) * ch + ci // cw) * w + (ids % cells) * cw + ci % cw
    top, pick = _top(cs.reshape(-1), min(num, cs.numel()))
    lin = lin.reshape(-1)[pick]
    if top.numel() < num:
        top = F.pad(top, (0, num - top.numel()))
        lin = F.pad(lin, (0, num - lin.numel()))
    return top, lin


def keypoints(frame: torch.Tensor, num: int, threshold: float, cells: int, dtype=torch.float32):
    """(xy (N, 2) float32, valid (N,)) of an (H, W) frame: corners, their
    subpixel peaks from a parabola through the raw response's neighbours
    (offsets clipped to half a pixel), padded slots at (0, 0)."""
    raw = fast_scores(frame, threshold, dtype)
    top, lin = select(suppress(raw), num, cells)
    h, w = raw.shape
    valid = top > 0
    xy = torch.stack([(lin % w).to(torch.float32), (lin // w).to(torch.float32)], -1)
    flat = raw.reshape(-1).to(dtype)
    lin_c = lin.clamp(w + 1, h * w - w - 2)

    def offset(minus, centre, plus):
        denom = minus - 2.0 * centre + plus
        off = torch.where(denom.abs() > 1e-6, 0.5 * (minus - plus) / denom, torch.zeros_like(denom))
        return off.clamp(-0.5, 0.5)

    centre = flat[lin_c]
    dx = offset(flat[lin_c - 1], centre, flat[lin_c + 1])
    dy = offset(flat[lin_c - w], centre, flat[lin_c + w])
    xy = xy + torch.stack([dx, dy], -1).to(torch.float32)
    return torch.where(valid[:, None], xy, torch.zeros_like(xy)), valid


def blur(image: torch.Tensor, sigma: float, radius: int = 4, dtype=torch.float32) -> torch.Tensor:
    """Separable Gaussian blur of radius 4 (rows, then columns), wrapping
    at the image's edges; weights normalised in float64, applied in
    float32, the centre tap first, then each pair outwards."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = [float(v) for v in (k / k.sum()).astype(np.float32)]
    img = image.to(dtype)

    def sweep(z, dim):
        acc = k[radius] * z
        for j in range(1, radius + 1):
            acc = acc + k[radius + j] * torch.roll(z, -j, dims=dim)
            acc = acc + k[radius - j] * torch.roll(z, j, dims=dim)
        return acc

    return sweep(sweep(img, -2), -1)


def pattern() -> np.ndarray:
    """(256, 2, 2) (dx, dy) point pairs: Gaussian with sigma 6 around the
    keypoint from a fixed generator, pulled in to a radius of 14."""
    rng = np.random.default_rng(0x5EED)
    pts = rng.normal(0.0, RADIUS / 5.0 * 2.0, size=(PAIRS, 2, 2))
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    return np.where(norms > 14.0, pts * (14.0 / np.maximum(norms, 1e-9)), pts)


def pair_offsets() -> np.ndarray:
    """(BINS, 256, 2) tile indices of each pair's two points, the pattern
    rotated by each bin's angle and rounded (half to even)."""
    pat = pattern()
    out = np.zeros((BINS, PAIRS, 2), dtype=np.int64)
    for b in range(BINS):
        ang = 2.0 * np.pi * b / BINS
        c, s = np.cos(ang), np.sin(ang)
        rot = np.stack([c * pat[..., 0] - s * pat[..., 1], s * pat[..., 0] + c * pat[..., 1]], -1)
        ri = np.clip(np.round(rot), -RADIUS, RADIUS).astype(np.int64)
        idx = (ri[..., 1] + RADIUS) * TILE + (ri[..., 0] + RADIUS)
        out[b] = idx
    return out


def moments() -> np.ndarray:
    """(1024, 2) x and y weights of the radius-15 disc inside a 32x32 tile."""
    cy, cx = np.mgrid[-RADIUS : RADIUS + 1, -RADIUS : RADIUS + 1]
    disc = (cx**2 + cy**2) <= RADIUS**2
    m = np.zeros((TILE, TILE, 2))
    m[: 2 * RADIUS + 1, : 2 * RADIUS + 1, 0] = cx * disc
    m[: 2 * RADIUS + 1, : 2 * RADIUS + 1, 1] = cy * disc
    return m.reshape(TILE * TILE, 2)


class Brief:
    """Steered BRIEF with its tables built once per device."""

    def __init__(self, device):
        self.offsets = torch.as_tensor(pair_offsets(), device=device)
        self.moments = torch.as_tensor(moments(), dtype=torch.float64, device=device)

    def describe(self, blurred: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
        """(N, 256) bool descriptors of the keypoints: a 32x32 tile of the
        blurred frame in bfloat16 at ``round(xy) - 15`` (clamped inside the
        frame), its intensity-centroid angle quantised to 32 bins, and for
        each pair of that bin's rotated pattern whether the second point is
        brighter than the first. Invalid keypoints get all zeros."""
        h, w = blurred.shape
        xs = (torch.round(xy[:, 0]).long() - RADIUS).clamp(0, w - TILE)
        ys = (torch.round(xy[:, 1]).long() - RADIUS).clamp(0, h - TILE)
        offs = torch.arange(TILE, device=blurred.device)
        lin = (ys[:, None, None] + offs[:, None]) * w + xs[:, None, None] + offs[None, :]
        tiles = blurred.reshape(-1)[lin.reshape(len(xy), -1)].to(torch.bfloat16)
        m = (tiles.to(torch.float64) @ self.moments).to(torch.float32)
        angle = torch.atan2(m[:, 1], m[:, 0])
        angle = torch.where(valid, angle, torch.zeros_like(angle))
        two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=angle.device)
        r = torch.fmod(angle, two_pi)
        r = torch.where((r != 0) & (r < 0), r + two_pi, r)
        bins = (torch.round(r / two_pi * BINS).long() % BINS).clamp(0, BINS - 1)
        idx = self.offsets[bins]  # (N, 256, 2)
        first = torch.gather(tiles, 1, idx[..., 0])
        second = torch.gather(tiles, 1, idx[..., 1])
        bits = second.to(torch.float32) > first.to(torch.float32)
        return bits & valid[:, None]


def pack(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool → (N, 8) int64 words, bit i of word j = bit 32 j + i."""
    words = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    return (words << torch.arange(32, device=bits.device)).sum(-1)


def unpack(words: torch.Tensor) -> torch.Tensor:
    """(N, 8) 32-bit words (any integer dtype) → (N, 256) bool."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return (((w[..., None] >> torch.arange(32, device=words.device)) & 1) == 1).reshape(*w.shape[:-1], 256)


def match(bits1, valid1, bits2, valid2, max_matches: int):
    """Mutual nearest neighbours by Hamming distance (the lower index on
    ties), best ``max_matches`` by distance, the query order on ties.
    Returns (pairs (K, 2) long, distances (K,))."""
    a = bits1.to(torch.float32)
    b = bits2.to(torch.float32)
    d = a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * (a @ b.T)
    big = torch.tensor(1e9, device=d.device)
    d = torch.where(valid2[None, :], d, big)
    d = torch.where(valid1[:, None], d, big)
    best = torch.argmin(d, 1)
    dist = d.gather(1, best[:, None])[:, 0]
    ok = valid1 & (dist < 256.0)
    mutual = torch.argmin(d, 0)[best] == torch.arange(len(d), device=d.device)
    ok = ok & mutual
    masked = torch.where(ok, dist, big)
    order = torch.sort(masked, stable=True).indices[:max_matches]
    order = order[masked[order] < 1e8]
    return torch.stack([order, best[order]], 1), dist[order]


class FrontEnd:
    """Keypoints, descriptors and matches of frames, as the configuration's
    pipeline states them."""

    def __init__(self, feature: dict, device, dtype=torch.float32):
        self.cfg = feature
        self.dtype = dtype
        self.brief = Brief(device)

    def features(self, frame: torch.Tensor):
        xy, valid = keypoints(
            frame, int(self.cfg["num_features"]), float(self.cfg["fast_threshold"]), int(self.cfg["grid_cells"]), self.dtype
        )
        blurred = blur(frame, float(self.cfg["blur_sigma"]), dtype=self.dtype).to(torch.float32)
        return xy, valid, self.brief.describe(blurred, xy, valid)

    def match(self, f1, f2):
        return match(f1[2], f1[1], f2[2], f2[1], int(self.cfg["max_matches"]))
