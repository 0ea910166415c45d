"""The comparison that decides ``correct``.

It judges answers that the timed path produced, for a sample of frames
drawn from the seed among those it posed (the last ``keep`` of the window,
so that the program's keyframe store, 10,000 by default, still holds
them), with the ones it was matched against:

- ``keypoints_off``: frames whose keypoints (positions and validity)
  differ from the reference's, or that the program posed and keeps no
  features for (the configurations' keyframe policy keeps every posed
  frame: a monocular step is unit-norm, ``min_translation`` 0.1) (exact:
  limit 0);
- ``descriptor_bits_off``: descriptor bits that differ (exact: limit 0);
- ``counts_off``: sampled frames whose feature or match count differs from
  the reference's (exact: limit 0);
- ``inliers_recount_gap``: the median over the sample of how far the
  inlier count the program states for a frame lies from the reference's
  recount: the reference's matches whose Sampson distance under the
  frame's relative pose (E = [t]x R) lies under the threshold the
  configuration states, as a share of the stated count (it holds the
  matching, the model and its decomposition, and the pose chain to what
  the pose stage said);
- ``support_gap``: the median over the sample of the share by which a
  frame's relative pose has less support among the reference's matches
  than the reference's own RANSAC pose (in BA cells it holds the
  window-refined keyframe poses);
- ``residual_excess``: the median over the sample of how much farther
  (median Sampson distance) the matches the reference's pose supports lie
  from the frame's relative pose than from the reference's, as a share.

A cell's file names the numbers it compares and their limits; the judge
computes those of ``NUMBERS``, and any other is a file of its own,
``checks/<number>.py`` (``spec.check``), that ``run.run_cell`` calls
beside it. A candidate is what is judged: the program's outputs
(``ProgramAnswers``) or the reference itself in a lower precision
(``ControlAnswers``). The judge imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import features as ref_features
from portbench.reference import geometry
from portbench.scene import ping_pong

NUMBERS = (
    "keypoints_off",
    "descriptor_bits_off",
    "counts_off",
    "inliers_recount_gap",
    "support_gap",
    "residual_excess",
)
POSE_NUMBERS = ("support_gap", "residual_excess")  # need the reference's own RANSAC pose


@dataclass
class Anchor:
    frame: int  # stream position of the judged frame
    prev: int  # stream position of the frame it was matched against


def _rel_from_poses(T_prev: np.ndarray, T_cur: np.ndarray):
    """(R, t) with X_cur = R X_prev + t from two world-from-camera poses."""
    rel = np.linalg.inv(T_cur) @ T_prev
    return rel[:3, :3], rel[:3, 3]


class ProgramAnswers:
    """The program's answers, read after the window from its own records:
    per-frame diagnostics, the trajectory and the keyframes' features."""

    def __init__(self, diags: Dict[int, object], trajectory: Dict[int, np.ndarray], keyframes: Dict[int, tuple], prev_of: Dict[int, int]):
        self.diags = diags
        self.trajectory = trajectory
        self.keyframes = keyframes
        self.prev_of = prev_of

    def judgeable(self) -> List[int]:
        out = []
        for f, d in self.diags.items():
            g = self.prev_of.get(f)
            if g is None or not d.pose_success or d.relocalized or d.model_type == "bootstrap":
                continue
            if f in self.trajectory and g in self.trajectory:
                out.append(f)
        return sorted(out)

    def posed(self, frame: int) -> bool:
        d = self.diags.get(frame)
        return bool(d is not None and d.pose_success)

    def features(self, frame: int):
        kf = self.keyframes.get(frame)
        if kf is None:
            return None
        xy, desc, valid = kf
        return np.asarray(xy, np.float32), np.ascontiguousarray(desc).view(np.uint32), np.asarray(valid, bool)

    def counts(self, frame: int):
        d = self.diags[frame]
        return int(d.num_features), int(d.num_matches)

    def inliers(self, anchor: "Anchor") -> int:
        return int(self.diags[anchor.frame].num_inliers)

    def relative(self, anchor: Anchor):
        return _rel_from_poses(self.trajectory[anchor.prev], self.trajectory[anchor.frame])


class ControlAnswers:
    """The reference in the program's place, every float stage in a lower
    precision: it must come out as not correct. It states, as the program
    does, its features, counts, each frame's relative pose and the inliers
    it counts for that pose on its own matches."""

    def __init__(self, judge: "Judge", dtype=torch.bfloat16):
        self.j = judge
        self.front = ref_features.FrontEnd(judge.feature_cfg, judge.device, dtype)
        self.dtype = dtype
        self._feats = {}
        self._poses = {}

    def _f(self, frame):
        if frame not in self._feats:
            self._feats[frame] = self.front.features(self.j.image(frame))
        return self._feats[frame]

    def posed(self, frame):
        return True

    def features(self, frame):
        xy, valid, bits = self._f(frame)
        words = ref_features.pack(bits).cpu().numpy().astype(np.uint32)
        return xy.cpu().numpy(), words, valid.cpu().numpy()

    def counts(self, frame):
        f = self._f(frame)
        prev = self.j.prev_frame(frame)
        pairs, _ = self.front.match(self._f(prev), f)
        return int(f[1].sum()), len(pairs)

    def _pose(self, anchor: Anchor):
        if anchor.frame not in self._poses:
            a, b = self._f(anchor.prev), self._f(anchor.frame)
            pairs, _ = self.front.match(a, b)
            p1, p2 = a[0][pairs[:, 0]], b[0][pairs[:, 1]]
            gen = torch.Generator(device=self.j.device).manual_seed(self.j.frame_seed(anchor.frame) ^ 0xC0)
            out = geometry.relative_pose(p1, p2, self.j.K, self.j.base_px, gen, dtype=self.dtype)
            if out is None:
                self._poses[anchor.frame] = (np.eye(3), np.zeros(3), 0)
            else:
                R, t = out[0], out[1]
                stated = geometry.recount(R, t, p1, p2, self.j.K, self.j.base_px, self.dtype)
                self._poses[anchor.frame] = (R.cpu().numpy(), t.cpu().numpy(), stated)
        return self._poses[anchor.frame]

    def inliers(self, anchor: Anchor) -> int:
        return self._pose(anchor)[2]

    def relative(self, anchor: Anchor):
        R, t, _ = self._pose(anchor)
        return R, t


class Judge:
    """Computes the judged numbers of a run against the reference."""

    def __init__(self, config: dict, frames: torch.Tensor, K: np.ndarray, seed: int, device, sample: int, keep: int):
        self.feature_cfg = config["pipeline"]["feature"]
        self.base_px = float(config["pipeline"]["pose"]["essential_threshold_px"])
        self.frames = frames
        self.K = K
        self.seed = int(seed)
        self.device = torch.device(device)
        self.sample = int(sample)
        self.keep = int(keep)
        self.front = ref_features.FrontEnd(self.feature_cfg, self.device)
        self._feats = {}
        self._prev = {}
        self.details: List[dict] = []  # per anchor, for the readings' record

    def frame_seed(self, frame: int) -> int:
        return int(np.random.SeedSequence([self.seed, 0x1D6E, frame]).generate_state(1)[0])

    def image(self, frame: int) -> torch.Tensor:
        return self.frames[ping_pong(frame, len(self.frames))].to(self.device)

    def prev_frame(self, frame: int) -> int:
        return self._prev.get(frame, frame - 1)

    def _f(self, frame):
        if frame not in self._feats:
            self._feats[frame] = self.front.features(self.image(frame))
        return self._feats[frame]

    def anchors(self, answers: ProgramAnswers) -> List[Anchor]:
        """A sample, drawn from the seed, of the last ``keep`` frames the
        program posed."""
        pool = answers.judgeable()[-self.keep:]
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0xA4C]))
        pick = sorted(rng.choice(len(pool), size=min(self.sample, len(pool)), replace=False).tolist()) if pool else []
        out = [Anchor(pool[i], answers.prev_of[pool[i]]) for i in pick]
        self._prev.update({a.frame: a.prev for a in out})
        return out

    def judge(self, answers, anchors: List[Anchor], wanted=NUMBERS) -> Dict[str, float]:
        """The numbers of ``wanted`` (the rest read NaN), with the frames
        checked and the anchors; a sample short of ``sample`` anchors reads
        infinite on every per-anchor median."""
        kp_off = bits_off = counts_off = 0
        recount, gaps, excess = [], [], []
        checked = set()
        for a in anchors:
            ref_prev, ref_cur = self._f(a.prev), self._f(a.frame)
            for frame, ref in ((a.prev, ref_prev), (a.frame, ref_cur)):
                if frame in checked:
                    continue
                checked.add(frame)
                got = answers.features(frame)
                if got is None:
                    kp_off += int(answers.posed(frame))
                    continue
                xy, words, valid = got
                rxy, rvalid = ref[0].cpu().numpy(), ref[1].cpu().numpy()
                if not (np.array_equal(valid, rvalid) and np.array_equal(xy, rxy)):
                    kp_off += 1
                bits = ref_features.unpack(torch.as_tensor(words.astype(np.int64), device=self.device))
                bits_off += int((bits != ref[2]).sum())
            pairs, _ = self.front.match(ref_prev, ref_cur)
            n_feat, n_match = answers.counts(a.frame)
            if n_feat != int(ref_cur[1].sum()) or n_match != len(pairs):
                counts_off += 1
            p1 = ref_prev[0][pairs[:, 0]]
            p2 = ref_cur[0][pairs[:, 1]]
            R, t = answers.relative(a)
            R_d = torch.as_tensor(R, dtype=torch.float64, device=self.device)
            t_d = torch.as_tensor(t, dtype=torch.float64, device=self.device)
            if "inliers_recount_gap" in wanted:
                stated = answers.inliers(a)
                got = geometry.recount(R_d, t_d, p1, p2, self.K, self.base_px)
                recount.append(abs(stated - got) / max(stated, 1))
                model = getattr(getattr(answers, "diags", {}).get(a.frame), "model_type", "")
                self.details.append({"frame": a.frame, "model": model, "stated": stated, "recount": got})
            if not set(POSE_NUMBERS) & set(wanted):
                continue
            gen = torch.Generator(device=self.device).manual_seed(self.frame_seed(a.frame))
            best = geometry.relative_pose(p1, p2, self.K, self.base_px, gen)
            if best is None:
                gaps.append(1.0)
                excess.append(math.inf)
                continue
            R_ref, t_ref, ref_support, cut = best
            n1 = geometry.normalise(p1.to(torch.float64), self.K)
            n2 = geometry.normalise(p2.to(torch.float64), self.K)
            gaps.append((ref_support - geometry.support(R_d, t_d, n1, n2, cut)) / max(ref_support, 1))
            res = geometry.residuals(R_d, t_d, R_ref, t_ref, n1, n2, cut)
            excess.append(math.inf if res is None else res[0] / max(res[1], 1e-12) - 1.0)
        short = len(anchors) < self.sample

        def median(xs, name):
            if name not in wanted:
                return math.nan
            return math.inf if short or not xs else float(np.median(xs))

        return {
            "keypoints_off": float(kp_off),
            "descriptor_bits_off": float(bits_off),
            "counts_off": float(counts_off),
            "inliers_recount_gap": median(recount, "inliers_recount_gap"),
            "support_gap": median(gaps, "support_gap"),
            "residual_excess": median(excess, "residual_excess"),
            "frames_checked": float(len(checked)),
            "anchors": float(len(anchors)),
        }


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every judged number at or under its limit (a missing or NaN number
    fails)."""
    for name, limit in limits.items():
        v = numbers.get(name)
        if v is None or not (v <= limit):
            return False
    return True
