"""Accuracy and tracking quality, after posebyte_tpu/utils/evaluation.py
(the reference ships no quantitative evaluation, SURVEY.md §4):

  * oks_similarity / match_detections: COCO-style OKS between a ground-truth
    and a predicted pose (standard sigmas, area normalisation) and greedy
    score-ordered matching;
  * keypoint_map: OKS-mAP over the COCO thresholds 0.50:0.05:0.95, with
    AP@0.5 and AP@0.75;
  * TrackingEvaluator: MOTA (misses, false positives, id switches) and IDF1
    accumulated over a sequence.

numpy on the host: it reads the per-frame track lists, never the device.
IDF1's global assignment is scipy's linear_sum_assignment.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core import constants as C


def oks_similarity(gt_pose: np.ndarray, pred_pose: np.ndarray,
                   gt_area: float | None = None) -> float:
    """COCO OKS between one GT pose [17,3] (conf>0 = labeled) and one
    predicted pose [17,3]."""
    vis = gt_pose[:, 2] > 0
    if not vis.any():
        return 0.0
    if gt_area is None:
        xs, ys = gt_pose[vis, 0], gt_pose[vis, 1]
        gt_area = max((xs.max() - xs.min()) * (ys.max() - ys.min()), 1.0)
    d2 = ((gt_pose[:, 0] - pred_pose[:, 0]) ** 2
          + (gt_pose[:, 1] - pred_pose[:, 1]) ** 2)
    k2 = (2.0 * C.COCO_SIGMAS) ** 2
    e = d2 / (2.0 * gt_area * k2)
    return float(np.mean(np.exp(-e[vis])))


def match_detections(gt_poses, pred_poses, pred_scores,
                     oks_threshold: float = 0.5):
    """Greedy score-ordered matching (COCO-style): each prediction, in
    descending score, takes the best unmatched GT with OKS >= threshold.

    Returns (matches [(gt_i, pred_j, oks)], unmatched_gt, unmatched_pred).
    """
    order = np.argsort(-np.asarray(pred_scores))
    taken = set()
    matches = []
    unmatched_pred = []
    for j in order:
        best, best_oks = -1, oks_threshold
        for i in range(len(gt_poses)):
            if i in taken:
                continue
            s = oks_similarity(np.asarray(gt_poses[i]),
                               np.asarray(pred_poses[j]))
            if s >= best_oks:
                best, best_oks = i, s
        if best >= 0:
            taken.add(best)
            matches.append((best, int(j), best_oks))
        else:
            unmatched_pred.append(int(j))
    unmatched_gt = [i for i in range(len(gt_poses)) if i not in taken]
    return matches, unmatched_gt, unmatched_pred


def keypoint_map(frames_gt, frames_pred, frames_scores):
    """OKS-mAP over COCO thresholds for a list of frames.

    frames_gt: list of [Ni,17,3]; frames_pred: list of [Mi,17,3];
    frames_scores: list of [Mi]. Returns {"mAP", "AP50", "AP75"}.
    """
    thresholds = np.arange(0.50, 0.99, 0.05)
    aps = []
    for t in thresholds:
        tp, scores, n_gt = [], [], 0
        for gt, pred, sc in zip(frames_gt, frames_pred, frames_scores):
            n_gt += len(gt)
            m, _, up = match_detections(gt, pred, sc, oks_threshold=t)
            for _, j, _ in m:
                tp.append(1); scores.append(sc[j])
            for j in up:
                tp.append(0); scores.append(sc[j])
        if n_gt == 0:
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores))
        tp_arr = np.asarray(tp)[order]
        cum_tp = np.cumsum(tp_arr)
        recall = cum_tp / n_gt
        precision = cum_tp / (np.arange(len(tp_arr)) + 1)
        # 101-point interpolation (COCO)
        ap = 0.0
        for r in np.linspace(0, 1, 101):
            p = precision[recall >= r]
            ap += (p.max() if len(p) else 0.0) / 101.0
        aps.append(ap)
    return {"mAP": float(np.mean(aps)), "AP50": float(aps[0]),
            "AP75": float(aps[5])}


@dataclasses.dataclass
class TrackingEvaluator:
    """MOTA-style sequence accumulation over (gt_id -> pose) frames."""
    oks_threshold: float = 0.5
    misses: int = 0
    false_positives: int = 0
    id_switches: int = 0
    total_gt: int = 0
    matches: int = 0

    def __post_init__(self):
        self._last_track_for_gt: dict = {}
        # IDF1 accumulation (Ristani et al. 2016, as in py-motmetrics):
        # per (gt_id, track_id) pair, the number of frames where the
        # pair is a FEASIBLE match (OKS >= threshold), independent of
        # the per-frame greedy choice; the final score solves a global
        # assignment over these counts.
        self._pair_frames: dict = {}
        self.total_pred: int = 0

    def update(self, gt: dict, tracks):
        """gt: {gt_id: pose [17,3]}; tracks: list of TrackOutput."""
        gt_ids = list(gt.keys())
        gt_poses = [gt[g] for g in gt_ids]
        pred_poses = [t.keypoints for t in tracks]
        pred_scores = [t.score for t in tracks]
        m, ug, up = match_detections(gt_poses, pred_poses, pred_scores,
                                     self.oks_threshold)
        self.total_gt += len(gt_ids)
        self.total_pred += len(tracks)
        self.misses += len(ug)
        self.false_positives += len(up)
        self.matches += len(m)
        for gi, pj, _ in m:
            g = gt_ids[gi]
            tid = tracks[pj].track_id
            prev = self._last_track_for_gt.get(g)
            if prev is not None and prev != tid:
                self.id_switches += 1
            self._last_track_for_gt[g] = tid
        for gi, g in enumerate(gt_ids):
            gp = np.asarray(gt_poses[gi])
            for t in tracks:
                if oks_similarity(gp, np.asarray(t.keypoints)) \
                        >= self.oks_threshold:
                    key = (g, t.track_id)
                    self._pair_frames[key] = \
                        self._pair_frames.get(key, 0) + 1

    @property
    def mota(self) -> float:
        if self.total_gt == 0:
            return 0.0
        return 1.0 - (self.misses + self.false_positives
                      + self.id_switches) / self.total_gt

    @property
    def idf1(self) -> float:
        """Identity-F1: a global one-to-one gt-trajectory <-> predicted-
        trajectory assignment maximizing identity-consistent matched
        frames (IDTP); IDF1 = 2*IDTP / (gt frames + pred frames).
        Unlike MOTA (which forgives a switch after one frame), IDF1
        punishes every frame spent under the wrong identity — the
        metric that shows whether lost-track recovery / Re-ID EARN
        anything on hard clips."""
        if not self._pair_frames:
            return 0.0
        gt_ids = sorted({g for g, _ in self._pair_frames})
        tr_ids = sorted({t for _, t in self._pair_frames})
        mat = np.zeros((len(gt_ids), len(tr_ids)))
        for (g, t), n in self._pair_frames.items():
            mat[gt_ids.index(g), tr_ids.index(t)] = n
        from scipy.optimize import linear_sum_assignment
        ri, ci = linear_sum_assignment(-mat)
        idtp = mat[ri, ci].sum()
        denom = self.total_gt + self.total_pred
        return float(2.0 * idtp / denom) if denom else 0.0

    def summary(self) -> dict:
        return {"MOTA": round(self.mota, 4),
                "IDF1": round(self.idf1, 4),
                "misses": self.misses,
                "false_positives": self.false_positives,
                "id_switches": self.id_switches,
                "matches": self.matches, "gt": self.total_gt}
