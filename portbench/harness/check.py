"""Whether what the timed path produced is right: the program's fetched
track outputs of the checked chunks against the plain reference's
(portbench/reference/) on the same frames.

The reference detects on every distinct frame of the clip once (the
letterbox, the model in float32, or the int8 configuration's w8a8 with
exact integer sums and its own calibration, the decode and NMS), then
tracks. The window's first chunks it follows from a fresh tracker, on
its own state; a chunk from later in the window it follows from the
program's tracker state before that chunk, which is the program's own
(the first chunks check the recurrence that this skips).

Numbers, over the checked frames; a cell compares those that its control
moves (portbench/checks/<cell>.json holds their limits) and reports the
others beside them. Within each checked run of chunks a program track id
is tied to the reference track id it first meets: by pose, nearest first
(mean keypoint distance within half the reference track's box diagonal),
where neither id is tied yet. New tracks take their ids in detection
order, which a rounding can change among people of nearly equal score;
after that, a track is paired with the reference track of the id it is
tied to.
  track_err_px      mean over the reference's tracks and the program's
                    unpaired ones: a paired track's mean distance in frame
                    pixels over the keypoints the reference sees (conf >
                    0.5); an unpaired track (or an id the program emits
                    twice in a frame) its box's diagonal, as far off as a
                    track on that person can be
  kp_max_px         the largest keypoint distance of a paired track
  tracks_unmatched  share of the reference's tracks left unpaired, plus
                    the program's unpaired ones
  state_mismatch    at the end of every checked chunk, the track ids in
                    one tracker state and not the other (all active
                    slots), plus the difference of their next ids: the
                    program's carried state against the reference's
  conf_max          the largest difference of a paired track's score or
                    keypoint confidence
"""
from __future__ import annotations

import numpy as np
import torch

from ..reference import model as M
from ..reference import pipeline as P
from ..reference.scene import calibration_frames
from .spec import ROOT

NAMES = ("track_err_px", "kp_max_px", "tracks_unmatched", "state_mismatch",
         "conf_max")


def reference_convs(config: dict, params: dict, seed: int, device,
                    levels: int | None = None, root: str = ROOT):
    """The reference's convs for `config`: float32, or for a quantised
    configuration its w8a8 (levels 127) convs with activation scales
    worked out here again from the calibration frames of `seed`. levels
    7 gives the w4a4 control on the same calibration."""
    q = config.get("quant")
    if q is None and levels is None:
        return M.Convs(params, device)
    q = q or {"skip": [], "calibration_frames": 16,
              "calibration_persons": 6}
    images = calibration_frames(q["calibration_frames"],
                                config["input_size"],
                                q["calibration_persons"], seed)
    scales = M.calibrate(params, config["family"], images, q["skip"], device,
                         root=root)
    levels = levels or 127
    act = {k: np.float32(s * np.float32(127.0) / np.float32(levels))
           if levels != 127 else s for k, s in scales.items()}
    return M.Convs(params, device, "quant", levels, q["skip"], act)


def reference_detections(config: dict, convs, frames_u8: np.ndarray,
                         device, block: int = 32, root: str = ROOT) -> list:
    """Per frame, after NMS: (poses [n, 17, 3], boxes [n, 4], scores [n])
    in model input pixels."""
    S = config["input_size"]
    det = config["detector"]
    family = config["family"]
    anchor_xy, strides = M.anchors(S, device, family, root)
    out = []
    with torch.no_grad():
        for s in range(0, len(frames_u8), block):
            x = P.letterbox(torch.from_numpy(frames_u8[s:s + block])
                            .to(device), S)
            heads = M.forward(convs, x, family, root)
            for poses, boxes, scores in P.decode(
                    *heads, anchor_xy, strides, det["conf_threshold"],
                    det["max_candidates"]):
                out.append(P.nms(poses, boxes, scores, det["iou_threshold"],
                                 det["oks_threshold"],
                                 det["max_detections"]))
    return out


def tracker_cfg(config: dict) -> dict:
    return {**config["tracker"], **config["tracker_constants"]}


def reference_tracks(config: dict, dets: list, frame_ids, state,
                     width: int, height: int):
    """The reference tracker over frames `frame_ids` (indices into dets)
    from `state` (None: a fresh tracker) -> (per frame a list of (id,
    score, pose [17, 3], box [4]) in frame pixels, the final Tracker)."""
    trk = P.Tracker(tracker_cfg(config), state)
    frames = []
    for f in frame_ids:
        poses, _, scores = dets[f]
        tracks = []
        for tid, score, pose in trk.step(poses, scores):
            fp, box = P.to_frame(pose, width, height, config["input_size"])
            tracks.append((tid, score, fp, box))
        frames.append(tracks)
    return frames, trk


def _kp_distance(track, pose) -> np.ndarray:
    """Distances in frame pixels of a program track's keypoints to a
    reference pose's, over the keypoints the reference sees."""
    kp = np.asarray(track.keypoints, np.float64)
    vis = pose[:, 2] > 0.5
    return np.hypot(*(kp[vis, :2] - pose[vis, :2]).T)


def _tie(prog: dict, ref: list, tied: dict, taken: set):
    """Ties the untied reference ids of a frame to untied program ids by
    pose, nearest first."""
    cand = []
    for rid, _, pose, box in ref:
        if rid in tied:
            continue
        for pid, t in prog.items():
            if pid in taken:
                continue
            d = _kp_distance(t, pose)
            if d.size and d.mean() <= 0.5 * _diagonal(box):
                cand.append((float(d.mean()), rid, pid))
    for _, rid, pid in sorted(cand):
        if rid not in tied and pid not in taken:
            tied[rid] = pid
            taken.add(pid)


def compare(segments: list) -> dict:
    """The numbers of the module docstring. segments: per checked run of
    chunks (program frames, reference frames, state pairs): program frames
    are lists of the program's TrackOutput (track_id, score, bbox,
    keypoints), reference frames lists of (id, score, pose, box), state
    pairs (program, reference) of (set of active ids, next id) at each
    chunk's end."""
    errs, kp_max, conf = [], 0.0, 0.0
    ref_total = unmatched = state_diff = 0
    for prog_frames, ref_frames, states in segments:
        tied, taken = {}, set()
        for prog, ref in zip(prog_frames, ref_frames, strict=True):
            by_id = {}
            for t in prog:
                if t.track_id in by_id:           # an id emitted twice
                    unmatched += 1
                    errs.append(_diagonal(t.bbox))
                by_id[t.track_id] = t
            _tie(by_id, ref, tied, taken)
            ref_total += len(ref)
            for rid, score, pose, box in ref:
                t = by_id.pop(tied.get(rid), None)
                if t is None:
                    unmatched += 1
                    errs.append(_diagonal(box))
                    continue
                d = _kp_distance(t, pose)
                errs.append(float(d.mean()) if d.size else 0.0)
                kp_max = max(kp_max, float(d.max()) if d.size else 0.0)
                conf = max(conf, abs(t.score - score), float(np.abs(
                    np.asarray(t.keypoints)[:, 2] - pose[:, 2]).max()))
            for t in by_id.values():              # the program's extra ones
                unmatched += 1
                errs.append(_diagonal(t.bbox))
        for (p_ids, p_next), (r_ids, r_next) in states:
            state_diff += len(p_ids ^ r_ids) + abs(p_next - r_next)
    if ref_total == 0:
        return {n: float("inf") for n in NAMES}
    return {"track_err_px": float(np.mean(errs)), "kp_max_px": kp_max,
            "tracks_unmatched": unmatched / ref_total,
            "state_mismatch": state_diff, "conf_max": conf}


def state_ids(state: dict):
    """(the ids of a numpy tracker state's active slots, its next id)."""
    return set(state["ids"][state["active"]].tolist()), state["next_id"]


def _diagonal(box) -> float:
    box = np.asarray(box, np.float64)
    return float(np.hypot(box[2] - box[0], box[3] - box[1]))


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell compares within its limit."""
    return all(numbers[n] <= lim for n, lim in limits.items())
