"""The port's accuracy loop pieces against the JAX package on the CPU:
utils/evaluation.py (oks_similarity, match_detections, keypoint_map,
TrackingEvaluator's MOTA and IDF1), the scenes and detector bypass of
utils/synthetic.py (CrowdedScene, poses_to_detections, render_frame's
colours), TrackerConfig.from_conf_threshold and
tracker/output.get_active_tracks, each on the same seeded numpy inputs.

Tolerances: the evaluation is numpy in both packages, so every number is
equal; the scenes are numpy too, bit for bit; get_active_tracks' ids and
scores are equal and its poses and boxes within the tracker's 1e-5 px
(tests/test_torch_tracker.py says why).
"""
import dataclasses

import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.core.structs import TrackerState as JTrackerState
from posebyte_tpu.tracker.output import get_active_tracks as j_active
from posebyte_tpu.tracker.step import tracker_step as j_step
from posebyte_tpu.utils import evaluation as JE
from posebyte_tpu.utils import synthetic as JS

from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import TrackerState
from posebyte_tpu_torch.tracker.output import get_active_tracks
from posebyte_tpu_torch.utils import evaluation as E
from posebyte_tpu_torch.utils import synthetic as S

torch.set_num_threads(2)


class _T:
    """A track as both evaluators read it."""

    def __init__(self, tid, pose, score=0.9):
        self.track_id = tid
        self.keypoints = pose
        self.score = score
        self.bbox = np.zeros(4, np.float32)


def _pose(cx, cy, scale=100.0):
    p = np.ones((17, 3), np.float32)
    p[:, :2] = np.asarray([cx, cy], np.float32) + S.POSE_OFFSETS * scale
    return p


def _noisy(rng, pose, sigma):
    out = pose.copy()
    out[:, :2] += rng.normal(0, sigma, (17, 2)).astype(np.float32)
    return out


def _frames(seed, n_frames=12, n_people=5):
    """Per frame: ground truth [P, 17, 3] (some keypoints unlabelled),
    predictions (noisy copies, one missed, one false) and their scores."""
    rng = np.random.default_rng(seed)
    scene = S.SyntheticScene(n_people, 640, 360, seed=seed)
    gts, preds, scores = [], [], []
    for _ in range(n_frames):
        gt = scene.step()
        gt[:, :, 2] = (rng.uniform(size=(n_people, 17)) > 0.2)
        p = [_noisy(rng, g, rng.uniform(0.5, 12.0)) for g in gt[1:]]
        p.append(_pose(*rng.uniform(100, 300, 2)))           # a false one
        gts.append(gt)
        preds.append(np.stack(p))
        scores.append(rng.uniform(0.2, 1.0, len(p)).astype(np.float32))
    return gts, preds, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oks_similarity_and_matching_match_jax(seed):
    gts, preds, scores = _frames(seed, n_frames=3)
    for gt, pred, sc in zip(gts, preds, scores):
        for g in gt:
            for p in pred:
                assert E.oks_similarity(g, p) == JE.oks_similarity(g, p)
                assert E.oks_similarity(g, p, 5000.0) == \
                    JE.oks_similarity(g, p, 5000.0)
        for thr in (0.5, 0.75, 0.9):
            assert E.match_detections(gt, pred, sc, thr) == \
                JE.match_detections(gt, pred, sc, thr)
    empty = np.zeros((17, 3), np.float32)
    assert E.oks_similarity(empty, gts[0][0]) == 0.0


@pytest.mark.parametrize("seed", [0, 3])
def test_keypoint_map_matches_jax(seed):
    gts, preds, scores = _frames(seed)
    got = E.keypoint_map(gts, preds, scores)
    assert got == JE.keypoint_map(gts, preds, scores)
    assert 0.0 < got["mAP"] < 1.0
    assert E.keypoint_map([], [], []) == JE.keypoint_map([], [], [])


@pytest.mark.parametrize("seed", [0, 5])
def test_tracking_evaluator_matches_jax(seed):
    """A sequence with misses, false positives, an id swap and a track
    that restarts: every count, MOTA and IDF1 equal."""
    gts, preds, scores = _frames(seed, n_frames=16)
    rng = np.random.default_rng(seed + 100)
    ours, theirs = E.TrackingEvaluator(), JE.TrackingEvaluator()
    for f, (gt, pred, sc) in enumerate(zip(gts, preds, scores)):
        ids = list(range(10, 10 + len(pred)))
        if f >= 8:
            ids[0], ids[1] = ids[1], ids[0]                  # a swap
        if f >= 12:
            ids[2] = 99                                      # a restart
        tracks = [_T(i, p, float(s)) for i, p, s in zip(ids, pred, sc)
                  if rng.uniform() > 0.1]
        g = {i: gt[i] for i in range(len(gt))}
        ours.update(g, tracks)
        theirs.update(g, tracks)
    assert ours.summary() == theirs.summary()
    assert ours.mota == theirs.mota and ours.idf1 == theirs.idf1
    assert ours.summary()["id_switches"] > 0


def _idf1_perfect():
    seq = []
    for t in range(10):
        gt = {0: _pose(100 + 4 * t, 100), 1: _pose(400, 300 + 4 * t)}
        seq.append((gt, [_T(7, gt[0]), _T(9, gt[1])]))
    return seq, {"MOTA": 1.0, "IDF1": 1.0, "id_switches": 0}


def _idf1_swap():
    seq = []
    for t in range(20):
        gt = {0: _pose(100, 100), 1: _pose(400, 300)}
        ids = (7, 9) if t < 10 else (9, 7)
        seq.append((gt, [_T(ids[0], gt[0]), _T(ids[1], gt[1])]))
    return seq, {"MOTA": 0.95, "IDF1": 0.5, "id_switches": 2}


def _idf1_fragmentation():
    seq = []
    for t in range(10):
        gt = {0: _pose(100, 100)}
        seq.append((gt, [_T(7 if t < 6 else 8, gt[0])]))
    return seq, {"IDF1": 0.6, "id_switches": 1}


@pytest.mark.parametrize("case", [_idf1_perfect, _idf1_swap,
                                  _idf1_fragmentation],
                         ids=["perfect", "swap", "fragmentation"])
def test_idf1_cases_of_the_hard_tracking_tests(case):
    """The three IDF1 cases of tests/test_hard_tracking.py:29-72: the
    port's summary equals JAX's and holds their values."""
    seq, want = case()
    ours, theirs = E.TrackingEvaluator(), JE.TrackingEvaluator()
    for gt, tracks in seq:
        ours.update(gt, tracks)
        theirs.update(gt, tracks)
    s = ours.summary()
    assert s == theirs.summary()
    for k, v in want.items():
        assert abs(s[k] - v) < 1e-6, (k, s)


@pytest.mark.parametrize("seed,kw", [
    (86002, dict(n_persons=8, width=640, height=360,
                 scale_range=(80.0, 130.0), speed=5.0, entry_exit=True,
                 clip_len=96)),
    (0, {}),
    (0, dict(n_persons=5, entry_exit=False, clip_len=40)),
], ids=["hard_clip", "default", "no_entry_exit"])
def test_crowded_scene_is_jax_bit_for_bit(seed, kw):
    ours = S.CrowdedScene(seed=seed, **kw)
    theirs = JS.CrowdedScene(seed=seed, **kw)
    n = kw.get("clip_len", 96)
    for (p, a), (jp, ja) in zip(ours.frames(n), theirs.frames(n)):
        assert p.dtype == jp.dtype and a.dtype == ja.dtype
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(a, ja)
    assert ours.n_persons == theirs.n_persons
    np.testing.assert_array_equal(ours.window, theirs.window)


def test_poses_to_detections_matches_jax():
    rng = np.random.default_rng(4)
    poses = np.stack([_noisy(rng, _pose(*rng.uniform(100, 500, 2)), 3.0)
                      for _ in range(5)])
    for score in (0.9, 0.4):
        got = S.poses_to_detections(poses, 16, score, device="cpu")
        want = JS.poses_to_detections(poses, 16, score)
        for f in ("poses", "boxes", "scores", "valid"):
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_render_frame_colours():
    """colors= paints each person in its own colour; the default palette
    is the one it replaces."""
    poses = np.stack([_pose(120, 150, 90), _pose(420, 200, 110)])
    palette = [(60 + (60 * i) % 196, 200, 255 - (50 * i) % 200)
               for i in range(2)]
    np.testing.assert_array_equal(
        S.render_frame(poses, 640, 360, colors=np.asarray(palette)),
        S.render_frame(poses, 640, 360))
    custom = S.render_frame(poses, 640, 360,
                            colors=np.asarray([(0, 0, 255), (255, 0, 0)]))
    assert (custom == (0, 0, 255)).all(-1).sum() > 100
    assert (custom == (255, 0, 0)).all(-1).sum() > 100


def test_from_conf_threshold_matches_jax():
    for conf, kw in ((0.3, {}), (0.5, dict(max_age=4, reid_weight=0.3))):
        got = dataclasses.asdict(TrackerConfig.from_conf_threshold(conf,
                                                                   **kw))
        want = dataclasses.asdict(JTrackerConfig.from_conf_threshold(conf,
                                                                     **kw))
        assert got == want
    assert TrackerConfig.from_conf_threshold(0.3).low_thresh == 0.15


def test_get_active_tracks_matches_jax():
    """A JAX tracker run over a moving scene; its state read back by the
    port's get_active_tracks (one packed host copy) against the JAX one."""
    T, D = 32, 16
    jcfg = JTrackerConfig(max_tracks=T, max_detections=D)
    cfg = TrackerConfig(max_tracks=T, max_detections=D)
    scene = JS.SyntheticScene(4, 640, 360, seed=9)
    state = JTrackerState.init(T, D)
    seen = 0
    for _ in range(6):
        det = JS.poses_to_detections(scene.step(), D, 0.8)
        state, _ = j_step(state, det, jcfg)
        want = j_active(state, det.scores, jcfg)
        port_state = TrackerState(**{
            f.name: torch.from_numpy(np.array(getattr(state, f.name)))
            for f in dataclasses.fields(TrackerState)})
        got = get_active_tracks(port_state, np.array(det.scores), cfg)
        assert [t.track_id for t in got] == [t.track_id for t in want]
        assert [t.score for t in got] == [t.score for t in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.keypoints, w.keypoints, atol=1e-5)
            np.testing.assert_allclose(g.bbox, w.bbox, atol=1e-5)
        seen = max(seen, len(got))
    assert seen == 4
