"""Port's tracker step and its primitives (posebyte_tpu_torch/tracker/,
ops/geometry.py, ops/oks.py, ops/gating.py, ops/kalman.py) against the JAX
package on the same numpy detections.

Tolerances: ids, states, hits, ages, activity and detection->slot maps
equal; poses and velocities within 1e-5 px plus 1e-6 of their value:
XLA's CPU compiler contracts poses + K * innov (and the box padding) into
fused multiply-adds, PyTorch rounds twice, so the two differ by one float32
ulp, which is 1.5e-5 px at 150 px and 1.2e-4 px at 1024 px. Velocities
are smoothed differences of such coordinates, so they carry that ulp as an
absolute error: within 1e-4 px/frame. Primitive matrices within 2e-6
(relative) of JAX's.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.core.structs import TrackerState as JTrackerState
from posebyte_tpu.ops import gating as jg
from posebyte_tpu.ops import geometry as jgeo
from posebyte_tpu.ops import kalman as jk
from posebyte_tpu.ops import oks as joks
from posebyte_tpu.tracker.output import extract_outputs_device as j_extract
from posebyte_tpu.tracker.step import tracker_step as j_step
from posebyte_tpu.utils.synthetic import SyntheticScene as JScene

from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import Detections, TrackerState
from posebyte_tpu_torch.ops import gating, geometry, kalman, oks
from posebyte_tpu_torch.tracker import extract_outputs_device, tracker_step
from posebyte_tpu_torch.utils.synthetic import SyntheticScene

torch.set_num_threads(2)

STATE_FIELDS = ("poses", "velocities", "scores", "ids", "states", "hits",
                "ages", "last_frame", "active", "next_id", "frame",
                "det_track_slot", "kf_mean", "kf_cov", "embeddings")
EXACT = ("ids", "states", "hits", "ages", "last_frame", "active", "next_id",
         "frame", "det_track_slot")
ATOL = {"velocities": 1e-4}


def detections_sequence(seed, frames, capacity, n_persons=6):
    """Per frame (poses, boxes, scores, valid) numpy arrays: a synthetic
    scene with keypoint noise, random dropouts, a stretch where person 0 is
    gone long enough to be lost and come back, low-confidence detections,
    and a duplicate detection."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(n_persons, 1280, 720, seed=seed, speed=6.0)
    out = []
    for t in range(frames):
        gt = scene.step()
        keep = rng.uniform(size=n_persons) > 0.15
        if 5 <= t < 19:
            keep[0] = False
        poses = gt[keep].copy()
        poses[..., :2] += rng.normal(0, 1.5, poses[..., :2].shape)
        poses[..., 2] = rng.uniform(0.05, 1.0, poses[..., 2].shape)
        if t % 4 == 1 and len(poses):          # a duplicate detection
            poses = np.concatenate([poses, poses[:1] + 2.0])
        scores = rng.uniform(0.1, 1.0, len(poses)).astype(np.float32)
        order = np.argsort(-scores, kind="stable")
        n = min(len(poses), capacity)
        P = np.zeros((capacity, 17, 3), np.float32)
        B = np.zeros((capacity, 4), np.float32)
        S = np.zeros((capacity,), np.float32)
        V = np.zeros((capacity,), bool)
        P[:n] = poses[order][:n]
        B[:n] = np.stack([P[:n, :, 0].min(1), P[:n, :, 1].min(1),
                          P[:n, :, 0].max(1), P[:n, :, 1].max(1)], -1)
        S[:n] = scores[order][:n]
        V[:n] = True
        out.append((P, B, S, V))
    return out


@pytest.mark.parametrize("seed,T,D", [(0, 32, 16), (1, 128, 64), (2, 8, 8)])
def test_tracker_sequence_matches_jax(seed, T, D):
    jcfg = JTrackerConfig(max_tracks=T, max_detections=D)
    tcfg = TrackerConfig(max_tracks=T, max_detections=D)
    jstate = JTrackerState.init(T, D)
    tstate = TrackerState.init(T, D)
    seen_states = set()
    for P, B, S, V in detections_sequence(seed, 20, D):
        jdet = JDetections(*(jnp.asarray(a) for a in (P, B, S, V)))
        tdet = Detections(*(torch.from_numpy(a) for a in (P, B, S, V)))
        jstate, jaux = j_step(jstate, jdet, jcfg)
        tstate, taux = tracker_step(tstate, tdet, tcfg)
        for f in STATE_FIELDS:
            want = np.asarray(getattr(jstate, f))
            got = getattr(tstate, f).numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, f
            if f in EXACT:
                np.testing.assert_array_equal(got, want, err_msg=f)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=ATOL.get(f, 1e-5), err_msg=f)
        assert int(taux["num_matched"]) == int(jaux["num_matched"])
        jout = j_extract(jstate, jdet.scores, jcfg)
        tout = extract_outputs_device(tstate, tdet.scores, tcfg)
        for g, w in zip(tout, jout):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-5)
        seen_states |= set(np.asarray(jstate.states)[
            np.asarray(jstate.active)].tolist())
    assert int(jstate.next_id) > 1
    if T >= 32:
        assert seen_states == {0, 1, 2}   # tentative, confirmed and lost


def test_tracker_step_leaves_input_state_alone():
    P, B, S, V = detections_sequence(3, 1, 8)[0]
    state = TrackerState.init(16, 8)
    before = {f: getattr(state, f).clone() for f in STATE_FIELDS}
    tracker_step(state, Detections(*(torch.from_numpy(a) for a in
                                     (P, B, S, V))),
                 TrackerConfig(max_tracks=16, max_detections=8))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f), before[f]), f


def test_synthetic_scene_matches_jax():
    a, b = SyntheticScene(5, 1280, 720, seed=9), JScene(5, 1280, 720, seed=9)
    for _ in range(30):
        np.testing.assert_array_equal(a.step(), b.step())


def _pose_sets(seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 640, (12, 17, 3)).astype(np.float32)
    d = t[rng.permutation(12)[:9]] + rng.normal(0, 3, (9, 17, 3)) \
        .astype(np.float32)
    t[..., 2] = rng.uniform(0, 1, (12, 17))
    d[..., 2] = rng.uniform(0, 1, (9, 17))
    t[3, :, 2] = 0.0                        # no visible keypoints
    return t, d


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6,
                               atol=1e-7)


def test_primitives_match_jax():
    t, d = _pose_sets(0)
    T, Dt = torch.from_numpy(t), torch.from_numpy(d)
    jt, jd = jnp.asarray(t), jnp.asarray(d)
    _close(oks.oks_matrix(T, Dt), joks.oks_matrix(jt, jd))
    _close(oks.oks_matrix(T, Dt, 0.2), joks.oks_matrix(jt, jd, 0.2))
    _close(oks.torso_oks_matrix(T, Dt), joks.torso_oks_matrix(jt, jd))
    tc, dc = geometry.pose_centers(T), geometry.pose_centers(Dt)
    _close(tc, jgeo.pose_centers(jt))
    _close(geometry.centers_iou_matrix(tc),
           jgeo.centers_iou_matrix(jnp.asarray(tc.numpy())))
    rng = np.random.default_rng(1)
    vel = rng.normal(0, 5, (12, 17, 2)).astype(np.float32)
    act = rng.uniform(size=12) > 0.2
    st = rng.integers(0, 3, 12).astype(np.int32)
    for thr in (3.0, 3.0 * 1.3):
        np.testing.assert_array_equal(
            gating.spatial_gate(tc, dc, torch.from_numpy(vel),
                                torch.from_numpy(act), torch.from_numpy(st),
                                thr).numpy(),
            np.asarray(jg.spatial_gate(
                jnp.asarray(tc.numpy()), jnp.asarray(dc.numpy()),
                jnp.asarray(vel), jnp.asarray(act), jnp.asarray(st), thr)))
    pred, v2 = kalman.cv_predict(T, torch.from_numpy(vel),
                                 torch.from_numpy(act), torch.from_numpy(st))
    jpred, jv2 = jk.cv_predict(jt, jnp.asarray(vel), jnp.asarray(act),
                               jnp.asarray(st))
    _close(pred, jpred)
    _close(v2, jv2)
    row = rng.integers(-1, 9, 12).astype(np.int32)
    for g, w in zip(kalman.cv_update(T, v2, Dt, torch.from_numpy(row),
                                     torch.from_numpy(act)),
                    jk.cv_update(jt, jv2, jd, jnp.asarray(row),
                                 jnp.asarray(act))):
        _close(g, w)
