"""The kalman136 motion model of the port (posebyte_tpu_torch/ops/kalman.py
::Kalman136, core/structs.py::KalmanState136 and the kalman136 branches of
tracker/step.py::tracker_step) against the JAX package on the same numpy
inputs.

Tolerances: Kalman136.predict and initiate equal JAX's bit for bit (the
same float32 operations in the same order: p + v + 0.5 a + (1/6) j left to
right, the process noise as float32 squares); update within 1e-6 relative
(a multiply-add that XLA may contract would differ by one ulp). The tracker
step with kalman136: integer state equal; poses, scores, the filter's mean
and covariance within 1e-5 px plus 1e-6 of their value and velocities
within 1e-4 px/frame, the tracker tolerance of tests/test_torch_tracker.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.core.structs import KalmanState136 as JKalmanState
from posebyte_tpu.core.structs import TrackerState as JTrackerState
from posebyte_tpu.ops.kalman import Kalman136 as JKalman136
from posebyte_tpu.tracker.output import extract_outputs_device as j_extract
from posebyte_tpu.tracker.step import tracker_step as j_step

from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import Detections, KalmanState136, \
    TrackerState
from posebyte_tpu_torch.ops.kalman import Kalman136, _PROCESS_NOISE_DIAG
from posebyte_tpu_torch.tracker import extract_outputs_device, tracker_step
from posebyte_tpu_torch.utils.synthetic import POSE_OFFSETS, \
    reid_embeddings_case, tracker_chunk_case

torch.set_num_threads(2)

EXACT = ("ids", "states", "hits", "ages", "last_frame", "active", "next_id",
         "frame", "det_track_slot")
CLOSE = ("poses", "scores", "kf_mean", "kf_cov", "embeddings")


def _poses(rng, n):
    p = np.zeros((n, 17, 3), np.float32)
    p[..., :2] = rng.uniform(100, 500, (n, 1, 2)) + POSE_OFFSETS[None] * \
        rng.uniform(50, 150, (n, 1, 1))
    p[..., 2] = rng.uniform(0.0, 1.0, (n, 17))
    p[0, :5, 2] = 0.0                     # conf 0: position variance 1000
    p[0, 5:9, 2] = 0.05                   # below 0.1: no update
    return p


def _both(mean, cov):
    return (JKalmanState(jnp.asarray(mean), jnp.asarray(cov)),
            KalmanState136(torch.from_numpy(mean), torch.from_numpy(cov)))


def _equal(got, want):
    np.testing.assert_array_equal(got.mean.numpy(), np.asarray(want.mean))
    np.testing.assert_array_equal(got.cov_diag.numpy(),
                                  np.asarray(want.cov_diag))


def test_process_noise_is_float32_squares():
    """0.1 and 0.05 squared in float32, not the literals 0.01 and 0.0025
    that the Pallas kernel adds (pallas_tracker.py:255-256)."""
    per_kp = _PROCESS_NOISE_DIAG[:8]
    assert per_kp.dtype == np.float32
    assert float(per_kp[4]) == 0.010000000707805157 != float(np.float32(0.01))
    assert float(per_kp[6]) == 0.002500000176951289 != float(
        np.float32(0.0025))
    assert per_kp[:4].tolist() == [1.0, 1.0, 0.25, 0.25]


def test_kalman136_roundtrip_matches_jax():
    """The JAX test_kalman136_roundtrip case: initiate two slots, predict,
    update one toward a shifted measurement, extract the poses."""
    rng = np.random.default_rng(0)
    det = _poses(rng, 2)
    j0 = JKalmanState.init(8)
    t0 = KalmanState136.init(8)
    _equal(t0, j0)
    slots, valid = np.asarray([3, 5], np.int32), np.asarray([True, True])
    j1 = JKalman136.initiate(j0, jnp.asarray(det), jnp.asarray(slots),
                             jnp.asarray(valid))
    t1 = Kalman136.initiate(t0, torch.from_numpy(det),
                            torch.from_numpy(slots), torch.from_numpy(valid))
    _equal(t1, j1)
    cov = t1.cov_diag.reshape(8, 17, 8)
    assert (cov[3, :5, 0] == 1000.0).all() and (cov[3, 5:, 0] == 10.0).all()
    j2, t2 = JKalman136.predict(j1), Kalman136.predict(t1)
    _equal(t2, j2)
    shifted = det.copy()
    shifted[0, :, 0] += 8.0
    args = (np.asarray([3], np.int32), np.asarray([0], np.int32),
            np.asarray([True]))
    j3 = JKalman136.update(j2, jnp.asarray(shifted),
                           *(jnp.asarray(a) for a in args))
    t3 = Kalman136.update(t2, torch.from_numpy(shifted),
                          *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(t3.mean.numpy(), np.asarray(j3.mean),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(t3.cov_diag.numpy(), np.asarray(j3.cov_diag),
                               rtol=1e-6, atol=0)
    m2, m3 = t2.mean.reshape(8, 17, 8), t3.mean.reshape(8, 17, 8)
    assert torch.equal(m3[5], m2[5])                   # the other slot
    assert torch.equal(m3[3, :9], m2[3, :9])           # conf < 0.1
    np.testing.assert_array_equal(
        Kalman136.extract_poses(t3).numpy(),
        np.asarray(JKalman136.extract_poses(j3)))


def test_kalman136_third_order_transition_matches_jax():
    """The JAX test_kalman136_third_order_transition case, and random
    means and covariances over 64 slots with both memories."""
    mean = np.zeros((1, 17, 8), np.float32)
    mean[0, :, 0], mean[0, :, 2], mean[0, :, 4], mean[0, :, 6] = \
        10.0, 2.0, 1.0, 0.6
    j, t = _both(mean.reshape(1, -1), np.ones((1, 136), np.float32))
    got = Kalman136.predict(t, accel_memory=0.9, jerk_memory=0.8)
    _equal(got, JKalman136.predict(j, accel_memory=0.9, jerk_memory=0.8))
    out = got.mean.reshape(17, 8).numpy()
    np.testing.assert_allclose(out[:, 0], 10 + 2 + 0.5 + 0.6 / 6.0,
                               rtol=1e-5)
    np.testing.assert_allclose(out[:, 4], 0.9, rtol=1e-5)
    np.testing.assert_allclose(out[:, 6], 0.48, rtol=1e-5)
    rng = np.random.default_rng(1)
    j, t = _both(rng.normal(0, 60, (64, 136)).astype(np.float32),
                 rng.uniform(0.5, 300, (64, 136)).astype(np.float32))
    for _ in range(3):
        j, t = JKalman136.predict(j, 0.9, 0.9), Kalman136.predict(t, 0.9, 0.9)
        _equal(t, j)


def test_kalman136_batched_update_and_initiate_drop_invalid_pairs():
    """Update over every slot with a random assignment (-1 unmatched),
    then initiate with invalid entries that point at live slots: the
    invalid ones are dropped, as in the JAX package."""
    rng = np.random.default_rng(2)
    T, N = 32, 12
    j, t = _both(rng.normal(100, 60, (T, 136)).astype(np.float32),
                 rng.uniform(0.5, 300, (T, 136)).astype(np.float32))
    det = _poses(rng, N)
    slots = np.arange(T, dtype=np.int32)
    rows = rng.integers(-1, N, T).astype(np.int32)
    args = (det, slots, rows, rows >= 0)
    j = JKalman136.update(j, *(jnp.asarray(a) for a in args))
    t = Kalman136.update(t, *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(t.mean.numpy(), np.asarray(j.mean), rtol=1e-6)
    np.testing.assert_allclose(t.cov_diag.numpy(), np.asarray(j.cov_diag),
                               rtol=1e-6)
    t = KalmanState136(*(torch.from_numpy(np.array(a))
                         for a in (j.mean, j.cov_diag)))
    slots = rng.permutation(T)[:N].astype(np.int32)
    valid = rng.uniform(size=N) > 0.4
    args = (det, slots, valid)
    j2 = JKalman136.initiate(j, *(jnp.asarray(a) for a in args))
    t2 = Kalman136.initiate(t, *(torch.from_numpy(a) for a in args))
    _equal(t2, j2)
    untouched = np.setdiff1d(np.arange(T), slots[valid])
    assert torch.equal(t2.mean[untouched], t.mean[untouched])


def _frames(seed, K, D, crowd):
    """tracker_chunk_case's detections (dropouts, a lost and found person,
    a near-duplicate, empty and crowded frames, keypoints below 0.1) with
    some keypoints at confidence 0, frame by frame."""
    (P, B, S, V), _ = tracker_chunk_case(seed, K, D, crowd=crowd)
    rng = np.random.default_rng(seed + 100)
    P[..., 2] *= rng.uniform(size=P.shape[:-1]) > 0.08
    return [tuple(a[k] for a in (P, B, S, V)) for k in range(K)]


@pytest.mark.parametrize("seed,T,D,crowd,kw,reid", [
    (0, 32, 16, 0, dict(), False),
    (1, 128, 64, 40, dict(accel_memory=0.8, jerk_memory=0.7), False),
    (2, 32, 16, 0, dict(reid_weight=0.3), True),
    (3, 16, 16, 12, dict(min_hits=1, max_age=2, lost_window=3), False),
])
def test_tracker_step_kalman136_matches_jax(seed, T, D, crowd, kw, reid):
    """tracker_step with motion_model="kalman136" frame by frame against
    the JAX step, with and without Re-ID, over 32 frames (crowded frames
    in two cases: new tracks, slot exhaustion)."""
    kw = dict(max_tracks=T, max_detections=D, motion_model="kalman136", **kw)
    jcfg, tcfg = JTrackerConfig(**kw), TrackerConfig(**kw)
    jstate, tstate = JTrackerState.init(T, D), TrackerState.init(T, D)
    frames = _frames(seed, 32, D, crowd)
    embs = reid_embeddings_case(seed, np.stack([f[3] for f in frames]))
    emitted, states = 0, set()
    for k, arrs in enumerate(frames):
        jdet = JDetections(*(jnp.asarray(a) for a in arrs))
        tdet = Detections(*(torch.from_numpy(a) for a in arrs))
        jstate, jaux = j_step(jstate, jdet, jcfg, det_embeddings=(
            jnp.asarray(embs[k]) if reid else None))
        tstate, taux = tracker_step(tstate, tdet, tcfg, (
            torch.from_numpy(embs[k]) if reid else None))
        for f in EXACT:
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f"{f}, frame {k}")
        for f in CLOSE:
            np.testing.assert_allclose(getattr(tstate, f).numpy(),
                                       np.asarray(getattr(jstate, f)),
                                       rtol=1e-6, atol=1e-5,
                                       err_msg=f"{f}, frame {k}")
        np.testing.assert_allclose(tstate.velocities.numpy(),
                                   np.asarray(jstate.velocities), rtol=1e-6,
                                   atol=1e-4, err_msg=f"velocities, {k}")
        np.testing.assert_allclose(taux["predicted_poses"].numpy(),
                                   np.asarray(jaux["predicted_poses"]),
                                   rtol=1e-6, atol=1e-5)
        jout = j_extract(jstate, jdet.scores, jcfg)
        tout = extract_outputs_device(tstate, tdet.scores, tcfg)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
        emitted += int(tout[4].sum())
        states |= set(tstate.states[tstate.active].tolist())
    assert emitted > 0 and int(tstate.next_id) > 1
    # the filter ran: live slots moved away from their initial state
    assert not torch.equal(tstate.kf_cov, TrackerState.init(T, D).kf_cov)
    if not crowd:          # crowds re-acquire the lost person's track
        assert states == {0, 1, 2}     # tentative, confirmed and lost


def test_tracker_step_kalman136_predicts_every_slot():
    """Free slots' filters are predicted too: their covariance grows by
    the process noise every frame, as Kalman136.predict does to the pool."""
    cfg = TrackerConfig(max_tracks=8, max_detections=4,
                        motion_model="kalman136")
    state = TrackerState.init(8, 4)
    empty = Detections(torch.zeros(4, 17, 3), torch.zeros(4, 4),
                       torch.zeros(4), torch.zeros(4, dtype=torch.bool))
    for _ in range(3):
        state, _ = tracker_step(state, empty, cfg)
    noise = torch.from_numpy(_PROCESS_NOISE_DIAG)
    assert torch.equal(state.kf_cov,
                       ((torch.ones(8, 136) + noise) + noise) + noise)
    assert not state.active.any()


def test_tracker_config_refuses_an_unknown_motion_model():
    with pytest.raises(ValueError):
        TrackerConfig(motion_model="kalman")
    assert dataclasses.replace(TrackerConfig(), motion_model="kalman136") \
        .motion_model == "kalman136"
