"""The port's tracker debug hooks (tracker/debug.py) and torch_trace
(utils/profiling.py) against the JAX package on the CPU, with the cases of
tests/test_debug_profiling_checkpoint.py:

- tracker_step_debug on one state, handed to both packages as the same
  numpy arrays (the JAX state after 17 frames of
  test_torch_tracker.detections_sequence, so tracks are confirmed and
  lost), and the next frame's detections: every key of
  JAX's dict; gates, the three tiers' assignments and the predicted poses
  and centres equal bit for bit; the OKS matrices and the costs within
  2e-6 relative (test_torch_tracker's primitive bar: XLA's exp and
  PyTorch's round differently by an ulp) and their LOCK_COST entries
  equal; then the JAX test's own case (the new track gates and matches its
  own detection);
- dump_detections: JAX's string character for character; get_track_states:
  JAX's list;
- torch_trace writes a Chrome trace of what runs inside it.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.core.structs import TrackerState as JTrackerState
from posebyte_tpu.tracker import debug as JDBG
from posebyte_tpu.tracker.step import tracker_step as j_step

from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import Detections, TrackerState
from posebyte_tpu_torch.tracker import debug as DBG
from posebyte_tpu_torch.tracker import tracker_step
from posebyte_tpu_torch.tracker.step import LOCK_COST

from test_torch_tracker import STATE_FIELDS, detections_sequence

torch.set_num_threads(2)

T, D = 32, 16
EXACT = ("predicted_poses", "track_centers", "det_centers", "gate_mask",
         "lost_gate_mask", "cost_high", "cost_low", "cost_lost",
         "row_assign_high", "col_assign_high", "row_assign_low",
         "col_assign_low", "row_assign_final", "col_assign_final")
CLOSE = ("oks_matrix", "torso_oks_matrix")


def _dets(arrays):
    return (JDetections(*(jnp.asarray(a) for a in arrays)),
            Detections(*(torch.from_numpy(a) for a in arrays)))


def _same_state(jstate):
    return TrackerState(**{f: torch.from_numpy(np.array(getattr(jstate, f)))
                           for f in STATE_FIELDS})


def test_tracker_step_debug_matches_jax():
    seq = detections_sequence(4, 18, D)
    jcfg = JTrackerConfig(max_tracks=T, max_detections=D)
    jstate = JTrackerState.init(T, D)
    for arrays in seq[:17]:
        jstate, _ = j_step(jstate, _dets(arrays)[0], jcfg)
    assert {1, 2} <= set(np.asarray(jstate.states)[
        np.asarray(jstate.active)].tolist())       # confirmed and lost
    jdet, tdet = _dets(seq[17])
    want = JDBG.tracker_step_debug(jstate, jdet, jcfg)
    got = DBG.tracker_step_debug(_same_state(jstate), tdet,
                                 TrackerConfig(max_tracks=T,
                                               max_detections=D))
    assert sorted(got) == sorted(want)
    for k in EXACT:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for k in CLOSE:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=2e-6,
                                   atol=1e-7, err_msg=k)
    assert (got["cost_high"] < LOCK_COST).any()
    assert (got["row_assign_final"] >= 0).sum() >= 3


def _make_det(pose, score=0.9, capacity=8):
    poses = np.zeros((capacity, 17, 3), np.float32)
    poses[0] = pose
    scores = np.zeros((capacity,), np.float32)
    scores[0] = score
    valid = np.zeros((capacity,), bool)
    valid[0] = True
    return (poses, np.zeros((capacity, 4), np.float32), scores, valid)


def test_tracker_step_debug_intermediates(random_pose_factory):
    cfg = TrackerConfig(max_tracks=16, max_detections=8)
    det = Detections(*map(torch.from_numpy,
                          _make_det(random_pose_factory())))
    state, _ = tracker_step(TrackerState.init(16, 8), det, cfg)
    dbg = DBG.tracker_step_debug(state, det, cfg)
    assert dbg["gate_mask"].shape == (16, 8)
    assert dbg["cost_high"].shape == (16, 8)
    slot = int(state.det_track_slot[0])
    assert dbg["gate_mask"][slot, 0]
    assert dbg["row_assign_final"][slot] == 0


def test_dump_and_track_states_match_jax(random_pose_factory):
    arrays = _make_det(random_pose_factory(), capacity=8)
    arrays[0][3, :, :] = arrays[0][0] + 40.0           # a second person
    arrays[2][3], arrays[3][3] = np.float32(0.4567), True
    jdet, tdet = _dets(arrays)
    for n in (1, 3):
        assert DBG.dump_detections(tdet, n) == JDBG.dump_detections(jdet, n)
    assert "det[3]" in DBG.dump_detections(tdet)
    jcfg = JTrackerConfig(max_tracks=16, max_detections=8)
    cfg = TrackerConfig(max_tracks=16, max_detections=8)
    jstate, tstate = JTrackerState.init(16, 8), TrackerState.init(16, 8)
    for _ in range(3):
        jstate, _ = j_step(jstate, jdet, jcfg)
        tstate, _ = tracker_step(tstate, tdet, cfg)
    ts = DBG.get_track_states(tstate)
    assert ts == JDBG.get_track_states(jstate)
    assert len(ts) == 2 and ts[0]["track_id"] == 1 and ts[0]["hits"] == 3


def test_torch_trace_writes_chrome_trace(tmp_path):
    from posebyte_tpu_torch.utils.profiling import torch_trace
    with torch_trace(str(tmp_path / "tr")) as path:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert path == str(tmp_path / "tr" / "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert os.path.getsize(path) > 0
