"""Tracker-state checkpoints across the packages: a TrackerState and a
KalmanState136 written by the port (posebyte_tpu_torch/utils/checkpoint.py,
the numpy-only safetensors writer of models/weights.py) load in the JAX
package (posebyte_tpu/utils/checkpoint.py, through the safetensors
package) and back, with the same metadata. Every field must come back
equal, with its dtype and shape.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core.structs import KalmanState136 as JKalmanState
from posebyte_tpu.core.structs import TrackerState as JTrackerState
from posebyte_tpu.utils import checkpoint as jck

from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import Detections, KalmanState136, \
    TrackerState
from posebyte_tpu_torch.models.weights import read_safetensors, \
    write_safetensors
from posebyte_tpu_torch.tracker import tracker_step
from posebyte_tpu_torch.utils import checkpoint as ck
from posebyte_tpu_torch.utils.synthetic import tracker_chunk_case


def _live_state():
    """A kalman136 tracker state after 10 frames of the synthetic case."""
    (P, B, S, V), _ = tracker_chunk_case(3, 10, 16, crowd=8)
    cfg = TrackerConfig(max_tracks=32, max_detections=16,
                        motion_model="kalman136")
    state = TrackerState.init(32, 16)
    for k in range(10):
        state, _ = tracker_step(state, Detections(*(
            torch.from_numpy(a[k]) for a in (P, B, S, V))), cfg)
    assert state.active.any()
    return state


def _assert_same(got, want):
    for f in dataclasses.fields(got):
        g = np.asarray(getattr(got, f.name))
        w = np.asarray(getattr(want, f.name))
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        np.testing.assert_array_equal(g, w, err_msg=f.name)


def test_tracker_state_round_trips_across_packages(tmp_path):
    state = _live_state()
    ck.save_tracker_state(state, str(tmp_path / "port.safetensors"))
    jstate = jck.load_tracker_state(str(tmp_path / "port.safetensors"))
    _assert_same(jstate, state)
    assert read_safetensors(str(tmp_path / "port.safetensors"))[1] == {
        "format": "posebyte-tracker-v1"}
    jck.save_tracker_state(jstate, str(tmp_path / "jax.safetensors"))
    back = ck.load_tracker_state(str(tmp_path / "jax.safetensors"))
    _assert_same(back, state)
    assert isinstance(back.poses, torch.Tensor)


def test_kalman_state_round_trips_across_packages(tmp_path):
    state = _live_state()
    kf = KalmanState136(state.kf_mean, state.kf_cov)
    ck.save_kalman_state(kf, str(tmp_path / "port.safetensors"))
    jkf = jck.load_kalman_state(str(tmp_path / "port.safetensors"))
    _assert_same(jkf, kf)
    jck.save_kalman_state(JKalmanState(jnp.asarray(jkf.mean) + 1.0,
                                       jkf.cov_diag),
                          str(tmp_path / "jax.safetensors"))
    back = ck.load_kalman_state(str(tmp_path / "jax.safetensors"))
    assert torch.equal(back.mean, kf.mean + 1.0)
    assert torch.equal(back.cov_diag, kf.cov_diag)
    assert read_safetensors(str(tmp_path / "jax.safetensors"))[1] == {
        "format": "posebyte-kalman136-v1"}


def test_missing_embeddings_default_like_jax(tmp_path):
    """A checkpoint without embeddings (written before Re-ID) loads with
    zero embeddings [T, 51] in both packages."""
    state = _live_state()
    arrays = {f.name: getattr(state, f.name).numpy()
              for f in dataclasses.fields(state) if f.name != "embeddings"}
    path = str(tmp_path / "old.safetensors")
    write_safetensors(path, arrays, {"format": "posebyte-tracker-v1"})
    got = ck.load_tracker_state(path)
    _assert_same(got, jck.load_tracker_state(path))
    assert got.embeddings.shape == (32, 51) and not got.embeddings.any()
    assert isinstance(jck.load_tracker_state(path), JTrackerState)


def test_writer_layout_and_refusals(tmp_path):
    """The writer pads its header to 8 bytes, keeps 0-d and bool arrays,
    and refuses a dtype the format has no name for."""
    path = str(tmp_path / "x.safetensors")
    arrays = {"a": np.arange(6, dtype=np.int32).reshape(2, 3),
              "b": np.asarray(7, np.int32), "c": np.asarray([True, False])}
    write_safetensors(path, arrays, {"k": "v"})
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    got, meta = read_safetensors(path)
    assert meta == {"k": "v"}
    for k, v in arrays.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    with pytest.raises(ValueError):
        write_safetensors(path, {"z": np.zeros(2, np.complex64)})
