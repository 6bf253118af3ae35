"""The port's Re-ID (posebyte_tpu_torch/ops/reid.py, the Re-ID branch of
tracker/step.py and of pipeline/runner.py) against the JAX package, on the
same numpy inputs.

Tolerances:
- pose_color_embedding: against both of the JAX package's lowerings
  within 2e-7 on the unit-norm embeddings, a few float32 ulps. Both sides
  equal, bit for bit, one float32 numpy reference that rounds every
  product and sum on its own, the port with the 51 squares summed in
  index order (the order Kernel 3 and the card use) and torch's CPU
  square root, JAX with XLA's sum of the squares and the IEEE square
  root: the gap is those two and nothing else.
- cosine_cost_matrix, blend_reid_cost, ema_update: within 1e-6.
- tracker_step with embeddings: ids, states, hits, emit and num_active
  equal; poses within 1e-4 px, embeddings within 1e-5.
- PosePipeline with reid_weight 0.3 (input 192, fp32, the trained 256
  checkpoint, both appearance sources, per frame and per chunk): ids and
  emit equal, keypoints within 1e-3 px.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.core.structs import TrackerState as JTrackerState
from posebyte_tpu.models.reid_head import load_reid_head as j_load_head
from posebyte_tpu.models.weights import load_params as j_load_params
from posebyte_tpu.ops import reid as JR
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline
from posebyte_tpu.tracker.output import extract_outputs_device as j_extract
from posebyte_tpu.tracker.step import tracker_step as j_step

from posebyte_tpu_torch.core.config import (DetectorConfig, PipelineConfig,
                                            TrackerConfig)
from posebyte_tpu_torch.core.structs import Detections, TrackerState
from posebyte_tpu_torch.models import load_params, load_reid_head
from posebyte_tpu_torch.ops import reid as R
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.tracker import extract_outputs_device, tracker_step
from posebyte_tpu_torch.utils.synthetic import (SyntheticScene,
                                                poses_to_arrays,
                                                render_frame)

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
HEAD = os.path.join(ASSETS, "reid-head-synthetic.safetensors")
DETECTOR = os.path.join(ASSETS, "yolov8n-pose-synthetic256.safetensors")


def edge_stress_poses(rng, n, size):
    """Poses at every sampling edge case (after tests/test_reid_head.py):
    interior, straddling the left and bottom edges, far outside the image
    (clamped), epsilon below and exactly on integer coordinates, and low
    confidences that gate keypoints off."""
    poses = np.ones((n, 17, 3), np.float32)
    poses[:, :, :2] = rng.uniform(-30, size + 30, (n, 17, 2))
    poses[0, :, :2] = rng.uniform(10, size - 10, (17, 2))
    poses[1, :, 0] = rng.uniform(-6, 6, 17)
    poses[2, :, 1] = size - rng.uniform(-6, 6, 17)
    near = rng.integers(1, size - 1, (17, 2)).astype(np.float32)
    poses[3, :, :2] = near - np.float32(1e-6)
    poses[4, :, :2] = near
    poses[5:, :, 2] = rng.uniform(0, 1, (n - 5, 17))
    return poses


def images(rng, size):
    """The same picture as u8 raw BGR and as float32 0..1."""
    u8 = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
    return u8, (u8.astype(np.float32) / np.float32(255.0))


def numpy_descriptor(img, poses, raw, sum_squares, sqrt):
    """The pose-colour descriptor in float32 numpy, every product and sum
    rounded on its own (numpy contracts nothing), with the sum of the 51
    squares and the square root given."""
    f = np.float32
    S = img.shape[0]
    x = np.clip(poses[..., 0], f(0), f(S - 1.001))
    y = np.clip(poses[..., 1], f(0), f(S - 1.001))
    x0, y0 = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
    fx = (x - x0.astype(f))[..., None]
    fy = (y - y0.astype(f))[..., None]
    c = (img[y0, x0] * (f(1) - fx)) * (f(1) - fy)
    c = c + (img[y0, x0 + 1] * fx) * (f(1) - fy)
    c = c + (img[y0 + 1, x0] * (f(1) - fx)) * fy
    c = c + (img[y0 + 1, x0 + 1] * fx) * fy
    if raw:
        c = c[..., ::-1] * f(1.0 / 255.0)
    c = c * (poses[..., 2] > 0.2)[..., None].astype(f)
    emb = c.reshape(len(poses), 51)
    norm = sqrt(sum_squares(emb * emb))
    return emb / np.maximum(norm, f(1e-6))[:, None]


def in_order(sq):
    total = sq[:, 0]
    for q in range(1, sq.shape[1]):
        total = total + sq[:, q]
    return total


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("u8", [False, True])
def test_pose_color_embedding_matches_jax(raw, u8):
    """The port against both of JAX's lowerings within 2e-7, and where the
    few ulps come from: the port is the numpy reference with the squares
    summed in index order and torch's square root (on the CPU not always
    correctly rounded), JAX is the same reference with XLA's sum of the
    squares and the IEEE square root, each bit for bit."""
    rng = np.random.default_rng(11 + 2 * raw + u8)
    S = 80
    img_u8, img_f32 = images(rng, S)
    img = img_u8 if u8 else img_f32
    poses = edge_stress_poses(rng, 8, S)
    got = R.pose_color_embedding(torch.from_numpy(img),
                                 torch.from_numpy(poses), raw_input=raw)
    assert got.shape == (8, R.REID_DIM) and got.dtype == torch.float32
    for impl in ("direct", "block"):
        want = np.asarray(JR.pose_color_embedding(
            jnp.asarray(img), jnp.asarray(poses), raw_input=raw,
            sample_impl=impl))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7)
    np.testing.assert_array_equal(got.numpy(), numpy_descriptor(
        img, poses, raw, in_order,
        lambda v: torch.sqrt(torch.from_numpy(v)).numpy()))
    np.testing.assert_array_equal(want, numpy_descriptor(
        img, poses, raw, lambda sq: np.asarray(jnp.sum(jnp.asarray(sq), -1)),
        np.sqrt))
    gated = poses[..., 2] <= 0.2
    assert gated.any()
    assert (got.numpy().reshape(8, 17, 3)[gated] == 0).all()


def test_embeddings_batched_over_frames():
    """A leading frame axis (the chunk path) gives each frame's own
    embeddings."""
    rng = np.random.default_rng(3)
    imgs = torch.from_numpy(rng.integers(0, 255, (3, 64, 64, 3),
                                         dtype=np.uint8))
    poses = torch.from_numpy(np.stack([edge_stress_poses(rng, 6, 64)
                                       for _ in range(3)]))
    batched = R.pose_color_embedding(imgs, poses, True)
    for i in range(3):
        assert torch.equal(batched[i], R.pose_color_embedding(
            imgs[i], poses[i], True))


def embedding_sets(seed, T=12, D=9):
    """Keypoint-blocked unit embeddings with invisible (zero) blocks, an
    all-zero track (never initialised) and an all-zero detection."""
    rng = np.random.default_rng(seed)

    def make(n):
        e = rng.normal(size=(n, 17, 3)).astype(np.float32)
        e[rng.random((n, 17)) < 0.3] = 0.0
        e = e.reshape(n, 51)
        return e / np.linalg.norm(e, axis=1, keepdims=True)

    t, d = make(T), make(D)
    t[2] = 0.0
    d[4] = 0.0
    d[0] = t[5] * np.float32(0.5)          # the same appearance, scaled
    return t.astype(np.float32), d.astype(np.float32)


def test_cosine_blend_and_ema_match_jax():
    t, d = embedding_sets(0)
    got = R.cosine_cost_matrix(torch.from_numpy(t), torch.from_numpy(d))
    want = np.asarray(JR.cosine_cost_matrix(jnp.asarray(t), jnp.asarray(d)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (got[2] == 1.0).all() and (got[:, 4] == 1.0).all()   # no overlap
    assert abs(float(got[5, 0])) < 1e-6                  # same appearance

    rng = np.random.default_rng(1)
    geom = rng.uniform(0, 1, got.shape).astype(np.float32)
    geom[rng.random(got.shape) < 0.4] = 1e9
    for w in (0.3, 0.55):
        gb = R.blend_reid_cost(torch.from_numpy(geom), got, w)
        wb = np.asarray(JR.blend_reid_cost(jnp.asarray(geom),
                                           jnp.asarray(want), w))
        np.testing.assert_allclose(gb.numpy(), wb, rtol=0, atol=1e-6)
        assert (gb.numpy()[geom >= 5e8] == 1e9).all()       # locks kept

    at = d[rng.integers(0, len(d), len(t))]
    matched = rng.random(len(t)) < 0.6
    alloc = ~matched & (rng.random(len(t)) < 0.5)
    for a in (None, alloc):
        ge = R.ema_update(torch.from_numpy(t), torch.from_numpy(at),
                          torch.from_numpy(matched),
                          None if a is None else torch.from_numpy(a), 0.85)
        we = np.asarray(JR.ema_update(jnp.asarray(t), jnp.asarray(at),
                                      jnp.asarray(matched),
                                      None if a is None else jnp.asarray(a),
                                      0.85))
        np.testing.assert_allclose(ge.numpy(), we, rtol=0, atol=1e-6)
    assert torch.equal(ge[~torch.from_numpy(matched | alloc)],
                       torch.from_numpy(t[~(matched | alloc)]))


def test_embed_fn_and_config_choose_the_source():
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.integers(0, 255, (64, 64, 3),
                                        dtype=np.uint8))
    poses = torch.from_numpy(edge_stress_poses(rng, 6, 64))
    head = load_reid_head(HEAD)
    free = R.make_embed_fn(None, raw_input=True)
    assert torch.equal(free(img, poses),
                       R.pose_color_embedding(img, poses, True))
    learned = R.make_embed_fn(head, raw_input=True)
    from posebyte_tpu_torch.models.reid_head import apply_reid_head
    assert torch.equal(learned(img, poses), apply_reid_head(
        head, img, poses, raw_input=True))
    with pytest.raises(ValueError):
        TrackerConfig(reid_sample_impl="onehot")
    assert TrackerConfig(reid_sample_impl="block").reid_weight == 0.0


def colour_sequence(seed, frames, D, persons=5):
    """Per frame the detection arrays of a synthetic scene (dropouts,
    keypoint noise, a person lost for a while) and each detection's
    embedding: a fixed colour signature per person plus noise, zero blocks
    where the keypoint confidence is <= 0.2."""
    rng = np.random.default_rng(seed)
    scene = SyntheticScene(persons, 1280, 720, seed=seed, speed=6.0)
    signature = rng.normal(size=(persons, 17, 3)).astype(np.float32)
    out = []
    for k in range(frames):
        gt = scene.step()
        keep = rng.random(persons) > 0.15
        if 3 <= k < 9:
            keep[0] = False
        idx = np.flatnonzero(keep)
        poses = gt[idx].copy()
        poses[..., :2] += rng.normal(0, 1.5, poses[..., :2].shape)
        poses[..., 2] = rng.uniform(0.05, 1.0, poses[..., 2].shape)
        scores = rng.uniform(0.2, 1.0, len(idx)).astype(np.float32)
        order = np.argsort(-scores, kind="stable")
        P, B, S, V = poses_to_arrays(poses[order].astype(np.float32), D,
                                     scores[order])
        emb = np.zeros((D, 17, 3), np.float32)
        emb[:len(idx)] = signature[idx[order]] + rng.normal(
            0, 0.3, (len(idx), 17, 3))
        emb[:len(idx)] *= (P[:len(idx), :, 2] > 0.2)[..., None]
        emb = emb.reshape(D, 51)
        emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-6)
        out.append((P, B, S, V, emb.astype(np.float32)))
    return out


@pytest.mark.parametrize("seed,T,D,kw", [
    (0, 32, 16, dict(reid_weight=0.3)),
    (1, 128, 64, dict(reid_weight=0.5, reid_ema=0.8, min_hits=1,
                      max_age=2, lost_window=4)),
])
def test_tracker_step_with_embeddings_matches_jax(seed, T, D, kw):
    jcfg = JTrackerConfig(max_tracks=T, max_detections=D, **kw)
    tcfg = TrackerConfig(max_tracks=T, max_detections=D, **kw)
    jstate, tstate = JTrackerState.init(T, D), TrackerState.init(T, D)
    emitted = 0
    for P, B, S, V, E in colour_sequence(seed, 14, D):
        jdet = JDetections(*(jnp.asarray(a) for a in (P, B, S, V)))
        tdet = Detections(*(torch.from_numpy(a) for a in (P, B, S, V)))
        jstate, jaux = j_step(jstate, jdet, jcfg,
                              det_embeddings=jnp.asarray(E))
        tstate, taux = tracker_step(tstate, tdet, tcfg, torch.from_numpy(E))
        for f in ("ids", "states", "hits", "ages", "active",
                  "det_track_slot", "next_id"):
            np.testing.assert_array_equal(getattr(tstate, f).numpy(),
                                          np.asarray(getattr(jstate, f)),
                                          err_msg=f)
        np.testing.assert_allclose(tstate.poses.numpy(),
                                   np.asarray(jstate.poses), atol=1e-4)
        np.testing.assert_allclose(tstate.embeddings.numpy(),
                                   np.asarray(jstate.embeddings), atol=1e-5)
        assert int(taux["num_active"]) == int(jaux["num_active"])
        jout = j_extract(jstate, jdet.scores, jcfg)
        tout = extract_outputs_device(tstate, tdet.scores, tcfg)
        np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
        np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
        emitted += int(tout[4].sum())
    assert emitted > 0 and (tstate.embeddings.abs().sum(1) > 0).any()


def test_tracker_step_ignores_embeddings_without_weight():
    """reid_weight 0 with embeddings given is the geometric tracker (the
    JAX rule: Re-ID needs both), and the embeddings stay as they were."""
    P, B, S, V, E = colour_sequence(2, 1, 16)[0]
    det = Detections(*(torch.from_numpy(a) for a in (P, B, S, V)))
    cfg = TrackerConfig(max_tracks=32, max_detections=16)
    a, _ = tracker_step(TrackerState.init(32, 16), det, cfg,
                        torch.from_numpy(E))
    b, _ = tracker_step(TrackerState.init(32, 16), det, cfg)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.poses, b.poses)
    assert not a.embeddings.any()


def _pipelines(head: bool):
    det = dict(input_size=192, num_anchors=756, max_candidates=64,
               max_detections=16)
    trk = dict(max_tracks=32, max_detections=16, reid_weight=0.3)
    jpipe = JPosePipeline(
        JPipelineConfig(detector=JDetectorConfig(**det),
                        tracker=JTrackerConfig(**trk), precision="fp32"),
        params=j_load_params(DETECTOR)[0],
        reid_params=j_load_head(HEAD) if head else None)
    tpipe = PosePipeline(
        PipelineConfig(detector=DetectorConfig(**det),
                       tracker=TrackerConfig(**trk), precision="fp32"),
        params=load_params(DETECTOR)[0], device="cpu",
        reid_params=load_reid_head(HEAD) if head else None)
    return jpipe, tpipe


def _same_outputs(tout, jout):
    for k in ("ids", "emit", "num_active"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]),
                                      err_msg=k)
    np.testing.assert_allclose(tout["poses"].numpy(),
                               np.asarray(jout["poses"]), atol=1e-3)


@pytest.mark.parametrize("head", [False, True])
def test_reid_pipeline_matches_jax(head):
    """PosePipeline with reid_weight 0.3 (the descriptor, or the learned
    head from its asset) per frame and per chunk against the JAX pipeline
    with the same weights; 1280x720 frames into 192 interpolate, so the
    float32 letterbox is what both sources sample."""
    scene = SyntheticScene(4, 1280, 720, seed=11)
    frames = np.stack([render_frame(scene.step(), 1280, 720)
                       for _ in range(10)])
    jpipe, tpipe = _pipelines(head)
    emitted = 0
    for chunk in (frames[:5], frames[5:]):
        jout = jax.device_get(jpipe.process_chunk(chunk))
        tout = tpipe.process_chunk(chunk)
        _same_outputs(tout, jout)
        emitted += int(tout["emit"].sum())
    np.testing.assert_allclose(tpipe.state.embeddings.numpy(),
                               np.asarray(jpipe.state.embeddings),
                               atol=1e-4)
    jpipe, tpipe = _pipelines(head)
    for fr in frames[:5]:
        _same_outputs(tpipe.process_frame(fr),
                      jax.device_get(jpipe.process_frame(fr)))
    assert emitted >= 8
    assert (tpipe.state.embeddings.abs().sum(1) > 0).sum() >= 2
