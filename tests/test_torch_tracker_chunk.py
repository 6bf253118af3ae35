"""Plain version of Kernel 3 (posebyte_tpu_torch/ops/tracker_chunk.py::
tracker_chunk_plain) against the JAX package, on the cv cases of
tests/test_pallas_tracker.py, with and without Re-ID, with the kalman136
motion model (with and without Re-ID), and with the torso tier switched
off (which only the kernel refuses).

References: the jitted lax.scan of tracker_step + extract_outputs_device
(with the serving scan's advance blend where a mask is given), and
tracker_chunk_pallas in interpret mode. The same numpy detections go to
both packages.

Tolerances: integer outputs and state fields (ids, emit, num_active,
states, hits, ages, last_frame, active, det_track_slot, next_id, frame)
equal; poses, boxes and scores within 1e-5 px plus 1e-6 of their value,
velocities within 1e-4 px/frame, the kalman136 filter's mean and
covariance like poses: the tracker tolerance of
tests/test_torch_tracker.py (XLA's CPU compiler fuses poses + K * innov
into one FMA, PyTorch rounds twice: one float32 ulp). Against the Pallas
kernel, whose one-hot selections and Python-double constants round
differently again, poses within 1e-3 px, the bar tests/test_pallas_tracker
.py holds that kernel to. With Re-ID the state's embeddings within 1e-5
of JAX's scan; against the Pallas kernel, whose cosine puts no epsilon
inside its square roots, ids, emit and num_active only, as
tests/test_pallas_tracker.py compares it with the scan; with kalman136 the
same three, since the Pallas kernel adds the process noise as the literals
0.01 and 0.0025 where Kalman136 adds float32 squares.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import TrackerConfig as JConfig
from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.core.structs import TrackerState as JState
from posebyte_tpu.ops.pallas_tracker import tracker_chunk_pallas
from posebyte_tpu.tracker.output import extract_outputs_device as j_extract
from posebyte_tpu.tracker.step import tracker_step as j_step
from posebyte_tpu.utils.synthetic import SyntheticScene, poses_to_detections

from posebyte_tpu_torch.core.config import TrackerConfig
from posebyte_tpu_torch.core.structs import Detections, TrackerState
from posebyte_tpu_torch.ops import tracker_chunk as TC
from posebyte_tpu_torch.utils.synthetic import reid_embeddings_case

torch.set_num_threads(2)

INT_STATE = ("ids", "states", "hits", "ages", "last_frame", "active",
             "next_id", "frame", "det_track_slot")
FLOAT_STATE = ("poses", "velocities", "scores", "kf_mean", "kf_cov")
INT_OUT = ("ids", "emit", "num_active")
FLOAT_OUT = ("scores", "poses", "boxes")


def _jax_scan(state, dets, cfg, advance=None, embs=None):
    """lax.scan of the JAX tracker step; with `advance`, the serving
    scan's blend (tests/test_pallas_tracker.py::_gated_scan_reference)."""
    def one(state, x):
        det, adv, emb = x
        new, aux = j_step(state, det, cfg, det_embeddings=emb)
        if adv is not None:
            new = jax.tree.map(lambda n, o: jnp.where(adv, n, o), new, state)
        ids, scores, poses, boxes, emit = j_extract(new, det.scores, cfg)
        na = aux["num_active"]
        if adv is not None:
            emit, na = emit & adv, jnp.where(adv, na, 0)
        return new, {"ids": ids, "scores": scores, "poses": poses,
                     "boxes": boxes, "emit": emit, "num_active": na}
    return jax.jit(lambda s, d, a, e: jax.lax.scan(one, s, (d, a, e)))(
        state, dets, advance, embs)


def _stack(dets):
    return JDetections(*(jnp.stack([getattr(d, f) for d in dets])
                         for f in ("poses", "boxes", "scores", "valid")))


def _to_torch(obj, cls):
    return cls(**{f.name: torch.from_numpy(np.array(getattr(obj, f.name)))
                  for f in dataclasses.fields(cls)})


def _check(got, want, advanced=None, pose_atol=1e-5, reid=False):
    """got: the port's (state, outs); want: JAX's. `advanced` limits the
    frame outputs compared to the advanced frames, except emit and
    num_active."""
    (gs, go), (ws, wo) = got, jax.device_get(want)
    for f in INT_STATE:
        np.testing.assert_array_equal(getattr(gs, f).numpy(),
                                      np.asarray(getattr(ws, f)), err_msg=f)
    if reid:
        np.testing.assert_allclose(gs.embeddings.numpy(),
                                   np.asarray(ws.embeddings), rtol=0,
                                   atol=1e-5, err_msg="embeddings")
    for f in FLOAT_STATE:
        np.testing.assert_allclose(
            getattr(gs, f).numpy(), np.asarray(getattr(ws, f)), rtol=1e-6,
            atol=1e-4 if f == "velocities" else pose_atol, err_msg=f)
    sel = slice(None) if advanced is None else np.asarray(advanced)
    for k in INT_OUT:
        g, w = go[k].numpy(), np.asarray(wo[k])
        if k == "ids":
            g, w = g[sel], w[sel]
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in FLOAT_OUT:
        np.testing.assert_allclose(go[k].numpy()[sel], np.asarray(wo[k])[sel],
                                   rtol=1e-6, atol=pose_atol, err_msg=k)


def _run(det_list, T=128, D=64, cfg_kw=None, advance=None, pallas=False,
         state=None, embs=None):
    cfg_kw = dict(max_tracks=T, max_detections=D, **(cfg_kw or {}))
    jcfg, tcfg = JConfig(**cfg_kw), TrackerConfig(**cfg_kw)
    jdets = _stack(det_list)
    jstate = JState.init(T, D) if state is None else state
    tdets = _to_torch(jdets, Detections)
    tstate = _to_torch(jstate, TrackerState)
    tadv = None if advance is None else torch.from_numpy(np.asarray(advance))
    temb = None if embs is None else torch.from_numpy(embs)
    got = TC.tracker_chunk_plain(tstate, tdets, tcfg, tadv, temb)
    jadv = None if advance is None else jnp.asarray(advance)
    jemb = None if embs is None else jnp.asarray(embs)
    want = _jax_scan(jstate, jdets, jcfg, jadv, jemb)
    _check(got, want, advance, reid=embs is not None)
    if pallas and (embs is not None or tcfg.motion_model == "kalman136"):
        want = jax.device_get(tracker_chunk_pallas(
            jstate, jdets, jcfg, det_embeddings=jemb, advance=jadv,
            interpret=True))
        for k in INT_OUT:
            np.testing.assert_array_equal(got[1][k].numpy(),
                                          np.asarray(want[1][k]), err_msg=k)
    elif pallas:
        want = tracker_chunk_pallas(jstate, jdets, jcfg, advance=jadv,
                                    interpret=True)
        _check(got, want, pose_atol=1e-3)
    return got


def _dropouts(scene, frames, capacity, seed, p=0.3, score=None):
    rng = np.random.default_rng(seed)
    out = []
    for gt in scene.frames(frames):
        keep = rng.random(len(gt)) > p
        subset = gt[keep] if keep.any() else gt[:1]
        out.append(poses_to_detections(
            subset, capacity, score=score(rng) if score else
            0.4 + 0.5 * rng.random()))
    return out


def test_moving_scene():
    scene = SyntheticScene(5, 1280, 720, seed=3)
    _run([poses_to_detections(gt, 64) for gt in scene.frames(6)],
         pallas=True)


def test_dropouts():
    _run(_dropouts(SyntheticScene(6, 960, 540, seed=9), 10, 64, 4))


def test_empty_and_crowded_frames():
    scene = SyntheticScene(40, 3840, 2160, seed=5, scale_range=(60.0, 90.0))
    crowded = [poses_to_detections(gt, 64) for gt in scene.frames(3)]
    empty = JDetections.empty(64)
    _run([empty, crowded[0], crowded[1], empty, crowded[2]])


def test_continues_from_state():
    """Two chunks threaded through the state equal one long scan."""
    scene = SyntheticScene(4, 640, 480, seed=11)
    dets = [poses_to_detections(gt, 64) for gt in scene.frames(8)]
    first, _ = _run(dets[:4])
    jstate = JState(**{f.name: jnp.asarray(getattr(first, f.name).numpy())
                       for f in dataclasses.fields(JState)})
    _run(dets[4:], state=jstate)


@pytest.mark.parametrize("T,D,cfg_kw", [
    (64, 32, dict(min_hits=1)),
    (128, 64, dict(match_threshold=0.3, high_thresh=0.5,
                   new_track_thresh=0.6, max_age=3, lost_window=2,
                   gate_threshold=2.0, dedup_iou_threshold=0.5)),
])
def test_config_variations(T, D, cfg_kw):
    _run(_dropouts(SyntheticScene(5, 800, 600, seed=13), 7, D, 2, p=0.25,
                   score=lambda r: 0.3 + 0.7 * r.random()),
         T=T, D=D, cfg_kw=cfg_kw)


def test_slot_exhaustion():
    scene = SyntheticScene(12, 1920, 1080, seed=6, scale_range=(60.0, 90.0))
    (state, outs) = _run([poses_to_detections(gt, 16)
                          for gt in scene.frames(4)], T=8, D=16,
                         cfg_kw=dict(min_hits=1))
    assert bool(state.active.all())


def test_all_empty_from_fresh_state():
    state, outs = _run([JDetections.empty(64) for _ in range(6)])
    assert not outs["emit"].any() and int(state.next_id) == 1
    assert int(state.frame) == 6


def test_advance_gating():
    scene = SyntheticScene(4, 960, 540, seed=23)
    advance = np.asarray([True, True, False, True, False, False, True,
                          True])
    state, outs = _run([poses_to_detections(gt, 64)
                        for gt in scene.frames(8)], advance=advance,
                       pallas=True)
    assert not outs["emit"][~advance].any()
    assert (outs["ids"][~advance] == -1).all()
    assert int(state.frame) == int(advance.sum())


def test_advance_all_true_is_identity():
    scene = SyntheticScene(3, 640, 480, seed=29)
    dets = [poses_to_detections(gt, 64) for gt in scene.frames(5)]
    sa, oa = _run(dets, advance=np.ones(5, bool))
    sb, ob = _run(dets)
    for k in oa:
        assert torch.equal(oa[k], ob[k]), k
    for f in dataclasses.fields(sa):
        assert torch.equal(getattr(sa, f.name), getattr(sb, f.name)), f.name


def test_starved_chunk_then_resume():
    scene = SyntheticScene(3, 640, 480, seed=31)
    dets = [poses_to_detections(gt, 64) for gt in scene.frames(8)]
    state, _ = _run(dets[:4])
    jstate = JState(**{f.name: jnp.asarray(getattr(state, f.name).numpy())
                       for f in dataclasses.fields(JState)})
    starved, out = _run(dets[4:], advance=np.zeros(4, bool), state=jstate)
    assert not out["emit"].any()
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(starved, f.name), getattr(state, f.name))
    resumed, out2 = _run(dets[4:], advance=np.ones(4, bool), state=jstate)
    assert int(resumed.frame) == int(state.frame) + 4 and out2["emit"].any()


def test_dedup_stress():
    base = SyntheticScene(1, 640, 480, seed=30,
                          scale_range=(100.0, 120.0)).step()[0]
    rng = np.random.default_rng(5)
    dets = []
    for _ in range(6):
        poses = np.stack([base + rng.normal(0, 1.5, base.shape)
                          .astype(np.float32) for _ in range(10)])
        poses[:, :, 2] = 1.0
        dets.append(poses_to_detections(poses, 64,
                                        score=0.5 + 0.5 * rng.random()))
    _run(dets)


def test_large_detection_pool():
    scene = SyntheticScene(50, 3840, 2160, seed=21, scale_range=(50.0, 80.0))
    _run([poses_to_detections(gt, 128) for gt in scene.frames(4)], T=128,
         D=128, pallas=True)


def test_streams_match_one_stream_each():
    """A leading stream axis runs each stream as its own chunk."""
    states, dets = [], []
    for s in range(3):
        scene = SyntheticScene(3 + s, 640, 480, seed=20 + s)
        jd = _stack([poses_to_detections(gt, 64) for gt in scene.frames(5)])
        dets.append(_to_torch(jd, Detections))
        states.append(TrackerState.init(128, 64))
    cfg = TrackerConfig()
    adv = torch.tensor([[True] * 5, [True, False, True, True, False],
                        [False] * 5])
    vs, vo = TC.tracker_chunk_plain(TC._stack(states), TC._stack(dets), cfg,
                                    adv)
    for s in range(3):
        rs, ro = TC.tracker_chunk_plain(states[s], dets[s], cfg, adv[s])
        for k in ro:
            assert torch.equal(vo[k][s], ro[k]), k
        for f in dataclasses.fields(rs):
            assert torch.equal(getattr(vs, f.name)[s],
                               getattr(rs, f.name)), f.name


def test_dispatch_and_refusals():
    state = TrackerState.init(16, 8)
    dets = Detections(torch.zeros(2, 8, 17, 3), torch.zeros(2, 8, 4),
                      torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.bool))
    cfg = TrackerConfig(max_tracks=16, max_detections=8)
    s, o = TC.tracker_chunk(state, dets, cfg)
    assert int(s.frame) == 2 and o["ids"].shape == (2, 8)
    with pytest.raises(ValueError):           # the kernel takes CUDA only
        TC.tracker_chunk_cuda(state, dets, cfg)
    # kalman136 runs in the plain version; the kernel, too, takes CUDA only
    kalman = dataclasses.replace(cfg, motion_model="kalman136")
    s, o = TC.tracker_chunk(state, dets, kalman)
    assert int(s.frame) == 2 and not torch.equal(s.kf_cov, state.kf_cov)
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(state, dets, kalman)
    # only the kernel refuses torso_tier=False; the plain version runs it
    no_torso = dataclasses.replace(cfg, torso_tier=False)
    s, o = TC.tracker_chunk(state, dets, no_torso)
    assert int(s.frame) == 2
    with pytest.raises(NotImplementedError):
        TC.tracker_chunk_cuda(state, dets, no_torso)
    # embeddings exactly when reid_weight > 0
    reid = dataclasses.replace(cfg, reid_weight=0.3)
    embs = torch.zeros(2, 8, 51)
    for c, e in ((reid, None), (cfg, embs)):
        with pytest.raises(ValueError):
            TC.tracker_chunk(state, dets, c, det_embeddings=e)
        with pytest.raises(ValueError):
            TC.tracker_chunk_cuda(state, dets, c, det_embeddings=e)
    s, o = TC.tracker_chunk(state, dets, reid, det_embeddings=embs)
    assert int(s.frame) == 2


def test_torso_tier_off_matches_jax_scan():
    """torso_tier=False (the evaluation ablation) runs in the plain chunk
    tracker and equals JAX's scan of tracker_step without the torso tier."""
    _run(_dropouts(SyntheticScene(6, 960, 540, seed=9), 10, 64, 4),
         cfg_kw=dict(torso_tier=False))


def _reid_dets(seed, frames, D, persons=5):
    dets = _dropouts(SyntheticScene(persons, 1280, 720, seed=seed), frames,
                     D, seed, p=0.25)
    valid = np.stack([np.asarray(d.valid) for d in dets])
    return dets, reid_embeddings_case(seed, valid)


@pytest.mark.parametrize("seed,T,D,cfg_kw", [
    (17, 128, 64, dict(reid_weight=0.4, reid_ema=0.85)),
    (3, 32, 16, dict(reid_weight=0.3, min_hits=1, max_age=2,
                     lost_window=3)),
])
def test_reid_matches_jax_scan_and_pallas_ids(seed, T, D, cfg_kw):
    """Re-ID: the cosine blend of tiers 1 and 3, the EMA and the new
    tracks' embeddings against JAX's scan; ids, emit and num_active also
    against the Pallas kernel in interpret mode."""
    dets, embs = _reid_dets(seed, 8, D)
    state, outs = _run(dets, T=T, D=D, cfg_kw=cfg_kw, embs=embs,
                       pallas=True)
    assert outs["emit"].any() and (state.embeddings.abs().sum(1) > 0).any()


def test_reid_advance_holes_and_streams():
    """Re-ID with holes in the advance mask at S = 1 and S = 3: each
    stream against JAX's gated scan, and the stacked streams equal the
    streams run one by one."""
    cfg_kw = dict(reid_weight=0.3)
    advs = [np.asarray([True, True, False, True, False, True, True, False]),
            np.asarray([False, True, True, True, True, False, True, True]),
            np.ones(8, bool)]
    per_stream = []
    for s, adv in enumerate(advs):
        dets, embs = _reid_dets(30 + s, 8, 64, persons=3 + s)
        per_stream.append((dets, embs, _run(dets, cfg_kw=cfg_kw, embs=embs,
                                            advance=adv)))
    cfg = TrackerConfig(**cfg_kw)
    stacked = TC.tracker_chunk_plain(
        TC._stack([TrackerState.init(128, 64)] * 3),
        TC._stack([_to_torch(_stack(d), Detections)
                   for d, _, _ in per_stream]), cfg,
        torch.from_numpy(np.stack(advs)),
        torch.from_numpy(np.stack([e for _, e, _ in per_stream])))
    for s, (_, _, (rs, ro)) in enumerate(per_stream):
        for k in ro:
            assert torch.equal(stacked[1][k][s], ro[k]), k
        for f in dataclasses.fields(rs):
            assert torch.equal(getattr(stacked[0], f.name)[s],
                               getattr(rs, f.name)), f.name


KALMAN = dict(motion_model="kalman136")


@pytest.mark.parametrize("seed,T,D,cfg_kw,reid", [
    (8, 128, 64, KALMAN, False),
    (17, 128, 64, dict(KALMAN, reid_weight=0.4, accel_memory=0.8), True),
    (3, 32, 16, dict(KALMAN, min_hits=1, max_age=2, lost_window=3,
                     jerk_memory=0.7), False),
])
def test_kalman136_matches_jax_scan_and_pallas_ids(seed, T, D, cfg_kw, reid):
    """kalman136 (the third-order predict of every slot, the per-keypoint
    update, initiation) with and without Re-ID against JAX's scan, the
    filter included; ids, emit and num_active also against the Pallas
    kernel in interpret mode (the JAX test_chunk_kernel_kalman136 case)."""
    dets, embs = _reid_dets(seed, 8, D)
    state, outs = _run(dets, T=T, D=D, cfg_kw=cfg_kw,
                       embs=embs if reid else None, pallas=True)
    assert outs["emit"].any() and (state.kf_cov != 1.0).all(dim=1).any()


def test_kalman136_advance_holes_streams_and_continuation():
    """kalman136 with holes in the advance mask at S = 3 streams, each
    against JAX's gated scan; the stacked streams equal the streams run
    one by one; then a second chunk continues from the first's state."""
    advs = [np.asarray([True, True, False, True, False, True, True, False]),
            np.asarray([False, True, True, True, True, False, True, True]),
            np.ones(8, bool)]
    per_stream = []
    for s, adv in enumerate(advs):
        dets = _dropouts(SyntheticScene(3 + s, 960, 540, seed=40 + s), 12,
                         64, s)
        per_stream.append((dets, _run(dets[:8], cfg_kw=KALMAN,
                                      advance=adv)))
    cfg = TrackerConfig(**KALMAN)
    stacked = TC.tracker_chunk_plain(
        TC._stack([TrackerState.init(128, 64)] * 3),
        TC._stack([_to_torch(_stack(d[:8]), Detections)
                   for d, _ in per_stream]), cfg,
        torch.from_numpy(np.stack(advs)))
    for s, (_, (rs, ro)) in enumerate(per_stream):
        for k in ro:
            assert torch.equal(stacked[1][k][s], ro[k]), k
        for f in dataclasses.fields(rs):
            assert torch.equal(getattr(stacked[0], f.name)[s],
                               getattr(rs, f.name)), f.name
    dets, (first, _) = per_stream[0]
    jstate = JState(**{f.name: jnp.asarray(getattr(first, f.name).numpy())
                       for f in dataclasses.fields(JState)})
    state, outs = _run(dets[8:], cfg_kw=KALMAN, state=jstate)
    assert int(state.frame) == int(first.frame) + 4 and outs["emit"].any()
