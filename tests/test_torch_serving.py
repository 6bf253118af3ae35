"""The port's stream servers (posebyte_tpu_torch/pipeline/serving.py)
against the JAX package's on the same frames, with the oracle detector
(models/oracle.py) of both packages fed the same head tensors: every
scenario of tests/test_serving.py runs on a JAX server and on the port's
(device="cpu") in lockstep, and every served frame's outputs must agree.
Also the port's PosePipeline with an injected detector and with
raw_preproc=False (the normalised letterbox into the unfolded model)
against the JAX PosePipeline, per frame and per chunk.

Tolerances: step counts, frame counters, ids, emit and num_active equal;
poses, boxes and scores within 2e-6 relative plus 2e-4 absolute, the
decode bar of tests/test_torch_preprocess_decode.py (the DFL softmax
expectation of XLA's CPU kernels and PyTorch's differ by a few float32
ulps). The real-model pipeline: ids equal, keypoints within 1e-2 px (fp32
convolutions of XLA and oneDNN differ in summation order), as
tests/test_torch_pipeline.py holds them.
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
from posebyte_tpu.models.oracle import encode_oracle_head as j_encode
from posebyte_tpu.models.oracle import make_oracle_heads as j_oracle
from posebyte_tpu.models.reid_head import init_reid_head
from posebyte_tpu.models.weights import load_params as j_load_params
from posebyte_tpu.parallel import make_mesh
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline
from posebyte_tpu.pipeline import serving as JS
from posebyte_tpu.utils.synthetic import SyntheticScene, pose_bbox

from posebyte_tpu_torch.core.config import (DetectorConfig, PipelineConfig,
                                            TrackerConfig)
from posebyte_tpu_torch.models import load_params, reid_head_from_jax
from posebyte_tpu_torch.models.oracle import encode_oracle_head, \
    make_oracle_heads
from posebyte_tpu_torch.ops.preprocess import letterbox_params
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.pipeline import serving as TS

torch.set_num_threads(2)

H, W, S = 96, 128, 64
DET = dict(input_size=S, num_anchors=84, max_candidates=16, max_detections=4)
TRK = dict(max_tracks=8, max_detections=4, min_hits=1)
REID = dict(TRK, reid_weight=0.3)
STREAMS = 8
CHUNK = 4
ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")


def configs(trk):
    return (JPipelineConfig(detector=JDetectorConfig(**DET),
                            tracker=JTrackerConfig(**trk)),
            PipelineConfig(detector=DetectorConfig(**DET),
                           tracker=TrackerConfig(**trk)))


def oracle_gt(n=3, seed=5, scores=(0.9, 0.8, 0.7)):
    """n people of the synthetic scene in letterbox coordinates, their
    boxes and scores."""
    scene = SyntheticScene(n, W, H, seed=seed, scale_range=(30.0, 40.0),
                           speed=0.0)
    gt = scene.step()
    scale, _, _, pad_x, pad_y = letterbox_params(W, H, S)
    gt[:, :, :2] = gt[:, :, :2] * scale + np.float32([pad_x, pad_y])
    return (gt, np.stack([pose_bbox(p) for p in gt]),
            np.asarray(scores[:n], np.float32))


HEAD = j_encode(*oracle_gt(), S)
HEAD1 = j_encode(*oracle_gt(1, scores=(0.9,)), S)


def frames(seed, n):
    return np.random.default_rng(seed).integers(0, 255, (n, H, W, 3),
                                                np.uint8)


def assert_outputs_equal(ref, got):
    assert set(got) == set(ref)
    for k in ("ids", "emit", "num_active"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    for k in ("poses", "boxes", "scores"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=2e-6,
                                   atol=2e-4, err_msg=k)


class Both:
    """A JAX server and the port's driven by the same calls: each call's
    result must be the same on both, and every polled frame's outputs
    agree."""

    def __init__(self, jsrv, tsrv):
        self.j, self.t = jsrv, tsrv

    def open_stream(self):
        sid = self.t.open_stream()
        assert self.j.open_stream() == sid
        return sid

    def close_stream(self, sid):
        self.j.close_stream(sid)
        self.t.close_stream(sid)

    def submit(self, sid, frame):
        self.j.submit(sid, frame)
        self.t.submit(sid, frame)

    def step(self):
        n = self.t.step()
        assert self.j.step() == n
        return n

    def poll(self, sid):
        ref, got = self.j.poll(sid), self.t.poll(sid)
        assert len(got) == len(ref)
        for r, g in zip(ref, got):
            assert_outputs_equal(r, g)
        return got

    def frame_counter(self, sid):
        n = int(self.t.states.frame[sid])
        assert int(np.asarray(self.j.states.frame)[sid]) == n
        return n


def jax_server(cls, trk, head=HEAD, reid=None, **kw):
    jcfg, _ = configs(trk)
    return cls(num_streams=STREAMS, frame_shape=(H, W), config=jcfg,
               mesh=make_mesh(8), params=head, dtype=jnp.float32,
               heads_fn=j_oracle(), reid_params=reid, **kw)


def port_server(cls, trk, head=HEAD, reid=None, **kw):
    _, tcfg = configs(trk)
    return cls(STREAMS, (H, W), config=tcfg, params=head, device="cpu",
               dtype=torch.float32, heads_fn=make_oracle_heads(),
               reid_params=None if reid is None else reid_head_from_jax(reid),
               **kw)


@pytest.fixture(scope="module")
def jax_servers():
    """The JAX servers, each built (and compiled) once for the module;
    every test closes the streams it opens, and opening a slot resets it."""
    built = {}

    def get(kind, trk=TRK, head_name="head", reid=None):
        key = (kind, tuple(sorted(trk.items())), head_name, reid is None)
        if key not in built:
            head = HEAD if head_name == "head" else HEAD1
            cls, kw = ((JS.StreamServer, {}) if kind == "frame" else
                       (JS.ChunkedStreamServer, {"chunk": CHUNK}))
            built[key] = jax_server(cls, trk, head, reid, **kw)
        return built[key]
    return get


def both(jax_servers, kind="frame", trk=TRK, head_name="head", reid=None):
    cls, kw = ((TS.StreamServer, {}) if kind == "frame" else
               (TS.ChunkedStreamServer, {"chunk": CHUNK}))
    head = HEAD if head_name == "head" else HEAD1
    return Both(jax_servers(kind, trk, head_name, reid),
                port_server(cls, trk, head, reid, **kw))


def test_encode_oracle_head_matches_jax():
    gt, boxes, scores = oracle_gt()
    want = j_encode(gt, boxes, scores, S)
    got = encode_oracle_head(gt, boxes, scores, S)
    for k in ("box", "cls", "kpt"):
        np.testing.assert_array_equal(got[k], want[k])
    heads = make_oracle_heads()({k: torch.from_numpy(v)
                                 for k, v in got.items()},
                                torch.zeros((3, S, S, 3)))
    assert [tuple(h.shape) for h in heads] == [(3, 84, 64), (3, 84, 1),
                                               (3, 84, 51)]


@pytest.mark.parametrize("kind", ["frame", "chunk"])
def test_lifecycle_open_submit_step_poll_close(jax_servers, kind):
    srv = both(jax_servers, kind)
    fr = frames(0, 3)
    a, b = srv.open_stream(), srv.open_stream()
    assert a != b
    srv.submit(a, fr[0])
    srv.submit(a, fr[1])
    srv.submit(b, fr[2])
    if kind == "frame":
        assert srv.step() == 2          # one frame per stream consumed
        assert srv.step() == 1          # a's second frame
    else:
        assert srv.step() == 3          # a chunk holds both of a's frames
    assert srv.step() == 0              # nothing queued -> nothing runs
    outs_a, outs_b = srv.poll(a), srv.poll(b)
    assert len(outs_a) == 2 and len(outs_b) == 1
    assert outs_a[0]["emit"].shape == (4,) and outs_a[0]["emit"].sum() == 3
    srv.close_stream(a)
    srv.close_stream(b)
    for s in (srv.j, srv.t):
        with pytest.raises(KeyError):
            s.submit(a, fr[0])


def _episode_ids(srv, sid, n=4):
    ids = set()
    for _ in range(n):
        srv.submit(sid, np.zeros((H, W, 3), np.uint8))
        srv.step()
    for out in srv.poll(sid):
        ids.update(int(i) for i in out["ids"][out["emit"]])
    return ids


@pytest.mark.parametrize("kind", ["frame", "chunk"])
def test_slot_reuse_resets_tracker_state(jax_servers, kind):
    """Ids restart after close and reopen of a slot: the reset really
    re-initialises that slot's state (next_id back to 1, no tracks)."""
    srv = both(jax_servers, kind, head_name="head1")
    sid = srv.open_stream()
    assert _episode_ids(srv, sid) == {1}
    assert int(srv.t.states.next_id[sid]) == 2
    srv.close_stream(sid)
    sid2 = srv.open_stream()
    assert sid2 == sid
    assert _episode_ids(srv, sid2) == {1}
    assert int(srv.t.states.next_id[sid]) == 2
    srv.close_stream(sid2)


def test_starved_stream_does_not_age(jax_servers):
    srv = both(jax_servers)
    fr = frames(1, 4)
    a, b = srv.open_stream(), srv.open_stream()
    srv.submit(a, fr[0])
    srv.step()
    before_a, before_b = srv.frame_counter(a), srv.frame_counter(b)
    for i in range(3):
        srv.submit(b, fr[1 + i])
        srv.step()
    assert srv.frame_counter(a) == before_a
    assert srv.frame_counter(b) == before_b + 3
    srv.poll(a)
    srv.poll(b)
    srv.close_stream(a)
    srv.close_stream(b)


def test_pool_exhaustion(jax_servers):
    srv = both(jax_servers)
    sids = [srv.open_stream() for _ in range(STREAMS)]
    for s in (srv.j, srv.t):
        with pytest.raises(RuntimeError):
            s.open_stream()
    for sid in sids:
        srv.close_stream(sid)


def test_outputs_pollable_after_close(jax_servers):
    srv = both(jax_servers)
    sid = srv.open_stream()
    srv.submit(sid, frames(5, 1)[0])
    srv.step()
    srv.close_stream(sid)
    assert len(srv.poll(sid)) == 1        # EOS leaves outputs pollable
    for s in (srv.j, srv.t):
        with pytest.raises(KeyError):
            s.poll(99)


def test_chunked_server_matches_per_frame(jax_servers):
    """Both servers of the port give the same per-stream outputs as each
    other and as the JAX servers (partial chunks, starvation, a reset)."""
    fr = frames(7, 12)
    runs = {}
    for kind in ("frame", "chunk"):
        srv = both(jax_servers, kind)
        a, b, c = srv.open_stream(), srv.open_stream(), srv.open_stream()
        for f in fr[:5]:
            srv.submit(a, f)
        for f in fr[5:8]:
            srv.submit(b, f)
        srv.submit(c, fr[8])
        srv.step()
        srv.close_stream(c)               # c's slot reopens: a reset
        assert srv.open_stream() == c
        for f in fr[9:]:
            srv.submit(c, f)
        while srv.step():
            pass
        runs[kind] = [srv.poll(s) for s in (a, b, c)]
        assert [len(r) for r in runs[kind]] == [5, 3, 3]
        assert srv.frame_counter(a) == 5 and srv.frame_counter(c) == 3
        for s in (a, b, c):
            srv.close_stream(s)
    for pf, ch in zip(runs["frame"], runs["chunk"]):
        for r, g in zip(pf, ch):
            np.testing.assert_array_equal(g["emit"], r["emit"])
            np.testing.assert_array_equal(g["ids"], r["ids"])
            np.testing.assert_allclose(g["poses"], r["poses"], atol=1e-4)


def test_chunked_server_lifecycle(jax_servers):
    srv = both(jax_servers, "chunk")
    sid = srv.open_stream()
    for f in frames(9, 9):
        srv.submit(sid, f)
    assert [srv.step() for _ in range(4)] == [4, 4, 1, 0]   # partial tail
    assert len(srv.poll(sid)) == 9
    assert srv.frame_counter(sid) == 9    # the padded tail did not age it
    srv.close_stream(sid)


@pytest.mark.parametrize("kind", ["frame", "chunk"])
@pytest.mark.parametrize("learned", [False, True])
def test_serving_with_reid(jax_servers, kind, learned):
    """Re-ID (weight 0.3) with the pose-colour descriptor or the learned
    head, sampled from the normalised letterbox: outputs as the JAX
    server's, finite per-slot embeddings close to its."""
    reid = init_reid_head(jax.random.PRNGKey(4)) if learned else None
    srv = both(jax_servers, kind, REID, reid=reid)
    sid = srv.open_stream()
    for f in frames(11, 5):
        srv.submit(sid, f)
    while srv.step():
        pass
    assert len(srv.poll(sid)) == 5
    emb = srv.t.states.embeddings[sid].numpy()
    assert np.isfinite(emb).all() and (np.abs(emb).sum(-1) > 0).sum() == 3
    np.testing.assert_allclose(
        emb, np.asarray(srv.j.states.embeddings)[sid], atol=1e-5)
    srv.close_stream(sid)


def test_one_nms_and_one_tracker_call_per_step(monkeypatch):
    """Every step serves all its streams with one pose-NMS keep mask (one
    Kernel 1 launch on the card) and one tracker_chunk call (one Kernel 3
    launch), whatever the number of streams."""
    from posebyte_tpu_torch.ops import nms as N
    calls = {"nms": 0, "tracker": 0}
    nms_keep, tracker = N.nms_keep, TS.tracker_chunk

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(N, "nms_keep", count("nms", nms_keep))
    monkeypatch.setattr(TS, "tracker_chunk", count("tracker", tracker))
    for cls, kw in ((TS.StreamServer, {}),
                    (TS.ChunkedStreamServer, {"chunk": CHUNK})):
        srv = port_server(cls, TRK, **kw)
        sids = [srv.open_stream() for _ in range(5)]
        for i, sid in enumerate(sids):
            for f in frames(i, 2 + i):
                srv.submit(sid, f)
        steps = 0
        calls.update(nms=0, tracker=0)
        while srv.step():
            steps += 1
        assert calls == {"nms": steps, "tracker": steps}


def test_server_runs_on_the_card_unless_told():
    """With no device named the servers run on the card, and raise where
    there is none; they never move to the CPU on their own."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    _, tcfg = configs(TRK)
    for cls in (TS.StreamServer, TS.ChunkedStreamServer):
        with pytest.raises(RuntimeError):
            cls(STREAMS, (H, W), config=tcfg, params=HEAD,
                heads_fn=make_oracle_heads())
    with pytest.raises(ValueError):     # an injected detector's params
        TS.StreamServer(2, (H, W), config=tcfg, device="cpu",
                        heads_fn=make_oracle_heads())


@pytest.fixture(scope="module")
def scene_frames():
    from posebyte_tpu_torch.utils.synthetic import render_frame
    w, h = 1280, 720
    scene = SyntheticScene(4, w, h, seed=11)
    return np.stack([render_frame(scene.step(), w, h) for _ in range(4)])


def test_pipeline_injected_detector_matches_jax():
    """PosePipeline(heads_fn=oracle) against the JAX one, per frame and per
    chunk; the injected detector forces raw_preproc=False in both."""
    jcfg, tcfg = configs(TRK)
    fr = frames(3, 4)
    jp = JPosePipeline(jcfg, params=HEAD, heads_fn=j_oracle(),
                       dtype=jnp.float32)
    tp = PosePipeline(tcfg, params=HEAD, device="cpu", dtype=torch.float32,
                      heads_fn=make_oracle_heads())
    assert not tp.config.detector.raw_preproc
    for f in fr:
        ref = {k: np.asarray(v) for k, v in jp.process_frame(f).items()}
        got = {k: v.numpy() for k, v in tp.process_frame(f).items()}
        assert_outputs_equal({k: ref[k] for k in ref if k in got},
                             {k: got[k] for k in ref if k in got})
    jp.reset()
    tp.reset()
    ref = jax.device_get(jp.process_chunk(fr))
    got = tp.process_chunk(fr)
    for i in range(len(fr)):
        assert_outputs_equal({k: v[i] for k, v in ref.items()},
                             {k: v[i].numpy() for k, v in got.items()})


def test_pipeline_normalised_ingest_matches_jax(scene_frames):
    """The real 256 model with raw_preproc=False (the unfolded stem on the
    normalised letterbox), fp32, against the JAX pipeline: ids equal,
    keypoints within 1e-2 px, per frame and per chunk."""
    det = dict(input_size=256, num_anchors=1344, raw_preproc=False)
    jp = JPosePipeline(JPipelineConfig(detector=JDetectorConfig(**det),
                                       precision="fp32"),
                       params=j_load_params(ASSET)[0])
    tp = PosePipeline(PipelineConfig(detector=DetectorConfig(**det),
                                     precision="fp32"),
                      params=load_params(ASSET)[0], device="cpu")
    h, w = scene_frames.shape[1:3]

    def agree(jt, tt):
        assert [t.track_id for t in tt] == [t.track_id for t in jt]
        for a, b in zip(tt, jt):
            np.testing.assert_allclose(a.keypoints, b.keypoints, atol=1e-2)

    n_tracks = 0
    for f in scene_frames[:3]:
        jt = jp.fetch_outputs(jp.process_frame(f), w, h)
        tt = tp.fetch_outputs(tp.process_frame(f), w, h)
        agree(jt, tt)
        n_tracks = len(tt)
    assert n_tracks >= 3                      # the people are tracked
    jp.reset()
    tp.reset()
    jouts = jax.device_get(jp.process_chunk(scene_frames))
    touts = tp.fetch_chunk_outputs(tp.process_chunk(scene_frames), w, h)
    for i, tt in enumerate(touts):
        jt = jp.fetch_outputs({k: v[i] for k, v in jouts.items()}, w, h)
        agree(jt, tt)
