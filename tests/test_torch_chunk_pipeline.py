"""The port's chunked path (posebyte_tpu_torch/pipeline/runner.py chunk
methods and the batched ops under them) against the JAX package, on the
same numpy inputs.

- Selection letterbox: bytes equal to JAX's letterbox_flat_nhwc(raw=True,
  selection=True) and to the port's matmul lowering, at 1280x720 -> 640
  and 1920x1080 -> 640 (exact decimations), batched over frames.
- decode_topk and pose_nms over a leading K axis against jax.vmap of the
  JAX functions at K = 4: candidate order, validity and scores equal,
  coordinates within 2e-6 relative plus 2e-4 px (the DFL softmax bound of
  tests/test_torch_preprocess_decode.py); compacted NMS output equal.
- PosePipeline.process_chunk on the CPU against JAX's process_chunk (its
  lax.scan path on the CPU backend): the trained 256 checkpoint, fp32,
  K = 4, 1280x720 frames (which decimate exactly into 256, so the
  selection lowering runs); track ids and emit equal, keypoints and boxes
  within 1e-2 px (the bar of tests/test_torch_pipeline.py: XLA's and
  oneDNN's fp32 convolutions sum in different orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.models.weights import load_params as j_load_params
from posebyte_tpu.ops.decode import decode_topk as j_decode_topk
from posebyte_tpu.ops.nms import pose_nms as j_pose_nms
from posebyte_tpu.ops.preprocess import letterbox_flat_nhwc as j_letterbox
from posebyte_tpu.pipeline import PosePipeline as JPosePipeline

from posebyte_tpu_torch.core.config import DetectorConfig, PipelineConfig
from posebyte_tpu_torch.core.structs import Detections
from posebyte_tpu_torch.models import load_params
from posebyte_tpu_torch.ops import decode as D
from posebyte_tpu_torch.ops import nms as N
from posebyte_tpu_torch.ops import preprocess as P
from posebyte_tpu_torch.pipeline import PosePipeline
from posebyte_tpu_torch.utils.synthetic import SyntheticScene, render_frame

torch.set_num_threads(2)

ASSET = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets",
    "yolov8n-pose-synthetic256.safetensors")


@pytest.mark.parametrize("w,h,target", [(1280, 720, 640), (1920, 1080, 640),
                                        (1280, 720, 256)])
def test_selection_letterbox_bytes_equal(w, h, target):
    assert P._selection_strides(w, h, target) is not None
    rng = np.random.default_rng(w * h)
    frames = rng.integers(0, 256, (2, h * w * 3), dtype=np.uint8)
    got = P.letterbox_flat_nhwc(torch.from_numpy(frames), w, h, target,
                                selection=True, raw=True)
    assert got.dtype == torch.uint8 and got.shape == (2, target, target, 3)
    for i in range(2):
        want = np.asarray(j_letterbox(jnp.asarray(frames[i]), w, h, target,
                                      selection=True, raw=True))
        assert want.dtype == np.uint8
        np.testing.assert_array_equal(got[i].numpy(), want)
        matmul = P.letterbox_flat_nhwc(torch.from_numpy(frames[i]), w, h,
                                       target, raw=True)
        np.testing.assert_array_equal(got[i].float().numpy(),
                                      matmul.numpy())


def test_selection_needs_an_exact_decimation():
    """Interpolating geometries take the matmul lowering (float output)."""
    assert P._selection_strides(333, 517, 256) is None
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (517 * 333 * 3,), dtype=np.uint8))
    out = P.letterbox_flat_nhwc(frame, 333, 517, 256, selection=True,
                                raw=True)
    assert out.dtype == torch.float32
    assert torch.equal(out, P.letterbox_flat_nhwc(frame, 333, 517, 256,
                                                  raw=True))


def head_batch(seed, K=4, A=1344):
    rng = np.random.default_rng(seed)
    box = rng.normal(0, 2, (K, A, 64)).astype(np.float32)
    cls = (np.round(rng.normal(-2, 2, (K, A, 1)) * 2) / 2).astype(np.float32)
    kpt = rng.normal(0, 1, (K, A, 51)).astype(np.float32)
    return box, cls, kpt


def test_batched_decode_and_nms_match_vmapped_jax():
    box, cls, kpt = head_batch(0)

    def j_one(b, c, k):
        det = j_decode_topk(b, c, k, 0.25, 256, 256, topk_impl="sort",
                            gather_impl="index")
        return det, j_pose_nms(det, 0.55, 0.55, 128, presorted=True)

    jdet, jnms = jax.vmap(j_one)(jnp.asarray(box), jnp.asarray(cls),
                                 jnp.asarray(kpt))
    tdet = D.decode_topk(torch.from_numpy(box), torch.from_numpy(cls),
                         torch.from_numpy(kpt), 0.25, 256, 256)
    assert tdet.poses.shape == (4, 256, 17, 3)
    np.testing.assert_array_equal(tdet.valid.numpy(), np.asarray(jdet.valid))
    np.testing.assert_array_equal(tdet.scores.numpy(),
                                  np.asarray(jdet.scores))
    for f in ("poses", "boxes"):
        np.testing.assert_allclose(getattr(tdet, f).numpy(),
                                   np.asarray(getattr(jdet, f)),
                                   rtol=2e-6, atol=2e-4)
    # NMS on identical candidates: feed JAX's decoded set to both
    cand = Detections(*(torch.from_numpy(np.array(getattr(jdet, f)))
                        for f in ("poses", "boxes", "scores", "valid")))
    tnms = N.pose_nms(cand, 0.55, 0.55, 128)
    for f in ("poses", "boxes", "scores", "valid"):
        np.testing.assert_array_equal(getattr(tnms, f).numpy(),
                                      np.asarray(getattr(jnms, f)))
    kept = tnms.valid.sum(1)
    assert (kept > 0).all() and (kept < cand.valid.sum(1)).all()
    # one frame of the batch equals the unbatched call
    one = N.pose_nms(Detections(cand.poses[2], cand.boxes[2],
                                cand.scores[2], cand.valid[2]), 0.55, 0.55,
                     128)
    assert torch.equal(one.poses, tnms.poses[2])
    assert torch.equal(one.valid, tnms.valid[2])


def _frames(n, seed=11, persons=4, w=1280, h=720):
    scene = SyntheticScene(persons, w, h, seed=seed)
    return np.stack([render_frame(scene.step(), w, h) for _ in range(n)])


def test_chunk_pipeline_matches_jax():
    det = dict(input_size=256, num_anchors=1344)
    jpipe = JPosePipeline(JPipelineConfig(detector=JDetectorConfig(**det),
                                          precision="fp32"),
                          params=j_load_params(ASSET)[0])
    tpipe = PosePipeline(PipelineConfig(detector=DetectorConfig(**det),
                                        precision="fp32"),
                         params=load_params(ASSET)[0], device="cpu")
    frames = _frames(8)
    emitted = 0
    for chunk in (frames[:4], frames[4:]):
        jout = jax.device_get(jpipe.process_chunk(chunk))
        tout = tpipe.process_chunk(chunk)
        for k in ("ids", "emit", "num_active"):
            np.testing.assert_array_equal(tout[k].numpy(),
                                          np.asarray(jout[k]), err_msg=k)
        for k in ("poses", "boxes", "scores"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       atol=1e-2, err_msg=k)
        emitted += int(tout["emit"].sum())
        per_frame = tpipe.fetch_chunk_outputs(tout, 1280, 720)
        assert [len(r) for r in per_frame] == \
            tout["emit"].sum(1).tolist()
        for i, tracks in enumerate(per_frame):     # the packed copy is exact
            want = tpipe.fetch_outputs({k: v[i] for k, v in tout.items()},
                                       1280, 720)
            assert [(t.track_id, t.score) for t in tracks] == \
                [(t.track_id, t.score) for t in want]
            for got, ref in zip(tracks, want):
                np.testing.assert_array_equal(got.keypoints, ref.keypoints)
                np.testing.assert_array_equal(got.bbox, ref.bbox)
    assert emitted >= 4 * 4                      # the people are tracked
    assert int(tpipe.state.frame) == 8 and tpipe.timing["frames"] == 8


def test_stream_matches_process_frame():
    """process_stream (depth-pipelined) gives process_frame's outputs."""
    det = DetectorConfig(input_size=256, num_anchors=1344)
    cfg = PipelineConfig(detector=det, precision="fp32")
    params = load_params(ASSET)[0]
    frames = _frames(5, seed=3)
    a = PosePipeline(cfg, params=params, device="cpu")
    b = PosePipeline(cfg, params=params, device="cpu")
    streamed = list(a.process_stream(iter(frames), sync_depth=2))
    assert len(streamed) == 5
    for fr, out in zip(frames, streamed):
        want = b.process_frame(fr)
        for k in ("ids", "emit", "poses", "num_active"):
            assert torch.equal(out[k], want[k]), k


def test_timing_matches_jax_across_chunks_and_frames():
    """`timing` and `mean_frame_ms` kept as the JAX package keeps them
    through the same calls: two chunks, then one frame. Chunks count their
    frames but no dispatch time; process_frame adds both."""
    det = dict(input_size=256, num_anchors=1344)
    jpipe = JPosePipeline(JPipelineConfig(detector=JDetectorConfig(**det),
                                          precision="fp32"),
                          params=j_load_params(ASSET)[0])
    tpipe = PosePipeline(PipelineConfig(detector=DetectorConfig(**det),
                                        precision="fp32"),
                         params=load_params(ASSET)[0], device="cpu")
    frames = _frames(5, seed=5)
    for pipe in (jpipe, tpipe):
        pipe.process_chunk(frames[:2])
        pipe.process_chunk_device(pipe.stage_chunk(frames[2:4]), 720, 1280)
    assert tpipe.timing == jpipe.timing == {"dispatch_ms": 0.0, "frames": 4}
    assert tpipe.mean_frame_ms == jpipe.mean_frame_ms == 0.0
    for pipe in (jpipe, tpipe):
        pipe.process_frame(frames[4], block=True)
    assert tpipe.timing["frames"] == jpipe.timing["frames"] == 5
    assert tpipe.timing["dispatch_ms"] > 0.0 and \
        jpipe.timing["dispatch_ms"] > 0.0
    for pipe in (jpipe, tpipe):
        assert pipe.mean_frame_ms == pipe.timing["dispatch_ms"] / 5
