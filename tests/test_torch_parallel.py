"""The port's parallel/ package against the JAX package's on the CPU.

Multi-stream serving: MultiStreamPipeline and MultiStreamChunkPipeline
over CPU meshes of 2 and 4 entries (one device named several times)
against JAX's on 8 and 4 virtual devices (tests/test_parallel_crowded.py's
configuration, fp32, yolov8n-pose at 64 on the same weights): ids equal,
keypoints within 1e-3 px. The servers with mesh=, params=None and seed.

Data-parallel training: make_dp_train_step over 2 gloo ranks, spawned
here (torch.multiprocessing; the ranks run tests/torch_train_data.py's
dp_worker, which imports no JAX; a FileStore in the test's directory), against
one single-process step on the whole batch, the port's and JAX's (the
contract of tests/test_parallel_train.py: SGD, loss within 1e-5, params
within rtol 5e-4, atol 5e-6); the indivisible-batch refusal; shard_dataset
trimming with a warning; make_dp_scan_train lowering the loss with the
ranks' parameters equal.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

from posebyte_tpu.core.config import DetectorConfig as JDetectorConfig
from posebyte_tpu.core.config import PipelineConfig as JPipelineConfig
from posebyte_tpu.core.config import TrackerConfig as JTrackerConfig
from posebyte_tpu.models.train import make_train_step as j_make_train_step
from posebyte_tpu.parallel import make_mesh as j_make_mesh
from posebyte_tpu.parallel import MultiStreamPipeline as JMultiStream
from posebyte_tpu.parallel.sharding import \
    MultiStreamChunkPipeline as JMultiStreamChunk

from posebyte_tpu_torch.core import (DetectorConfig, PipelineConfig,
                                     TrackerConfig)
from posebyte_tpu_torch.models import optim as O
from posebyte_tpu_torch.models import train as T
from posebyte_tpu_torch.models.weights import params_from_jax
from posebyte_tpu_torch.models.yolo_pose import init_params
from posebyte_tpu_torch.parallel import (MultiStreamChunkPipeline,
                                         MultiStreamPipeline,
                                         make_dp_train_step, make_mesh)
from posebyte_tpu_torch.parallel.train import DataMesh

from test_torch_quant import jax_tree
from torch_train_data import S, SCAN_INDICES, dp_worker, tiny_data

torch.set_num_threads(1)

MODEL = "yolov8n-pose"


def configs():
    """tests/test_parallel_crowded.py's configuration (a low detector
    confidence, so that random weights give tracks to compare)."""
    kw = dict(input_size=64, num_anchors=84, max_candidates=16,
              max_detections=4, conf_threshold=0.01)
    return (JPipelineConfig(detector=JDetectorConfig(**kw),
                            tracker=JTrackerConfig(max_tracks=8,
                                                   max_detections=4),
                            model_name=MODEL, precision="fp32"),
            PipelineConfig(detector=DetectorConfig(**kw),
                           tracker=TrackerConfig(max_tracks=8,
                                                 max_detections=4),
                           model_name=MODEL, precision="fp32"))


@pytest.fixture(scope="module")
def weights():
    flat = init_params(0, MODEL)
    return flat, jax_tree(flat, MODEL)


def _same(got, want):
    np.testing.assert_array_equal(got["ids"], np.asarray(want["ids"]))
    np.testing.assert_array_equal(got["emit"], np.asarray(want["emit"]))
    np.testing.assert_array_equal(got["num_active"],
                                  np.asarray(want["num_active"]))
    np.testing.assert_allclose(got["poses"], np.asarray(want["poses"]),
                               atol=1e-3)


@pytest.mark.parametrize("n_mesh", [2, 4])
def test_multistream_pipeline_matches_jax(weights, n_mesh):
    flat, jp = weights
    jcfg, tcfg = configs()
    J = JMultiStream(8, jcfg, j_make_mesh(8), params=jp, dtype=jnp.float32)
    P = MultiStreamPipeline(8, tcfg, make_mesh(n_mesh, device="cpu"),
                            params=flat, dtype=torch.float32)
    assert P.mesh.shape == {"stream": n_mesh}
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (8, 96, 128, 3), dtype=np.uint8)
    emitted = 0
    for _ in range(3):
        out = P.process_frames(frames)
        _same(out, J.process_frames(frames))
        emitted += int(out["emit"].sum())
    assert out["emit"].shape == (8, 4) and emitted > 0
    assert P.states.frame.tolist() == [3] * 8


@pytest.mark.parametrize("n_mesh", [2, 4])
def test_multistream_chunk_pipeline_matches_jax(weights, n_mesh):
    flat, jp = weights
    jcfg, tcfg = configs()
    J = JMultiStreamChunk(4, 3, jcfg, j_make_mesh(4), params=jp,
                          dtype=jnp.float32)
    P = MultiStreamChunkPipeline(4, 3, tcfg, make_mesh(n_mesh, device="cpu"),
                                 params=flat, dtype=torch.float32)
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (4, 3, 96, 128, 3), dtype=np.uint8)
    for step in range(2):
        out = P.process_chunks(frames)
        _same(out, J.process_chunks(frames))
        assert int(P.states.frame[0]) == 3 * (step + 1)
    assert out["ids"].shape == (4, 3, 4)
    assert out["poses"].shape == (4, 3, 4, 17, 3)
    assert out["boxes"].shape == (4, 3, 4, 4)
    assert out["emit"].any()


def test_make_mesh():
    mesh = make_mesh(3, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh()


def test_servers_take_mesh_params_none_and_seed():
    """A server over a mesh of 2 equals the one-device server; params None
    draws init_params(seed) in the servers and in PosePipeline."""
    from posebyte_tpu_torch.pipeline import (ChunkedStreamServer,
                                             PosePipeline, StreamServer)
    _, cfg = configs()
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 255, (4, 2, 96, 128, 3), dtype=np.uint8)
    for cls, kw in ((StreamServer, {}), (ChunkedStreamServer,
                                         {"chunk": 2})):
        one = cls(4, (96, 128), config=cfg, device="cpu",
                  params=init_params(3, MODEL), **kw)
        two = cls(4, (96, 128), config=cfg, params=None, seed=3,
                  mesh=make_mesh(2, device="cpu"), **kw)
        for srv in (one, two):
            for s in range(4):
                sid = srv.open_stream()
                for f in frames[s]:
                    srv.submit(sid, f)
            while srv.step():
                pass
        for s in range(4):
            a, b = one.poll(s), two.poll(s)
            assert len(a) == len(b) == 2
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x["ids"], y["ids"])
                np.testing.assert_array_equal(x["poses"], y["poses"])
        assert two.states.frame.tolist() == [2] * 4
        with pytest.raises(ValueError):
            cls(3, (96, 128), config=cfg, mesh=make_mesh(2, device="cpu"),
                **kw)
    a = PosePipeline(cfg, device="cpu", seed=5)
    b = PosePipeline(cfg, init_params(5, MODEL), device="cpu")
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def test_dp_step_rejects_indivisible_batch():
    mesh = DataMesh(rank=0, world_size=2, device=torch.device("cpu"))
    o = O.sgd(1e-2)
    params = T.trainable_params(init_params(0, MODEL))
    step = make_dp_train_step(MODEL, S, o, mesh)
    batch = {k: torch.from_numpy(v) for k, v in tiny_data(3).items()}
    with pytest.raises(ValueError, match="divide"):
        step(params, o.init(params), batch)


def test_dp_two_gloo_ranks_match_one_process(tmp_path):
    mp.start_processes(dp_worker, args=(2, str(tmp_path / "store"),
                                        str(tmp_path)),
                       nprocs=2, start_method="spawn")
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))

    data = tiny_data(4)
    o = O.sgd(1e-2)
    flat = init_params(0, MODEL)
    tp = T.trainable_params(flat)
    p_ref, _, loss_ref, parts_ref = T.make_train_step(MODEL, S, o)(
        tp, o.init(tp), {k: torch.from_numpy(v) for k, v in data.items()})
    jopt = optax.sgd(1e-2)
    jp = jax_tree(flat, MODEL)
    jp1, _, jloss, _ = jax.jit(j_make_train_step(MODEL, S, jopt))(
        jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in data.items()})
    jref = params_from_jax(jp1)
    for r in (r0, r1):
        np.testing.assert_allclose(float(r["loss"]), float(loss_ref),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(r["loss"]), float(jloss),
                                   rtol=1e-5)
        for k in parts_ref:
            np.testing.assert_allclose(float(r[f"part_{k}"]),
                                       float(parts_ref[k]), rtol=1e-4,
                                       atol=1e-6)
        for k in jref:
            for want in (p_ref[k].numpy(), jref[k]):
                np.testing.assert_allclose(r[f"p_{k}"], want, rtol=5e-4,
                                           atol=5e-6, err_msg=k)
    # shard_dataset: 5 samples trimmed to 4 with a warning, 2 a rank
    assert int(r0["shard"]) == int(r1["shard"]) == 2
    assert int(r0["warned"]) >= 1
    # the scan trainer on given indices equals the single-process scan
    # over the same global batches (samples 0-3, rank r's local i = 2r + i)
    glob = SCAN_INDICES + np.array([0, 0, 2, 2])
    run1 = T.make_scan_train(MODEL, S, o, batch_size=4)
    s_ref, _, l_ref = run1(tp, o.init(tp), {k: torch.from_numpy(v[:4])
                                            for k, v in
                                            tiny_data(5).items()},
                           torch.from_numpy(glob))
    for r in (r0, r1):
        np.testing.assert_allclose(r["l_idx"], l_ref.numpy(), rtol=1e-5)
        for k in flat:
            np.testing.assert_allclose(r[f"s_{k}"], s_ref[k].numpy(),
                                       rtol=5e-4, atol=5e-6, err_msg=k)
    # on its own draws: finite, the ranks equal, and the group's loss
    # lower in the second segment (medians: at 2 samples a rank a single
    # step can spike, as in the single-process runs)
    for r in (r0, r1):
        assert np.isfinite(r["l1"]).all() and np.isfinite(r["l2"]).all()
        assert np.median(r["l2"]) < np.median(r["l1"])
    np.testing.assert_array_equal(r0["l2"], r1["l2"])
    for k in flat:
        np.testing.assert_array_equal(r0[f"q_{k}"], r1[f"q_{k}"])
