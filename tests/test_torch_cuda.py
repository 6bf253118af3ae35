"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips on a host without a card (a CUDA
kernel has no CPU mode). The file imports neither JAX nor the JAX package,
so that it runs on a card's host, which has neither; there, skip the JAX
conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: none for the kernels (keep masks and assignments equal); the
pipeline on the card against the CPU in fp32 within 1e-2 px with equal
track ids (cuDNN and oneDNN sum the convolutions in different orders).
"""
import os

import numpy as np
import pytest
import torch

from posebyte_tpu_torch.ops import assignment as A
from posebyte_tpu_torch.ops import nms as N
from posebyte_tpu_torch.utils.synthetic import POSE_OFFSETS

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def candidates(seed, n, n_valid, chain=0):
    """Score-sorted NMS candidates: clustered person poses, a chain of
    shifted copies each suppressing the next, an invalid tail."""
    rng = np.random.default_rng(seed)
    n_cl = max(1, n // 12)
    centers = rng.uniform(60, 580, (n_cl, 2))
    scales = rng.uniform(40, 160, n_cl)
    cl = rng.integers(0, n_cl, n)
    poses = np.zeros((n, 17, 3), np.float32)
    poses[..., :2] = (centers[cl][:, None] + POSE_OFFSETS[None]
                      * scales[cl][:, None, None]
                      + rng.normal(0, 4, (n, 17, 2)))
    poses[..., 2] = rng.uniform(0, 1, (n, 17))
    for i in range(chain):
        poses[i, :, :2] = 320 + POSE_OFFSETS * 100 + np.float32(i * 9.0) \
            * np.array([1, 0], np.float32)
        poses[i, :, 2] = 0.9
    boxes = np.stack([poses[..., 0].min(1), poses[..., 1].min(1),
                      poses[..., 0].max(1), poses[..., 1].max(1)],
                     -1).astype(np.float32)
    valid = np.arange(n) < n_valid
    return poses, boxes, valid


def cost_matrix(seed, R, C, locked=0.6, ties=False, inactive=0.1):
    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 1, (R, C))
    if ties:
        cost = np.round(cost * 4) / 4
    cost[rng.uniform(size=(R, C)) < locked] = 1e9
    cost[min(3, R - 1), :] = 1e9
    active = rng.uniform(size=R) >= inactive
    return cost.astype(np.float32), active


@pytest.mark.parametrize("seed,n,n_valid,chain", [
    (0, 256, 240, 0), (1, 256, 256, 40), (2, 100, 80, 30), (3, 512, 500, 0),
    (4, 1, 1, 0), (5, 64, 0, 0)])
def test_nms_kernel_matches_plain(card, seed, n, n_valid, chain):
    p, b, v = (torch.from_numpy(a).to(card)
               for a in candidates(seed, n, n_valid, chain))
    got = N.nms_keep_cuda(p, b, v, 0.55, 0.55)
    want = N.nms_keep_plain(p, b, v, 0.55, 0.55)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_nms_kernel_batched_counts_and_refuses_bad_input(card):
    cases = [candidates(s, 128, 120, 25 * (s == 1)) for s in range(3)]
    p, b, v = (torch.stack([torch.from_numpy(c[i]) for c in cases]).to(card)
               for i in range(3))
    before = N.nms_keep_cuda.launches
    got = N.nms_keep_cuda(p, b, v, 0.5, 0.6)
    assert N.nms_keep_cuda.launches == before + 1
    for i in range(3):
        assert torch.equal(got[i], N.nms_keep_plain(p[i], b[i], v[i],
                                                    0.5, 0.6))
    with pytest.raises(TypeError):
        N.nms_keep_cuda(p.double(), b, v, 0.55, 0.55)
    with pytest.raises(ValueError):
        N.nms_keep_cuda(p[:, :, :16].contiguous(), b, v, 0.55, 0.55)
    with pytest.raises(ValueError):
        N.nms_keep_cuda(p.transpose(0, 1), b, v, 0.55, 0.55)
    with pytest.raises(ValueError):
        N.nms_keep_cuda(torch.zeros((1, 600, 17, 3), device=card),
                        torch.zeros((1, 600, 4), device=card),
                        torch.ones((1, 600), dtype=torch.bool, device=card),
                        0.55, 0.55)
    assert N.nms_keep_cuda.launches == before + 1


@pytest.mark.parametrize("seed,R,C,locked,ties", [
    (0, 16, 12, 0.0, False), (1, 24, 16, 0.3, True),
    (2, 128, 64, 0.7, False), (3, 128, 64, 0.5, True), (4, 7, 30, 0.2, True),
    (5, 64, 64, 0.9, True), (6, 1030, 20, 0.5, False), (7, 1, 1, 0.0, False)])
def test_auction_kernel_matches_plain(card, seed, R, C, locked, ties):
    cost, active = cost_matrix(seed, R, C, locked, ties)
    c, a = torch.from_numpy(cost).to(card), torch.from_numpy(active).to(card)
    kr, kc = A.auction_assign_cuda(c, a)
    pr, pc = A.auction_assign(c, a)
    torch.cuda.synchronize()
    assert torch.equal(kr, pr) and torch.equal(kc, pc)


def test_auction_kernel_batched_counts_and_refuses_bad_input(card):
    cases = [cost_matrix(s, 128, 64, 0.6, s % 2 == 0) for s in range(4)]
    c = torch.stack([torch.from_numpy(x[0]) for x in cases]).to(card)
    a = torch.stack([torch.from_numpy(x[1]) for x in cases]).to(card)
    before = A.auction_assign_cuda.launches
    kr, kc = A.auction_assign_cuda(c, a)
    assert A.auction_assign_cuda.launches == before + 1
    for i in range(4):
        pr, pc = A.auction_assign(c[i], a[i])
        assert torch.equal(kr[i], pr) and torch.equal(kc[i], pc)
    with pytest.raises(TypeError):
        A.auction_assign_cuda(c.double(), a)
    with pytest.raises(ValueError):
        A.auction_assign_cuda(c.transpose(1, 2), a)
    with pytest.raises(ValueError):
        A.auction_assign_cuda(c[:, :, ::2], a)
    with pytest.raises(ValueError):
        A.auction_assign_cuda(torch.zeros((1, 512, 512), device=card))
    assert A.auction_assign_cuda.launches == before + 1


def test_pipeline_card_matches_cpu(card):
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame

    asset = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets",
        "yolov8n-pose-synthetic256.safetensors")
    cfg = PipelineConfig(detector=DetectorConfig(input_size=256,
                                                 num_anchors=1344),
                         precision="fp32")
    params = load_params(asset)[0]
    pipes = [PosePipeline(cfg, params, device=d) for d in ("cpu", card)]
    scene = SyntheticScene(4, 1280, 720, seed=11)
    before = (N.nms_keep_cuda.launches, A.auction_assign_cuda.launches)
    for _ in range(6):
        fr = render_frame(scene.step(), 1280, 720)
        cpu, gpu = (p.fetch_outputs(p.process_frame(fr), 1280, 720)
                    for p in pipes)
        assert [t.track_id for t in gpu] == [t.track_id for t in cpu]
        for a, b in zip(gpu, cpu):
            np.testing.assert_allclose(a.keypoints, b.keypoints, atol=1e-2)
    assert len(gpu) >= 3
    assert (N.nms_keep_cuda.launches - before[0],
            A.auction_assign_cuda.launches - before[1]) == (6, 18)
