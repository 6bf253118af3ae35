"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips on a host without a card (a CUDA
kernel has no CPU mode). The file imports neither JAX nor the JAX package,
so that it runs on a card's host, which has neither; there, skip the JAX
conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Tolerances: none for Kernels 1 and 2 (keep masks and assignments equal);
Kernel 3 against its plain version on the card, with and without Re-ID:
integer outputs and state equal, floats within 1e-5 px + 1e-6 relative
(the same float32 operations in the same order), and with kalman136 every
float equal too; the per-frame and the chunk pipeline on the card against
the CPU in fp32 within 1e-2 px with equal track ids (cuDNN and oneDNN sum
the convolutions in different orders), with and without Re-ID, with either
motion model. Kernel 4 against its plain version on the card, in both
modes (int8 input; float input quantised in its load): the int32 sums and
the bf16 and float32 outputs equal. The int8 pipeline (float32
activations) on the card against the CPU: ids equal, keypoints within 8 px
with a median difference within 0.5 px (2.2 and 0.32 px measured on an
H100): the float convolutions of cuDNN and oneDNN differ ~1e-6 relative,
which moves a few activations across a rounding boundary of the next
quantisation, and one int8 step of a head activation moves a keypoint by
up to ~4 px at stride 32; Kernel 4 itself is equal to its plain version on
every shape, and the activation quantisation on the card to the CPU's on
the same float inputs, ties included.
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
    n = N.MAX_N + 1                       # past the kernel's own limit
    with pytest.raises(ValueError):
        N.nms_keep_cuda(torch.zeros((1, n, 17, 3), device=card),
                        torch.zeros((1, n, 4), device=card),
                        torch.ones((1, n), dtype=torch.bool, device=card),
                        0.55, 0.55)
    with pytest.raises(ValueError):
        N.nms_keep_cuda(p.cpu(), b.cpu(), v.cpu(), 0.55, 0.55)
    assert N.nms_keep_cuda.launches == before + 1


# N = 1024: the greedy pass reads its mask from shared memory; N = 2048:
# from device memory (it does not fit), 2 register words a lane; N = 5000:
# 8 words a lane, 3 of them past the last. B = 128 at N = 1024: 528 tiles
# a set in the dominance grid.
@pytest.mark.parametrize("n,B", [(1024, 1), (1024, 4), (2048, 1), (2048, 4),
                                 (1024, 128), (5000, 2)])
def test_nms_kernel_large_n_matches_plain(card, n, B):
    sets = [candidates(10 + i % 4, n, n - 20 * (i % 4), 40 * (i % 2 == 0))
            for i in range(B)]
    p, b, v = (torch.stack([torch.from_numpy(s[i]) for s in sets]).to(card)
               for i in range(3))
    got = N.nms_keep_cuda(p, b, v, 0.55, 0.55)
    want = [N.nms_keep_plain(p[i], b[i], v[i], 0.55, 0.55)
            for i in range(min(B, 4))]   # set i repeats set i % 4
    torch.cuda.synchronize()
    for i in range(B):
        assert torch.equal(got[i], want[i % 4]), i


@pytest.mark.parametrize("seed,R,C,locked,ties", [
    (0, 16, 12, 0.0, False), (1, 24, 16, 0.3, True),
    (2, 128, 64, 0.7, False), (3, 128, 64, 0.5, True), (4, 7, 30, 0.2, True),
    (5, 64, 64, 0.9, True), (6, 1030, 20, 0.5, False), (7, 1, 1, 0.0, False),
    # the most rows the 1024-thread v1 fitted at C = 64 and at C = 20
    (8, 886, 64, 0.6, True), (9, 2730, 20, 0.5, False)])
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
    with pytest.raises(ValueError):
        A.auction_assign_cuda(c.cpu(), a.cpu())
    with pytest.raises(TypeError):
        A.auction_assign_cuda(c, a.to(torch.uint8))
    assert A.auction_assign_cuda.launches == before + 1


def auction_edge_case(name):
    """(cost [B, R, C], active [B, R]) of an edge case of Kernel 2's bidder
    set, lane groups and tie rules."""
    rng = np.random.default_rng(len(name))
    if name == "all_locked":
        mats = [(np.full((128, 64), 1e9, np.float32), np.ones(128, bool))]
    elif name == "all_inactive":
        mats = [(rng.uniform(0, 1, (128, 64)).astype(np.float32),
                 np.zeros(128, bool))]
    elif name == "one_locked":
        mats = [(np.full((1, 1), 1e9, np.float32), np.ones(1, bool))]
    elif name == "ragged":
        mats = [cost_matrix(11, 128, 65, 0.5, True)]
    elif name == "ties":
        mats = [(np.zeros((128, 64), np.float32), np.ones(128, bool))]
    elif name == "budget":
        mats = [cost_matrix(12, 128, 64, 0.0, False)]
    else:
        mats = [cost_matrix(13 + i, 40, 24, 0.4, True) for i in range(3)]
    return (np.stack([m[0] for m in mats]), np.stack([m[1] for m in mats]))


@pytest.mark.parametrize("name", ["all_locked", "all_inactive",
                                  "one_locked", "ragged", "ties", "budget",
                                  "batch3"])
def test_auction_kernel_edge_cases_match_plain(card, name):
    """Kernel 2 on its edge cases: assignments and rounds equal to the
    plain version's, with the active mask and with none (every row)."""
    cost, active = auction_edge_case(name)
    c, a = torch.from_numpy(cost).to(card), torch.from_numpy(active).to(card)
    rounds = torch.full((len(c),), -1, dtype=torch.int32, device=card)
    kr, kc = A.auction_assign_cuda(c, a, rounds=rounds)
    nr, nc = A.auction_assign_cuda(c)
    torch.cuda.synchronize()
    for i in range(len(c)):
        pr, pc, pn = A.auction_assign_rounds(c[i], a[i])
        assert torch.equal(kr[i], pr) and torch.equal(kc[i], pc)
        assert int(rounds[i]) == pn
        pr, pc = A.auction_assign(c[i])
        assert torch.equal(nr[i], pr) and torch.equal(nc[i], pc)


def test_auction_kernel_rounds_leave_outputs_unchanged(card):
    """rounds_out set: the assignments of a launch without it, and each
    matrix's rounds with a bid equal to the plain version's count (one
    matrix runs out of the budget)."""
    cases = [cost_matrix(s, 128, 64, 0.6, True) for s in range(3)]
    cases.append(cost_matrix(9, 128, 64, 0.0, False))
    c = torch.stack([torch.from_numpy(x[0]) for x in cases]).to(card)
    a = torch.stack([torch.from_numpy(x[1]) for x in cases]).to(card)
    rounds = torch.full((4,), -1, dtype=torch.int32, device=card)
    kr, kc = A.auction_assign_cuda(c, a)
    rr, rc = A.auction_assign_cuda(c, a, rounds=rounds)
    torch.cuda.synchronize()
    assert torch.equal(kr, rr) and torch.equal(kc, rc)
    want = [A.auction_assign_rounds(c[i], a[i])[2] for i in range(4)]
    assert rounds.tolist() == want
    assert want[3] == A.auction_iterations(128)


def test_pipeline_refuses_more_candidates_than_kernel1_takes(card):
    """A configuration whose NMS sets exceed Kernel 1's limit (N.MAX_N) is
    refused when the pipeline is built on the card, not mid-run; the CPU
    takes it, and the card takes N = 1024."""
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.pipeline import PosePipeline

    params = load_params(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets",
        "yolov8n-pose-synthetic256.safetensors"))[0]
    big = PipelineConfig(detector=DetectorConfig(
        input_size=2560, max_candidates=N.MAX_N + 1))   # 134400 anchors
    with pytest.raises(ValueError):
        PosePipeline(big, params, device=card)
    PosePipeline(big, params, device="cpu")
    PosePipeline(PipelineConfig(detector=DetectorConfig(
        max_candidates=1024)), params, device=card)


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


def tracker_chunk_inputs(card, seed, K, T, D, crowd, streams=None,
                         reid=False):
    """Detections, advance mask and a fresh state on the card, from the
    synthetic tracker case; with `streams`, a leading stream axis; with
    `reid`, also the detections' embeddings (last)."""
    from posebyte_tpu_torch.core.structs import Detections, TrackerState
    from posebyte_tpu_torch.ops.tracker_chunk import _stack
    from posebyte_tpu_torch.utils.synthetic import reid_embeddings_case, \
        tracker_chunk_case

    def one(s):
        arrays, adv = tracker_chunk_case(seed + s, K, D, crowd=crowd)
        emb = reid_embeddings_case(seed + s, arrays[3])
        return (Detections(*(torch.from_numpy(a).to(card) for a in arrays)),
                torch.from_numpy(adv).to(card),
                TrackerState.init(T, D, card), torch.from_numpy(emb).to(card))

    if streams is None:
        case = one(0)
    else:
        cases = [one(s) for s in range(streams)]
        case = (_stack([c[0] for c in cases]),
                torch.stack([c[1] for c in cases]),
                _stack([c[2] for c in cases]),
                torch.stack([c[3] for c in cases]))
    return case if reid else case[:3]


def assert_chunk_equal(got, want):
    """Integers equal; floats within 1e-5 px + 1e-6 relative (both sides
    run the same float32 operations in the same order on the card)."""
    import dataclasses
    (gs, go), (ws, wo) = got, want
    pairs = [(f.name, getattr(gs, f.name), getattr(ws, f.name))
             for f in dataclasses.fields(gs)] + \
        [(k, go[k], wo[k]) for k in wo]
    for name, g, w in pairs:
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-5,
                                       msg=name)
        else:
            assert torch.equal(g, w), name


@pytest.mark.parametrize("streams,K,T,D,crowd", [
    (None, 128, 128, 64, 40), (3, 128, 128, 64, 40), (None, 24, 16, 16, 12),
    (2, 12, 128, 128, 100)])
def test_tracker_chunk_kernel_matches_plain(card, streams, K, T, D, crowd):
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    dets, adv, state = tracker_chunk_inputs(card, 5, K, T, D, crowd, streams)
    cfg = TrackerConfig(max_tracks=T, max_detections=D)
    before = TC.tracker_chunk_cuda.launches
    got = TC.tracker_chunk_cuda(state, dets, cfg, adv)
    assert TC.tracker_chunk_cuda.launches == before + 1
    want = TC.tracker_chunk_plain(state, dets, cfg, adv)
    torch.cuda.synchronize()
    assert_chunk_equal(got, want)
    assert got[1]["emit"].any()
    # without a mask every frame advances
    got = TC.tracker_chunk_cuda(state, dets, cfg)
    want = TC.tracker_chunk_plain(state, dets, cfg)
    assert_chunk_equal(got, want)


@pytest.mark.parametrize("streams,motion,reid", [
    (None, "cv", False), (3, "kalman136", True)])
def test_tracker_chunk_stage_clock_leaves_outputs_unchanged(card, streams,
                                                            motion, reid):
    """Kernel 3 with its stage clock on gives the same outputs, bit for
    bit, as without; the clock counts every stage and each tier's
    rounds, and adds into the tensor it is given."""
    import dataclasses
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    dets, adv, state, emb = tracker_chunk_inputs(card, 6, 64, 128, 64, 40,
                                                 streams, reid=True)
    cfg = TrackerConfig(motion_model=motion,
                        reid_weight=0.3 if reid else 0.0)
    emb = emb if reid else None
    S = 1 if streams is None else streams
    clock = torch.zeros((S, TC.CLOCK_COLUMNS), dtype=torch.int64,
                        device=card)
    want = TC.tracker_chunk_cuda(state, dets, cfg, adv, emb)
    got = TC.tracker_chunk_cuda(state, dets, cfg, adv, emb,
                                stage_cycles=clock[0] if streams is None
                                else clock)
    torch.cuda.synchronize()
    (gs, go), (ws, wo) = got, want
    for f in dataclasses.fields(gs):
        assert torch.equal(getattr(gs, f.name), getattr(ws, f.name)), f.name
    for k in wo:
        assert torch.equal(go[k], wo[k]), k
    n = len(TC.STAGES)
    assert (clock[:, :n] > 0).all() and (clock[:, n] > 0).all()
    once = clock.clone()
    TC.tracker_chunk_cuda(state, dets, cfg, adv, emb, stage_cycles=(
        clock[0] if streams is None else clock))
    torch.cuda.synchronize()
    assert (clock[:, n:n + 3] == 2 * once[:, n:n + 3]).all()
    split = TC.read_stage_clock(clock, 2 * S * 64)
    assert abs(sum(split["share"].values()) - 1.0) < 1e-9


@pytest.mark.parametrize("streams,D", [(None, 64), (3, 64), (None, 128),
                                       (3, 128)])
def test_tracker_chunk_kernel_reid_matches_plain(card, streams, D):
    """Kernel 3 with Re-ID (reid_weight 0.3) at S = 1 and 3, D = 64 and
    128, holes in the advance mask, crowded frames."""
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    K = 64 if D == 64 else 12
    dets, adv, state, emb = tracker_chunk_inputs(card, 9, K, 128, D,
                                                 D - 24, streams, reid=True)
    cfg = TrackerConfig(max_tracks=128, max_detections=D, reid_weight=0.3)
    before = TC.tracker_chunk_cuda.launches
    got = TC.tracker_chunk_cuda(state, dets, cfg, adv, emb)
    assert TC.tracker_chunk_cuda.launches == before + 1
    want = TC.tracker_chunk_plain(state, dets, cfg, adv, emb)
    torch.cuda.synchronize()
    assert_chunk_equal(got, want)
    assert got[1]["emit"].any()
    assert (got[0].embeddings.abs().sum(-1) > 0).any()


def test_tracker_chunk_kernel_refuses_what_it_does_not_run(card):
    import dataclasses
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    dets, adv, state, emb = tracker_chunk_inputs(card, 1, 4, 128, 64, 0,
                                                 reid=True)
    # kalman136 runs (one launch), and carries the filter out
    before = TC.tracker_chunk_cuda.launches
    new, _ = TC.tracker_chunk_cuda(state, dets,
                                   TrackerConfig(motion_model="kalman136"),
                                   adv)
    assert TC.tracker_chunk_cuda.launches == before + 1
    assert not torch.equal(new.kf_cov, state.kf_cov)
    before = TC.tracker_chunk_cuda.launches
    with pytest.raises(NotImplementedError):
        TC.tracker_chunk_cuda(state, dets, TrackerConfig(torso_tier=False),
                              adv)
    # embeddings exactly when reid_weight > 0, of [K, D, 51] float32
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(state, dets, TrackerConfig(reid_weight=0.5),
                              adv)
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(state, dets, TrackerConfig(), adv, emb)
    reid = TrackerConfig(reid_weight=0.5)
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(state, dets, reid, adv, emb[:, :32])
    with pytest.raises(TypeError):
        TC.tracker_chunk_cuda(state, dets, reid, adv, emb.double())
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(state, dets, reid, adv, emb.cpu())
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(TC._pick(TC._stack([state]), 0),
                              dataclasses.replace(dets, poses=dets.poses
                                                  .cpu()), TrackerConfig())
    with pytest.raises(TypeError):
        TC.tracker_chunk_cuda(state, dataclasses.replace(
            dets, scores=dets.scores.double()), TrackerConfig())
    with pytest.raises(ValueError):
        TC.tracker_chunk_cuda(state, dets, TrackerConfig(max_tracks=64))
    assert TC.tracker_chunk_cuda.launches == before


def assert_chunk_identical(got, want):
    """Every field and output equal, floats bit for bit."""
    import dataclasses
    (gs, go), (ws, wo) = got, want
    pairs = [(f.name, getattr(gs, f.name), getattr(ws, f.name))
             for f in dataclasses.fields(gs)] + \
        [(k, go[k], wo[k]) for k in wo]
    for name, g, w in pairs:
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("streams,D,reid", [
    (None, 64, False), (3, 64, False), (None, 64, True), (3, 128, True),
    (None, 128, False)])
def test_tracker_chunk_kernel_kalman_matches_plain(card, streams, D, reid):
    """Kernel 3's kalman136 variant at S = 1 and 3, D = 64 and 128, with
    and without Re-ID, holes in the advance mask, crowded frames, from a
    pool whose filter is drawn at random: everything equal to the plain
    version, the filter included."""
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    K = 64 if D == 64 else 12
    case = tracker_chunk_inputs(card, 13, K, 128, D, D - 24, streams,
                                reid=True)
    dets, adv, state, emb = case[:3] + (case[3] if reid else None,)
    g = torch.Generator(device="cpu").manual_seed(D)
    shape = state.kf_mean.shape
    state.kf_mean = (torch.randn(shape, generator=g) * 40).to(card)
    state.kf_cov = (torch.rand(shape, generator=g) * 0.1 + 0.001).to(card)
    cfg = TrackerConfig(max_tracks=128, max_detections=D,
                        motion_model="kalman136",
                        reid_weight=0.3 if reid else 0.0)
    before = TC.tracker_chunk_cuda.launches
    got = TC.tracker_chunk_cuda(state, dets, cfg, adv, emb)
    assert TC.tracker_chunk_cuda.launches == before + 1
    want = TC.tracker_chunk_plain(state, dets, cfg, adv, emb)
    torch.cuda.synchronize()
    assert_chunk_identical(got, want)
    assert got[1]["emit"].any() and not adv.all()


def test_chunk_pipeline_card_matches_cpu(card):
    """The chunk path: one Kernel 1 and one Kernel 3 launch per chunk, no
    auction launch, and the CPU's track ids (fp32, keypoints within
    1e-2 px)."""
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.ops import tracker_chunk as TC
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
    kernels = (N.nms_keep_cuda, A.auction_assign_cuda, TC.tracker_chunk_cuda)
    for _ in range(2):
        frames = np.stack([render_frame(scene.step(), 1280, 720)
                           for _ in range(6)])
        before = [k.launches for k in kernels]
        cpu, gpu = (p.fetch_chunk_outputs(p.process_chunk(frames), 1280,
                                          720) for p in pipes)
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 1]
        for a, b in zip(gpu, cpu):
            assert [t.track_id for t in a] == [t.track_id for t in b]
            for x, y in zip(a, b):
                np.testing.assert_allclose(x.keypoints, y.keypoints,
                                           atol=1e-2)
    assert len(gpu[-1]) >= 3


def test_stream_card_matches_process_frame(card):
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame

    asset = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets",
        "yolov8n-pose-synthetic256.safetensors")
    cfg = PipelineConfig(detector=DetectorConfig(input_size=256,
                                                 num_anchors=1344))
    params = load_params(asset)[0]
    scene = SyntheticScene(4, 1280, 720, seed=5)
    frames = [render_frame(scene.step(), 1280, 720) for _ in range(6)]
    a, b = (PosePipeline(cfg, params, device=card) for _ in range(2))
    streamed = list(a.process_stream(iter(frames), sync_depth=2))
    assert len(streamed) == 6
    for fr, out in zip(frames, streamed):
        want = b.process_frame(fr)
        for k in ("ids", "emit", "poses", "num_active"):
            assert torch.equal(out[k], want[k]), k


@pytest.mark.parametrize("head", [False, True])
def test_reid_pipeline_card_matches_cpu(card, head):
    """The Re-ID pipeline (reid_weight 0.3; the descriptor, or the learned
    head) on the card against the CPU, fp32: a chunk of K = 8 (one Kernel 1
    and one Kernel 3 launch, no auction launch) and 4 frames of the
    per-frame path (1 Kernel 1 and 3 Kernel 2 launches each); ids equal,
    keypoints within 1e-2 px."""
    from posebyte_tpu_torch.core import (DetectorConfig, PipelineConfig,
                                         TrackerConfig)
    from posebyte_tpu_torch.models import load_params, load_reid_head
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame

    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets")
    cfg = PipelineConfig(detector=DetectorConfig(input_size=256,
                                                 num_anchors=1344),
                         tracker=TrackerConfig(reid_weight=0.3),
                         precision="fp32")
    params = load_params(os.path.join(
        assets, "yolov8n-pose-synthetic256.safetensors"))[0]
    reid = load_reid_head(os.path.join(
        assets, "reid-head-synthetic.safetensors")) if head else None
    scene = SyntheticScene(4, 1280, 720, seed=11)
    frames = np.stack([render_frame(scene.step(), 1280, 720)
                       for _ in range(12)])
    kernels = (N.nms_keep_cuda, A.auction_assign_cuda, TC.tracker_chunk_cuda)

    def same(cpu, gpu):
        assert [t.track_id for t in gpu] == [t.track_id for t in cpu]
        for x, y in zip(gpu, cpu):
            np.testing.assert_allclose(x.keypoints, y.keypoints, atol=1e-2)

    pipes = [PosePipeline(cfg, params, device=d, reid_params=reid)
             for d in ("cpu", card)]
    before = [k.launches for k in kernels]
    cpu, gpu = (p.fetch_chunk_outputs(p.process_chunk(frames[:8]), 1280,
                                      720) for p in pipes)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 1]
    for a, b in zip(cpu, gpu):
        same(a, b)
    assert len(gpu[-1]) >= 3
    before = [k.launches for k in kernels]
    for fr in frames[8:]:
        cpu, gpu = (p.fetch_outputs(p.process_frame(fr), 1280, 720)
                    for p in pipes)
        same(cpu, gpu)
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 12, 0]
    torch.testing.assert_close(pipes[1].state.embeddings.cpu(),
                               pipes[0].state.embeddings, rtol=0, atol=1e-3)


@pytest.mark.parametrize("reid", [False, True])
def test_kalman_pipeline_card_matches_cpu(card, reid):
    """The kalman136 pipeline (with and without Re-ID, the descriptor) on
    the card against the CPU, fp32: a chunk of K = 8 (one Kernel 1 and one
    Kernel 3 launch, no auction launch) and 4 frames of the per-frame path
    (1 Kernel 1 and 3 Kernel 2 launches each); ids equal, keypoints within
    1e-2 px, the filter within 1e-2."""
    from posebyte_tpu_torch.core import (DetectorConfig, PipelineConfig,
                                         TrackerConfig)
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame

    assets = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets")
    cfg = PipelineConfig(
        detector=DetectorConfig(input_size=256, num_anchors=1344),
        tracker=TrackerConfig(motion_model="kalman136",
                              reid_weight=0.3 if reid else 0.0),
        precision="fp32")
    params = load_params(os.path.join(
        assets, "yolov8n-pose-synthetic256.safetensors"))[0]
    scene = SyntheticScene(4, 1280, 720, seed=17)
    frames = np.stack([render_frame(scene.step(), 1280, 720)
                       for _ in range(12)])
    kernels = (N.nms_keep_cuda, A.auction_assign_cuda, TC.tracker_chunk_cuda)
    pipes = [PosePipeline(cfg, params, device=d) for d in ("cpu", card)]

    def same(cpu, gpu):
        assert [t.track_id for t in gpu] == [t.track_id for t in cpu]
        for x, y in zip(gpu, cpu):
            np.testing.assert_allclose(x.keypoints, y.keypoints, atol=1e-2)

    before = [k.launches for k in kernels]
    cpu, gpu = (p.fetch_chunk_outputs(p.process_chunk(frames[:8]), 1280,
                                      720) for p in pipes)
    assert [k.launches - b for k, b in zip(kernels, before)] == [1, 0, 1]
    for a, b in zip(cpu, gpu):
        same(a, b)
    assert len(gpu[-1]) >= 3
    before = [k.launches for k in kernels]
    for fr in frames[8:]:
        cpu, gpu = (p.fetch_outputs(p.process_frame(fr), 1280, 720)
                    for p in pipes)
        same(cpu, gpu)
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 12, 0]
    for f in ("kf_mean", "kf_cov"):
        torch.testing.assert_close(getattr(pipes[1].state, f).cpu(),
                                   getattr(pipes[0].state, f), rtol=0,
                                   atol=1e-2)


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
@pytest.mark.parametrize("B,H,W,C,O,bias", [
    (2, 8, 8, 128, 128, False),       # the JAX kernel test's shape
    (1, 80, 80, 51, 51, True),        # the keypoint head's ragged widths
    (1, 20, 20, 256, 1, True),        # the confidence head's one channel
    (4, 40, 40, 64, 130, True)])      # ragged output tiles, a batch
def test_conv_int8_kernel_matches_plain(card, k, stride, B, H, W, C, O,
                                        bias):
    """Kernel 4 (each instantiation) against its plain version on the card
    (an exact float64 convolution): int32 sums, bf16 and float32 outputs
    equal bit for bit; one launch per call."""
    from posebyte_tpu_torch.ops import conv_int8 as CI
    rng = np.random.default_rng(B * H + C + O)
    x = torch.from_numpy(rng.normal(0, 40, (B, C, H, W)).astype(np.float32))
    xq = CI.quantize_activation(x.to(card), torch.tensor(1.0, device=card))
    wq = CI.pack_weights(torch.from_numpy(rng.integers(
        -127, 128, (O, C, k, k)).astype(np.int8)).to(card))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, O).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 1, O).astype(np.float32)).to(card) \
        if bias else None
    for dtype in (torch.int32, torch.bfloat16, torch.float32):
        before = CI.conv_int8_cuda.launches
        got = CI.conv_int8(xq, wq, scale, b, k, stride, dtype)
        assert CI.conv_int8_cuda.launches == before + 1
        want = CI.conv_int8_plain(xq, wq, scale, b, k, stride, dtype)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == dtype
        assert torch.equal(got.contiguous().view(-1).view(torch.int16)
                           if dtype == torch.bfloat16 else got,
                           want.contiguous().view(-1).view(torch.int16)
                           if dtype == torch.bfloat16 else want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
@pytest.mark.parametrize("B,H,W,C,O,bias,ps,x_off", [
    (2, 8, 8, 128, 128, False, 128, 0),   # the JAX kernel test's shape
    (1, 80, 80, 51, 51, True, 51, 0),     # 102-byte bf16 rows, 32-pixel tiles
    (1, 80, 80, 32, 128, True, 64, 32),   # c2f's channel slice, 64-pixel tiles
    (1, 20, 20, 256, 1, True, 256, 0),    # the confidence head's one channel
    (4, 40, 40, 64, 130, True, 64, 0)])   # ragged output tiles, 128-pixel tiles
def test_conv_w8a8_kernel_matches_plain(card, dtype, k, stride, B, H, W, C,
                                        O, bias, ps, x_off):
    """Kernel 4's float mode (the activation quantised in its load) against
    its plain version on the card (quantize_activation, then an exact
    float64 convolution): int32 sums and the output in the input's type
    equal bit for bit, .5 ties included; one launch per call and no other
    device operation."""
    from posebyte_tpu_torch.ops import conv_int8 as CI
    rng = np.random.default_rng(B * H + C + O + x_off)
    s_x = np.float32(0.04)
    full = rng.normal(0, 3, (B, H, W, ps)).astype(np.float32)
    n = rng.integers(-140, 140, full.shape).astype(np.float32)
    ties = rng.uniform(size=full.shape) < 0.3
    full[ties] = ((n + np.float32(0.5)) * s_x)[ties]
    x = torch.from_numpy(full).to(card, dtype).permute(0, 3, 1, 2)[
        :, x_off:x_off + C]
    sx = torch.tensor(s_x, device=card)
    wq = CI.pack_weights(torch.from_numpy(rng.integers(
        -127, 128, (O, C, k, k)).astype(np.int8)).to(card))
    scale = torch.from_numpy(rng.uniform(1e-4, 1e-2, O).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 1, O).astype(np.float32)).to(card) \
        if bias else None
    for out_dtype in (torch.int32, dtype):
        before = CI.conv_int8_cuda.launches
        got = CI.conv_w8a8(x, sx, wq, scale, b, k, stride, out_dtype)
        assert CI.conv_int8_cuda.launches == before + 1
        want = CI.conv_w8a8_plain(x, sx, wq, scale, b, k, stride, out_dtype)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == out_dtype
        if out_dtype != torch.int32:
            got, want = got.float(), want.float()
        assert torch.equal(got, want)


@pytest.mark.parametrize("s_x", [0.05, 0.012852498, 0.10032497])
def test_conv_w8a8_card_quantises_ties_like_cpu(card, s_x):
    """The quantisation in Kernel 4's load equals quantize_activation on
    the CPU: a 1x1 conv with identity weights and scale 1, int32 sums,
    returns the quantised values themselves; inputs at (n + 0.5) * s_x,
    beyond the clamp, of both signs, float32 and bf16."""
    from posebyte_tpu_torch.ops import conv_int8 as CI
    rng = np.random.default_rng(5)
    s = np.float32(s_x)
    n = rng.integers(-140, 140, (2, 51, 6, 7)).astype(np.float32)
    x = ((n + np.float32(0.5)) * s).astype(np.float32)
    x[:, ::4] = rng.normal(0, 40 * s, x[:, ::4].shape)
    eye = CI.pack_weights(torch.eye(51, dtype=torch.int8)[:, :, None, None]
                          .to(card))
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).contiguous(
            memory_format=torch.channels_last)
        want = CI.quantize_activation(xt, torch.tensor(s))[..., :51]
        got = CI.conv_w8a8(xt.to(card), torch.tensor(s, device=card), eye,
                           torch.ones(51, device=card), None, 1, 1,
                           torch.int32)
        assert torch.equal(got.permute(0, 2, 3, 1).cpu(), want.int())


@pytest.mark.parametrize("s_x", [0.05, 0.012852498, 0.10032497])
def test_quantize_activation_card_matches_cpu_with_ties(card, s_x):
    """clamp(round(x / s_x)) half to even on the card, equal to the CPU's
    and to numpy's float32 arithmetic on the same inputs: values at
    (n + 0.5) * s_x, beyond the clamp, of both signs, float32 and bf16.
    The card divides by the 0-d device tensor; a multiplication by the
    reciprocal, as ATen does for a CPU scalar divisor, would move ties."""
    from posebyte_tpu_torch.ops import conv_int8 as CI
    rng = np.random.default_rng(3)
    s = np.float32(s_x)
    n = rng.integers(-140, 140, (2, 51, 6, 7)).astype(np.float32)
    x = ((n + np.float32(0.5)) * s).astype(np.float32)
    x[:, ::4] = rng.normal(0, 40 * s, x[:, ::4].shape)
    r = np.round(x / s)
    assert (r != np.floor(x / s + np.float32(0.5))).sum() > 50
    for dtype in (torch.float32, torch.bfloat16):
        xt = torch.from_numpy(x).to(dtype).contiguous(
            memory_format=torch.channels_last)
        xf = xt.float().numpy()
        want = np.transpose(np.clip(np.round(xf / s), -127, 127)
                            .astype(np.int8), (0, 2, 3, 1))
        cpu = CI.quantize_activation(xt, torch.tensor(s))
        gpu = CI.quantize_activation(xt.to(card),
                                     torch.tensor(s, device=card)).cpu()
        assert torch.equal(gpu, cpu)
        np.testing.assert_array_equal(gpu[..., :51].numpy(), want)
        assert not gpu[..., 51:].any()


def test_int8_pipeline_card_matches_cpu(card):
    """The w8a8 pipeline (yolov8n-pose 256, quantised and calibrated by the
    port on the CPU) with float32 activations on the card against the CPU:
    a chunk of K = 8 and 4 per-frame frames; ids equal, keypoints within
    the bars of the module's docstring; Kernel 4 launched once per
    quantised conv (59 per frame and per chunk) and quantize_activation
    never run on the card."""
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.models import quant as Q
    from posebyte_tpu_torch.ops import conv_int8 as CI
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        calibration_frames, render_frame

    asset = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets",
        "yolov8n-pose-synthetic256.safetensors")
    qparams = Q.calibrate_activations(
        Q.quantize_params(load_params(asset)[0]), "yolov8n-pose",
        calibration_frames(16, 256, seed=1), device="cpu")
    cfg = PipelineConfig(detector=DetectorConfig(input_size=256,
                                                 num_anchors=1344),
                         precision="int8")
    pipes = [PosePipeline(cfg, qparams, device=d, dtype=torch.float32)
             for d in ("cpu", card)]
    scene = SyntheticScene(4, 1280, 720, seed=11)
    frames = np.stack([render_frame(scene.step(), 1280, 720)
                       for _ in range(12)])

    diffs = []

    def same(cpu, gpu):
        assert [t.track_id for t in gpu] == [t.track_id for t in cpu]
        for x, y in zip(gpu, cpu):
            diffs.append(np.abs(x.keypoints[:, :2] - y.keypoints[:, :2]))

    quantize, on_card = CI.quantize_activation, []

    def count(x, s_x):
        on_card.append(x.is_cuda)
        return quantize(x, s_x)

    before = CI.conv_int8_cuda.launches
    CI.quantize_activation = count
    try:
        cpu, gpu = (p.fetch_chunk_outputs(p.process_chunk(frames[:8]), 1280,
                                          720) for p in pipes)
        for a, b in zip(cpu, gpu):
            same(a, b)
        assert CI.conv_int8_cuda.launches - before == 59
        assert len(gpu[-1]) >= 3
        for fr in frames[8:]:
            same(*(p.fetch_outputs(p.process_frame(fr), 1280, 720)
                   for p in pipes))
    finally:
        CI.quantize_activation = quantize
    assert CI.conv_int8_cuda.launches - before == 59 * 5
    # the CPU quantises eagerly once per conv, the card never (its load)
    assert len(on_card) == 59 * 5 and not any(on_card)
    d = np.concatenate([x.ravel() for x in diffs])
    assert d.max() <= 8.0 and np.median(d) <= 0.5


SRV_H, SRV_W = 96, 128


def serving_run(kind, device, reid, counts=None):
    """Both servers' lifecycle at the small config (input 64, T = 8, D = 4)
    with the oracle detector (three people; the pixels feed only Re-ID):
    4 streams, stream 1 starved for a step, stream 2 closed after 2 frames
    and reopened (a reset). Returns each stream's outputs; `counts` gets
    each step's launches of Kernels 1, 2 and 3."""
    from posebyte_tpu_torch.core import (DetectorConfig, PipelineConfig,
                                         TrackerConfig)
    from posebyte_tpu_torch.models.oracle import encode_oracle_head, \
        make_oracle_heads
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    from posebyte_tpu_torch.pipeline import serving as SV
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, pose_bbox

    scene = SyntheticScene(3, 64, 64, seed=5, scale_range=(14.0, 18.0),
                           speed=0.0)
    gt = scene.step()
    head = encode_oracle_head(gt, np.stack([pose_bbox(p) for p in gt]),
                              np.float32([0.9, 0.8, 0.7]), 64)
    cfg = PipelineConfig(
        detector=DetectorConfig(input_size=64, num_anchors=84,
                                max_candidates=16, max_detections=4),
        tracker=TrackerConfig(max_tracks=8, max_detections=4, min_hits=1,
                              reid_weight=0.3 if reid else 0.0))
    kw = {"chunk": 3} if kind == "chunk" else {}
    cls = SV.ChunkedStreamServer if kind == "chunk" else SV.StreamServer
    srv = cls(4, (SRV_H, SRV_W), config=cfg, params=head, device=device,
              dtype=torch.float32, heads_fn=make_oracle_heads(), **kw)
    frames = np.random.default_rng(3).integers(0, 255, (4, 5, SRV_H, SRV_W,
                                                        3), np.uint8)
    sids = [srv.open_stream() for _ in range(4)]
    kernels = (N.nms_keep_cuda, A.auction_assign_cuda, TC.tracker_chunk_cuda)
    outs = [[] for _ in sids]

    def step():
        before = [k.launches for k in kernels]
        n = srv.step()
        if counts is not None and n:
            counts.append([k.launches - b for k, b in zip(kernels, before)])
        return n

    for sid in sids:
        if sid != 1:
            for f in frames[sid, :2]:
                srv.submit(sid, f)
    step()
    srv.close_stream(2)
    assert srv.open_stream() == 2
    for sid in sids:
        for f in frames[sid, 2:]:
            srv.submit(sid, f)
    while step():
        pass
    for sid in sids:
        outs[sid] = srv.poll(sid)
    frames_seen = [int(f) for f in srv.states.frame.cpu()]
    return outs, frames_seen


@pytest.mark.parametrize("kind", ["frame", "chunk"])
@pytest.mark.parametrize("reid", [False, True])
def test_servers_card_match_cpu(card, kind, reid):
    """Both stream servers on the card against the CPU: the same outputs
    per stream (ids and emit equal, poses within 1e-4 px), each step one
    Kernel 1 and one Kernel 3 launch and no Kernel 2 launch, frame
    counters equal to the frames each stream was served."""
    counts = []
    cpu, cpu_frames = serving_run(kind, "cpu", reid)
    gpu, gpu_frames = serving_run(kind, card, reid, counts)
    assert counts and all(c == [1, 0, 1] for c in counts)
    assert gpu_frames == cpu_frames
    for a, b in zip(gpu, cpu):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["ids"], y["ids"])
            np.testing.assert_array_equal(x["emit"], y["emit"])
            np.testing.assert_allclose(x["poses"], y["poses"], atol=1e-4)
    assert [len(o) for o in gpu] == [5, 3, 3, 5]
    assert gpu[2][0]["ids"][gpu[2][0]["emit"]].tolist() == [1, 2, 3]


def test_tracker_chunk_kernel_one_frame_streams_matches_plain(card):
    """Kernel 3 as the per-frame server runs it: K = 1 for S = 8 streams
    with holes in the advance mask, from states some frames in; bit for
    bit against its plain version (tracker_step per stream)."""
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    dets, adv, state = tracker_chunk_inputs(card, 21, 9, 128, 64, 40, 8)
    cfg = TrackerConfig()
    state, _ = TC.tracker_chunk_plain(state, TC._pick(
        dets, (slice(None), slice(0, 8))), cfg, adv[:, :8])
    last = TC._pick(dets, (slice(None), slice(8, 9)))
    adv1 = torch.arange(8, device=card)[:, None] % 3 != 1
    before = TC.tracker_chunk_cuda.launches
    got = TC.tracker_chunk_cuda(state, last, cfg, adv1)
    assert TC.tracker_chunk_cuda.launches == before + 1
    want = TC.tracker_chunk_plain(state, last, cfg, adv1)
    torch.cuda.synchronize()
    assert_chunk_identical(got, want)
    assert got[1]["emit"].any()


@pytest.mark.parametrize("B", [8, 64])
def test_nms_kernel_stream_batches_matches_plain(card, B):
    """Kernel 1 at the servers' batches: B = S per frame, B = S K per
    chunk (S = 8, K = 8), N = 256, in one launch."""
    sets = [candidates(30 + i, 256, 256 - 7 * (i % 9), 40 * (i % 3 == 0))
            for i in range(B)]
    p, b, v = (torch.stack([torch.from_numpy(s[i]) for s in sets]).to(card)
               for i in range(3))
    before = N.nms_keep_cuda.launches
    got = N.nms_keep_cuda(p, b, v, 0.55, 0.55)
    assert N.nms_keep_cuda.launches == before + 1
    want = torch.stack([N.nms_keep_plain(p[i], b[i], v[i], 0.55, 0.55)
                        for i in range(B)])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_v11_pipeline_card_matches_cpu(card):
    """yolo11n-pose (its 640 checkpoint at input 192 on 320x240 frames, as
    tests/test_torch_v11.py runs it against JAX) in fp32 on the card
    against the CPU: 4 per-frame frames and a chunk of K = 4, ids equal,
    keypoints within 1e-2 px (the scene's 4 people tracked from the third
    frame, 2-4 of them in view at its end)."""
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame

    asset = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets",
        "yolo11n-pose-synthetic640.safetensors")
    params, name = load_params(asset)
    cfg = PipelineConfig(detector=DetectorConfig(input_size=192,
                                                 num_anchors=756),
                         model_name=name, precision="fp32")
    pipes = [PosePipeline(cfg, params, device=d) for d in ("cpu", card)]
    scene = SyntheticScene(4, 320, 240, seed=11)
    frames = np.stack([render_frame(scene.step(), 320, 240)
                       for _ in range(8)])
    results = [[p.fetch_outputs(p.process_frame(f), 320, 240)
                for f in frames[:4]] for p in pipes]
    results = [r + p.fetch_chunk_outputs(p.process_chunk(frames[4:]), 320,
                                         240) for r, p in zip(results, pipes)]
    for cpu, gpu in zip(*results):
        assert [t.track_id for t in gpu] == [t.track_id for t in cpu]
        for x, y in zip(gpu, cpu):
            np.testing.assert_allclose(x.keypoints, y.keypoints, atol=1e-2)
    assert sum(len(r) for r in results[1]) >= 16


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,H", [(64, 80), (128, 20), (256, 20)])
def test_depthwise_w8a8_route_matches_plain_on_card(card, dtype, C, H):
    """YOLO11's depthwise w8a8 route (cuDNN's float32 depthwise conv of the
    quantised values) equal bit for bit to its plain version (a float64
    conv) on the card, at the channel counts and sizes of yolo11n-pose's
    seven depthwise convs at 640, ties and values beyond the clamp
    included."""
    from posebyte_tpu_torch.ops import conv_int8 as CI
    rng = np.random.default_rng(C + H)
    s = np.float32(0.04)
    n = rng.integers(-140, 140, (8, C, H, H)).astype(np.float32)
    x = torch.from_numpy((n + np.float32(0.5) * rng.integers(0, 2, n.shape))
                         * s).to(card, dtype).contiguous(
        memory_format=torch.channels_last)
    w = torch.from_numpy(rng.integers(-127, 128, (C, 1, 3, 3)).astype(
        np.float32)).to(card)
    dq = torch.from_numpy(s * rng.uniform(0.001, 0.02, C).astype(
        np.float32)).to(card)
    b = torch.from_numpy(rng.normal(0, 0.5, C).astype(np.float32)).to(card)
    args = (x, torch.tensor(s, device=card), w, dq, b)
    got = CI.conv_w8a8_depthwise(*args)
    want = CI.conv_w8a8_depthwise_plain(*args)
    assert got.dtype == dtype and got.is_cuda
    assert torch.equal(got.float().view(torch.int32),
                       want.float().view(torch.int32))


ASSET256 = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "assets", "yolov8n-pose-synthetic256.safetensors")


def test_decode_variants_card_equal(card):
    """On the card every topk_impl and gather_impl gives the sort / index
    decode bit for bit, and decode_topk_levels the concatenated decode."""
    from posebyte_tpu_torch.ops import decode as D
    rng = np.random.default_rng(3)
    sizes = [(256 // s) ** 2 for s in (8, 16, 32)]
    levels = tuple(tuple(torch.from_numpy(rng.normal(m, s, (4, a, c)).astype(
        np.float32)).to(card, torch.bfloat16) for m, s, c in
        ((0, 1, 64), (-2, 2, 1), (0, 1, 51))) for a in sizes)
    cat = [torch.cat([lv[j] for lv in levels], dim=1) for j in range(3)]
    ref = D.decode_topk(*cat, 0.25, 256, 256)
    for ti in ("sort", "bisect", "approx"):
        for gi in ("index", "onehot"):
            for got in (D.decode_topk(*cat, 0.25, 256, 256, topk_impl=ti,
                                      gather_impl=gi),
                        D.decode_topk_levels(levels, 0.25, 256, 256,
                                             topk_impl=ti, gather_impl=gi)):
                for f in ("poses", "boxes", "scores", "valid"):
                    assert torch.equal(getattr(got, f), getattr(ref, f)), \
                        (ti, gi, f)


def test_tail_pipeline_card_matches_post_and_cpu(card):
    """decode_fusion="tail" on the card: per chunk and per frame equal to
    "post" bit for bit, Kernels 1 and 3 (chunk) and 1 and 2 (frame)
    launched as on the post path, and the CPU's ids (fp32)."""
    import dataclasses
    from posebyte_tpu_torch.core import DetectorConfig, PipelineConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.ops import tracker_chunk as TC
    from posebyte_tpu_torch.pipeline import PosePipeline
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    post = PipelineConfig(detector=DetectorConfig(input_size=256,
                                                  num_anchors=1344),
                          precision="fp32")
    tail = dataclasses.replace(post, detector=dataclasses.replace(
        post.detector, decode_fusion="tail", topk_impl="bisect"))
    params = load_params(ASSET256)[0]
    scene = SyntheticScene(4, 1280, 720, seed=11)
    frames = np.stack([render_frame(scene.step(), 1280, 720)
                       for _ in range(6)])
    kernels = (N.nms_keep_cuda, A.auction_assign_cuda, TC.tracker_chunk_cuda)
    outs = {}
    for name, cfg, dev in (("post", post, card), ("tail", tail, card),
                           ("cpu", tail, "cpu")):
        pipe = PosePipeline(cfg, params, device=dev)
        before = [k.launches for k in kernels]
        chunk = pipe.process_chunk(frames)
        pipe.reset()
        frame = [pipe.process_frame(f) for f in frames[:3]]
        if dev != "cpu":
            assert [k.launches - b for k, b in zip(kernels, before)] == \
                [1 + 3, 3 * 3, 1]
        outs[name] = (chunk, frame)
    for a, b in zip([outs["post"][0]] + outs["post"][1],
                    [outs["tail"][0]] + outs["tail"][1]):
        for k in ("ids", "scores", "poses", "boxes", "emit", "num_active"):
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(outs["tail"][0]["ids"].cpu(), outs["cpu"][0]["ids"])
    assert (outs["cpu"][0]["ids"] >= 0).any()


def test_engine_card_matches_cpu(card):
    """YoloPoseEngine at fp32: detect_device_native (Kernel 1, one launch)
    and detect_batch (the legacy NMS, no kernel) on the card against the
    CPU: validity equal, keypoints within 1e-2 px."""
    from posebyte_tpu_torch.core import DetectorConfig
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.models.engine import YoloPoseEngine
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene, \
        render_frame
    cfg = DetectorConfig(input_size=256, num_anchors=1344)
    params = load_params(ASSET256)[0]
    engs = [YoloPoseEngine(config=cfg, params=params, precision="fp32",
                           device=d) for d in ("cpu", card)]
    frames = np.stack([render_frame(p, 1280, 720) for p in
                       (SyntheticScene(4, 1280, 720, seed=2).step(),
                        SyntheticScene(3, 1280, 720, seed=3).step())])
    before = N.nms_keep_cuda.launches
    dets = [e.detect_device_native(torch.from_numpy(
        frames[0].reshape(-1)).to(e.device), 720, 1280) for e in engs]
    assert N.nms_keep_cuda.launches - before == 1
    assert torch.equal(dets[0].valid, dets[1].valid.cpu())
    assert int(dets[0].valid.sum()) >= 3
    torch.testing.assert_close(dets[1].poses.cpu(), dets[0].poses, rtol=0,
                               atol=1e-2)
    a, b = (e.detect_batch(frames) for e in engs)
    for x, y in zip(a, b):
        assert len(x) == len(y) >= 3
        for p, q in zip(x, y):
            np.testing.assert_allclose(p["keypoints"], q["keypoints"],
                                       atol=1e-2)


def test_aot_int8_launches_kernel4(card, tmp_path):
    """The int8 (w8a8) locked engine on the card: one run launches Kernel 4
    59 times (its plain version never) and equals the eager int8 forward
    bit for bit; the float engine equals eager forward_raw."""
    from posebyte_tpu_torch.models import load_params
    from posebyte_tpu_torch.models import quant as Q
    from posebyte_tpu_torch.models.aot import export_engine_aot, \
        load_engine_aot
    from posebyte_tpu_torch.models.layers import prepare_params
    from posebyte_tpu_torch.models.yolo_pose import build_model
    from posebyte_tpu_torch.ops import conv_int8 as CI
    from posebyte_tpu_torch.utils.synthetic import calibration_frames
    params = load_params(ASSET256)[0]
    qparams = Q.calibrate_activations(Q.quantize_params(params),
                                      "yolov8n-pose",
                                      calibration_frames(8, 256, seed=1),
                                      device="cpu")
    x = torch.from_numpy(calibration_frames(2, 256, seed=2)).to(card)
    for p, dtype in ((params, torch.float32), (qparams, torch.bfloat16)):
        path = str(tmp_path / "e.pt2")
        export_engine_aot(p, "yolov8n-pose", path, batch=2, input_size=256,
                          dtype=dtype)
        run = load_engine_aot(path)
        plain = CI.conv_w8a8_plain
        CI.conv_w8a8_plain = None                # never on the card
        try:
            before = CI.conv_int8_cuda.launches
            got = run(x)
            n = CI.conv_int8_cuda.launches - before
        finally:
            CI.conv_w8a8_plain = plain
        apply_fn, _ = build_model("yolov8n-pose", dtype)
        with torch.inference_mode():
            want = apply_fn(prepare_params(p, dtype, card), x)
        assert n == (59 if dtype == torch.bfloat16 else 0)
        assert torch.equal(got, want)


def test_debug_card_matches_cpu(card):
    """tracker_step_debug on the card (its tiers through Kernel 2, three
    launches) against the CPU on the same state: assignments equal, costs
    within 1e-6."""
    from posebyte_tpu_torch.core.config import TrackerConfig
    from posebyte_tpu_torch.core.structs import Detections, TrackerState
    from posebyte_tpu_torch.tracker import tracker_step
    from posebyte_tpu_torch.tracker.debug import tracker_step_debug
    from posebyte_tpu_torch.utils.synthetic import SyntheticScene
    cfg = TrackerConfig(max_tracks=32, max_detections=16)
    scene = SyntheticScene(6, 1280, 720, seed=4)

    def det(dev):
        P = np.zeros((16, 17, 3), np.float32)
        P[:6] = gt
        B = np.zeros((16, 4), np.float32)
        B[:6] = np.stack([gt[..., 0].min(1), gt[..., 1].min(1),
                          gt[..., 0].max(1), gt[..., 1].max(1)], -1)
        S = np.zeros((16,), np.float32)
        S[:6] = 0.9
        return Detections(*(torch.from_numpy(a).to(dev) for a in
                            (P, B, S, np.arange(16) < 6)))

    state = TrackerState.init(32, 16)
    for _ in range(4):
        gt = scene.step()
        state, _ = tracker_step(state, det("cpu"), cfg)
    gt = scene.step()
    want = tracker_step_debug(state, det("cpu"), cfg)
    before = A.auction_assign_cuda.launches
    import dataclasses
    on_card = TrackerState(**{f.name: getattr(state, f.name).to(card)
                              for f in dataclasses.fields(state)})
    got = tracker_step_debug(on_card, det(card), cfg)
    assert A.auction_assign_cuda.launches - before == 3
    for k, v in want.items():
        if k.startswith(("row_", "col_")) or v.dtype == bool:
            np.testing.assert_array_equal(got[k], v, k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=1e-6)
    assert (got["row_assign_final"] >= 0).sum() == 6
