"""Port's pose-NMS (posebyte_tpu_torch/ops/nms.py) against the JAX package.

The same score-sorted candidates, made from a seed with numpy, go through
the JAX XLA path (nms_overlap_matrix + _greedy_keep), the TPU kernel in
interpret mode (nms_keep_pallas, exact for suppression chains up to 23
deep), and the port's plain version. Keep masks and compacted detections
must be equal. Kernel 1 itself (CUDA) is held against the plain version in
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from posebyte_tpu.core.structs import Detections as JDetections
from posebyte_tpu.ops.nms import _greedy_keep as j_greedy_keep
from posebyte_tpu.ops.nms import nms_overlap_matrix as j_overlap
from posebyte_tpu.ops.nms import pose_nms as j_pose_nms
from posebyte_tpu.ops.pallas_kernels import nms_keep_pallas

from posebyte_tpu_torch.core.structs import Detections
from posebyte_tpu_torch.ops import nms as N

torch.set_num_threads(2)

OFFSETS = np.array([
    (0.0, -0.45), (-0.05, -0.5), (0.05, -0.5), (-0.1, -0.48),
    (0.1, -0.48), (-0.2, -0.3), (0.2, -0.3), (-0.25, -0.1),
    (0.25, -0.1), (-0.25, 0.1), (0.25, 0.1), (-0.15, 0.05),
    (0.15, 0.05), (-0.15, 0.3), (0.15, 0.3), (-0.15, 0.5), (0.15, 0.5),
], np.float32)


def make_candidates(seed, n, n_valid, chain=0):
    """Score-sorted candidates: clustered person poses (dense overlaps), a
    chain of shifted copies each suppressing the next, an invalid tail."""
    rng = np.random.default_rng(seed)
    n_cl = max(1, n // 12)
    centers = rng.uniform(60, 580, (n_cl, 2))
    scales = rng.uniform(40, 160, n_cl)
    cl = rng.integers(0, n_cl, n)
    poses = np.zeros((n, 17, 3), np.float32)
    poses[..., :2] = (centers[cl][:, None] + OFFSETS[None]
                      * scales[cl][:, None, None]
                      + rng.normal(0, 4, (n, 17, 2)))
    poses[..., 2] = rng.uniform(0, 1, (n, 17))
    for i in range(chain):
        poses[i, :, :2] = 320 + OFFSETS * 100 + np.float32(i * 9.0) \
            * np.array([1, 0], np.float32)
        poses[i, :, 2] = 0.9
    boxes = np.stack([poses[..., 0].min(1), poses[..., 1].min(1),
                      poses[..., 0].max(1), poses[..., 1].max(1)],
                     -1).astype(np.float32)
    scores = np.sort(rng.uniform(0.3, 1.0, n).astype(np.float32))[::-1]
    valid = np.arange(n) < n_valid
    poses[~valid], boxes[~valid], scores[~valid] = 0, 0, 0
    return poses, boxes, scores.copy(), valid


def jax_keep(poses, boxes, scores, valid, iou, oks):
    det = JDetections(poses=jnp.asarray(poses), boxes=jnp.asarray(boxes),
                      scores=jnp.asarray(scores), valid=jnp.asarray(valid))
    return np.asarray(j_greedy_keep(j_overlap(det, iou, oks), det.valid))


def chain_sweeps(poses, boxes, valid, iou, oks):
    """Jacobi sweeps the greedy solution needs (longest chain + 1)."""
    det = Detections(*(torch.from_numpy(a) for a in
                       (poses, boxes, np.zeros(len(valid), np.float32),
                        valid)))
    dom = N.nms_overlap_matrix(det, iou, oks).triu(1)
    v = det.valid
    keep, prev, sweeps = v, torch.zeros_like(v), 0
    while not torch.equal(keep, prev):
        prev, keep = keep, v & ~(dom & keep[:, None]).any(0)
        sweeps += 1
    return sweeps


# Tolerance: none. Keep masks are booleans and must be equal.
@pytest.mark.parametrize("seed,n,n_valid,chain,thr", [
    (0, 256, 240, 0, (0.55, 0.55)),
    (1, 256, 256, 40, (0.55, 0.55)),
    (2, 128, 100, 30, (0.5, 0.6)),
    (3, 64, 59, 0, (0.65, 0.45)),
])
def test_plain_keep_matches_jax_xla(seed, n, n_valid, chain, thr):
    poses, boxes, scores, valid = make_candidates(seed, n, n_valid, chain)
    want = jax_keep(poses, boxes, scores, valid, *thr)
    got = N.nms_keep_plain(torch.from_numpy(poses), torch.from_numpy(boxes),
                           torch.from_numpy(valid), *thr)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n_valid       # some kept, some suppressed
    if chain > 24:     # deeper than the TPU kernel's 24 sweeps reach
        assert chain_sweeps(poses, boxes, valid, *thr) > 24


@pytest.mark.parametrize("seed,chain", [(4, 0), (5, 20)])
def test_plain_keep_matches_pallas_interpret(seed, chain):
    poses, boxes, scores, valid = make_candidates(seed, 64, 60, chain)
    assert chain_sweeps(poses, boxes, valid, 0.55, 0.55) <= 24
    want = np.asarray(nms_keep_pallas(
        jnp.asarray(poses), jnp.asarray(boxes), jnp.asarray(valid),
        0.55, 0.55, interpret=True))
    got = N.nms_keep_plain(torch.from_numpy(poses), torch.from_numpy(boxes),
                           torch.from_numpy(valid), 0.55, 0.55)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pose_nms_compaction_matches_jax():
    poses, boxes, scores, valid = make_candidates(6, 256, 200, 10)
    jd = j_pose_nms(JDetections(poses=jnp.asarray(poses),
                                boxes=jnp.asarray(boxes),
                                scores=jnp.asarray(scores),
                                valid=jnp.asarray(valid)),
                    0.55, 0.55, 16, presorted=True)
    td = N.pose_nms(Detections(*(torch.from_numpy(a) for a in
                                 (poses, boxes, scores, valid))),
                    0.55, 0.55, 16)
    for f in ("poses", "boxes", "scores", "valid"):
        np.testing.assert_array_equal(getattr(td, f).numpy(),
                                      np.asarray(getattr(jd, f)))
    assert td.valid.sum() == 16                     # more kept than slots


def test_pose_nms_few_survivors_zero_tail():
    poses, boxes, scores, valid = make_candidates(7, 64, 5)
    td = N.pose_nms(Detections(*(torch.from_numpy(a) for a in
                                 (poses, boxes, scores, valid))),
                    0.55, 0.55, 16)
    k = int(td.valid.sum())
    assert 0 < k <= 5 and not td.valid[k:].any()
    assert (td.poses[k:] == 0).all() and (td.scores[k:] == 0).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    poses, boxes, _, valid = make_candidates(8, 32, 32)
    with pytest.raises(ValueError):
        N.nms_keep_cuda(torch.from_numpy(poses), torch.from_numpy(boxes),
                        torch.from_numpy(valid), 0.55, 0.55)
