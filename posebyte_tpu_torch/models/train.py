"""Training on synthetic scenes: the YOLO-pose losses, after
posebyte_tpu/models/train.py.

  * assign_targets: each ground-truth box takes the 3x3 cells around its
    centre at the one pyramid level its size picks (stride 8 below 96 px,
    16 below 192, else 32), the cells whose centre lies in the box and in
    the grid.
  * pose_loss: BCE on the class logits of every anchor; on the assigned
    cells, distribution-focal loss on the box bins, L1 on their decoded
    expectation, L1 on the raw keypoint offsets and BCE on the keypoint
    confidences. It takes a leading batch axis (batch_loss runs one call
    for the batch where JAX vmaps one image's).
  * batch_loss, make_train_step, make_scan_train: the mean loss of a batch
    of letterboxed u8 images through forward_heads in float32, one
    optimizer step, and a segment of steps over a dataset on the device.

Parameters for training are a dict of float32 leaf tensors in the port's
layout (OIHW), the keys of models.load_params (trainable_params makes them
from numpy weights; params_numpy takes them back for save_params).
forward_heads is differentiable on them; the raw-ingest stem fold is not
used (images are divided by 255). make_scan_train's loop keeps its losses
on the device and reads nothing back, so the host queues the steps ahead of
the card. Call core.set_numeric_settings() first on the card: TF32 would
change every float32 product.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .yolo_pose import MODEL_CONFIGS, REG_MAX, forward_heads, make_anchors

NUM_KPT = 17
NEIGHBORS = tuple((dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1))

# Box-size thresholds (input px) for the pyramid level: boxes smaller than
# LEVEL_EDGES[0] supervise stride 8, then 16, else 32.
LEVEL_EDGES = (96.0, 192.0)


def trainable_params(params: dict, device="cpu") -> dict:
    """A checkpoint's flat dict (numpy or tensors) -> float32 leaf tensors
    on `device`, contiguous OIHW, for training."""
    return {k: torch.as_tensor(np.asarray(v, np.float32)).to(device)
            .contiguous() for k, v in params.items()}


def params_numpy(params: dict) -> dict:
    """Training tensors -> the port's flat dict of float32 numpy arrays
    (what save_params and the pipelines take)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _constants(input_size: int, device: torch.device) -> dict:
    """The loss's constant tensors on `device`, made once: a copy from
    pageable host memory to the card waits for the card's queue to drain,
    which in a training loop would stop the host from running ahead. They
    are made as normal tensors even under inference_mode (an evaluation
    may come first), so that autograd can save them later."""
    ns = [input_size // s for s in (8, 16, 32)]
    anchors, strides = make_anchors(input_size)
    with torch.inference_mode(False):
        consts = {
            "level_strides": torch.tensor([8.0, 16.0, 32.0]),
            "level_n": torch.tensor(ns),
            "level_offset": torch.tensor([0, ns[0] ** 2,
                                          ns[0] ** 2 + ns[1] ** 2]),
            "neighbors": torch.tensor(NEIGHBORS),
            "anchors": torch.from_numpy(anchors.copy()),
            "strides": torch.from_numpy(strides.copy()),
            "bins": torch.arange(REG_MAX, dtype=torch.float32)}
        return {k: v.to(device) for k, v in consts.items()}


@functools.lru_cache(maxsize=None)
def _divisor_255(device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.tensor(255.0).to(device)


def to_unit(img_u8: torch.Tensor) -> torch.Tensor:
    """u8 images -> float32 / 255, divided by a 0-d tensor on their device
    (ATen divides by a host scalar on the card as a product with its
    reciprocal, one bit off the division)."""
    return img_u8.float() / _divisor_255(img_u8.device)


def assign_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   input_size: int):
    """GT boxes [..., P, 4] xyxy (input coords) and valid [..., P] ->
    (idx [..., P, 9] int64 flat anchor ids, mask [..., P, 9] bool)."""
    c = _constants(input_size, gt_boxes.device)
    strides, ns, offs = c["level_strides"], c["level_n"], c["level_offset"]
    x1, y1, x2, y2 = gt_boxes.unbind(-1)
    m = torch.maximum(x2 - x1, y2 - y1)
    lvl = (m >= LEVEL_EDGES[0]).long() + (m >= LEVEL_EDGES[1]).long()
    s, n, off = strides[lvl], ns[lvl], offs[lvl]
    icx = torch.floor((x1 + x2) * 0.5 / s).long()
    icy = torch.floor((y1 + y2) * 0.5 / s).long()
    d = c["neighbors"]
    ix = icx[..., None] + d[:, 0]
    iy = icy[..., None] + d[:, 1]
    n9 = n[..., None]
    inb = (ix >= 0) & (ix < n9) & (iy >= 0) & (iy < n9)
    axc = (ix.float() + 0.5) * s[..., None]
    ayc = (iy.float() + 0.5) * s[..., None]
    in_box = ((axc >= x1[..., None]) & (axc <= x2[..., None])
              & (ayc >= y1[..., None]) & (ayc <= y2[..., None]))
    mask = inb & in_box & gt_valid[..., None]
    idx = off[..., None] + torch.minimum(iy.clamp_min(0), n9 - 1) * n9 \
        + torch.minimum(ix.clamp_min(0), n9 - 1)
    return idx, mask


def _dfl_ce(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Distribution focal loss: the cross-entropy of the two integer bins
    around the fractional target distance. logits [..., REG_MAX], target
    [...] -> [...]."""
    t = target.clamp(0.0, REG_MAX - 1.001)
    lo = torch.floor(t).long()
    hi = lo + 1
    wl = hi.float() - t
    wh = t - lo.float()
    logp = torch.log_softmax(logits, dim=-1)

    def take(i):
        return torch.gather(logp, -1, i[..., None])[..., 0]

    return -(wl * take(lo) + wh * take(hi.clamp_max(REG_MAX - 1)))


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE (optax.sigmoid_binary_cross_entropy,
    as the JAX module inlines it)."""
    return torch.clamp_min(logits, 0.0) - logits * labels \
        + torch.log1p(torch.exp(-torch.abs(logits)))


def pose_loss(box_l: torch.Tensor, cls_l: torch.Tensor, kpt_r: torch.Tensor,
              gt_poses: torch.Tensor, gt_boxes: torch.Tensor,
              gt_valid: torch.Tensor, input_size: int,
              w_cls: float = 1.0, w_dfl: float = 0.5, w_box: float = 0.05,
              w_kpt: float = 2.0, w_kobj: float = 0.5):
    """The loss over raw head outputs, per image: box_l [..., A, 64],
    cls_l [..., A, 1], kpt_r [..., A, 51]; gt_poses [..., P, 17, 3] (input
    coords, conf > 0 labelled), gt_boxes [..., P, 4] xyxy, gt_valid [...,
    P]. Returns (total [...], {cls, dfl, box, kpt, kobj: [...]})."""
    lead = box_l.shape[:-2]
    box_l, cls_l, kpt_r = (t.reshape(-1, *t.shape[-2:])
                           for t in (box_l, cls_l, kpt_r))
    gt_poses = gt_poses.reshape(-1, *gt_poses.shape[-3:])
    gt_boxes = gt_boxes.reshape(-1, *gt_boxes.shape[-2:])
    gt_valid = gt_valid.reshape(-1, gt_valid.shape[-1])
    dev = box_l.device
    c = _constants(input_size, dev)
    anchors, strides = c["anchors"], c["strides"]      # [A, 2] grid, [A]
    B, A = box_l.shape[:2]
    P = gt_boxes.shape[1]

    idx, mask = assign_targets(gt_boxes, gt_valid, input_size)  # [B,P,9]
    fmask = mask.float()
    num_pos = fmask.sum((1, 2)).clamp_min(1.0)                  # [B]

    # classification: BCE over every anchor; masked cells go to a dump
    # slot A, which is cut off (JAX's .at[].max(mode="drop"))
    scatter = torch.where(mask, idx, A).reshape(B, -1)
    tcls = torch.zeros((B, A + 1), device=dev).scatter(1, scatter, 1.0)
    cls_bce = sigmoid_bce(cls_l[..., 0].float(), tcls[:, :A])
    cls_loss = cls_bce.sum(-1) / num_pos

    # per-candidate gathers
    flat = idx.clamp(0, A - 1).reshape(B, P * 9)
    rows = torch.arange(B, device=dev)[:, None]
    a_sel = anchors[flat].reshape(B, P, 9, 2)
    s_sel = strides[flat].reshape(B, P, 9)
    pb = box_l[rows, flat].reshape(B, P, 9, 4, REG_MAX).float()
    pk = kpt_r[rows, flat].reshape(B, P, 9, NUM_KPT, 3).float()

    # box: DFL + L1 on the decoded expectation, in stride units from
    # each candidate cell's centre
    g = gt_boxes[:, :, None, :] / s_sel[..., None]              # [B,P,9,4]
    td = torch.stack([a_sel[..., 0] - g[..., 0], a_sel[..., 1] - g[..., 1],
                      g[..., 2] - a_sel[..., 0], g[..., 3] - a_sel[..., 1]],
                     dim=-1).clamp(0.0, REG_MAX - 1.001)
    dfl = _dfl_ce(pb, td).sum(-1)                               # [B,P,9]
    dfl_loss = (dfl * fmask).sum((1, 2)) / num_pos
    exp_d = torch.softmax(pb, dim=-1) @ c["bins"]
    box_l1 = torch.abs(exp_d - td).sum(-1)
    box_loss = (box_l1 * fmask).sum((1, 2)) / num_pos

    # keypoints: L1 on the raw offsets (decode: kxy = (raw * 2 + anchor -
    # 0.5) * stride) and BCE on their confidence
    t_raw = (gt_poses[:, :, None, :, :2] / s_sel[..., None, None]
             - (a_sel[:, :, :, None, :] - 0.5)) / 2.0        # [B,P,9,17,2]
    kvis = (gt_poses[..., 2] > 0.0).float()                     # [B,P,17]
    kv = kvis[:, :, None, :] * fmask[..., None]                 # [B,P,9,17]
    kpt_l1 = torch.abs(pk[..., :2] - t_raw).sum(-1)
    kpt_loss = (kpt_l1 * kv).sum((1, 2, 3)) \
        / kv.sum((1, 2, 3)).clamp_min(1.0)
    kobj = sigmoid_bce(pk[..., 2], kvis[:, :, None, :].expand_as(pk[..., 2]))
    kobj_loss = (kobj * fmask[..., None]).sum((1, 2, 3)) \
        / (fmask.sum((1, 2)) * NUM_KPT).clamp_min(1.0)

    total = (w_cls * cls_loss + w_dfl * dfl_loss + w_box * box_loss
             + w_kpt * kpt_loss + w_kobj * kobj_loss)
    parts = {"cls": cls_loss, "dfl": dfl_loss, "box": box_loss,
             "kpt": kpt_loss, "kobj": kobj_loss}
    return total.reshape(lead), {k: v.reshape(lead) for k, v in parts.items()}


def batch_loss(params: dict, batch: dict, model_name: str, input_size: int):
    """Mean pose_loss over a batch dict: img [B, S, S, 3] uint8 (RGB,
    letterboxed), poses [B, P, 17, 3], boxes [B, P, 4], valid [B, P].
    Returns (loss, {part: mean})."""
    family = MODEL_CONFIGS[model_name].family
    box, cls, kpt = forward_heads(params, to_unit(batch["img"]), family)
    totals, parts = pose_loss(box, cls, kpt, batch["poses"], batch["boxes"],
                              batch["valid"], input_size)
    return totals.mean(), {k: v.mean() for k, v in parts.items()}


def loss_and_grads(params: dict, batch: dict, model_name: str,
                   input_size: int):
    """(loss, parts, grads) of batch_loss, the grads a dict like params."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss, parts = batch_loss(leaves, batch, model_name, input_size)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            dict(zip(leaves, grads)))


def make_train_step(model_name: str, input_size: int, optimizer):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss,
    parts): one update of `optimizer` (models.optim) on batch_loss's
    gradients."""
    from .optim import apply_updates

    def step(params, opt_state, batch):
        loss, parts, grads = loss_and_grads(params, batch, model_name,
                                            input_size)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, parts

    return step


def draw_indices(steps: int, batch_size: int, n: int,
                 generator: torch.Generator, device) -> torch.Tensor:
    """[steps, batch_size] sample indices in [0, n), uniform with
    replacement as JAX's randint, from `generator` (on `device`)."""
    return torch.randint(0, n, (steps, batch_size), generator=generator,
                         device=device)


def make_scan_train(model_name: str, input_size: int, optimizer,
                    batch_size: int):
    """Returns run(params, opt_state, data, indices) -> (params, opt_state,
    losses [steps]): one step per row of `indices` ([steps, batch_size]
    int64 on data's device, e.g. draw_indices), each on the rows it names
    of `data` (a dict of [N, ...] tensors on the device). The losses stay
    on the device; nothing in the loop waits for it."""
    step = make_train_step(model_name, input_size, optimizer)

    def run(params, opt_state, data, indices):
        if indices.shape[-1] != batch_size:
            raise ValueError(f"indices {tuple(indices.shape)}: expected "
                             f"[steps, {batch_size}]")
        losses = []
        for sel in indices:
            batch = {k: v.index_select(0, sel) for k, v in data.items()}
            params, opt_state, loss, _ = step(params, opt_state, batch)
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return run
