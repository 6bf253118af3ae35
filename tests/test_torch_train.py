"""Training in the port (posebyte_tpu_torch/models/train.py, optim.py,
init_params, init_reid_head) against the JAX package's (models/train.py,
optax, init_params, init_reid_head) on the same numpy inputs, at input 64
as the JAX tests train.

init_params cannot draw JAX's values, so it is held to JAX's tree (keys,
shapes, dtypes) and to He-normal statistics: per tensor of at least 4096
elements a standard deviation within 10% of sqrt(2 / fan_in), zero
biases. The losses and steps run both packages on the same weights: the
port's init_params turned into the JAX tree (test_torch_quant.jax_tree).

Tolerances: assign_targets bit for bit; pose_loss's parts 1e-5 relative
(sums over anchors in different orders); one SGD step's loss 1e-5 and its
parameters within rtol 5e-4, atol 5e-6 (the contract of
tests/test_parallel_train.py: an SGD update is the gradient times lr, and
the gradients' sums run in different orders); the optimizer chain's
updates within 1e-6 relative of optax's on identical gradients.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from posebyte_tpu.models import train as JT
from posebyte_tpu.models.reid_head import init_reid_head as j_init_reid_head
from posebyte_tpu.models.reid_head import load_reid_head as j_load_reid_head
from posebyte_tpu.models.yolo_pose import init_params as j_init_params

from posebyte_tpu_torch.models import optim as O
from posebyte_tpu_torch.models import train as T
from posebyte_tpu_torch.models.reid_head import (IN_DIM, init_reid_head,
                                                 load_reid_head,
                                                 save_reid_head)
from posebyte_tpu_torch.models.weights import params_from_jax
from posebyte_tpu_torch.models.yolo_pose import init_params

from test_torch_quant import jax_tree
from torch_train_data import S, tiny_data

torch.set_num_threads(1)

MODELS = ["yolov8n-pose", "yolo11n-pose"]


def jax_shapes(name):
    tree = jax.eval_shape(lambda k: j_init_params(k, name),
                          jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), tree))


@pytest.mark.parametrize("name", MODELS)
def test_init_params_tree_matches_jax(name):
    want = jax_shapes(name)
    got = init_params(0, name)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype == np.float32, k


@pytest.mark.parametrize("name", MODELS)
def test_init_params_he_normal(name):
    p = init_params(0, name)
    checked = 0
    for k, v in p.items():
        if k.endswith(".b"):
            assert not v.any(), k
        elif v.size >= 4096:
            fan_in = v.shape[1] * v.shape[2] * v.shape[3]
            std = np.sqrt(2.0 / fan_in)
            assert abs(v.std() / std - 1.0) < 0.10, (k, v.std(), std)
            assert abs(v.mean()) < 0.1 * std, k
            checked += 1
    assert checked > 40
    again, other = init_params(0, name), init_params(1, name)
    assert all(np.array_equal(p[k], again[k]) for k in p)
    assert not np.array_equal(p["b0.w"], other["b0.w"])
    g = torch.Generator().manual_seed(0)
    assert np.array_equal(init_params(g, name)["b0.w"], p["b0.w"])


def test_init_reid_head_matches_jax_and_saves(tmp_path):
    j = j_init_reid_head(jax.random.PRNGKey(0))
    h = init_reid_head(0)
    assert list(h) == list(j)
    for k in j:
        assert tuple(h[k].shape) == j[k].shape and h[k].dtype == torch.float32
    for k, fan_in in (("w1", IN_DIM), ("w2", h["w1"].shape[1])):
        bound = 1.0 / np.sqrt(fan_in)
        assert float(h[k].abs().max()) <= bound
        assert float(h[k].abs().max()) > 0.8 * bound
    assert not h["b1"].any() and not h["b2"].any()
    path = str(tmp_path / "head.safetensors")
    save_reid_head(h, path)
    for loaded in (j_load_reid_head(path), load_reid_head(path)):
        for k in h:
            np.testing.assert_array_equal(np.asarray(loaded[k]), h[k])


def test_assign_targets_bit_equal():
    rng = np.random.default_rng(0)
    B, P = 6, 8
    c = rng.uniform(-20, 276, (B, P, 2))
    half = rng.uniform(2, 130, (B, P, 2))
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    boxes[0, 0] = [76.0, 36.0, 124.0, 84.0]        # tests/test_train.py's
    boxes[0, 1] = [50.0, 50.0, 200.0, 180.0]
    valid = rng.random((B, P)) > 0.2
    idx, mask = T.assign_targets(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), 256)
    for b in range(B):
        ji, jm = JT.assign_targets(jnp.asarray(boxes[b]),
                                   jnp.asarray(valid[b]), 256)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(jm))
    assert mask.any() and not mask.all()


def _oracle_case():
    """tests/test_train.py's perfect-prediction case: the oracle head of
    two people, and a random head."""
    from posebyte_tpu.models.oracle import encode_oracle_head
    from posebyte_tpu.utils.synthetic import SyntheticScene, pose_bbox
    scene = SyntheticScene(2, 256, 256, seed=5, scale_range=(60.0, 90.0))
    gt = scene.step()
    boxes = np.stack([pose_bbox(p) for p in gt])
    head = encode_oracle_head(gt, boxes, np.full(len(gt), 0.99,
                                                 np.float32), 256)
    P = 8
    gp = np.zeros((P, 17, 3), np.float32)
    gb = np.zeros((P, 4), np.float32)
    gv = np.zeros((P,), bool)
    gp[:len(gt)], gb[:len(gt)], gv[:len(gt)] = gt, boxes, True
    rng = np.random.default_rng(0)
    rand = {k: rng.normal(0, 1, v.shape).astype(np.float32)
            for k, v in head.items()}
    return [head, rand], gp, gb, gv


def test_pose_loss_parts_match_jax():
    heads, gp, gb, gv = _oracle_case()
    # both heads as one batch of two through the port's batched loss
    stack = {k: np.stack([h[k] for h in heads]) for k in ("box", "cls",
                                                         "kpt")}
    total, parts = T.pose_loss(
        *(torch.from_numpy(np.ascontiguousarray(stack[k]))
          for k in ("box", "cls", "kpt")),
        *(torch.from_numpy(np.stack([a, a])) for a in (gp, gb, gv)), 256)
    for i, h in enumerate(heads):
        jt, jparts = JT.pose_loss(jnp.asarray(h["box"]), jnp.asarray(h["cls"]),
                                  jnp.asarray(h["kpt"]), jnp.asarray(gp),
                                  jnp.asarray(gb), jnp.asarray(gv), 256)
        np.testing.assert_allclose(float(total[i]), float(jt), rtol=1e-5)
        for k in jparts:
            np.testing.assert_allclose(float(parts[k][i]), float(jparts[k]),
                                       rtol=1e-5, atol=1e-7)
    # one image without a batch axis gives the same
    one, _ = T.pose_loss(*(torch.from_numpy(heads[1][k])
                           for k in ("box", "cls", "kpt")),
                         *(torch.from_numpy(a) for a in (gp, gb, gv)), 256)
    assert one.shape == () and float(one) == float(total[1])
    # the perfect head beats the random one, as the JAX test asks
    assert float(total[0]) < 0.7 * float(total[1])


def test_sigmoid_bce_and_dfl_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 4, (64, 16)).astype(np.float32)
    labels = (rng.random((64, 16)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        T.sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(labels)),
        np.asarray(JT.optax_sigmoid_bce(logits, labels)), rtol=1e-6,
        atol=1e-7)
    target = rng.uniform(-2, 18, (64,)).astype(np.float32)
    target[:3] = [0.0, 14.999, 15.0]                  # the clips' edges
    np.testing.assert_allclose(
        T._dfl_ce(torch.from_numpy(logits), torch.from_numpy(target)),
        np.asarray(JT._dfl_ce(logits, target)), rtol=1e-5, atol=1e-6)


def _close_params(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k],
                                   rtol=5e-4, atol=5e-6, err_msg=k)


@pytest.mark.parametrize("name", MODELS)
def test_train_step_matches_jax(name):
    """batch_loss and one SGD make_train_step on the same weights and
    batch in both packages."""
    flat = init_params(0, name)
    jp = jax_tree(flat, name)
    data = tiny_data(4)
    opt = optax.sgd(1e-2)
    jstep = jax.jit(JT.make_train_step(name, S, opt))
    jp1, _, jloss, jparts = jstep(jp, opt.init(jp),
                                  {k: jnp.asarray(v) for k, v in
                                   data.items()})
    o = O.sgd(1e-2)
    tp = T.trainable_params(flat)
    p1, _, loss, parts = T.make_train_step(name, S, o)(
        tp, o.init(tp), {k: torch.from_numpy(v) for k, v in data.items()})
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-4, atol=1e-6)
    _close_params(p1, params_from_jax(jp1))


def test_scan_train_matches_jax_on_its_indices():
    """make_scan_train over the batches JAX's run draws from its keys
    (jax.random.randint per key), SGD: the same losses step by step and
    the same parameters after three steps."""
    name = "yolov8n-pose"
    flat = init_params(0, name)
    data = tiny_data(8)
    opt = optax.sgd(1e-2)
    keys = jax.random.split(jax.random.PRNGKey(1), 3)
    jrun = jax.jit(JT.make_scan_train(name, S, opt, batch_size=4))
    jp = jax_tree(flat, name)
    jp3, _, jlosses = jrun(jp, opt.init(jp),
                           {k: jnp.asarray(v) for k, v in data.items()},
                           keys)
    idx = np.stack([np.asarray(jax.random.randint(k, (4,), 0, 8))
                    for k in keys])
    o = O.sgd(1e-2)
    tp = T.trainable_params(flat)
    run = T.make_scan_train(name, S, o, batch_size=4)
    p3, _, losses = run(tp, o.init(tp),
                        {k: torch.from_numpy(v) for k, v in data.items()},
                        torch.from_numpy(idx).long())
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    _close_params(p3, params_from_jax(jp3))
    with pytest.raises(ValueError):
        run(tp, o.init(tp), {k: torch.from_numpy(v) for k, v in
                             data.items()}, torch.zeros((2, 3)).long())


def test_scan_train_optimizes():
    """tests/test_train.py's overfit on the port: two segments of six
    Adam steps on batches drawn from a generator; the loss falls."""
    name = "yolov8n-pose"
    data = {k: torch.from_numpy(v) for k, v in tiny_data(8).items()}
    o = O.adam(3e-3)
    params = T.trainable_params(init_params(0, name))
    st = o.init(params)
    run = T.make_scan_train(name, S, o, batch_size=4)
    g = torch.Generator().manual_seed(1)
    params, st, l1 = run(params, st, data, T.draw_indices(6, 4, 8, g, "cpu"))
    params, st, l2 = run(params, st, data, T.draw_indices(6, 4, 8, g, "cpu"))
    l1, l2 = l1.numpy(), l2.numpy()
    assert np.isfinite(l1).all() and np.isfinite(l2).all()
    assert l2.mean() < l1.mean()
    assert l2[-1] < l1[0] * 0.7


@pytest.mark.parametrize("which", ["trainer_chain", "adam", "sgd"])
def test_optimizer_matches_optax(which):
    """Five updates on identical synthetic gradients, the third with a
    global norm above 5.0 (the clip's), from the same parameters."""
    rng = np.random.default_rng(0)
    shapes = {"a.w": (8, 4, 3, 3), "a.b": (8,), "c.w": (3, 8, 1, 1),
              "c.b": (3,)}
    params = {k: rng.normal(0, 0.3, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 3.0 if i == 2 else 0.05, s)
              .astype(np.float32) for k, s in shapes.items()}
             for i in range(5)]
    assert np.sqrt(sum((g ** 2).sum() for g in grads[2].values())) > 5.0
    lr = 1e-3
    if which == "trainer_chain":     # scripts/train_synthetic.py's chain
        js = optax.warmup_cosine_decay_schedule(
            init_value=lr * 0.05, peak_value=lr, warmup_steps=2,
            decay_steps=20, end_value=lr * 0.02)
        ts = O.warmup_cosine_decay_schedule(lr * 0.05, lr, 2, 20, lr * 0.02)
        for c in range(25):
            np.testing.assert_allclose(float(ts(c)), float(js(c)),
                                       rtol=1e-6)
        jo = optax.chain(optax.clip_by_global_norm(5.0),
                         optax.adamw(js, weight_decay=1e-5))
        to = O.chain(O.clip_by_global_norm(5.0),
                     O.adamw(ts, weight_decay=1e-5))
    elif which == "adam":
        jo, to = optax.adam(lr), O.adam(lr)
    else:
        jo, to = optax.sgd(1e-2), O.sgd(1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = jo.init(jp), to.init(tp)
    for g in grads:
        ju, jst = jo.update({k: jnp.asarray(v) for k, v in g.items()},
                            jst, jp)
        tu, tst = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                            tst, tp)
        for k in ju:
            want = np.asarray(ju[k])
            np.testing.assert_allclose(tu[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
        jp = optax.apply_updates(jp, ju)
        tp = O.apply_updates(tp, tu)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)
