"""Shared by tests/test_torch_train.py and test_torch_parallel.py: the JAX
training tests' tiny batch and the data-parallel rank that
test_torch_parallel spawns. It imports no JAX, so that a spawned rank
starts quickly."""
import os
import warnings

import numpy as np
import torch

from posebyte_tpu_torch.models import optim as O
from posebyte_tpu_torch.models import train as T
from posebyte_tpu_torch.models.yolo_pose import init_params
from posebyte_tpu_torch.parallel import (make_data_mesh, make_dp_scan_train,
                                         make_dp_train_step, shard_dataset)

S = 64
MODEL = "yolov8n-pose"


def tiny_data(n, seed=3, P=4):
    """The JAX training tests' batch (tests/test_train.py): noise images,
    P people with random keypoints and boxes."""
    rng = np.random.default_rng(seed)
    data = {
        "img": rng.integers(0, 255, (n, S, S, 3), dtype=np.uint8),
        "poses": rng.uniform(10, 54, (n, P, 17, 3)).astype(np.float32),
        "boxes": np.sort(rng.uniform(5, 59, (n, P, 2, 2))
                         .astype(np.float32), axis=2)
        .transpose(0, 1, 3, 2).reshape(n, P, 4),
        "valid": np.ones((n, P), bool),
    }
    data["poses"][..., 2] = 1.0
    return data


# Three steps' rows of each rank's shard of 2: rank r takes columns 2r and
# 2r + 1 (shard_dataset gives rank r the samples 2r and 2r + 1).
SCAN_INDICES = np.array([[0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 1, 1]])


def dp_worker(rank, world, store, out_dir):
    """One gloo rank: the DP step on the global batch of 4, then
    shard_dataset of 5 samples and two segments of the DP scan trainer;
    its results to out_dir/rank{rank}.npz."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    mesh = make_data_mesh(world, device="cpu", store_path=store)
    assert mesh.shape == {"data": world} and mesh.rank == rank
    o = O.sgd(1e-2)
    params = T.trainable_params(init_params(0, MODEL))
    batch = {k: torch.from_numpy(v) for k, v in tiny_data(4).items()}
    p1, _, loss, parts = make_dp_train_step(MODEL, S, o, mesh)(
        params, o.init(params), batch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        data = shard_dataset(tiny_data(5), mesh)
    # the scan trainer on given indices into each rank's shard (SGD)
    local = torch.from_numpy(SCAN_INDICES[:, 2 * rank:2 * rank + 2])
    s3, _, l_idx = make_dp_scan_train(MODEL, S, o, 2, mesh)(
        params, o.init(params), data, 3, indices=local)
    # ... and on its own draws (Adam)
    adam = O.adam(3e-3)
    run = make_dp_scan_train(MODEL, S, adam, 2, mesh)
    q = T.trainable_params(init_params(0, MODEL))
    st = adam.init(q)
    q, st, l1 = run(q, st, data, 6, seed=1)
    q, st, l2 = run(q, st, data, 6, seed=1, first_step=6)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             loss=loss.numpy(), l1=l1.numpy(), l2=l2.numpy(),
             l_idx=l_idx.numpy(),
             **{f"s_{k}": v.numpy() for k, v in s3.items()},
             shard=data["img"].shape[0], warned=len(caught),
             **{f"part_{k}": v.numpy() for k, v in parts.items()},
             **{f"p_{k}": v.numpy() for k, v in p1.items()},
             **{f"q_{k}": v.numpy() for k, v in q.items()})
    torch.distributed.destroy_process_group()


