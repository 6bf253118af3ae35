"""Data-parallel training, after posebyte_tpu/parallel/train.py
(make_data_mesh, shard_dataset, make_dp_train_step, make_dp_scan_train).

PyTorch's idiom for it: one process per device in a torch.distributed
process group (NCCL between cards, gloo on the CPU), launched by torchrun
or torch.multiprocessing. The parameters and the optimizer state are
replicated: each rank computes the gradients of its share of the batch,
the gradients are summed over the group by one all-reduce and divided by
the world size, and every rank then runs the same optimizer update on the
same averaged gradients, so the replicas stay equal without a broadcast.

The JAX module's warning carries over: average the gradients exactly
once. Here that is the one all-reduce SUM followed by the one division by
the world size; wrapping the model in DistributedDataParallel as well
(which averages itself) would divide twice, and an all-reduce AVG on top
of the division likewise, leaving the update world-size times too small.
tests/test_torch_parallel.py holds a 2-rank step equal to one step on the
whole batch in one process.

Contract, as in JAX: one step over n ranks of a global batch B (B a
multiple of n, each rank taking its contiguous B / n) equals one
single-process step on the whole batch, up to the order of the sums.

No process group is created at import. make_data_mesh creates one when
none exists, from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK;
a single process without them), through a FileStore under build/, never
a network address.
"""
from __future__ import annotations

import dataclasses
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..models.optim import apply_updates, flatten, unflatten
from ..models.train import loss_and_grads

__all__ = ["make_data_mesh", "make_dp_train_step", "make_dp_scan_train",
           "shard_dataset"]

STORE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "dp")


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the ``data`` axis: its rank of world_size,
    its device and the process group."""
    rank: int
    world_size: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> dict:
        return {"data": self.world_size}


def _default_store() -> str:
    run = os.environ.get("TORCHELASTIC_RUN_ID", "")
    port = os.environ.get("MASTER_PORT", "")
    name = f"{run}-{port}" if run or port else f"pid{os.getpid()}"
    return os.path.join(STORE_DIR, f"{name}.store")


def make_data_mesh(n_devices: int | None = None, device=None,
                   store_path: str | None = None) -> DataMesh:
    """The ``data`` axis over the processes of a group. Uses the process
    group that exists, else creates one: rank and world size from
    torchrun's environment (RANK, WORLD_SIZE; 0 and 1 without them),
    NCCL on the card (device LOCAL_RANK) or gloo on the CPU (device="cpu"),
    rendezvous by a FileStore at store_path (default under build/dp/, one
    file per torchrun launch). n_devices, where given, must equal the
    world size."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for gloo on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0))
        world = int(os.environ.get("WORLD_SIZE", 1))
        path = store_path or _default_store()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        store = dist.FileStore(path, world)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo", store=store,
            rank=rank, world_size=world)
    mesh = DataMesh(dist.get_rank(), dist.get_world_size(), device,
                    dist.group.WORLD)
    if n_devices is not None and n_devices != mesh.world_size:
        raise ValueError(f"--dp {n_devices} but the process group has "
                         f"{mesh.world_size} ranks")
    return mesh


def shard_dataset(data: dict, mesh: DataMesh) -> dict:
    """This rank's contiguous share of a host dataset ({k: [N, ...]}) on
    its device. N is trimmed to a multiple of the world size, with a
    warning when samples are dropped."""
    n_dev = mesh.world_size
    out = {}
    for k, v in data.items():
        n = (v.shape[0] // n_dev) * n_dev
        if n != v.shape[0]:
            warnings.warn(
                f"shard_dataset: trimming '{k}' from {v.shape[0]} to {n} "
                f"samples ({v.shape[0] - n} dropped) to divide evenly "
                f"over {n_dev} devices", stacklevel=2)
        per = n // n_dev
        out[k] = torch.as_tensor(np.ascontiguousarray(
            v[mesh.rank * per:(mesh.rank + 1) * per])).to(mesh.device)
    return out


def _averaged(loss, parts, grads, mesh: DataMesh):
    """The group's mean loss, parts and gradients: one all-reduce SUM of
    one flat tensor (gradients, then loss and parts), then one division
    by the world size."""
    keys = list(parts)
    flat = torch.cat([flatten(grads), loss.reshape(1),
                      torch.stack([parts[k] for k in keys])])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = flat / mesh.world_size
    n = flat.numel() - 1 - len(keys)
    grads = unflatten(flat[:n], grads)
    return flat[n], dict(zip(keys, flat[n + 1:])), grads


def _dp_update(model_name: str, input_size: int, optimizer,
               mesh: DataMesh):
    """update(params, opt_state, local) -> (params, opt_state, loss,
    parts): this rank's gradients of its local batch, averaged over the
    group once (_averaged), then the same optimizer update on every
    rank."""
    def update(params, opt_state, local):
        loss, parts, grads = loss_and_grads(params, local, model_name,
                                            input_size)
        loss, parts, grads = _averaged(loss, parts, grads, mesh)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss, parts

    return update


def make_dp_train_step(model_name: str, input_size: int, optimizer,
                       mesh: DataMesh):
    """Returns step(params, opt_state, batch) -> (params, opt_state, loss,
    parts). `batch` is the GLOBAL batch (dict of [B, ...] on this rank's
    device, the same on every rank); B must divide by the world size
    (ValueError). Each rank grads its share, the gradients are averaged
    over the group, and the same update runs on every rank."""
    update = _dp_update(model_name, input_size, optimizer, mesh)

    def step(params, opt_state, batch):
        B = next(iter(batch.values())).shape[0]
        if B % mesh.world_size:
            raise ValueError(f"batch {B} does not divide over "
                             f"{mesh.world_size} ranks")
        per = B // mesh.world_size
        return update(params, opt_state,
                      {k: v[mesh.rank * per:(mesh.rank + 1) * per]
                       for k, v in batch.items()})

    return step


def step_generator(seed: int, step: int, rank: int,
                   device) -> torch.Generator:
    """The generator a rank draws step `step`'s batch from, seeded from
    (seed, step, rank) as JAX folds the axis index into the step's key."""
    s = np.random.SeedSequence([seed, step, rank]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def make_dp_scan_train(model_name: str, input_size: int, optimizer,
                       batch_per_device: int, mesh: DataMesh):
    """Returns run(params, opt_state, data, steps, seed=0, first_step=0,
    indices=None) -> (params, opt_state, losses [steps]): `steps` DP
    steps, each rank drawing batch_per_device rows of ITS shard (data:
    shard_dataset's dict) with step_generator(seed, first_step + i, rank),
    or taking them from indices [steps, batch_per_device]. The effective
    global batch is batch_per_device * world size. The losses (the
    group's mean) stay on the device."""
    update = _dp_update(model_name, input_size, optimizer, mesh)

    def run(params, opt_state, data, steps, seed=0, first_step=0,
            indices=None):
        n_local = next(iter(data.values())).shape[0]
        losses = []
        for i in range(steps):
            if indices is None:
                g = step_generator(seed, first_step + i, mesh.rank,
                                   mesh.device)
                sel = torch.randint(0, n_local, (batch_per_device,),
                                    generator=g, device=mesh.device)
            else:
                sel = indices[i]
            params, opt_state, loss, _ = update(
                params, opt_state,
                {k: v.index_select(0, sel) for k, v in data.items()})
            losses.append(loss)
        return params, opt_state, torch.stack(losses)

    return run
