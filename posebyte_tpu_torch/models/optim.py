"""The optimizers the trainers use, in plain PyTorch with optax's
arithmetic (optax 0.2: clip_by_global_norm, adam, adamw, sgd, chain and
warmup_cosine_decay_schedule), so that the port's training steps follow
the JAX package's.

A transformation works as optax's does: init(params) -> state and
update(grads, state, params) -> (updates, state), the parameters a dict of
float32 tensors and the update added to them (apply_updates). Inside, the
leaves are concatenated into one flat tensor, so an update is a few
kernels whatever the number of leaves. Every decision stays on the
device (the clip is a torch.where on the norm), and the step counts are
host integers, so a training loop never waits for the device.

Where torch.optim differs from optax, this module follows optax:
- the clip scales by max_norm / norm only where norm >= max_norm, and
  divides by the norm itself (clip_grad_norm_ divides by norm + 1e-6 and
  always scales);
- a schedule is read at the count before the update, from 0;
- adamw's weight decay applies to every leaf, biases included, and is
  added to Adam's update before the learning rate scales it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


def flatten(tree: dict) -> torch.Tensor:
    """A dict of tensors -> one flat float32 tensor, in the dict's order."""
    return torch.cat([v.reshape(-1).float() for v in tree.values()])


def unflatten(flat: torch.Tensor, like: dict) -> dict:
    """flatten's inverse: views of `flat` shaped as the leaves of `like`."""
    sizes = [v.numel() for v in like.values()]
    return {k: part.view(v.shape) for (k, v), part
            in zip(like.items(), torch.split(flat, sizes))}


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, leaf by leaf (optax.apply_updates)."""
    keys = list(params)
    new = torch._foreach_add([params[k] for k in keys],
                             [updates[k] for k in keys])
    return dict(zip(keys, new))


@dataclasses.dataclass(frozen=True)
class GradientTransformation:
    """init(params) -> state; update(grads, state, params) -> (updates,
    state). `init_flat` and `update_flat` work on flatten's tensors."""
    init_flat: Callable
    update_flat: Callable

    def init(self, params: dict):
        return self.init_flat(flatten(params))

    def update(self, grads: dict, state, params: dict | None = None):
        p = None if params is None else flatten(params)
        u, state = self.update_flat(flatten(grads), state, p)
        return unflatten(u, grads), state


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    """Apply the transformations in order (optax.chain)."""
    def init(p):
        return tuple(t.init_flat(p) for t in transforms)

    def update(g, state, p):
        new = []
        for t, s in zip(transforms, state):
            g, s = t.update_flat(g, s, p)
            new.append(s)
        return g, tuple(new)

    return GradientTransformation(init, update)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax.clip_by_global_norm: where the norm of all the gradients is
    at least max_norm, each becomes (g / norm) * max_norm."""
    def update(g, state, p):
        norm = torch.sqrt(torch.sum(g * g))
        return torch.where(norm < max_norm, g, (g / norm) * max_norm), state

    return GradientTransformation(lambda p: (), update)


def _f32(x) -> float:
    return float(np.float32(x))


def _scale_by_schedule(schedule) -> GradientTransformation:
    """Multiply by -schedule(count), count from 0 before the update
    (optax.scale_by_learning_rate)."""
    if not callable(schedule):
        lr = schedule
        schedule = lambda count: lr    # noqa: E731

    def update(g, count, p):
        return g * -_f32(schedule(count)), count + 1

    return GradientTransformation(lambda p: 0, update)


# Adam's constants, optax's defaults (no trainer sets others).
B1, B2, EPS = 0.9, 0.999, 1e-8


def _scale_by_adam() -> GradientTransformation:
    """optax.scale_by_adam (eps_root 0, no Nesterov): the moments'
    exponential averages, bias-corrected by 1 - b ** count in float32."""
    def init(p):
        return (0, torch.zeros_like(p), torch.zeros_like(p))

    def update(g, state, p):
        count, mu, nu = state
        mu = (1 - B1) * g + B1 * mu
        nu = (1 - B2) * (g * g) + B2 * nu
        count += 1
        c = np.float32(count)
        bc1 = np.float32(1) - np.float32(B1) ** c
        bc2 = np.float32(1) - np.float32(B2) ** c
        u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + EPS)
        return u, (count, mu, nu)

    return GradientTransformation(init, update)


def _add_decayed_weights(weight_decay: float) -> GradientTransformation:
    def update(g, state, p):
        return g + weight_decay * p, state

    return GradientTransformation(lambda p: (), update)


def sgd(learning_rate) -> GradientTransformation:
    """optax.sgd without momentum: -lr * g."""
    return _scale_by_schedule(learning_rate)


def adam(learning_rate) -> GradientTransformation:
    return chain(_scale_by_adam(), _scale_by_schedule(learning_rate))


def adamw(learning_rate, weight_decay: float) -> GradientTransformation:
    """optax.adamw with no mask: Adam's update plus weight_decay * p on
    every leaf, then times -lr."""
    return chain(_scale_by_adam(),
                 _add_decayed_weights(weight_decay),
                 _scale_by_schedule(learning_rate))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable:
    """optax.warmup_cosine_decay_schedule in float32: linear from
    init_value to peak_value over warmup_steps, then cosine decay to
    end_value at decay_steps."""
    f = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def linear(count):
        if warmup_steps <= 0:
            return f(init_value)
        frac = f(1) - f(min(max(count, 0), warmup_steps)) / f(warmup_steps)
        return f(init_value - peak_value) * frac + f(peak_value)

    def cosine(count):
        t = f(min(count, cos_steps))
        decay = f(0.5) * (f(1) + f(math.cos(f(math.pi) * t / f(cos_steps))))
        return f(peak_value) * (f(1 - alpha) * decay + f(alpha))

    def schedule(count: int):
        return linear(count) if count < warmup_steps \
            else cosine(count - warmup_steps)

    return schedule
