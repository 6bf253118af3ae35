"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Raises when no card is present and no device was named: the port never
    moves to the CPU on its own. Pass device="cpu" to run the plain
    versions on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def set_numeric_settings() -> None:
    """Full-float32 matmuls and convolutions, no cuDNN autotuning.

    The letterbox interpolation and the fp32 model path are held against
    the JAX package in float32, which TF32 (10-bit mantissa) would break;
    autotuning would spend the first frames trying algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
