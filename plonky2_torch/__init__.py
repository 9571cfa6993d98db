"""plonky2_torch: the PyTorch/CUDA port of plonky2_tpu for one NVIDIA H100.

Field elements are int64 tensors holding the uint64 bit patterns of
canonical Goldilocks residues (torch's uint64 lacks add, sub, shifts and
compares on the CPU). Hand-written Hopper kernels live in `csrc/` and are
reached through `ops/`; every kernel has a plain PyTorch version beside it,
which runs for CPU tensors.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is wanted and absent (no silent CPU fallback)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device; pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def device_key(device) -> torch.device:
    """`device` with its index: a card named without one ("cuda") is the
    current card, so per-device caches keep one entry a card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device
