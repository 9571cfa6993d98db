"""Hand-written Hopper kernels (`csrc/`) and their wrappers.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs the plain
PyTorch version beside it, in the same module, for a CPU tensor; there is
no other fallback. `Kernel.launches` counts kernel launches, so a run can
show which kernels its path went through.
"""

from __future__ import annotations

import torch


class Kernel:
    """One CUDA kernel of the port (or one mode of it): where it lives,
    which TPU kernel it replaces, and how many times its wrapper launched
    it. `batch1` counts the launches on a single state (K5's transcript
    duplexes)."""

    def __init__(self, kid: str, name: str, source: str, replaces: str):
        self.kid = kid
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.batch1 = 0

    @property
    def label(self) -> str:
        return f"{self.kid} {self.name}"


K2 = Kernel("K2", "ntt_rows", "plonky2_torch/csrc/ntt.cu",
            "plonky2_tpu/ops/pallas_ntt.py:421")
K3 = Kernel("K3", "ntt_four_step", "plonky2_torch/csrc/ntt.cu",
            "plonky2_tpu/ops/pallas_ntt.py:524")
K4 = Kernel("K4", "merkle_tree", "plonky2_torch/csrc/poseidon.cu",
            "plonky2_tpu/ops/pallas_poseidon.py:203")
# K5's three modes: the permutation (the device transcript's duplexes among
# its launches), the host path's grind over one chunk of candidates, and
# the fused path's grind to the lowest valid witness on the device
K5 = Kernel("K5", "poseidon_permute", "plonky2_torch/csrc/poseidon.cu",
            "plonky2_tpu/ops/pallas_poseidon.py:288")
K5_CHUNK = Kernel("K5", "poseidon_grind_chunk", "plonky2_torch/csrc/poseidon.cu",
                  "plonky2_tpu/ops/pallas_poseidon.py:288")
K5_DEVICE = Kernel("K5", "poseidon_grind_device", "plonky2_torch/csrc/poseidon.cu",
                   "plonky2_tpu/ops/pallas_poseidon.py:288")
KERNELS = (K2, K3, K4, K5, K5_CHUNK, K5_DEVICE)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.batch1 = 0


def launch_counts() -> dict[str, int]:
    """Each kernel's launches since the last reset, by label."""
    return {k.label: k.launches for k in KERNELS}


def stream_ptr(t) -> int:
    """The current CUDA stream on `t`'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
