"""Middle-shape check of the port against the reference on the CPU.

Runs `commit_and_open` at the bench_recursion middle-circuit shapes
(degree 2^13, oracles of 85/135/20/16 polynomials, arities (4, 4), 16 PoW
bits, 28 queries, seed 2026) through the port's plain path on the CPU and
through the reference package's host-transcript path, and prints both
proofs' sha256. `chip_smoke.py` prints the sha256 of the same proof made by
the CUDA kernels on the card, so the three can be compared. Takes a few
minutes and about 2 GB of memory; not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_middle.py
"""

import hashlib
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)
import test_torch_fri  # noqa: E402
from plonky2_tpu.fri.config import FriConfig, FriReductionStrategy  # noqa: E402
from plonky2_tpu.util import export_cache  # noqa: E402
from plonky2_torch.examples import commit_and_open as co  # noqa: E402

SEED = 2026  # the seed chip_smoke.py uses for its middle-shape run


def main() -> int:
    inputs = co.random_inputs(co.MIDDLE_DEGREE_BITS, co.MIDDLE_COUNTS, seed=SEED)
    t = time.perf_counter()
    port = co.commit_and_open(inputs, co.middle_fri_config(), device="cpu")
    print(f"port (plain, cpu): {time.perf_counter() - t:.1f} s, {len(port)} bytes, "
          f"sha256 {hashlib.sha256(port).hexdigest()}", flush=True)
    export_cache._ENABLED = False
    config = FriConfig(rate_bits=3, cap_height=4, proof_of_work_bits=16,
                       reduction_strategy=FriReductionStrategy.ConstantArityBits(4, 5),
                       num_query_rounds=28)
    t = time.perf_counter()
    ref = test_torch_fri._reference_commit_and_open(inputs, config)
    print(f"reference (host path, cpu): {time.perf_counter() - t:.1f} s, {len(ref)} bytes, "
          f"sha256 {hashlib.sha256(ref).hexdigest()}")
    print("identical" if ref == port else "DIFFERENT")
    return 0 if ref == port else 1


if __name__ == "__main__":
    sys.exit(main())
