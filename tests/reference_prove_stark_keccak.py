"""The Keccak-hashed Starky proves of chip_smoke's `stark_keccak` phase,
made by the reference.

Proves `FibonacciStark(2^k)` (public inputs [0, 1, fibonacci(2^k - 1, 0, 1)])
and `LookupTestStark(2^k)` (its own `generate_trace()`) under
`StarkConfig.standard_fast_config()` and `KeccakHasher` with the reference
package on the CPU, checks each with the reference's Keccak verifier, and
prints each proof's field-by-field digest (tests/torch_proof_walk.py: the
reference writes no bytes for a Keccak Starky proof) beside the
reference's prove and verify times (CPU times of this host, not device
times). At k = 20 (the default) the two digests are chip_smoke's
STARK_KECCAK_FIB20_DIGEST and STARK_KECCAK_LOOKUP20_DIGEST. At k = 5 they
are `plonky2_torch/data/stark_keccak.json`'s (tests/torch_make_data.py
--stark-keccak).

With `--port` the port proves the same traces on the CPU (its plain
kernels, the native keccak-f) and the script holds its walk to the
reference's; keep k small there. Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_stark_keccak.py
    JAX_PLATFORMS=cpu python tests/reference_prove_stark_keccak.py --log-rows 8 --port
"""

import argparse
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)

from plonky2_tpu.hash.hashers import KeccakHasher  # noqa: E402
from plonky2_tpu.starky.config import StarkConfig  # noqa: E402
from plonky2_tpu.starky.prover import prove  # noqa: E402
from plonky2_tpu.starky.verifier import verify_stark_proof  # noqa: E402
from reference_prove_stark import cases  # noqa: E402
from torch_proof_walk import digest, field_digests  # noqa: E402


def port_prove(name: str, log_rows: int, trace, pis):
    """The port's CPU prove of the same trace: (proof, seconds)."""
    from plonky2_torch.hash.hashers import KeccakHasher as TKeccakHasher
    from plonky2_torch.starky import fibonacci_stark, test_starks
    from plonky2_torch.starky.config import StarkConfig as TStarkConfig
    from plonky2_torch.starky.prover import prove as tprove
    from plonky2_torch.starky.verifier import verify_stark_proof as tverify

    stark = (fibonacci_stark.FibonacciStark(1 << log_rows) if name == "fibonacci"
             else test_starks.LookupTestStark(1 << log_rows))
    config = TStarkConfig.standard_fast_config()
    t = time.perf_counter()
    proof = tprove(stark, config, trace, pis, device="cpu", hasher=TKeccakHasher)
    seconds = time.perf_counter() - t
    tverify(stark, proof, config, hasher=TKeccakHasher)
    return proof, seconds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-rows", type=int, default=20)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    config = StarkConfig.standard_fast_config()
    ok = True
    for name, stark, trace, pis in cases(args.log_rows):
        t = time.perf_counter()
        proof = prove(stark, config, trace, pis, hasher=KeccakHasher)
        prove_s = time.perf_counter() - t
        t = time.perf_counter()
        verify_stark_proof(stark, proof, config, hasher=KeccakHasher)
        verify_s = time.perf_counter() - t
        print(f"{name} 2^{args.log_rows} Keccak: reference digest {digest(proof)}; "
              f"reference prove {prove_s:.1f} s, verify {verify_s:.2f} s (CPU times); "
              f"peak RSS {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB",
              flush=True)
        if args.port:
            port, port_s = port_prove(name, args.log_rows, trace, pis)
            same = field_digests(port) == field_digests(proof)
            ok &= same
            print(f"{name} 2^{args.log_rows} Keccak: port (plain, cpu) {port_s:.1f} s, "
                  f"digest {digest(port)}, equal to the reference's field by field: {same}; "
                  f"the port's verifier accepts it", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
