"""The Starky proves of chip_smoke's `starky` phase, made by the reference.

Proves `FibonacciStark(2^k)` (public inputs [0, 1, fibonacci(2^k - 1, 0, 1)])
and `LookupTestStark(2^k)` (its own `generate_trace()`, numpy seed 0) under
`StarkConfig.standard_fast_config()` with the reference package on the CPU,
checks each with the reference's verifier, and prints each proof's size and
sha256 beside the reference's prove and verify times (CPU times of this
host, not device times). At k = 20 (the default) the two hashes are
chip_smoke's FIB20_PROOF_SHA256 and LOOKUP20_PROOF_SHA256; each prove takes
a few minutes, most of it tracing and compiling, and a few GB of memory.

With `--port` the port proves the same traces on the CPU (its plain
kernels) and the script holds its bytes to the reference's and runs the
port's verifier; keep k small there (the plain Poseidon tree is slow).
Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_stark.py
    JAX_PLATFORMS=cpu python tests/reference_prove_stark.py --log-rows 12 --port
"""

import argparse
import hashlib
import os
import resource
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import conftest  # noqa: E402,F401  (JAX on the CPU, x64)

from plonky2_tpu.starky.config import StarkConfig  # noqa: E402
from plonky2_tpu.starky.fibonacci_stark import FibonacciStark, fibonacci  # noqa: E402
from plonky2_tpu.starky.prover import prove  # noqa: E402
from plonky2_tpu.starky.serialization import stark_proof_to_bytes  # noqa: E402
from plonky2_tpu.starky.test_starks import LookupTestStark  # noqa: E402
from plonky2_tpu.starky.verifier import verify_stark_proof  # noqa: E402


def sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def cases(log_rows: int):
    """(name, reference stark, trace, public inputs) of the two proves."""
    n = 1 << log_rows
    fib = FibonacciStark(n)
    pis = [0, 1, fibonacci(n - 1, 0, 1)]
    lookup = LookupTestStark(n)
    return [("fibonacci", fib, fib.generate_trace(pis[0], pis[1]), pis),
            ("lookup", lookup, lookup.generate_trace(), [])]


def port_prove(name: str, log_rows: int, trace, pis):
    """The port's CPU prove of the same trace: (bytes, seconds, verified)."""
    from plonky2_torch.starky import fibonacci_stark, test_starks
    from plonky2_torch.starky.config import StarkConfig as TStarkConfig
    from plonky2_torch.starky.prover import prove as tprove
    from plonky2_torch.starky.serialization import stark_proof_to_bytes as t_to_bytes
    from plonky2_torch.starky.verifier import verify_stark_proof as tverify

    stark = (fibonacci_stark.FibonacciStark(1 << log_rows) if name == "fibonacci"
             else test_starks.LookupTestStark(1 << log_rows))
    config = TStarkConfig.standard_fast_config()
    t = time.perf_counter()
    proof = tprove(stark, config, trace, pis, device="cpu")
    seconds = time.perf_counter() - t
    tverify(stark, proof, config)
    return t_to_bytes(proof, config), seconds


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-rows", type=int, default=20)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    config = StarkConfig.standard_fast_config()
    ok = True
    for name, stark, trace, pis in cases(args.log_rows):
        t = time.perf_counter()
        proof = prove(stark, config, trace, pis)
        prove_s = time.perf_counter() - t
        t = time.perf_counter()
        verify_stark_proof(stark, proof, config)
        verify_s = time.perf_counter() - t
        blob = stark_proof_to_bytes(proof, config)
        print(f"{name} 2^{args.log_rows}: reference proof {len(blob)} bytes, sha256 "
              f"{sha(blob)}; reference prove {prove_s:.1f} s, verify {verify_s:.2f} s "
              f"(CPU times); peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f} GiB",
              flush=True)
        if args.port:
            port, port_s = port_prove(name, args.log_rows, trace, pis)
            same = port == blob
            ok &= same
            print(f"{name} 2^{args.log_rows}: port (plain, cpu) {port_s:.1f} s, sha256 "
                  f"{sha(port)}, equal to the reference's: {same}; the port's verifier "
                  f"accepts it", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
