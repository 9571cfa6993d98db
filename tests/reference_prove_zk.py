"""The bench_recursion chain under the zero-knowledge config, made by the
reference on the CPU.

Runs `tests/reference_prove_sizes.py`'s flow (the three circuits built,
then each layer proved with the rng seeded to 2026 before its prove) at
inner 2^14 under `CircuitConfig.standard_recursion_zk_config()` for every
layer, as the reference's `run_chain(14, config=...)` does: the inner
circuit's 8,193 noop gates take 2,998 blinding rows and 3,000 blinded Z
pairs, so it has degree 2^15; the middle circuit verifies that salted
proof in circuit, and the outer circuit the middle's. Prints the sha256 of
each layer's verifier data and proof (chip_smoke's ZK_VERIFIER_SHA256S and
ZK_PROOF_SHA256S) and runs the reference's `plonky2_verify` on the last
proof. The times printed are the reference's on this host's CPU, not
device times. On an 8-core x86 CPU, beside another reference run, it took
~20 min (the builds 77, 66 and 29 s, the proves 379, 432 and 220 s) and a
peak of 7.9 GiB. Not collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prove_zk.py [--size 14] [--out DIR]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import reference_prove_sizes as rps  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--size", type=int, default=14)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    return rps.run(args.size, rps.CircuitConfig.standard_recursion_zk_config(),
                   f"zk{args.size}", args.out)


if __name__ == "__main__":
    sys.exit(main())
