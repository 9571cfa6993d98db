"""The reference's multi-chip dry-run step, for chip_smoke's `multigpu` phase.

Runs `plonky2_tpu.parallel.sharded_prover_step` on an 8-device CPU mesh
(its default shapes and `rng(0)` inputs) and prints the sha256 of its cap
[4, 4] and Z [64] as u64 little-endian bytes, cap first: chip_smoke's
PROVER_STEP_SHA256, which `plonky2_torch.parallel.sharded_prover_step`
must give on every rank. With `--port` the port's function then runs as
one gloo rank on this CPU and the script holds it to the same hash. Not
collected by pytest.

    JAX_PLATFORMS=cpu python tests/reference_prover_step.py [--port]
"""

import hashlib
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def step_sha256(cap, z) -> str:
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(cap, dtype=np.uint64).tobytes()
                          + np.ascontiguousarray(z, dtype=np.uint64).tobytes()).hexdigest()


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from plonky2_tpu.parallel import make_mesh, sharded_prover_step

    cap, z = sharded_prover_step(make_mesh())
    want = step_sha256(np.asarray(cap), np.asarray(z))
    print(f"reference sharded_prover_step on {len(jax.devices())} CPU devices: {want}")
    if "--port" in sys.argv[1:]:
        from plonky2_torch import parallel
        from plonky2_torch.field import goldilocks as g

        with parallel.local_group("gloo") as group:
            got = step_sha256(*(g.to_numpy(t) for t in parallel.sharded_prover_step(group)))
        print(f"port sharded_prover_step, one gloo rank: {got}")
        return 0 if got == want else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
