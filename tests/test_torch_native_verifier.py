"""The port's own native verifier (`plonky2_torch/native/src/verifier.cc`,
`plonky2_torch.native.verifier_binary()`), on the CPU.

The binary is built once for the module, with g++, into
`plonky2_torch/build/verifier-<hash>/`. It accepts every committed fixture
under its flags: the Poseidon circuits, `keccak_factorial` (`--keccak`),
factorial's compressed proof (`--compressed`) and the two STARK proofs
(`--stark=fibonacci`, `--stark=permutation`); it rejects one tampered proof
of each kind; and it takes exactly `--stark` and `--stark=<air>`, so that
`--starkfoo` exits 2 where the reference's binary reads it as `--stark`.
A failed build raises.
"""

import os
import random
import subprocess

import pytest

from plonky2_tpu import native as jnative
from plonky2_torch import native

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "fixtures")
POSEIDON = ["factorial", "fibonacci", "range_check", "square_root", "bench_recursion"]
# (name, flags, files) of each accepted fixture
CASES = ([(n, [], [f"{n}.verifier.bin", f"{n}.proof.bin"]) for n in POSEIDON]
         + [("keccak_factorial", ["--keccak"],
             ["keccak_factorial.verifier.bin", "keccak_factorial.proof.bin"]),
            ("factorial_compressed", ["--compressed"],
             ["factorial.verifier.bin", "factorial.compressed.bin"]),
            ("starky_fibonacci", ["--stark=fibonacci"], ["starky_fibonacci.proof.bin"]),
            ("starky_permutation", ["--stark=permutation"], ["starky_permutation.proof.bin"])])


@pytest.fixture(scope="module")
def binary():
    path = native.verifier_binary()
    assert path.startswith(str(native.BUILD_ROOT))
    return path


def _run(binary, flags, paths):
    return subprocess.run([binary, *flags, *paths], capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("name,flags,files", CASES, ids=[c[0] for c in CASES])
def test_accepts_fixture(binary, name, flags, files):
    r = _run(binary, flags, [os.path.join(FIXTURES, f) for f in files])
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "OK"


@pytest.mark.parametrize("name,flags,files", CASES[:1] + CASES[-4:],
                         ids=[c[0] for c in CASES[:1] + CASES[-4:]])
def test_rejects_tampered_proof(binary, tmp_path, name, flags, files):
    """A flipped bit in the proof's body; its position drawn from a seed."""
    blob = bytearray(open(os.path.join(FIXTURES, files[-1]), "rb").read())
    pos = random.Random(sum(map(ord, name))).randrange(len(blob) // 4, len(blob))
    blob[pos] ^= 1
    bad = tmp_path / "tampered.bin"
    bad.write_bytes(bytes(blob))
    r = _run(binary, flags, [os.path.join(FIXTURES, f) for f in files[:-1]] + [str(bad)])
    assert r.returncode == 1, (pos, r.stdout, r.stderr)


def test_refuses_a_flag_that_only_starts_with_stark(binary):
    proof = os.path.join(FIXTURES, "starky_fibonacci.proof.bin")
    r = _run(binary, ["--starkfoo"], [proof])
    assert r.returncode == 2
    assert "unknown flag" in r.stderr
    assert _run(binary, ["--stark"], [proof]).returncode == 0
    assert _run(binary, ["--stark=nope"], [proof]).returncode == 2
    # the reference's binary takes the prefix as `--stark`
    assert _run(jnative.verifier_binary(), ["--starkfoo"], [proof]).returncode == 0


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path)
    broken = tmp_path / "broken.cc"
    broken.write_text("int main( {")
    monkeypatch.setattr(native, "VERIFIER_SRC", broken)
    with pytest.raises(RuntimeError, match="building the native verifier failed"):
        native.verifier_binary()
