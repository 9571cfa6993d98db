"""Central prover randomness (zk blinding salts), seedable for reproducible
proofs; the same draw API as the reference package's `util/rng.py`."""

from __future__ import annotations

import numpy as np

_rng: np.random.Generator = np.random.default_rng()


def seed(value: int | None) -> None:
    """Re-seed prover randomness. None restores OS entropy."""
    global _rng
    _rng = np.random.default_rng(value)


def rng() -> np.random.Generator:
    return _rng


def field_elements(n: int, p: int) -> np.ndarray:
    """n uniform canonical field elements as u64."""
    return _rng.integers(0, p, size=n, dtype=np.uint64)


def field_matrix(shape: tuple, p: int) -> np.ndarray:
    return _rng.integers(0, p, size=shape, dtype=np.uint64)
