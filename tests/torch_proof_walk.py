"""A field-by-field walk of a proof object, for proofs that have no byte
format: the Keccak-hashed Starky proof (the reference's
starky/serialization.py writes Poseidon caps only).

The walk visits a dataclass's fields in their declared order, each under
its name, and encodes what it meets with a type tag: a byte digest as its
bytes, an int as 8 little-endian bytes, a list or tuple as its length and
its items, None as itself. The two packages' proof classes have the same
fields, so the same proof gives the same walk in both. `digest` is the
sha256 of the whole walk; `field_digests` one sha256 for each field path
down to the first non-dataclass value (e.g. "proof.openings.local_values"),
so that a difference names its field. chip_smoke.py carries a copy of
`walk` (it imports nothing of the tests). Not collected by pytest.
"""

from __future__ import annotations

import dataclasses
import hashlib


def walk(x, h) -> None:
    """Feed `x`'s encoding to the hash object `h`."""
    if x is None:
        h.update(b"N")
    elif isinstance(x, (bytes, bytearray)):
        h.update(b"B" + len(x).to_bytes(4, "little") + bytes(x))
    elif dataclasses.is_dataclass(x):
        h.update(b"D")
        for f in dataclasses.fields(x):
            h.update(b"F" + len(f.name).to_bytes(4, "little") + f.name.encode())
            walk(getattr(x, f.name), h)
    elif isinstance(x, (list, tuple)):
        h.update(b"L" + len(x).to_bytes(4, "little"))
        for v in x:
            walk(v, h)
    elif hasattr(x, "tolist"):  # a numpy array or scalar
        walk(x.tolist(), h)
    elif isinstance(x, int):
        h.update(b"I" + (int(x) % (1 << 64)).to_bytes(8, "little"))
    else:
        raise TypeError(f"no walk of {type(x).__name__}")


def digest(x) -> str:
    h = hashlib.sha256()
    walk(x, h)
    return h.hexdigest()


def field_digests(x, path: str = "") -> dict:
    """{field path: sha256 of its walk}, in walk order."""
    if not dataclasses.is_dataclass(x):
        return {path: digest(x)}
    out = {}
    for f in dataclasses.fields(x):
        out.update(field_digests(getattr(x, f.name), f"{path}.{f.name}" if path else f.name))
    return out
