"""Byte-exact proof serialization, up to the FRI proof, both ways (all
integers little-endian): field element = canonical u64; extension element =
its D coordinates; digest = 4 field elements, or under Keccak its
HASH_SIZE raw bytes; Merkle cap = its digests with no length prefix; Merkle
proof = u8 sibling count then digests; FRI proof = commit-phase caps, query
rounds, final polynomial, PoW witness. The reader takes the shapes from the
FRI parameters, as the reference's does, and the digest form from its
`hasher` (Poseidon unless set)."""

from __future__ import annotations

import struct

from plonky2_torch.fri.proof import FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep
from plonky2_torch.hash.merkle import MerkleProof


class Writer:
    def __init__(self):
        self.buf = bytearray()

    def write_u8(self, x: int) -> None:
        self.buf.append(x)

    def write_usize(self, x: int) -> None:
        self.buf += struct.pack("<Q", x)

    def write_field(self, x: int) -> None:
        self.buf += struct.pack("<Q", x)

    def write_field_vec(self, v) -> None:
        for x in v:
            self.write_field(x)

    def write_field_ext(self, x) -> None:
        for c in x:
            self.write_field(c)

    def write_field_ext_vec(self, v) -> None:
        for x in v:
            self.write_field_ext(x)

    def write_hash(self, h) -> None:
        if isinstance(h, (bytes, bytearray)):
            self.buf += bytes(h)  # a BytesHash's raw bytes
        else:
            self.write_field_vec(h)

    def write_merkle_cap(self, cap) -> None:
        for h in cap:
            self.write_hash(h)

    def write_merkle_proof(self, p: MerkleProof) -> None:
        self.write_u8(len(p.siblings))
        for h in p.siblings:
            self.write_hash(h)

    def write_fri_proof(self, fp: FriProof) -> None:
        for cap in fp.commit_phase_merkle_caps:
            self.write_merkle_cap(cap)
        for fqr in fp.query_round_proofs:
            for v, p in fqr.initial_trees_proof.evals_proofs:
                self.write_field_vec(v)
                self.write_merkle_proof(p)
            for fqs in fqr.steps:
                self.write_field_ext_vec(fqs.evals)
                self.write_merkle_proof(fqs.merkle_proof)
        self.write_field_ext_vec(fp.final_poly)
        self.write_field(fp.pow_witness)


class Reader:
    def __init__(self, data: bytes, hasher=None):
        self.data = data
        self.pos = 0
        self.hasher = hasher

    def read_u8(self) -> int:
        x = self.data[self.pos]
        self.pos += 1
        return x

    def read_usize(self) -> int:
        (x,) = struct.unpack_from("<Q", self.data, self.pos)
        self.pos += 8
        return x

    read_field = read_usize

    def read_field_vec(self, n: int) -> list[int]:
        out = list(struct.unpack_from(f"<{n}Q", self.data, self.pos))
        self.pos += 8 * n
        return out

    def read_field_ext_vec(self, n: int) -> list[tuple]:
        flat = self.read_field_vec(2 * n)
        return list(zip(flat[::2], flat[1::2]))

    def read_hash(self) -> list[int] | bytes:
        if not getattr(self.hasher, "algebraic", True):
            out = bytes(self.data[self.pos:self.pos + self.hasher.HASH_SIZE])
            self.pos += self.hasher.HASH_SIZE
            return out
        return self.read_field_vec(4)

    def read_merkle_cap(self, cap_height: int) -> list:
        return [self.read_hash() for _ in range(1 << cap_height)]

    def read_merkle_proof(self) -> MerkleProof:
        return MerkleProof(siblings=[self.read_hash() for _ in range(self.read_u8())])

    def read_fri_proof(self, num_leaves_per_oracle, params) -> FriProof:
        caps = [self.read_merkle_cap(params.config.cap_height)
                for _ in params.reduction_arity_bits]
        rounds = []
        for _ in range(params.config.num_query_rounds):
            evals_proofs = [(self.read_field_vec(n), self.read_merkle_proof())
                            for n in num_leaves_per_oracle]
            steps = [FriQueryStep(evals=self.read_field_ext_vec(1 << arity_bits),
                                  merkle_proof=self.read_merkle_proof())
                     for arity_bits in params.reduction_arity_bits]
            rounds.append(FriQueryRound(
                initial_trees_proof=FriInitialTreeProof(evals_proofs=evals_proofs),
                steps=steps))
        final_poly = self.read_field_ext_vec(params.final_poly_len())
        return FriProof(commit_phase_merkle_caps=caps, query_round_proofs=rounds,
                        final_poly=final_poly, pow_witness=self.read_field())
