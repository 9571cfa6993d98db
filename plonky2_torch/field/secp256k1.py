"""secp256k1 base and scalar fields: the non-FFT-friendly fields of ECDSA
gadgets (reference field/src/secp256k1_base.rs, secp256k1_scalar.rs; the
reference package's field/secp256k1.py). Host scalar arithmetic on exact
Python ints; no kernel touches them.
"""

from __future__ import annotations


class _PrimeField:
    """Generic prime-field scalar ops."""

    P: int
    TWO_ADICITY: int
    MULTIPLICATIVE_GROUP_GENERATOR: int
    POWER_OF_TWO_GENERATOR: int

    @classmethod
    def add(cls, a, b):
        return (a + b) % cls.P

    @classmethod
    def sub(cls, a, b):
        return (a - b) % cls.P

    @classmethod
    def neg(cls, a):
        return (-a) % cls.P

    @classmethod
    def mul(cls, a, b):
        return (a * b) % cls.P

    @classmethod
    def square(cls, a):
        return (a * a) % cls.P

    @classmethod
    def exp(cls, a, e):
        return pow(a, e, cls.P)

    @classmethod
    def inverse(cls, a):
        if a == 0:
            raise ZeroDivisionError
        return pow(a, cls.P - 2, cls.P)

    @classmethod
    def div(cls, a, b):
        return cls.mul(a, cls.inverse(b))

    @classmethod
    def sqrt(cls, a):
        """Tonelli-Shanks; None for non-residues."""
        if a == 0:
            return 0
        if pow(a, (cls.P - 1) // 2, cls.P) != 1:
            return None
        if cls.P % 4 == 3:
            return pow(a, (cls.P + 1) // 4, cls.P)
        s = cls.TWO_ADICITY
        q = (cls.P - 1) >> s
        m = s
        c = pow(cls.MULTIPLICATIVE_GROUP_GENERATOR, q, cls.P)
        t = pow(a, q, cls.P)
        r = pow(a, (q + 1) // 2, cls.P)
        while t != 1:
            t2, i = t, 0
            while t2 != 1:
                t2 = cls.mul(t2, t2)
                i += 1
            b = pow(c, 1 << (m - i - 1), cls.P)
            m, c = i, cls.mul(b, b)
            t, r = cls.mul(t, cls.mul(b, b)), cls.mul(r, b)
        return r

    @classmethod
    def primitive_root_of_unity(cls, n_log: int) -> int:
        assert 0 <= n_log <= cls.TWO_ADICITY
        return pow(cls.POWER_OF_TWO_GENERATOR, 1 << (cls.TWO_ADICITY - n_log), cls.P)


class Secp256k1Base(_PrimeField):
    """p = 2^256 - 2^32 - 977 (reference secp256k1_base.rs:84-104)."""

    P = (1 << 256) - (1 << 32) - 977
    TWO_ADICITY = 1
    MULTIPLICATIVE_GROUP_GENERATOR = 5
    POWER_OF_TWO_GENERATOR = P - 1  # NEG_ONE


class Secp256k1Scalar(_PrimeField):
    """Group order n (reference secp256k1_scalar.rs:84-104)."""

    P = int(
        "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141", 16
    )
    TWO_ADICITY = 6
    MULTIPLICATIVE_GROUP_GENERATOR = 7
    POWER_OF_TWO_GENERATOR = int(
        "0x0C1DC060E7A91986DF9879A3FBC483A898BDEAB680756045992F4B5402B052F2", 16
    )
