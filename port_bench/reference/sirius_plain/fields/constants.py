"""Field and curve constants for the supported 2-cycles.

The port's own copy of `sirius_tpu/fields/constants.py` (the port imports
nothing of the JAX package).  Curve/field parameters mirror the reference's
curve suite (halo2curves bn256/grumpkin and pasta), defined from the
published curve specifications.

All values are plain Python ints; the device word tables are derived in
`jfield.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

# ---------------------------------------------------------------------------
# Limb geometry: every field element is 16 little-endian 16-bit limbs
# (256 bits of storage for <= 255-bit primes), stored as uint32 on device.
# Montgomery radix R = 2^256.
# ---------------------------------------------------------------------------
NUM_LIMBS = 16
LIMB_BITS = 16
MONT_BITS = NUM_LIMBS * LIMB_BITS  # 256
MONT_R = 1 << MONT_BITS


@dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field (host-side ints only)."""

    name: str
    modulus: int
    # multiplicative generator of F*, matching halo2curves' `GENERATOR`
    generator: int
    # 2-adicity: modulus - 1 = 2^s * odd
    two_adicity: int

    @property
    def num_bits(self) -> int:
        return self.modulus.bit_length()

    @property
    def root_of_unity(self) -> int:
        """2^s-th primitive root of unity = generator^((p-1)/2^s) mod p.

        Matches halo2curves' `ROOT_OF_UNITY` (used by reference `src/fft.rs:12-23`).
        """
        return pow(self.generator, (self.modulus - 1) >> self.two_adicity, self.modulus)

    @property
    def r_mod_p(self) -> int:
        return MONT_R % self.modulus

    @property
    def r2_mod_p(self) -> int:
        return (MONT_R * MONT_R) % self.modulus

    @property
    def n0_inv(self) -> int:
        """-modulus^{-1} mod 2^LIMB_BITS (Montgomery n' for limb radix)."""
        return (-pow(self.modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)

    @property
    def zeta(self) -> int:
        """Coset generator for coset FFT.

        halo2curves uses `ZETA` (a primitive cube root of unity) for coset FFT;
        the reference's coset fft multiplies by `F::ZETA` powers
        (`src/fft.rs:186-228`). We define zeta = generator^((p-1)/3) when
        3 | p-1, which matches the cube-root-of-unity convention.
        """
        assert (self.modulus - 1) % 3 == 0
        return pow(self.generator, (self.modulus - 1) // 3, self.modulus)


# ---------------------------------------------------------------------------
# bn256 (BN254): G1 over Fq, scalar field Fr.  y^2 = x^3 + 3, g = (1, 2).
# grumpkin: curve over Fr with scalar field Fq (forms a 2-cycle with bn256).
#           y^2 = x^3 - 17, g = (1, sqrt(-16)).
# ---------------------------------------------------------------------------
BN256_FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583
BN256_FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

bn256_fq = FieldSpec("bn256_fq", BN256_FQ_MODULUS, generator=3, two_adicity=1)
bn256_fr = FieldSpec("bn256_fr", BN256_FR_MODULUS, generator=7, two_adicity=28)

# ---------------------------------------------------------------------------
# pasta (pallas / vesta): 2-cycle used by reference tests.
#   Ep (pallas): base Fp, scalar Fq;  Eq (vesta): base Fq, scalar Fp.
#   y^2 = x^3 + 5, generator (-1, 2) in halo2curves.
# ---------------------------------------------------------------------------
PASTA_FP_MODULUS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
PASTA_FQ_MODULUS = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

pasta_fp = FieldSpec("pasta_fp", PASTA_FP_MODULUS, generator=5, two_adicity=32)
pasta_fq = FieldSpec("pasta_fq", PASTA_FQ_MODULUS, generator=5, two_adicity=32)


@dataclass(frozen=True)
class CurveSpec:
    """Short Weierstrass curve y^2 = x^3 + a*x + b over `base`, order `scalar`."""

    name: str
    base: FieldSpec
    scalar: FieldSpec
    a: int
    b: int
    gx: int
    gy: int

    def __post_init__(self):
        p = self.base.modulus
        assert (self.gy * self.gy - (self.gx**3 + self.a * self.gx + self.b)) % p == 0


def _sqrt_mod(a: int, p: int) -> int:
    """Tonelli-Shanks square root (host-side, setup only)."""
    if a == 0:
        return 0
    assert pow(a, (p - 1) // 2, p) == 1, "not a QR"
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general Tonelli-Shanks
    s, q = 0, p - 1
    while q % 2 == 0:
        s += 1
        q //= 2
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2i = 0, t
        while t2i != 1:
            t2i = t2i * t2i % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c, t, r = i, b * b % p, t * b * b % p, r * b % p
    return r


@lru_cache(maxsize=None)
def _grumpkin_gy() -> int:
    """grumpkin generator y with x = 1: y = sqrt(1 - 17) = sqrt(-16) mod r.

    halo2curves picks y = 17631683881184975370165255887551781615748388533673675138860
    (the even... the canonical published value); we compute the root and select
    the published one explicitly.
    """
    r = BN256_FR_MODULUS
    y = _sqrt_mod((-16) % r, r)
    published = 17631683881184975370165255887551781615748388533673675138860
    if y != published:
        y = r - y
    assert y == published, "grumpkin generator derivation mismatch"
    return y


bn256_g1 = CurveSpec("bn256_g1", base=bn256_fq, scalar=bn256_fr, a=0, b=3, gx=1, gy=2)
grumpkin = CurveSpec(
    "grumpkin",
    base=bn256_fr,
    scalar=bn256_fq,
    a=0,
    b=(-17) % BN256_FR_MODULUS,
    gx=1,
    gy=_grumpkin_gy(),
)

# pasta generators: halo2curves pasta uses g = (-1, 2) for both curves.
pallas = CurveSpec(
    "pallas",
    base=pasta_fp,
    scalar=pasta_fq,
    a=0,
    b=5,
    gx=PASTA_FP_MODULUS - 1,
    gy=2,
)
vesta = CurveSpec(
    "vesta",
    base=pasta_fq,
    scalar=pasta_fp,
    a=0,
    b=5,
    gx=PASTA_FQ_MODULUS - 1,
    gy=2,
)

