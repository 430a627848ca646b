"""Field and curve constants for ark-curve25519 (the reference's group).

The reference instantiates every protocol over `ark_curve25519::EdwardsProjective`
(twisted Edwards form of Curve25519) with scalar field Fr = Z/ell
(e.g. reference src/e2e_test.rs:1).

Limb layout for the TPU kernels: 16 limbs x 16 bits, little-endian, stored in
(u)int32 lanes.  16-bit limbs are the sweet spot for the TPU's 32-bit VPU:
a limb product fits a u32 exactly and 32 partial products accumulate without
overflow, so schoolbook multiplication + Montgomery REDC vectorize with no
64-bit emulation.
"""

# Base field: p = 2^255 - 19
P = 2**255 - 19

# Scalar field (subgroup order): ell = 2^252 + delta
FR = 2**252 + 27742317777372353535851937790883648493

# Twisted Edwards coefficients: a*x^2 + y^2 = 1 + d*x^2*y^2
# (ark-curve25519 Curve25519Config; a is a QR mod p and d a non-QR, which
#  makes the unified addition law complete -- verified in tests.)
CURVE_A = 486664
CURVE_D = 486660

COFACTOR = 8

# Subgroup generator (matches ark-curve25519 GENERATOR_{X,Y}; y = 4/5 mod p).
GENERATOR_X = 38213832894368730265794714087330135568483813637251082400757400312561599933396
GENERATOR_Y = 46316835694926478169428394003475163141307993866256225615783033603165251855960

# Limb layout
LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1

# Montgomery parameters (R = 2^256)
R_BITS = LIMB_BITS * NUM_LIMBS
R_MONT = 1 << R_BITS

# Modulus bit sizes (ark: MODULUS_BIT_SIZE)
P_BITS = 255
FR_BITS = 253


def limbs_of(x: int, n: int = NUM_LIMBS, bits: int = LIMB_BITS) -> list[int]:
    mask = (1 << bits) - 1
    return [(x >> (bits * i)) & mask for i in range(n)]


def from_limbs(limbs, bits: int = LIMB_BITS) -> int:
    x = 0
    for i, limb in enumerate(limbs):
        x |= int(limb) << (bits * i)
    return x
