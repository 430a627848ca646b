// 256-bit Montgomery field arithmetic shared by the port's CUDA kernels.
//
// Elements are 8 little-endian 32-bit words with 64-bit products.  The
// Montgomery radix is R = 2^256, the same as the JAX package's 16x16-bit
// layout: for a given product a*b the reduction multiple m is the unique
// value in [0, R) with a*b + m*p = 0 (mod R), whatever the limb width, so
// the result of one word-by-word REDC plus one conditional subtract of p is
// identical, limb for limb once repacked to 16-bit limbs, to the reference
// kernel's (lasso_tpu/ops/field_pallas.py:_mont_mul_body).
//
// The port's tensors hold 16-bit limbs in int32; load16/store16 pack two
// limbs into each 32-bit word and back.
//
// Everything here is __host__ __device__ and uses no CUDA intrinsics, so a
// host compiler can build it as well.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define F256_HD __host__ __device__ __forceinline__
#else
#define F256_HD inline
#endif

namespace f256 {

constexpr int N = 8;  // 32-bit words per element

struct Modulus {
  uint32_t p[N];
  uint32_t n0;  // -p^{-1} mod 2^32
};

// Twisted Edwards curve over Fp: a*x^2 + y^2 = 1 + d*x^2*y^2.
struct Curve {
  Modulus fp;
  uint32_t a[N];  // a * 2^256 mod p (Montgomery form)
  uint32_t d[N];  // d * 2^256 mod p
};

// Fr = 2^252 + 27742317777372353535851937790883648493 (curve25519's scalar field)
F256_HD Modulus fr_modulus() {
  return Modulus{{0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                  0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u},
                 0x12547e1bu};
}

// Fp = 2^255 - 19 (curve25519's base field)
F256_HD Modulus fp_modulus() {
  return Modulus{{0xffffffedu, 0xffffffffu, 0xffffffffu, 0xffffffffu,
                  0xffffffffu, 0xffffffffu, 0xffffffffu, 0x7fffffffu},
                 0x286bca1bu};
}

// ark-curve25519's twisted Edwards form: a = 486664, d = 486660.
F256_HD Curve curve25519() {
  return Curve{fp_modulus(),
               {0x011a2f30u, 0u, 0u, 0u, 0u, 0u, 0u, 0u},
               {0x011a2e98u, 0u, 0u, 0u, 0u, 0u, 0u, 0u}};
}

// x - p into r; returns the final borrow (1 when x < p).
F256_HD uint32_t sub_words(uint32_t r[N], const uint32_t x[N],
                           const uint32_t p[N]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t d = (uint64_t)x[i] - p[i] - borrow;
    r[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  return borrow;
}

// x + y into r; returns the final carry.
F256_HD uint32_t add_words(uint32_t r[N], const uint32_t x[N],
                           const uint32_t y[N]) {
  uint32_t carry = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t s = (uint64_t)x[i] + y[i] + carry;
    r[i] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  return carry;
}

// Montgomery product a*b*2^-256 mod p for canonical a, b < p (CIOS).
F256_HD void mont_mul(uint32_t out[N], const uint32_t a[N],
                      const uint32_t b[N], const Modulus& m) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    // t = (t + q*p) / 2^32 with q chosen so the low word cancels
    uint32_t q = t[0] * m.n0;
    s = (uint64_t)q * m.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)q * m.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  // t < 2p: one conditional subtract
  uint32_t r[N];
  uint32_t borrow = sub_words(r, t, m.p);
  bool take = (t[N] != 0) || (borrow == 0);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = take ? r[i] : t[i];
}

// (a + b) mod p for canonical a, b.
F256_HD void add_mod(uint32_t out[N], const uint32_t a[N],
                     const uint32_t b[N], const Modulus& m) {
  uint32_t s[N], r[N];
  uint32_t carry = add_words(s, a, b);
  uint32_t borrow = sub_words(r, s, m.p);
  bool take = carry || !borrow;
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = take ? r[i] : s[i];
}

// (a - b) mod p for canonical a, b.
F256_HD void sub_mod(uint32_t out[N], const uint32_t a[N],
                     const uint32_t b[N], const Modulus& m) {
  uint32_t d[N], r[N];
  uint32_t borrow = sub_words(d, a, b);
  add_words(r, d, m.p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = borrow ? r[i] : d[i];
}

// Complete unified addition add-2008-hwcd on extended coordinates
// (X, Y, Z, T) in Montgomery form: 9 general and 2 constant products.
// P+P, P+identity and P+(-P) need no special case (a square, d not).
F256_HD void padd_point(uint32_t out[4][N], const uint32_t p1[4][N],
                        const uint32_t p2[4][N], const Curve& c) {
  const Modulus& m = c.fp;
  uint32_t A[N], B[N], C[N], D[N], E[N], F[N], G[N], H[N], s[N], u[N];
  mont_mul(A, p1[0], p2[0], m);   // X1*X2
  mont_mul(B, p1[1], p2[1], m);   // Y1*Y2
  mont_mul(s, p1[3], p2[3], m);   // T1*T2
  mont_mul(C, s, c.d, m);         // d*T1*T2
  mont_mul(D, p1[2], p2[2], m);   // Z1*Z2
  add_mod(s, p1[0], p1[1], m);    // X1+Y1
  add_mod(u, p2[0], p2[1], m);    // X2+Y2
  mont_mul(E, s, u, m);
  sub_mod(E, E, A, m);
  sub_mod(E, E, B, m);            // E = (X1+Y1)(X2+Y2) - A - B
  sub_mod(F, D, C, m);            // F = D - C
  add_mod(G, D, C, m);            // G = D + C
  mont_mul(s, A, c.a, m);
  sub_mod(H, B, s, m);            // H = B - a*A
  mont_mul(out[0], E, F, m);
  mont_mul(out[1], G, H, m);
  mont_mul(out[2], F, G, m);
  mont_mul(out[3], E, H, m);
}

// 16 int32-held 16-bit limbs at stride `stride` -> 8 words.
F256_HD void load16(uint32_t w[N], const int32_t* src, int64_t stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint32_t lo = (uint32_t)src[(2 * i) * stride];
    uint32_t hi = (uint32_t)src[(2 * i + 1) * stride];
    w[i] = (lo & 0xffffu) | (hi << 16);
  }
}

// 8 words -> 16 int32-held 16-bit limbs at stride `stride`.
F256_HD void store16(int32_t* dst, const uint32_t w[N], int64_t stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    dst[(2 * i) * stride] = (int32_t)(w[i] & 0xffffu);
    dst[(2 * i + 1) * stride] = (int32_t)(w[i] >> 16);
  }
}

}  // namespace f256
