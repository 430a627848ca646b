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
// Two implementations of the same arithmetic:
//   - f256::mont_mul, add_mod, sub_mod: portable __host__ __device__ C++ in
//     uint64_t, with no CUDA intrinsics, so a host compiler builds them too
//     (the CPU tests hold them, and the kernels' addressing, K3's lane
//     split and K2's grid below, against the plain versions).
//   - f256::dev: device-only, on PTX carry chains (mad.lo.cc / madc.hi.cc /
//     addc.cc), seen only by nvcc.  K1 and K2 (Fr) use dev::mont_mul; K2
//     (Fp) uses dev::mont_mul_p25519 and K3 dev::P25519Ops, whose products
//     reduce with p = 2^255 - 19's form; K5's add/sub use dev::add_mod and
//     dev::sub_mod for both fields.
// Both give the same canonical words for the same inputs.

#pragma once

#include <stddef.h>
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

// Twisted Edwards curve over Fp: a*x^2 + y^2 = 1 + d*x^2*y^2, with small a
// and d: a product with either is x*a mod p (mul_small_p25519), the same
// value as the Montgomery product with a * 2^256 mod p.
struct Curve {
  Modulus fp;
  uint32_t a, d;
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
F256_HD Curve curve25519() { return Curve{fp_modulus(), 486664u, 486660u}; }

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

// x * k mod p for Fp = 2^255 - 19 only, canonical x and k < 2^32: the
// product, then the bits from 2^255 up folded back in times 19 (2^255 = 19
// mod p), then one conditional subtract.
F256_HD void mul_small_p25519(uint32_t out[N], const uint32_t x[N], uint32_t k,
                              const Modulus& m) {
  uint32_t w[N];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint64_t s = (uint64_t)x[i] * k + c;
    w[i] = (uint32_t)s;
    c = s >> 32;
  }
  const uint64_t h = (c << 1) | (w[N - 1] >> 31);  // x*k >> 255, < 2^33
  w[N - 1] &= 0x7fffffffu;
  c = h * 19u;
#pragma unroll
  for (int i = 0; i < N; ++i) {  // < 2^255 + 2^38 < 2p
    const uint64_t s = (uint64_t)w[i] + (uint32_t)c;
    w[i] = (uint32_t)s;
    c = (c >> 32) + (s >> 32);
  }
  uint32_t r[N];
  const uint32_t borrow = sub_words(r, w, m.p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = borrow ? w[i] : r[i];
}

// The portable arithmetic as an Ops policy for the templates below.
struct PortableOps {
  F256_HD static void mul(uint32_t o[N], const uint32_t a[N],
                          const uint32_t b[N], const Modulus& m) {
    mont_mul(o, a, b, m);
  }
  F256_HD static void add(uint32_t o[N], const uint32_t a[N],
                          const uint32_t b[N], const Modulus& m) {
    add_mod(o, a, b, m);
  }
  F256_HD static void sub(uint32_t o[N], const uint32_t a[N],
                          const uint32_t b[N], const Modulus& m) {
    sub_mod(o, a, b, m);
  }
  F256_HD static void mul_small(uint32_t o[N], const uint32_t a[N], uint32_t k,
                                const Modulus& m) {
    mul_small_p25519(o, a, k, m);
  }
};

// Complete unified addition add-2008-hwcd on extended coordinates
// (X, Y, Z, T) in Montgomery form, 9 general and 2 constant products,
// split over a pair of lanes as K3 runs it.  P+P, P+identity and P+(-P)
// need no special case (a square, d not).
//
// Lane 0 holds X and Y of both points (u = X, v = Y), lane 1 holds Z and T
// (u = Z, v = T).  Both lanes run the same products on their own operands:
//   first:  lane 0: A = X1*X2, B = Y1*Y2, a*A, E' = (X1+Y1)(X2+Y2)
//                   -> f = E = E' - A - B, g = H = B - a*A
//           lane 1: D = Z1*Z2, T1*T2, C = d*T1*T2
//                   -> f = F = D - C,      g = G = D + C
//   (the lanes exchange f and g: o1, o2 are the partner's)
//   second: lane 0: X3 = E*F, T3 = E*H;  lane 1: Y3 = G*H, Z3 = F*G.
// Every intermediate is the canonical value of padd_plain's, so the
// projective limbs out are equal to the plain version's.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ops>
F256_HD void padd_pair_first(uint32_t f[N], uint32_t g[N],
                             const uint32_t u1[N], const uint32_t v1[N],
                             const uint32_t u2[N], const uint32_t v2[N],
                             int lane, const Curve& c) {
  const Modulus& m = c.fp;
  uint32_t r1[N], r2[N], r3[N], x[N];
  Ops::mul(r1, u1, u2, m);        // A = X1*X2      | D = Z1*Z2
  Ops::mul(r2, v1, v2, m);        // B = Y1*Y2      | T1*T2
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = lane ? r2[j] : r1[j];
  Ops::mul_small(r3, x, lane ? c.d : c.a, m);  // a*A | C = d*T1*T2
  if (lane) {
    Ops::sub(f, r1, r3, m);       // F = D - C
    Ops::add(g, r1, r3, m);       // G = D + C
  } else {
    uint32_t s[N], t[N];
    Ops::add(s, u1, v1, m);       // X1+Y1
    Ops::add(t, u2, v2, m);       // X2+Y2
    Ops::mul(x, s, t, m);
    Ops::sub(x, x, r1, m);
    Ops::sub(f, x, r2, m);        // E = (X1+Y1)(X2+Y2) - A - B
    Ops::sub(g, r2, r3, m);       // H = B - a*A
  }
}

// r5 = X3 (lane 0) or Y3 (lane 1); r6 = T3 (lane 0) or Z3 (lane 1).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ops>
F256_HD void padd_pair_second(uint32_t r5[N], uint32_t r6[N],
                              const uint32_t f[N], const uint32_t g[N],
                              const uint32_t o1[N], const uint32_t o2[N],
                              int lane, const Curve& c) {
  uint32_t x[N], y[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    x[j] = lane ? g[j] : f[j];
    y[j] = lane ? o2[j] : o1[j];
  }
  Ops::mul(r5, x, y, c.fp);       // X3 = E*F       | Y3 = G*H
  Ops::mul(r6, f, g, c.fp);       // T3 = E*H       | Z3 = F*G
}

// The whole sum in one thread: both lanes of the pair in turn.
F256_HD void padd_point(uint32_t out[4][N], const uint32_t p1[4][N],
                        const uint32_t p2[4][N], const Curve& c) {
  uint32_t f[2][N], g[2][N];
  for (int lane = 0; lane < 2; ++lane)
    padd_pair_first<PortableOps>(f[lane], g[lane], p1[2 * lane],
                                 p1[2 * lane + 1], p2[2 * lane],
                                 p2[2 * lane + 1], lane, c);
  for (int lane = 0; lane < 2; ++lane)
    padd_pair_second<PortableOps>(out[lane ? 1 : 0], out[lane ? 2 : 3],
                                  f[lane], g[lane], f[1 - lane], g[1 - lane],
                                  lane, c);
}

// K1's shared-memory tile: element e's 16-byte chunk c (its limbs 4c..4c+3)
// sits at chunk slot 4e + (c ^ ((e >> 1) & 3)).  Within one element the
// map permutes the four chunks, so it is a bijection of [0, 4T) for any
// tile of T elements.  A 16-byte shared-memory access is served 8 threads
// at a time, and the 32 banks hold 8 chunks per row: with an unswizzled
// 64-byte row stride, 8 threads reading chunk c of 8 neighbouring elements
// hit 2 distinct bank groups (4-way conflict); with the swizzle their slots
// fall in 8 distinct ones, as do the slots of 8 neighbouring chunks that 8
// threads copy in from device memory.
F256_HD int tile_slot(int e, int c) { return 4 * e + (c ^ ((e >> 1) & 3)); }

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

// ---------------------------------------------------------------------------
// K2's limb-major work, one thread's share (the kernel is in mont_mul_lm.cu).
//
// Limb i of column c of row k of a contiguous [K, 16, n] tensor sits at
// (k*16 + i)*n + c: threads on neighbouring columns read neighbouring
// addresses.  A thread owns kCols neighbouring columns of one row; with
// kCols = 2 it reads and writes each limb of both as one 8-byte access on
// the card (n even and 8-byte aligned operands, so a pair never straddles
// two rows).
// ---------------------------------------------------------------------------

template <int kCols>
F256_HD void load_cols(int32_t v[kCols], const int32_t* p) {
#ifdef __CUDA_ARCH__
  if constexpr (kCols == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = x.x;
    v[1] = x.y;
    return;
  }
  if constexpr (kCols == 1) {
    v[0] = __ldg(p);
    return;
  }
#endif
#pragma unroll
  for (int c = 0; c < kCols; ++c) v[c] = p[c];
}

template <int kCols>
F256_HD void store_cols(int32_t* p, const int32_t v[kCols]) {
#ifdef __CUDA_ARCH__
  if constexpr (kCols == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
    return;
  }
#endif
#pragma unroll
  for (int c = 0; c < kCols; ++c) p[c] = v[c];
}

// kCols neighbouring columns of 16 limbs at limb stride n -> kCols x 8 words.
template <int kCols>
F256_HD void load16_cols(uint32_t w[kCols][N], const int32_t* src,
                         uint32_t n) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int32_t lo[kCols], hi[kCols];
    load_cols<kCols>(lo, src + (size_t)(2 * i) * n);
    load_cols<kCols>(hi, src + (size_t)(2 * i + 1) * n);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      w[c][i] = ((uint32_t)lo[c] & 0xffffu) | ((uint32_t)hi[c] << 16);
    }
  }
}

template <int kCols>
F256_HD void store16_cols(int32_t* dst, const uint32_t w[kCols][N],
                          uint32_t n) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int32_t lo[kCols], hi[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      lo[c] = (int32_t)(w[c][i] & 0xffffu);
      hi[c] = (int32_t)(w[c][i] >> 16);
    }
    store_cols<kCols>(dst + (size_t)(2 * i) * n, lo);
    store_cols<kCols>(dst + (size_t)(2 * i + 1) * n, hi);
  }
}

// The products of flat columns first .. first + kCols - 1 of [K, 16, n]
// operands (flat column = k*n + c): out = a*b*2^-256 mod p through
// Mul::mul.  kBConst: b is one [16, 1] element, read into registers once.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Mul, bool kBConst, int kCols>
F256_HD void mont_mul_lm_columns(const int32_t* a, const int32_t* b,
                                 int32_t* out, uint32_t first, uint32_t n) {
  const uint32_t k = first / n;
  const size_t at = (size_t)k * 16 * n + (first - k * n);
  uint32_t x[kCols][N], y[kCols][N], z[kCols][N];
  load16_cols<kCols>(x, a + at, n);
  if (kBConst) {
    load16_cols<1>(y, b, 1);
#pragma unroll
    for (int c = 1; c < kCols; ++c) {
#pragma unroll
      for (int i = 0; i < N; ++i) y[c][i] = y[0][i];
    }
  } else {
    load16_cols<kCols>(y, b + at, n);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) Mul::mul(z[c], x[c], y[c]);
  store16_cols<kCols>(out + at, z, n);
}

// The portable product as a Mul policy (field 0 = Fr, 1 = Fp).
template <int kField>
struct PortableMul {
  F256_HD static void mul(uint32_t o[N], const uint32_t a[N],
                          const uint32_t b[N]) {
    mont_mul(o, a, b, kField == 0 ? fr_modulus() : fp_modulus());
  }
};

// K2's grid for `total` products on rows of n columns: blocks of
// `threads`, one product per thread, or a pair of neighbouring columns per
// thread (max_cols = 2) where n is even, the operands are 8-byte aligned
// (`pairs_ok`) and the launch still gives each of the `sms` SMs four blocks
// of pairs.
struct LmLaunch {
  int cols;
  uint32_t groups, blocks;  // groups = products / cols, one per thread
};

F256_HD LmLaunch lm_launch(uint32_t total, uint32_t n, bool pairs_ok, int sms,
                           int threads, int max_cols) {
  const bool pairs = max_cols == 2 && pairs_ok && n % 2 == 0 &&
                     total / 2 >= 4u * (uint32_t)sms * (uint32_t)threads;
  const int cols = pairs ? 2 : 1;
  const uint32_t groups = total / cols;
  return LmLaunch{cols, groups, (groups + threads - 1) / threads};
}

// ---------------------------------------------------------------------------
// K5's work, one thread's share (the kernels are in field_arith.cu).
//
// Add and sub: element (o, i) of an operand's logical [outer, inner] batch
// sits o * s0 + i * s1 int32s from its base, its 16 limbs contiguous and
// 16-byte aligned (a broadcast axis has stride 0), so half views
// x[:, :h] of a contiguous [I, n, 16] tensor and one broadcast [16]
// element are read in place.  The output is contiguous.
//
// Column sums: exact per-limb sums of [n, m, 16] limbs (rows at stride sn,
// column sets at stride sm), split by rows over up to kMaxSplits blocks per
// column set, then tfield._split_shift three times: [m, 19] int64 columns,
// equal limb for limb to the plain version's.
//
// Finish: wide columns (value V < R*p, each column in [0, 2^48)) -> the
// canonical limbs of V mod p, which is what the plain version's REDC and
// product with R^2 give.
// ---------------------------------------------------------------------------

constexpr int kWide = 19;      // limbs of a column sum: 16 + 3 splits
constexpr int kMaxWide = 33;   // widest column set a finish takes (2W + 1)
constexpr int kMaxSplits = 8;  // blocks per column set: a portable cluster

// 16 contiguous, 16-byte aligned limbs -> 8 words (four 16-byte loads on
// the card).
F256_HD void load16_vec(uint32_t w[N], const int32_t* src) {
#ifdef __CUDA_ARCH__
  const int4* p = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int4 v = __ldg(p + c);
    w[2 * c] = ((uint32_t)v.x & 0xffffu) | ((uint32_t)v.y << 16);
    w[2 * c + 1] = ((uint32_t)v.z & 0xffffu) | ((uint32_t)v.w << 16);
  }
#else
  load16(w, src, 1);
#endif
}

F256_HD void store16_vec(int32_t* dst, const uint32_t w[N]) {
#ifdef __CUDA_ARCH__
  int4* p = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p[c] = make_int4((int32_t)(w[2 * c] & 0xffffu), (int32_t)(w[2 * c] >> 16),
                     (int32_t)(w[2 * c + 1] & 0xffffu),
                     (int32_t)(w[2 * c + 1] >> 16));
  }
#else
  store16(dst, w, 1);
#endif
}

// Offset of flat element e of a strided [outer, inner] batch.
F256_HD int64_t strided_at(uint32_t e, uint32_t inner, int64_t s0,
                           int64_t s1) {
  const uint32_t o = e / inner;
  return (int64_t)o * s0 + (int64_t)(e - o * inner) * s1;
}

// out[e] = a[e] + b[e] or a[e] - b[e] mod p, through Ops::add / Ops::sub.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ops, bool kSub>
F256_HD void addsub_element(const int32_t* a, const int32_t* b, int32_t* out,
                            uint32_t e, uint32_t inner, int64_t sa0,
                            int64_t sa1, int64_t sb0, int64_t sb1,
                            const Modulus& m) {
  uint32_t x[N], y[N], z[N];
  load16_vec(x, a + strided_at(e, inner, sa0, sa1));
  load16_vec(y, b + strided_at(e, inner, sb0, sb1));
  if (kSub) {
    Ops::sub(z, x, y, m);
  } else {
    Ops::add(z, x, y, m);
  }
  store16_vec(out + (size_t)e * 16, z);
}

// K5's grid for the column sums of m sets of n rows: `threads` per block,
// four to a row (one 16-byte chunk, four limbs, each), from one warp up to
// 1024; `splits` blocks per set, each over its own range of rows (one
// cluster), where the sets alone would not give each of the `sms` SMs two
// blocks and every split still has four rows per thread group.
struct SumLaunch {
  int threads, splits;
};

F256_HD SumLaunch sum_launch(int64_t n, int64_t m, int sms) {
  int threads = 32;
  while (threads < 1024 && threads < 4 * n) threads *= 2;
  int64_t splits = 1;
  if (m < 2 * (int64_t)sms) {
    splits = (2 * (int64_t)sms + m - 1) / m;
    const int64_t by_rows = n / threads;  // 4 rows per thread group
    if (splits > by_rows) splits = by_rows;
    if (splits > kMaxSplits) splits = kMaxSplits;
    if (splits < 1) splits = 1;
  }
  return SumLaunch{threads, (int)splits};
}

// Rows [begin, end) of split s of n.
F256_HD void split_rows(int64_t n, int splits, int s, int64_t* begin,
                        int64_t* end) {
  *begin = n * s / splits;
  *end = n * (s + 1) / splits;
}

// Four contiguous, 16-byte aligned limbs.
F256_HD void load4(uint32_t v[4], const int32_t* p) {
#ifdef __CUDA_ARCH__
  const int4 x = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = (uint32_t)x.x, v[1] = (uint32_t)x.y, v[2] = (uint32_t)x.z;
  v[3] = (uint32_t)x.w;
#else
  for (int k = 0; k < 4; ++k) v[k] = (uint32_t)p[k];
#endif
}

// Thread t's share of rows [begin, end) of one column set (base: its row
// 0): rows begin + t/4, begin + t/4 + threads/4, ..., chunk t % 4, summed
// into acc (limbs 4 * (t % 4) ...).
F256_HD void sum_rows(uint64_t acc[4], const int32_t* base, int64_t sn,
                      int64_t begin, int64_t end, int t, int threads) {
  const int32_t* p = base + 4 * (t & 3);
  const int64_t step = threads / 4;
#pragma unroll 4
  for (int64_t r = begin + t / 4; r < end; r += step) {
    uint32_t v[4];
    load4(v, p + r * sn);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += v[k];
  }
}

// tfield._split_shift three times on one set's 16 exact limb sums.
F256_HD void wide_columns(int64_t out[kWide], const uint64_t sums[16]) {
  int64_t c[kWide];
  for (int j = 0; j < kWide; ++j) c[j] = j < 16 ? (int64_t)sums[j] : 0;
  for (int width = 16; width < kWide; ++width) {
    for (int j = width; j >= 0; --j) {
      c[j] = (j < width ? (c[j] & 0xffff) : 0) + (j > 0 ? c[j - 1] >> 16 : 0);
    }
  }
  for (int j = 0; j < kWide; ++j) out[j] = c[j];
}

// R^2 mod p, the factor that turns REDC's V * R^-1 back into V.
F256_HD void r2_words(uint32_t r2[N], int field) {
  const uint32_t fr[N] = {0x449c0f01u, 0xa40611e3u, 0x68859347u, 0xd00e1ba7u,
                          0x17f5be65u, 0xceec73d2u, 0x7c309a3du, 0x0399411bu};
  for (int i = 0; i < N; ++i) r2[i] = field == 0 ? fr[i] : (i == 0 ? 0x5a4u : 0);
}

// V mod p of `width` <= kMaxWide wide columns, V = sum_j cols[j] * 2^(16j)
// < R*p, each column in [0, 2^48): V as 2N + 2 words, word-by-word REDC
// (V * R^-1 mod p, below 2p, one conditional subtract), then the product
// with R^2 mod p through Ops::mul.
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Ops>
F256_HD void finish_wide(uint32_t out[N], const int64_t* cols, int width,
                         const Modulus& m, int field) {
  constexpr int kWords = 2 * N + 2;
  uint32_t t[kWords];
  uint64_t carry = 0;  // < 2^34
  for (int k = 0; k < kWords; ++k) {
    const uint64_t lo = 2 * k < width ? (uint64_t)cols[2 * k] : 0;
    const uint64_t hi = 2 * k + 1 < width ? (uint64_t)cols[2 * k + 1] : 0;
    const uint64_t s = carry + (lo & 0xffffffffu) + ((hi & 0xffffu) << 16);
    t[k] = (uint32_t)s;
    carry = (s >> 32) + (lo >> 32) + (hi >> 16);
  }
  for (int i = 0; i < N; ++i) {
    const uint32_t q = t[i] * m.n0;
    uint64_t c = 0;
    for (int j = 0; j < N; ++j) {
      const uint64_t s = (uint64_t)q * m.p[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    for (int j = i + N; j < kWords && c; ++j) {
      const uint64_t s = (uint64_t)t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  uint32_t r[N], x[N], r2[N];
  const uint32_t borrow = sub_words(r, t + N, m.p);
  const bool take = (t[2 * N] != 0) || (borrow == 0);
  for (int i = 0; i < N; ++i) x[i] = take ? r[i] : t[N + i];
  r2_words(r2, field);
  Ops::mul(out, x, r2, m);
}

#ifdef __CUDACC__
// ---------------------------------------------------------------------------
// Device-only arithmetic on PTX carry chains (K1, K2 and K3).
//
// The portable mont_mul above writes each CIOS step as a 64-bit multiply
// plus 64-bit adds and a shift; nvcc turns that into a wide multiply and
// separate carry arithmetic.  Here each row of the product is two carry
// chains of 32-bit multiply-adds (low halves, then high halves one word
// up), with the carries in the hardware's carry flag: 264 multiply-add
// instructions per product (8 rows of a*b[i] and 8 of q*p, 16 each, plus
// the 8 q), no 64-bit temporaries.  A carry chain must not be split across
// asm statements (nothing keeps the flag between them), so each chain is
// one statement.
// ---------------------------------------------------------------------------
namespace dev {

// t[0..9] += a * bi: the low halves into t[0..7], the high halves into
// t[1..8], every carry up to t[9].
__device__ __forceinline__ void mac_row(uint32_t t[N + 2], const uint32_t a[N],
                                        uint32_t bi) {
  asm(
      "mad.lo.cc.u32 %0, %10, %18, %0;\n\t"
      "madc.lo.cc.u32 %1, %11, %18, %1;\n\t"
      "madc.lo.cc.u32 %2, %12, %18, %2;\n\t"
      "madc.lo.cc.u32 %3, %13, %18, %3;\n\t"
      "madc.lo.cc.u32 %4, %14, %18, %4;\n\t"
      "madc.lo.cc.u32 %5, %15, %18, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %18, %6;\n\t"
      "madc.lo.cc.u32 %7, %17, %18, %7;\n\t"
      "addc.cc.u32 %8, %8, 0;\n\t"
      "addc.u32 %9, %9, 0;\n\t"
      "mad.hi.cc.u32 %1, %10, %18, %1;\n\t"
      "madc.hi.cc.u32 %2, %11, %18, %2;\n\t"
      "madc.hi.cc.u32 %3, %12, %18, %3;\n\t"
      "madc.hi.cc.u32 %4, %13, %18, %4;\n\t"
      "madc.hi.cc.u32 %5, %14, %18, %5;\n\t"
      "madc.hi.cc.u32 %6, %15, %18, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %18, %7;\n\t"
      "madc.hi.cc.u32 %8, %17, %18, %8;\n\t"
      "addc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(bi));
}

// t[0..8] < 2p -> the canonical t mod p: subtract p once and keep the
// difference unless it borrowed past t[8].
__device__ __forceinline__ void reduce_once(uint32_t out[N],
                                            const uint32_t t[N + 1],
                                            const uint32_t p[N]) {
  uint32_t r[N], top;
  asm(
      "sub.cc.u32 %0, %9, %18;\n\t"
      "subc.cc.u32 %1, %10, %19;\n\t"
      "subc.cc.u32 %2, %11, %20;\n\t"
      "subc.cc.u32 %3, %12, %21;\n\t"
      "subc.cc.u32 %4, %13, %22;\n\t"
      "subc.cc.u32 %5, %14, %23;\n\t"
      "subc.cc.u32 %6, %15, %24;\n\t"
      "subc.cc.u32 %7, %16, %25;\n\t"
      "subc.u32 %8, %17, 0;"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]), "=r"(r[4]),
        "=r"(r[5]), "=r"(r[6]), "=r"(r[7]), "=r"(top)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(p[0]), "r"(p[1]), "r"(p[2]),
        "r"(p[3]), "r"(p[4]), "r"(p[5]), "r"(p[6]), "r"(p[7]));
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = top ? t[i] : r[i];
}

// Montgomery product a*b*2^-256 mod p for canonical a, b < p (CIOS).
__device__ __forceinline__ void mont_mul(uint32_t out[N], const uint32_t a[N],
                                         const uint32_t b[N],
                                         const Modulus& m) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mac_row(t, a, b[i]);                // t += a * b[i]
    mac_row(t, m.p, t[0] * m.n0);       // t += q * p, t[0] becomes 0
#pragma unroll
    for (int j = 0; j < N + 1; ++j) t[j] = t[j + 1];  // t /= 2^32
    t[N + 1] = 0;
  }
  reduce_once(out, t, m.p);
}

// t[0..9] += q * (2^255 - 19) = q * 2^255 - 19 * q, modulo 2^320 (the sum
// itself is in range): one multiply and two short carry chains instead of a
// row of 16 multiply-adds.
__device__ __forceinline__ void mac_p25519(uint32_t t[N + 2], uint32_t q) {
  const uint32_t lo = q * 19u, hi = __umulhi(q, 19u);
  asm(
      "sub.cc.u32 %0, %0, %10;\n\t"
      "subc.cc.u32 %1, %1, %11;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.cc.u32 %8, %8, 0;\n\t"
      "subc.u32 %9, %9, 0;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]),
        "+r"(t[5]), "+r"(t[6]), "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(lo), "r"(hi));
  asm(
      "add.cc.u32 %0, %0, %3;\n\t"
      "addc.cc.u32 %1, %1, %4;\n\t"
      "addc.u32 %2, %2, 0;"
      : "+r"(t[7]), "+r"(t[8]), "+r"(t[9])
      : "r"(q << 31), "r"(q >> 1));
}

// Montgomery product for Fp = 2^255 - 19 only (m must be fp_modulus()):
// the reduction rows as q * 2^255 - 19 * q.  The same canonical result as
// mont_mul.
__device__ __forceinline__ void mont_mul_p25519(uint32_t out[N],
                                                const uint32_t a[N],
                                                const uint32_t b[N],
                                                const Modulus& m) {
  uint32_t t[N + 2];
#pragma unroll
  for (int i = 0; i < N + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mac_row(t, a, b[i]);                // t += a * b[i]
    mac_p25519(t, t[0] * m.n0);         // t += q * p, t[0] becomes 0
#pragma unroll
    for (int j = 0; j < N + 1; ++j) t[j] = t[j + 1];  // t /= 2^32
    t[N + 1] = 0;
  }
  reduce_once(out, t, m.p);
}

// x * k mod p for Fp = 2^255 - 19 only (as f256::mul_small_p25519).
__device__ __forceinline__ void mul_small_p25519(uint32_t out[N],
                                                 const uint32_t x[N],
                                                 uint32_t k, const Modulus& m) {
  uint32_t w[N + 1];
  asm(
      "mul.lo.u32 %0, %9, %17;\n\t"
      "mul.lo.u32 %1, %10, %17;\n\t"
      "mul.lo.u32 %2, %11, %17;\n\t"
      "mul.lo.u32 %3, %12, %17;\n\t"
      "mul.lo.u32 %4, %13, %17;\n\t"
      "mul.lo.u32 %5, %14, %17;\n\t"
      "mul.lo.u32 %6, %15, %17;\n\t"
      "mul.lo.u32 %7, %16, %17;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, 0;"
      : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]), "=r"(w[4]),
        "=r"(w[5]), "=r"(w[6]), "=r"(w[7]), "=r"(w[8])
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]), "r"(k));
  const uint32_t h = (w[N] << 1) | (w[N - 1] >> 31);  // x*k >> 255
  w[N - 1] &= 0x7fffffffu;
  asm(
      "mad.lo.cc.u32 %0, %8, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %9, %1;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(w[0]), "+r"(w[1]), "+r"(w[2]), "+r"(w[3]), "+r"(w[4]),
        "+r"(w[5]), "+r"(w[6]), "+r"(w[7])
      : "r"(h), "r"(19u));
  w[N] = 0;  // < 2^255 + 19 * 2^32 < 2p
  reduce_once(out, w, m.p);
}

// (a + b) mod p for canonical a, b.
__device__ __forceinline__ void add_mod(uint32_t out[N], const uint32_t a[N],
                                        const uint32_t b[N],
                                        const Modulus& m) {
  uint32_t s[N + 1];
  s[N] = 0;
  asm(
      "add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, %24;\n\t"
      "addc.u32 %8, %8, 0;"
      : "=r"(s[0]), "=r"(s[1]), "=r"(s[2]), "=r"(s[3]), "=r"(s[4]),
        "=r"(s[5]), "=r"(s[6]), "=r"(s[7]), "+r"(s[8])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
  reduce_once(out, s, m.p);
}

// (a - b) mod p for canonical a, b: the difference, plus p where it
// borrowed.
__device__ __forceinline__ void sub_mod(uint32_t o[N], const uint32_t a[N],
                                        const uint32_t b[N],
                                        const Modulus& m) {
  uint32_t d[N], q[N], mask = 0;
  asm(
      "sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, %8, 0;"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]), "=r"(d[4]),
        "=r"(d[5]), "=r"(d[6]), "=r"(d[7]), "+r"(mask)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]),
        "r"(b[4]), "r"(b[5]), "r"(b[6]), "r"(b[7]));
#pragma unroll
  for (int i = 0; i < N; ++i) q[i] = m.p[i] & mask;
  asm(
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;"
      : "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3]), "=r"(o[4]),
        "=r"(o[5]), "=r"(o[6]), "=r"(o[7])
      : "r"(d[0]), "r"(d[1]), "r"(d[2]), "r"(d[3]), "r"(d[4]), "r"(d[5]),
        "r"(d[6]), "r"(d[7]), "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]),
        "r"(q[4]), "r"(q[5]), "r"(q[6]), "r"(q[7]));
}

// The carry-chain arithmetic for Fp = 2^255 - 19 only, as an Ops policy for
// padd_pair_first/second (K3).
struct P25519Ops {
  __device__ __forceinline__ static void mul(uint32_t o[N], const uint32_t a[N],
                                             const uint32_t b[N],
                                             const Modulus& m) {
    dev::mont_mul_p25519(o, a, b, m);
  }
  __device__ __forceinline__ static void add(uint32_t o[N], const uint32_t a[N],
                                             const uint32_t b[N],
                                             const Modulus& m) {
    dev::add_mod(o, a, b, m);
  }
  __device__ __forceinline__ static void sub(uint32_t o[N], const uint32_t a[N],
                                             const uint32_t b[N],
                                             const Modulus& m) {
    dev::sub_mod(o, a, b, m);
  }
  __device__ __forceinline__ static void mul_small(uint32_t o[N],
                                                   const uint32_t a[N],
                                                   uint32_t k,
                                                   const Modulus& m) {
    dev::mul_small_p25519(o, a, k, m);
  }
};

}  // namespace dev
#endif  // __CUDACC__

}  // namespace f256
