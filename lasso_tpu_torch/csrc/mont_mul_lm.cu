// K2: batched limb-major Montgomery multiplication for Hopper (sm_90a).
//
// Replaces lasso_tpu/ops/field_pallas.py:_mont_mul_lm_batched (kernel body
// _mont_mul_body, entry mont_mul_lm): out = a*b*2^-256 mod p for Fr or Fp,
// canonical, on limb-major [K, 16, n] int32-held 16-bit limbs.  It carries
// every field product of the unfused curve path (curve/tcurve.py
// _padd_unfused / _pdbl_unfused, three stacked products per group op).
//
// What bounds it: memory, as for K1.  Each product reads 2 x 64 B and
// writes 64 B against 136 32x32->64-bit multiplies (272 32-bit multiply
// instructions); at the card's 3.35 TB/s and ~67 T 32-bit ops/s the bytes
// take about 14x as long as the multiplies.
//
// Design: one thread per (k, column), the whole CIOS product and REDC in
// registers (field256.cuh).  Thread (k, col) reads limb i of an operand at
// k*k_stride + i*limb_stride + col*col_stride; for a [K, 16, n] operand
// that is (k*16 + i)*n + col, so neighbouring threads read neighbouring
// addresses and every load and store is coalesced without a transpose.
// Strides of 0 let an operand be one broadcast [16, 1] element (the curve
// constants a and d) without the wrapper materializing it.  The TPU
// kernel's padding of n to a multiple of 1024 is gone: the last block
// masks the ragged edge.  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace {

struct Operand {
  const int32_t* ptr;
  int64_t k_stride, limb_stride, col_stride;
};

__global__ void mont_mul_lm_kernel(Operand a, Operand b,
                                   int32_t* __restrict__ out, int64_t k,
                                   int64_t n, f256::Modulus m) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= k * n) return;
  int64_t kk = idx / n;
  int64_t col = idx - kk * n;
  uint32_t x[f256::N], y[f256::N], z[f256::N];
  f256::load16(x, a.ptr + kk * a.k_stride + col * a.col_stride,
               a.limb_stride);
  f256::load16(y, b.ptr + kk * b.k_stride + col * b.col_stride,
               b.limb_stride);
  f256::mont_mul(z, x, y, m);
  f256::store16(out + kk * 16 * n + col, z, n);
}

}  // namespace

// a, b: limb-major operands addressed through their (k, limb, column)
// strides; out: contiguous [k, 16, n].  Returns the cudaError of the launch.
extern "C" int lasso_mont_mul_lm(const int32_t* a, int64_t a_k, int64_t a_l,
                                 int64_t a_c, const int32_t* b, int64_t b_k,
                                 int64_t b_l, int64_t b_c, int32_t* out,
                                 int64_t k, int64_t n, int field,
                                 void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const f256::Modulus m =
      field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  const int threads = 256;
  const int64_t blocks = (k * n + threads - 1) / threads;
  mont_mul_lm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      Operand{a, a_k, a_l, a_c}, Operand{b, b_k, b_l, b_c}, out, k, n, m);
  return (int)cudaGetLastError();
}
