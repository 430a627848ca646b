// K1: batched Montgomery multiplication for Hopper (sm_90a).
//
// Replaces lasso_tpu/ops/field_pallas.py:_mont_mul_lm (kernel body
// _mont_mul_body, entry mont_mul_pallas): out = a*b*2^-256 mod p for Fr or
// Fp, canonical, on the port's [n, 16] int32-held 16-bit limb layout.
//
// What bounds it: memory.  Each product reads 2 x 64 B and writes 64 B
// (16 int32-held limbs per element) and does 2*8*8 + 8 = 136 32x32->64-bit
// multiplies (272 32-bit multiply instructions); at the card's 3.35 TB/s and
// ~67 T 32-bit ops/s the bytes take about 14x as long as the multiplies.
//
// Design: one element per thread, the whole CIOS product and REDC in
// registers (field256.cuh); two 16-bit limbs pack into each 32-bit word on
// load, so a 256-bit element is 8 words and 64 multiplies per product
// instead of the TPU kernel's 256 16x16-bit ones.  Nothing is staged in
// shared memory: each operand is read once.  A row stride of 0 lets one
// operand be a single broadcast constant (a challenge, R^2, 1) without the
// wrapper materializing it.  The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace {

__global__ void mont_mul_kernel(const int32_t* __restrict__ a,
                                const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int64_t n,
                                int64_t a_stride, int64_t b_stride,
                                f256::Modulus m) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[f256::N], y[f256::N], z[f256::N];
  f256::load16(x, a + i * a_stride, 1);
  f256::load16(y, b + i * b_stride, 1);
  f256::mont_mul(z, x, y, m);
  f256::store16(out + i * 16, z, 1);
}

}  // namespace

extern "C" int lasso_mont_mul(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t n, int64_t a_stride,
                              int64_t b_stride, int field, void* stream) {
  if (n <= 0) return 0;
  const f256::Modulus m =
      field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  const int threads = 256;
  const int64_t blocks = (n + threads - 1) / threads;
  mont_mul_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      a, b, out, n, a_stride, b_stride, m);
  return (int)cudaGetLastError();
}
