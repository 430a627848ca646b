// K3: fused twisted Edwards point addition for Hopper (sm_90a).
//
// Replaces lasso_tpu/ops/field_pallas.py:_padd_lm_batched (kernel body
// _padd_body with _add_t/_sub_t/_cond_sub_t, entry padd_pallas): the
// complete unified add-2008-hwcd on extended points over curve25519's Fp,
// 9 general and 2 constant Montgomery products, on the port's limb-major
// [K, 4, 16, n] int32 layout.  pdbl is padd(P, P).
//
// What bounds it: memory.  Each sum reads 2 x 256 B and writes 256 B (64
// int32-held limbs per point) against 11 x 136 = 1496 32x32->64-bit
// multiplies (2992 32-bit multiply instructions); at the card's 3.35 TB/s
// and ~67 T 32-bit ops/s the bytes take about 5x as long as the multiplies.
// Registers are the scarce resource: two input points, the result and the
// formula's temporaries are live at once.
//
// Design: one point per thread with the whole formula in registers
// (field256.cuh:padd_point), so no intermediate product ever leaves the
// SM.  Thread i of batch k reads limb j of coordinate c at
// ((k*4 + c)*16 + j)*n + i: neighbouring threads read neighbouring
// addresses, every load and store is coalesced, and the layout needs no
// transpose at the boundary.  Blocks are kept at 128 threads because of
// the register footprint.  The kernel allocates nothing and launches on
// the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace {

__global__ void padd_kernel(const int32_t* __restrict__ p,
                            const int32_t* __restrict__ q,
                            int32_t* __restrict__ out, int64_t k, int64_t n,
                            f256::Curve c) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= k * n) return;
  int64_t kk = idx / n;
  int64_t i = idx - kk * n;
  int64_t base = kk * 64 * n + i;
  uint32_t a[4][f256::N], b[4][f256::N], r[4][f256::N];
#pragma unroll
  for (int co = 0; co < 4; ++co) {
    f256::load16(a[co], p + base + co * 16 * n, n);
    f256::load16(b[co], q + base + co * 16 * n, n);
  }
  f256::padd_point(r, a, b, c);
#pragma unroll
  for (int co = 0; co < 4; ++co) {
    f256::store16(out + base + co * 16 * n, r[co], n);
  }
}

}  // namespace

extern "C" int lasso_padd(const int32_t* p, const int32_t* q, int32_t* out,
                          int64_t k, int64_t n, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (k * n + threads - 1) / threads;
  padd_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      p, q, out, k, n, f256::curve25519());
  return (int)cudaGetLastError();
}
