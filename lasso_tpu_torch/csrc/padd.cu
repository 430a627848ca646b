// K3: fused twisted Edwards point addition for Hopper (sm_90a).
//
// Replaces lasso_tpu/ops/field_pallas.py:_padd_lm_batched (kernel body
// _padd_body with _add_t/_sub_t/_cond_sub_t, entry padd_pallas): the
// complete unified add-2008-hwcd on extended points over curve25519's Fp,
// 9 general and 2 constant Montgomery products, on the port's limb-major
// [K, 4, 16, n] int32 layout.  pdbl is padd(P, P).
//
// What bounds it on the H100: the integer pipes, then memory.  Each sum
// reads 2 x 256 B and writes 256 B (64 int32-held limbs per point) against
// 11 products of 272 32-bit multiply instructions each in the general
// CIOS count.  The card issues 32-bit integer multiplies at 64 per clock
// per SM (132 SMs, ~16.7e12/s at 1980 MHz) against 3.35 TB/s: at 2^16
// points the bytes take 15.0 us and the multiplies 11.7 us.  In practice
// the instruction stream sets the time: every multiply-add with a carry
// is two SASS instructions (IMAD or IMAD.HI, then IADD3.X), and the
// chains of carries leave little to overlap.
//
// Design:
//   - Fewer instructions per sum.  The products run on PTX carry chains
//     (f256::dev::P25519Ops); their reduction rows use p = 2^255 - 19's
//     form, q * 2^255 - 19 * q, one multiply and two short chains instead
//     of 16 multiply-adds; the two constant products (a = 486664,
//     d = 486660) are x * k mod p, eight multiplies and a fold, instead of
//     Montgomery products with a * 2^256 and d * 2^256.  Each gives the
//     same canonical value as padd_plain's product.
//   - Two lanes per point.  The even lane holds X and Y of both points,
//     the odd lane Z and T; both run the same products on their own
//     operands, exchange two field elements each through __shfl_xor_sync,
//     and finish two of the four output products each
//     (f256::padd_pair_first/second: 5 full product steps and one constant
//     product per lane, twice the warps of one point per thread).  The
//     formula and its order are padd_plain's, so the projective limbs are
//     equal.
//   - Loads and stores stay coalesced: lane pair i reads limb j of
//     coordinate c at ((k*4 + c)*16 + j)*n + i, so the even lanes of a warp
//     read 16 neighbouring addresses of one coordinate and the odd lanes
//     16 of another; the layout needs no transpose at the boundary.
//   - The ragged edge: a pair past the last point computes on the last
//     point (it must still join the shuffle) and stores nothing.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace {

// Threads per block (two per point), chosen from the ptxas report and a
// sweep on the card (lasso_tpu_torch/benches/kernel_sweep.py --sweep).
constexpr int kThreads = 128;
static_assert(kThreads % 32 == 0, "whole warps: every lane joins the shuffle");

__global__ void __launch_bounds__(kThreads)
    padd_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                int32_t* __restrict__ out, int64_t k, int64_t n,
                f256::Curve c) {
  using f256::N;
  const int64_t total = k * n;
  const int64_t pt = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 1;
  const int lane = threadIdx.x & 1;
  const bool live = pt < total;
  const int64_t ptc = live ? pt : total - 1;
  const int64_t kk = ptc / n;
  const int64_t base = kk * 64 * n + (ptc - kk * n);
  const int64_t coord = 16 * n;  // distance between coordinates

  // this lane's two coordinates of each point: (X, Y) or (Z, T)
  uint32_t u1[N], v1[N], u2[N], v2[N];
  const int64_t own = base + 2 * lane * coord;
  f256::load16(u1, p + own, n);
  f256::load16(v1, p + own + coord, n);
  f256::load16(u2, q + own, n);
  f256::load16(v2, q + own + coord, n);

  uint32_t f[N], g[N], o1[N], o2[N];
  f256::padd_pair_first<f256::dev::P25519Ops>(f, g, u1, v1, u2, v2, lane, c);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    o1[j] = __shfl_xor_sync(0xffffffffu, f[j], 1);
    o2[j] = __shfl_xor_sync(0xffffffffu, g[j], 1);
  }
  uint32_t r5[N], r6[N];
  f256::padd_pair_second<f256::dev::P25519Ops>(r5, r6, f, g, o1, o2, lane, c);
  if (live) {
    f256::store16(out + base + (lane ? 1 : 0) * coord, r5, n);  // X3 | Y3
    f256::store16(out + base + (lane ? 2 : 3) * coord, r6, n);  // T3 | Z3
  }
}

}  // namespace

extern "C" int lasso_padd(const int32_t* p, const int32_t* q, int32_t* out,
                          int64_t k, int64_t n, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  const int64_t blocks = (2 * k * n + kThreads - 1) / kThreads;
  padd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      p, q, out, k, n, f256::curve25519());
  return (int)cudaGetLastError();
}
