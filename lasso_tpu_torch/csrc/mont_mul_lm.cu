// K2: batched limb-major Montgomery multiplication for Hopper (sm_90a).
//
// Replaces lasso_tpu/ops/field_pallas.py:_mont_mul_lm_batched (kernel body
// _mont_mul_body, entry mont_mul_lm): out = a*b*2^-256 mod p for Fr or Fp,
// canonical, on limb-major [K, 16, n] int32-held 16-bit limbs, either
// operand possibly one [16, 1] element read with stride 0.  It carries
// every field product of the unfused curve path (curve/tcurve.py
// _padd_unfused / _pdbl_unfused, three stacked products per group op).
//
// What bounds it on the H100 depends on the launch:
//   - Bytes, at [4, 16, 2^20]: each product reads 2 x 64 B and writes 64 B
//     (the bytes take 240 us at 3.35 TB/s) against 272 32-bit multiply
//     instructions (68 us at the card's 16.7e12 integer multiplies per
//     second: 64 per clock per SM, 132 SMs, 1980 MHz).
//   - One product's latency, at [4, 16, 512], the unfused path's most
//     common launch: 2048 products are 0.12 us of bytes and 0.03 us of
//     multiplies, so the launch takes what one thread's dependent chain
//     takes (its limb loads, 8 CIOS rows of carry chains, the stores) on
//     top of the launch itself.
//
// Design:
//   - Short chains.  The products run on PTX carry chains: Fr through
//     f256::dev::mont_mul, Fp through f256::dev::mont_mul_p25519, whose
//     reduction rows are q * 2^255 - 19 * q (one multiply and two short
//     chains instead of 16 multiply-adds).  The kernel is a template on the
//     field, one instantiation per field, so no product branches; the
//     modulus is an immediate.
//   - A grid shaped for the launch (f256::lm_launch), from a sweep on the
//     card.  Blocks of 128 threads, not 256: 2048 products run on 16 SMs
//     with one warp per scheduler, not on 8 SMs with two, which took 27%
//     longer.  At large launches a thread owns kCols = 2 neighbouring
//     columns of one row, each limb of both one 8-byte load, which halves
//     the load instructions (2-4% faster at [4, 16, 2^20]).  Smaller
//     blocks for small launches were no faster and are not kept.
//   - Coalesced limb-major addressing with no padding of n: limb i of
//     column c of row k is at (k*16 + i)*n + c, so neighbouring threads
//     read neighbouring addresses without a transpose, and the last block
//     masks the ragged edge.
//   - A [16, 1] operand is read once per thread into registers (the entry
//     swaps the operands so that it is b: the product is commutative and
//     its canonical result unique).  No assumption is made about its value.
//   - The kernel allocates nothing and launches on the caller's stream.
// Measured on an H100 (lasso_tpu_torch/benches/kernel_sweep.py, PERF.md):
// 0.0018 ms at [4, 16, 512], the same as the latency floor of one warp with
// one product per thread; 85-90% of the bytes bound at [4, 16, 2^20].
// ptxas: 32 to 56 registers in each of the 8 instantiations (2 fields x
// b whole or one element x 1 or 2 columns per thread), no spills.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kCols = 2;       // columns per thread at large launches

struct FrMul {
  __device__ __forceinline__ static void mul(uint32_t o[f256::N],
                                             const uint32_t a[f256::N],
                                             const uint32_t b[f256::N]) {
    f256::dev::mont_mul(o, a, b, f256::fr_modulus());
  }
};

struct FpMul {
  __device__ __forceinline__ static void mul(uint32_t o[f256::N],
                                             const uint32_t a[f256::N],
                                             const uint32_t b[f256::N]) {
    f256::dev::mont_mul_p25519(o, a, b, f256::fp_modulus());
  }
};

template <class Mul, bool kBConst, int kC>
__global__ void __launch_bounds__(kThreads)
    mont_mul_lm_kernel(const int32_t* __restrict__ a,
                       const int32_t* __restrict__ b,
                       int32_t* __restrict__ out, uint32_t n,
                       uint32_t groups) {
  const uint32_t g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < groups) {
    f256::mont_mul_lm_columns<Mul, kBConst, kC>(a, b, out, g * kC, n);
  }
}

template <class Mul>
cudaError_t launch(const int32_t* a, const int32_t* b, int32_t* out,
                   bool b_const, const f256::LmLaunch& s,
                   cudaStream_t stream, uint32_t n) {
  const dim3 grid(s.blocks), block(kThreads);
  if (s.cols == 2) {
    if (b_const) {
      mont_mul_lm_kernel<Mul, true, kCols>
          <<<grid, block, 0, stream>>>(a, b, out, n, s.groups);
    } else {
      mont_mul_lm_kernel<Mul, false, kCols>
          <<<grid, block, 0, stream>>>(a, b, out, n, s.groups);
    }
  } else if (b_const) {
    mont_mul_lm_kernel<Mul, true, 1>
        <<<grid, block, 0, stream>>>(a, b, out, n, s.groups);
  } else {
    mont_mul_lm_kernel<Mul, false, 1>
        <<<grid, block, 0, stream>>>(a, b, out, n, s.groups);
  }
  return cudaGetLastError();
}

// SMs of the current device, read once (one device per process).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) == cudaSuccess &&
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) ==
            cudaSuccess) {
      sms = v;
    }
  }
  return sms;
}

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

}  // namespace

// a, b: contiguous, 4-byte aligned [k, 16, n] limbs, or one [16, 1]
// element where bit 0 (a) or bit 1 (b) of `consts` is set; out: contiguous
// [k, 16, n].  field: 0 = Fr, 1 = Fp.  Returns the cudaError of the launch.
extern "C" int lasso_mont_mul_lm(const int32_t* a, const int32_t* b,
                                 int32_t* out, int64_t k, int64_t n,
                                 int consts, int field, void* stream) {
  if (k <= 0 || n <= 0) return 0;
  if (consts == 3 || k * n > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (consts == 1) {  // keep the broadcast operand in b
    const int32_t* t = a;
    a = b;
    b = t;
  }
  const bool b_const = consts != 0;
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const bool pairs_ok =
      aligned(a, 8) && aligned(out, 8) && (b_const || aligned(b, 8));
  const f256::LmLaunch s = f256::lm_launch((uint32_t)(k * n), (uint32_t)n,
                                           pairs_ok, sms, kThreads, kCols);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      field == 0 ? launch<FrMul>(a, b, out, b_const, s, st, (uint32_t)n)
                 : launch<FpMul>(a, b, out, b_const, s, st, (uint32_t)n);
  return (int)err;
}
