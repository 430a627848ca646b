// K5: the field layer's additions and column sums for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference leaves these carry chains to
// XLA, which fuses them; in eager PyTorch the plain versions
// (lasso_tpu_torch/field/tfield.py: _add_plain, _sub_plain,
// _sum_columns_plain, _finish_sum_plain) cost about 45, 17 and 155 aten
// ops a call.  Three entry points, each one launch:
//   - lasso_field_addsub: (a + b) or (a - b) mod p of canonical Montgomery
//     limbs, Fr or Fp, either operand strided or one broadcast element;
//   - lasso_field_sum: the exact column sums of [n, m, 16] limbs as the
//     plain version's [m, 19] int64 wide columns (the multi-device
//     prover's psum sits between them and the finish);
//   - lasso_field_finish: wide columns -> one canonical Montgomery element
//     each, the product with R^2 included.
//
// What bounds it on the H100: bytes.  An add or sub reads 2 x 64 B and
// writes 64 B an element against a 9-word carry chain or two; a column sum
// reads 64 B a row.  The prove's calls are small (2^15 elements and fewer),
// so a launch's fixed cost sets most of their time.
//
// Design:
//   - Add/sub: one element per thread, its 16 limbs as four 16-byte loads
//     per operand (f256::load16_vec), the sum on PTX carry chains
//     (f256::dev::add_mod / sub_mod), a grid-stride loop over blocks of
//     256.  One template per field and operation; the modulus is an
//     immediate.
//   - Column sums: four threads a row, each summing one 16-byte chunk (4
//     limbs) of its rows in 64-bit registers, so a warp reads 8 rows of
//     one set as 512 contiguous bytes where rows are contiguous; the lanes
//     of one chunk reduce by shuffles, the warps through shared memory.
//     Where the sets alone leave SMs idle, up to kMaxSplits blocks share a
//     set's rows as one thread block cluster, and block 0 adds the others'
//     partial sums from their shared memory (distributed shared memory),
//     so a sum is one launch with nothing to zero first.  Integer sums are
//     exact in any order: the columns equal the plain version's.
//   - Finish: one thread per column set (a proof sums a few sets at a
//     time), portable uint64 arithmetic (f256::finish_wide).
//   - The kernels allocate nothing and launch on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;         // add/sub threads per block
constexpr int kBlocksPerSm = 8;       // add/sub grid cap, in blocks per SM
constexpr int kFinishThreads = 128;

struct DevOps {
  __device__ __forceinline__ static void add(uint32_t o[f256::N],
                                             const uint32_t a[f256::N],
                                             const uint32_t b[f256::N],
                                             const f256::Modulus& m) {
    f256::dev::add_mod(o, a, b, m);
  }
  __device__ __forceinline__ static void sub(uint32_t o[f256::N],
                                             const uint32_t a[f256::N],
                                             const uint32_t b[f256::N],
                                             const f256::Modulus& m) {
    f256::dev::sub_mod(o, a, b, m);
  }
};

template <int kField>
__device__ __forceinline__ f256::Modulus modulus() {
  return kField == 0 ? f256::fr_modulus() : f256::fp_modulus();
}

template <int kField, bool kSub>
__global__ void __launch_bounds__(kThreads)
    field_addsub_kernel(const int32_t* __restrict__ a,
                        const int32_t* __restrict__ b,
                        int32_t* __restrict__ out, uint32_t total,
                        uint32_t inner, int64_t sa0, int64_t sa1, int64_t sb0,
                        int64_t sb1) {
  const f256::Modulus m = modulus<kField>();
  for (uint32_t e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    f256::addsub_element<DevOps, kSub>(a, b, out, e, inner, sa0, sa1, sb0,
                                       sb1, m);
  }
}

__global__ void __launch_bounds__(1024)
    field_sum_kernel(const int32_t* __restrict__ x, int64_t* __restrict__ out,
                     int64_t n, uint32_t m, int64_t sn, int64_t sm,
                     int splits) {
  __shared__ uint64_t warp_sums[32][16];
  __shared__ uint64_t part[16];
  __shared__ uint64_t total[16];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31, warps = blockDim.x / 32;
  const int rank = (int)cluster.block_rank();  // == blockIdx.x
  int64_t begin, end;
  f256::split_rows(n, splits, rank, &begin, &end);
  for (uint32_t set = blockIdx.y; set < m; set += gridDim.y) {
    uint64_t acc[4] = {0, 0, 0, 0};
    f256::sum_rows(acc, x + (int64_t)set * sm, sn, begin, end, t, blockDim.x);
    // lanes of one chunk (lane % 4) hold the same four limbs
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k] += __shfl_xor_sync(0xffffffffu, (unsigned long long)acc[k], off);
      }
    }
    if (lane < 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) warp_sums[t >> 5][4 * lane + k] = acc[k];
    }
    __syncthreads();
    if (t < 16) {
      uint64_t v = 0;
      for (int w = 0; w < warps; ++w) v += warp_sums[w][t];
      part[t] = v;
    }
    cluster.sync();  // every block's part is written
    if (rank == 0 && t < 16) {
      uint64_t v = 0;
      for (int r = 0; r < splits; ++r) v += cluster.map_shared_rank(part, r)[t];
      total[t] = v;
    }
    cluster.sync();  // block 0 has read every part
    if (rank == 0 && t == 0) {
      int64_t w[f256::kWide];
      f256::wide_columns(w, total);
      for (int j = 0; j < f256::kWide; ++j) out[(int64_t)set * f256::kWide + j] = w[j];
    }
  }
}

template <int kField>
__global__ void __launch_bounds__(kFinishThreads)
    field_finish_kernel(const int64_t* __restrict__ cols,
                        int32_t* __restrict__ out, uint32_t m, int width) {
  const uint32_t set = blockIdx.x * blockDim.x + threadIdx.x;
  if (set < m) {
    uint32_t w[f256::N];
    f256::finish_wide<f256::PortableOps>(w, cols + (int64_t)set * width, width,
                                      modulus<kField>(), kField);
    f256::store16(out + (int64_t)set * 16, w, 1);
  }
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

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <int kField>
cudaError_t launch_addsub(bool sub, dim3 grid, cudaStream_t st,
                          const int32_t* a, const int32_t* b, int32_t* out,
                          uint32_t total, uint32_t inner, int64_t sa0,
                          int64_t sa1, int64_t sb0, int64_t sb1) {
  if (sub) {
    field_addsub_kernel<kField, true><<<grid, kThreads, 0, st>>>(
        a, b, out, total, inner, sa0, sa1, sb0, sb1);
  } else {
    field_addsub_kernel<kField, false><<<grid, kThreads, 0, st>>>(
        a, b, out, total, inner, sa0, sa1, sb0, sb1);
  }
  return cudaGetLastError();
}

}  // namespace

// out[o, i] = a[o, i] +- b[o, i] mod p over a logical [outer, inner]
// batch: element (o, i) of a at a + o * sa0 + i * sa1 int32s (b likewise),
// 16 contiguous limbs each; out contiguous [outer * inner, 16].  Pointers
// 16-byte aligned and strides multiples of 4.  sub: 0 = add, 1 = sub;
// field: 0 = Fr, 1 = Fp.  Returns the cudaError of the launch.
extern "C" int lasso_field_addsub(const int32_t* a, const int32_t* b,
                                  int32_t* out, int64_t outer, int64_t inner,
                                  int64_t sa0, int64_t sa1, int64_t sb0,
                                  int64_t sb1, int sub, int field,
                                  void* stream) {
  if (outer <= 0 || inner <= 0) return 0;
  const int64_t total = outer * inner;
  if (total > INT32_MAX || !aligned16(a) || !aligned16(b) || !aligned16(out) ||
      ((sa0 | sa1 | sb0 | sb1) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (int64_t)kBlocksPerSm * sms) blocks = (int64_t)kBlocksPerSm * sms;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err =
      field == 0 ? launch_addsub<0>(sub, grid, st, a, b, out, (uint32_t)total,
                                    (uint32_t)inner, sa0, sa1, sb0, sb1)
                 : launch_addsub<1>(sub, grid, st, a, b, out, (uint32_t)total,
                                    (uint32_t)inner, sa0, sa1, sb0, sb1);
  return (int)err;
}

// out[j, :] = the wide columns of sum_r x[r, j, :] over rows r < n: x's
// row r of set j at x + r * sn + j * sm int32s, 16 contiguous limbs in
// [0, 2^16); out contiguous [m, 19] int64.  x 16-byte aligned, strides
// multiples of 4.  Returns the cudaError of the launch.
extern "C" int lasso_field_sum(const int32_t* x, int64_t* out, int64_t n,
                               int64_t m, int64_t sn, int64_t sm,
                               void* stream) {
  if (m <= 0) return 0;
  if (n < 0 || n > INT32_MAX || m > INT32_MAX || !aligned16(x) ||
      ((sn | sm) & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int sms = sm_count();
  if (sms == 0) return (int)cudaErrorInvalidDevice;
  const f256::SumLaunch s = f256::sum_launch(n, m, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)s.splits, (unsigned)(m < 65535 ? m : 65535));
  cfg.blockDim = dim3((unsigned)s.threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)s.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, field_sum_kernel, x, out, n,
                                 (uint32_t)m, sn, sm, s.splits);
}

// out[j] = the canonical Montgomery limbs of V_j mod p, V_j the value of
// wide columns cols[j, :width] (width <= 33, V_j < R * p, each column in
// [0, 2^48)); cols contiguous [m, width] int64, out contiguous [m, 16].
// Returns the cudaError of the launch.
extern "C" int lasso_field_finish(const int64_t* cols, int32_t* out,
                                  int64_t m, int64_t width, int field,
                                  void* stream) {
  if (m <= 0) return 0;
  if (m > INT32_MAX || width < 1 || width > f256::kMaxWide) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((m + kFinishThreads - 1) / kFinishThreads);
  cudaStream_t st = (cudaStream_t)stream;
  if (field == 0) {
    field_finish_kernel<0><<<blocks, kFinishThreads, 0, st>>>(
        cols, out, (uint32_t)m, (int)width);
  } else {
    field_finish_kernel<1><<<blocks, kFinishThreads, 0, st>>>(
        cols, out, (uint32_t)m, (int)width);
  }
  return (int)cudaGetLastError();
}
