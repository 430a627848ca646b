// K1: batched Montgomery multiplication for Hopper (sm_90a).
//
// Replaces lasso_tpu/ops/field_pallas.py:_mont_mul_lm (kernel body
// _mont_mul_body, entry mont_mul_pallas): out = a*b*2^-256 mod p for Fr or
// Fp, canonical, on the port's element-major [n, 16] int32-held 16-bit limb
// layout.  Either operand may be one broadcast [16] element (a challenge,
// R^2, 1), read with a row stride of 0.
//
// What bounds it on the H100: memory.  Each product reads 2 x 64 B and
// writes 64 B against 136 32x32->64-bit multiplies (272 32-bit multiply
// instructions).  The card issues 32-bit integer multiplies at 64 per clock
// per SM (132 SMs, ~16.7e12/s at 1980 MHz) against 3.35 TB/s of memory:
// at [2^20, 16] the bytes take 60 us, the multiplies 17 us.
//
// The layout is what held the first version back: one element per thread
// loading its 16 limbs as scalars puts neighbouring threads 64 B apart, so
// each warp load touches 32 sectors and uses 4 B of each.  (The reference
// avoids this on the TPU by transposing to limb-major before the kernel.)
//
// Design:
//   - A block owns a tile of kThreads consecutive elements: one contiguous
//     range of kThreads x 64 B per operand.  Its threads copy the tile into
//     shared memory with cp.async, 16 B per thread per copy, neighbouring
//     threads on neighbouring chunks (fully coalesced).
//   - Chunk c of element e lands at slot f256::tile_slot(e, c), a swizzle
//     that keeps both the copy-in and the per-element 16-byte reads free of
//     bank conflicts.  Each thread then reads its element (4 x 16 B), runs
//     the carry-chain product (f256::dev::mont_mul) and writes the result
//     back over its own a slots; the block stores the tile with coalesced
//     16-byte stores.
//   - Persistent grid: as many blocks as fit on the card stride over the
//     tiles through a two-stage ring, so the next tile's copy is in flight
//     while the current tile's products run.
//   - A broadcast operand is read once per thread into registers and never
//     staged; the C entry swaps the operands so the broadcast one is b
//     (the product is commutative and its canonical result unique).
//   - The ragged last tile is masked.
// Every operand must be 16-byte aligned (the wrapper checks).  The kernel
// allocates nothing and launches on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field256.cuh"

namespace {

constexpr int kThreads = 128;             // elements per tile, one per thread
constexpr int kChunks = 4;                // 16-byte chunks per element
constexpr int kTileChunks = kThreads * kChunks;

struct __align__(16) Stage {
  uint4 a[kTileChunks];
  uint4 b[kTileChunks];
};

__device__ __forceinline__ void cp_async16(uint4* smem, const uint4* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4 limbs (one chunk) <-> 2 words
__device__ __forceinline__ void unpack(uint32_t w[2], uint4 x) {
  w[0] = (x.x & 0xffffu) | (x.y << 16);
  w[1] = (x.z & 0xffffu) | (x.w << 16);
}

__device__ __forceinline__ uint4 pack(const uint32_t w[2]) {
  return make_uint4(w[0] & 0xffffu, w[0] >> 16, w[1] & 0xffffu, w[1] >> 16);
}

template <bool kBConst>
__global__ void __launch_bounds__(kThreads)
    mont_mul_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    uint4* __restrict__ out, int64_t n, f256::Modulus m) {
  __shared__ Stage stage[2];
  const int tid = threadIdx.x;
  const int64_t tiles = (n + kThreads - 1) / kThreads;

  // copy tile `tile`'s operands into stage s (only the chunks it has)
  auto issue = [&](int64_t tile, Stage& s) {
    const int64_t first = tile * kTileChunks;
    const int64_t left = n * kChunks - first;
    const int chunks = left < kTileChunks ? (int)left : kTileChunks;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int g = tid + k * kThreads;
      if (g < chunks) {
        const int slot = f256::tile_slot(g / kChunks, g % kChunks);
        cp_async16(&s.a[slot], a + first + g);
        if (!kBConst) cp_async16(&s.b[slot], b + first + g);
      }
    }
  };

  uint32_t y[f256::N];
  if (kBConst) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) unpack(y + 2 * c, __ldg(b + c));
  }

  int64_t tile = blockIdx.x;
  if (tile < tiles) issue(tile, stage[0]);
  cp_async_commit();
  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    Stage& cur = stage[it & 1];
    const int64_t next = tile + gridDim.x;
    if (next < tiles) issue(next, stage[(it + 1) & 1]);
    cp_async_commit();  // possibly empty: the current tile's group is then
    cp_async_wait_one();  // always the second newest
    __syncthreads();

    const int64_t left = n - tile * kThreads;
    const int elems = left < kThreads ? (int)left : kThreads;
    if (tid < elems) {
      uint32_t x[f256::N], z[f256::N];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int slot = f256::tile_slot(tid, c);
        unpack(x + 2 * c, cur.a[slot]);
        if (!kBConst) unpack(y + 2 * c, cur.b[slot]);
      }
      f256::dev::mont_mul(z, x, y, m);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        cur.a[f256::tile_slot(tid, c)] = pack(z + 2 * c);
      }
    }
    __syncthreads();

    const int64_t first = tile * kTileChunks;
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      const int g = tid + k * kThreads;
      if (g < elems * kChunks) {
        out[first + g] = cur.a[f256::tile_slot(g / kChunks, g % kChunks)];
      }
    }
    __syncthreads();  // the stage is free for the copy two tiles on
  }
}

// Blocks of `kernel` that fit on the current device at once, into *out.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int64_t* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  *out = (int64_t)sms * per_sm;
  if (err == cudaSuccess && *out == 0) err = cudaErrorInvalidConfiguration;
  return err;
}

template <bool kBConst>
int launch(const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
           const f256::Modulus& m, cudaStream_t stream) {
  static int64_t resident = 0;  // per instantiation; one device per process
  if (resident == 0) {
    const cudaError_t err =
        resident_blocks(mont_mul_kernel<kBConst>, &resident);
    if (err != cudaSuccess) {
      resident = 0;
      return (int)err;
    }
  }
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const int64_t blocks = tiles < resident ? tiles : resident;
  mont_mul_kernel<kBConst><<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(a), reinterpret_cast<const uint4*>(b),
      reinterpret_cast<uint4*>(out), n, m);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// a, b: [n, 16] rows (stride 16) or one broadcast [16] element (stride 0);
// out: [n, 16].  Returns the cudaError of the launch.
extern "C" int lasso_mont_mul(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t n, int64_t a_stride,
                              int64_t b_stride, int field, void* stream) {
  if (n <= 0) return 0;
  if ((a_stride != 0 && a_stride != 16) || (b_stride != 0 && b_stride != 16) ||
      !aligned16(a) || !aligned16(b) || !aligned16(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 1) a_stride = b_stride = 16;  // one element: no broadcast
  if (a_stride == 0 && b_stride == 0) return (int)cudaErrorInvalidValue;
  if (a_stride == 0) {  // keep the broadcast operand in b
    const int32_t* t = a;
    a = b;
    b = t;
    b_stride = 0;
  }
  const f256::Modulus m =
      field == 0 ? f256::fr_modulus() : f256::fp_modulus();
  cudaStream_t s = (cudaStream_t)stream;
  return b_stride == 0 ? launch<true>(a, b, out, n, m, s)
                       : launch<false>(a, b, out, n, m, s);
}
