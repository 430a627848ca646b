// K4: keccak-f[1600] for Hopper (sm_90a), the permutation of the
// device-resident Fiat-Shamir transcript.
//
// Replaces lasso_tpu/transcript/device_strobe.py:keccak_f1600_device, an
// XLA program (24 rounds of vector ops over 25 (lo, hi) uint32 lane
// halves), not a Pallas kernel.  In eager PyTorch its plain version
// (lasso_tpu_torch/transcript/device_strobe.py:keccak_f1600_plain) costs
// about 50 launches per round, some 1,200 per permutation; a proof runs
// hundreds of permutations.
//
// What bounds it on the H100: latency.  One permutation reads and writes
// 200 bytes and needs 24 x 155 64-bit logic operations, nothing against
// the card's rates; the 24 rounds depend on each other, and each
// round waits on three exchanges between lanes.  So the time is a launch's
// fixed cost plus one chain of 24 rounds.
//
// Design: one warp per state, one 64-bit lane per thread (thread l holds
// lane l = x + 5*y; threads 25..31 run on a copy of lane 0 so every shuffle
// has the full warp, and store nothing).  The lanes a thread reads from in
// a round are fixed (keccak::lane_map, computed once), so each round is
// 5 + 2 + 1 + 2 64-bit __shfl_sync and a few logic operations, all in
// registers.  The round constants come from the header's table once:
// thread i < 24 keeps constant i and round r reads it from thread r with
// one more shuffle, so no constant memory is set up.
//
// The state is [count, 200] int32, one byte per int32 (the transcript's
// byte tensor); a launch permutes every state in place, one block of one
// warp per state.  The kernel allocates nothing and launches on the
// caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

#include "keccak.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t from(uint64_t v, int lane) {
  return __shfl_sync(kFull, (unsigned long long)v, lane);
}

__global__ void __launch_bounds__(32) keccak_kernel(int32_t* __restrict__ states) {
  const int t = threadIdx.x;
  const int l = t < keccak::kLanes ? t : 0;
  int32_t* state = states + (int64_t)blockIdx.x * keccak::kStateBytes;
  const keccak::LaneMap m = keccak::lane_map(l);
  const uint64_t rc = keccak::round_constant(t < keccak::kRounds ? t : 0);

  uint64_t a = keccak::load_lane(state, l);
#pragma unroll 1
  for (int r = 0; r < keccak::kRounds; ++r) {
    // theta
    uint64_t c = from(a, m.column[0]);
#pragma unroll
    for (int k = 1; k < 5; ++k) c ^= from(a, m.column[k]);
    a ^= keccak::theta_d(from(c, m.c_prev), from(c, m.c_next));
    // rho + pi
    const uint64_t b = keccak::rotl(from(a, m.pi_src), m.pi_rot);
    // chi
    a = keccak::chi(b, from(b, m.chi1), from(b, m.chi2));
    // iota
    const uint64_t rc_r = from(rc, r);
    if (t == 0) a ^= rc_r;
  }
  if (t < keccak::kLanes) keccak::store_lane(state, t, a);
}

}  // namespace

// states: [count, 200] int32 bytes, permuted in place.  Returns the
// cudaError of the launch.
extern "C" int lasso_keccak_f1600(int32_t* states, int64_t count,
                                  void* stream) {
  if (count <= 0) return 0;
  if (count > 0x7fffffff) return (int)cudaErrorInvalidValue;
  keccak_kernel<<<(unsigned)count, 32, 0, (cudaStream_t)stream>>>(states);
  return (int)cudaGetLastError();
}
