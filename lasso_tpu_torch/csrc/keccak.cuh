// keccak-f[1600] lane arithmetic shared by kernel K4 (keccak.cu) and the
// CPU tests, which build this header with a host compiler.
//
// K4 runs one permutation per warp, one 64-bit lane per thread: thread l
// holds lane l = x + 5*y of the state (threads 25..31 compute on a copy of
// lane 0 and store nothing).  A round needs other lanes' values at three
// points, and each thread's source lanes are fixed, so they are computed
// once (lane_map) and the kernel exchanges values with __shfl_sync:
//   theta  c[x] = xor of the 5 lanes of column x; d = c[x-1] ^ rotl(c[x+1], 1)
//   rho+pi b[l] = rotl(a[pi_src(l)], rho(pi_src(l)))
//   chi    a[l] = b[l] ^ (~b[x+1, y] & b[x+2, y])
//   iota   lane 0 ^= the round constant
// Everything here is portable __host__ __device__ C++ with no CUDA
// intrinsics; the exchange itself is the kernel's (or the test's
// simulated warp's).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define KECCAK_HD __host__ __device__ __forceinline__
#else
#define KECCAK_HD inline
#endif

namespace keccak {

constexpr int kLanes = 25;
constexpr int kRounds = 24;
constexpr int kStateBytes = 200;

KECCAK_HD uint64_t rotl(uint64_t v, int n) {
  return (v << n) | (v >> ((64 - n) & 63));
}

KECCAK_HD uint64_t round_constant(int i) {
  const uint64_t rc[kRounds] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  return rc[i];
}

// rho rotation of flat lane l = x + 5*y
KECCAK_HD int rho(int l) {
  const int r[kLanes] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                         25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
  return r[l];
}

// The fixed source lanes of lane l's round.
struct LaneMap {
  int column[5];  // the lanes of l's column x: x, x+5, ..., x+20
  int c_prev;     // a lane of column x-1 (every lane of a column holds c[x])
  int c_next;     // a lane of column x+1
  int pi_src;     // the lane that rho+pi moves to l
  int pi_rot;     // its rho rotation
  int chi1;       // (x+1, y)
  int chi2;       // (x+2, y)
};

KECCAK_HD LaneMap lane_map(int l) {
  const int x = l % 5, y = l / 5;
  LaneMap m;
  for (int k = 0; k < 5; ++k) m.column[k] = x + 5 * k;
  m.c_prev = (x + 4) % 5;
  m.c_next = (x + 1) % 5;
  // pi sends (sx, sy) to (sy, (2*sx + 3*sy) % 5); so l = (x, y) comes from
  // sy = x and sx = (x + 3*y) % 5 (2 * 3 = 1 mod 5)
  m.pi_src = (x + 3 * y) % 5 + 5 * x;
  m.pi_rot = rho(m.pi_src);
  m.chi1 = (x + 1) % 5 + 5 * y;
  m.chi2 = (x + 2) % 5 + 5 * y;
  return m;
}

KECCAK_HD uint64_t theta_d(uint64_t c_prev, uint64_t c_next) {
  return c_prev ^ rotl(c_next, 1);
}

KECCAK_HD uint64_t chi(uint64_t b, uint64_t b1, uint64_t b2) {
  return b ^ (~b1 & b2);
}

// Lane l of a state of bytes held one per int32 (little-endian lanes).
KECCAK_HD uint64_t load_lane(const int32_t* state, int l) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) {
    v |= (uint64_t)((uint32_t)state[8 * l + i] & 0xffu) << (8 * i);
  }
  return v;
}

KECCAK_HD void store_lane(int32_t* state, int l, uint64_t v) {
  for (int i = 0; i < 8; ++i) state[8 * l + i] = (int32_t)((v >> (8 * i)) & 0xffu);
}

}  // namespace keccak
