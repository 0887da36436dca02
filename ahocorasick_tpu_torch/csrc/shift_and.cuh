// The shift-AND core shared by the Hopper scan kernels (sm_90a):
// bitap.cu (G1, G2), staged.cu (G3, G4) and fingerprint.cu (G5, G6).
//
// Per stream s (one thread), per byte b and limb k:
//   cm = lo[k][b & 15] & hi[k][b >> 4]
//   m' = ((m << 1) | (m[k-1] >> 31) | start[k]) & cm
// State is uint32_t, so `>> 31` is a logical shift. For K <= 64 the limbs
// live in registers (template buckets KR over K, fully unrolled limb loop)
// and lo/hi sit in shared memory: 16 consecutive words per limb fall in 16
// distinct banks and equal addresses broadcast, so the per-byte lookups
// are free of bank conflicts. Beyond 64 limbs (KR == 0) the state goes to
// a global scratch [K, S] (coalesced across lanes) and the tables are read
// through the read-only cache.
//
// Lanes are laid out as in the JAX package: words stream-major,
// word[w][s], so a warp's 32 loads of one word row are one coalesced
// 128-byte transaction.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace shift_and {

constexpr int kThreads = 64;   // threads (= streams) per block
constexpr int kLanes = 1024;   // streams per [8, 128] tile

// Limb state and per-limb constants: registers for KR > 0 (K <= KR),
// global memory for KR == 0.
template <int KR>
struct Limbs {
  uint32_t m[KR > 0 ? KR : 1];
  uint32_t sm[KR > 0 ? KR : 1];
  uint32_t em[KR > 0 ? KR : 1];
  uint32_t* g;
  const uint32_t* gsm;
  const uint32_t* gem;
  int S;

  __device__ __forceinline__ uint32_t& at(int k) {
    if constexpr (KR > 0) {
      return m[k];
    } else {
      return g[static_cast<size_t>(k) * S];
    }
  }
  __device__ __forceinline__ uint32_t start(int k) const {
    if constexpr (KR > 0) {
      return sm[k];
    } else {
      return __ldg(gsm + k);
    }
  }
  __device__ __forceinline__ uint32_t end(int k) const {
    if constexpr (KR > 0) {
      return em[k];
    } else {
      return __ldg(gem + k);
    }
  }
};

// Limb loop: fully unrolled over the bucket KR with a guard, or a plain
// run-time loop on the spill path. Needs `K` and `KR` in scope.
#define FOR_LIMBS(k)                                          \
  _Pragma("unroll") for (int k = 0; k < (KR > 0 ? KR : K); ++k) \
      if (KR == 0 || k < K)

template <int KR>
__device__ __forceinline__ uint32_t charmask(const uint32_t* LO,
                                             const uint32_t* HI, int k,
                                             uint32_t b) {
  if constexpr (KR > 0) {
    return LO[k * 16 + (b & 15u)] & HI[k * 16 + (b >> 4)];
  } else {
    return __ldg(LO + k * 16 + (b & 15u)) & __ldg(HI + k * 16 + (b >> 4));
  }
}

// The nybble tables: copied into the block's shared memory `tab` for
// KR > 0, read from global memory otherwise. Every thread of the block
// must call this before any of them returns.
template <int KR>
__device__ __forceinline__ void load_tables(const uint32_t* lo,
                                            const uint32_t* hi, int K,
                                            uint32_t* tab,
                                            const uint32_t*& LO,
                                            const uint32_t*& HI) {
  LO = lo;
  HI = hi;
  if constexpr (KR > 0) {
    for (int i = threadIdx.x; i < K * 16; i += kThreads) {
      tab[i] = lo[i];
      tab[K * 16 + i] = hi[i];
    }
    __syncthreads();
    LO = tab;
    HI = tab + K * 16;
  }
}

// Zero state; start/end masks into registers (KR > 0).
template <int KR>
__device__ __forceinline__ void init(Limbs<KR>& st, const uint32_t* sm,
                                     const uint32_t* em, uint32_t* state,
                                     int s, int S, int K) {
  st.g = state + s;
  st.gsm = sm;
  st.gem = em;
  st.S = S;
  FOR_LIMBS(k) {
    st.at(k) = 0u;
    if constexpr (KR > 0) {
      st.sm[k] = sm[k];
      st.em[k] = em[k];
    }
  }
}

template <int KR>
__device__ __forceinline__ void reset(Limbs<KR>& st, int K) {
  FOR_LIMBS(k) { st.at(k) = 0u; }
}

// Advance every limb by byte b; on_limb(k, m') sees each new limb word in
// limb order.
template <int KR, typename F>
__device__ __forceinline__ void step(Limbs<KR>& st, const uint32_t* LO,
                                     const uint32_t* HI, int K, uint32_t b,
                                     F&& on_limb) {
  uint32_t carry = 0u;
  FOR_LIMBS(k) {
    const uint32_t old = st.at(k);
    const uint32_t nm = ((old << 1) | carry | st.start(k)) &
                        charmask<KR>(LO, HI, k, b);
    carry = old >> 31;
    st.at(k) = nm;
    on_limb(k, nm);
  }
}

// Walk the Hw halo words of stream s (the tail of stream s-1), calling
// on_limb as `step` does.
template <int KR, typename F>
__device__ __forceinline__ void walk_halo(Limbs<KR>& st, const uint32_t* LO,
                                          const uint32_t* HI, int K,
                                          const uint32_t* halo, int Hw,
                                          int s, int S, F&& on_limb) {
  for (int w = 0; w < Hw; ++w) {
    const uint32_t word = halo[static_cast<size_t>(w) * S + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      step<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u, on_limb);
    }
  }
}

// Dynamic shared memory of a block: lo and hi for KR > 0, none otherwise.
inline size_t shmem_bytes(int KR, int K) {
  return KR > 0 ? static_cast<size_t>(K) * 32 * sizeof(uint32_t) : 0;
}

inline int blocks_for(int S) { return (S + kThreads - 1) / kThreads; }

}  // namespace shift_and

// Run the statement(s) after K with `KR` bound to the register bucket for
// K limbs (1, 2, 3, 4, 8, 16, 32, 64), or to 0 (spill path) beyond 64.
#define SHIFT_AND_FOR_BUCKET(K, ...)                      \
  do {                                                    \
    if ((K) <= 1) {                                       \
      constexpr int KR = 1;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 2) {                                \
      constexpr int KR = 2;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 3) {                                \
      constexpr int KR = 3;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 4) {                                \
      constexpr int KR = 4;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 8) {                                \
      constexpr int KR = 8;                               \
      __VA_ARGS__;                                        \
    } else if ((K) <= 16) {                               \
      constexpr int KR = 16;                              \
      __VA_ARGS__;                                        \
    } else if ((K) <= 32) {                               \
      constexpr int KR = 32;                              \
      __VA_ARGS__;                                        \
    } else if ((K) <= 64) {                               \
      constexpr int KR = 64;                              \
      __VA_ARGS__;                                        \
    } else {                                              \
      constexpr int KR = 0;                               \
      __VA_ARGS__;                                        \
    }                                                     \
  } while (0)
