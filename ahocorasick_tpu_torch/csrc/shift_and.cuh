// The shift-AND core shared by the Hopper scan kernels (sm_90a):
// bitap.cu (G1, G2), staged.cu (G3, G4) and fingerprint.cu (G5, G6).
//
// Per stream s, per byte b and limb k:
//   cm = lo[k][b & 15] & hi[k][b >> 4]
//   m' = ((m << 1) | (m[k-1] >> 31) | start[k]) & cm
// State is uint32_t, so `>> 31` is a logical shift. For K <= 64 the limbs
// live in registers (template buckets KR over K, fully unrolled limb loop)
// and lo/hi sit in shared memory: 16 consecutive words per limb fall in 16
// distinct banks and equal addresses broadcast, so the per-byte lookups
// are free of bank conflicts. Beyond 64 limbs (KR == 0) the state goes to
// a global scratch, one row per limb coalesced across threads, and the
// tables are read through the read-only cache.
//
// Lanes are laid out as in the JAX package: words stream-major,
// word[w][s], so a warp's 32 loads of one word row are one coalesced
// 128-byte transaction.
//
// Two thread mappings use the core:
//   - one thread per stream (kThreads per block): G3 and G4 (staged.cu),
//     walk_halo then the body;
//   - one thread per (segment, stream) (kSegThreads per block): G1/G2
//     (bitap.cu) and G5/G6 (fingerprint.cu). Each stream is cut into P
//     segments of Ls bytes (segment_plan in ops/bitap_kernels.py); a
//     segment warms up over the H bytes before it, which is exact because
//     a state bit at chain offset i depends only on the last i + 1 bytes,
//     whatever the state before them, and i <= max_len - 1 <= H: the
//     warm-up plus the byte itself cover them. Words reach the byte loop
//     through a per-thread cp.async ring (walk_rows), so loads stay in
//     flight while the thread computes, and the step (step_padded) runs
//     every limb of the bucket with no per-limb branch. What bounds these
//     kernels is instruction issue (bitap.cu, fingerprint.cu).

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

// ---------------------------------------------------------------------------
// Segmented scans (bitap.cu, fingerprint.cu): each L-byte stream is cut
// into P segments of Ls = L / P bytes, one thread per (segment, stream).
// ---------------------------------------------------------------------------
constexpr int kSegThreads = 128;  // threads per block

// The (segment, stream) of this thread. Warps are 32 consecutive streams of
// one segment, so a warp's load of one word row is one 128-byte
// transaction; the segments of a stream group sit in neighbouring warps, so
// segment j's warm-up rows (segment j-1's last rows) are read close in
// time. `t` indexes the thread's limb scratch on the spill path.
struct Segment {
  int t;   // thread, 0 .. S*P-1
  int s;   // stream
  int j;   // segment
  int w0;  // first body word of the segment
  int nw;  // body words per segment, Wb / P
};

__device__ __forceinline__ bool segment_of(int S, int P, int Wb,
                                           Segment& g) {
  g.t = blockIdx.x * kSegThreads + threadIdx.x;
  if (g.t >= S * P) return false;
  const int warp = g.t >> 5;
  g.j = warp % P;
  g.s = (warp / P) * 32 + (g.t & 31);
  g.nw = Wb / P;
  g.w0 = g.j * g.nw;
  return true;
}

// Row i of a segment's walk, a pointer into `halo` (i < Hw, segment 0) or
// `body` (everything else). The walk is Hw warm-up rows, then the
// segment's nw body rows: segment 0 warms up over the halo (the tail of
// stream s-1), segment j > 0 over the Hw body rows before its own.
struct SegmentRows {
  const uint32_t* halo;
  const uint32_t* body;
  size_t S;
  int Hw;
  int w0;
  bool first;  // segment 0
  __device__ __forceinline__ const uint32_t* row(int i, int s) const {
    if (first && i < Hw) return halo + static_cast<size_t>(i) * S + s;
    return body + static_cast<size_t>(w0 + i - Hw) * S + s;
  }
};

// Words in flight: each thread keeps kRing - 1 rows of its walk in flight
// ahead of the one it scans, copied by cp.async into its own slots of a
// ring in shared memory ([kRing][kSegThreads] words, conflict-free).
constexpr int kRing = 4;

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
}

// Walk rows [0, count) in order, calling on_word(i, word). Each thread
// reads back only the slots it copied into, so cp.async.wait_group is the
// only synchronisation needed.
template <typename F>
__device__ __forceinline__ void walk_rows(const SegmentRows& r, int s,
                                          int count, uint32_t* ring,
                                          F&& on_word) {
  uint32_t* mine = ring + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) {
    if (i < count) cp_async4(mine + i * kSegThreads, r.row(i, s));
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    // Commit group g carries row g. Slot (i + kRing - 1) % kRing was read
    // one word ago and used; after this commit, waiting until at most
    // kRing - 1 groups are pending completes row i.
    const int ahead = i + kRing - 1;
    if (ahead < count) {
      cp_async4(mine + (ahead % kRing) * kSegThreads, r.row(ahead, s));
    }
    cp_async_commit();
    cp_async_wait();
    on_word(i, mine[(i % kRing) * kSegThreads]);
  }
}

// The segmented kernels step all KR register limbs with no per-limb guard:
// limbs K..KR-1 get zero tables and zero start and end masks, so they stay
// 0 and report nothing. A guard `k < K` compiles to a branch per limb and
// byte, and with it a recomputed table address and a register copy of the
// new state.

// The nybble tables, for KR > 0 copied into the block's shared memory
// `tab` and padded with zeros to KR limbs: lo at tab, hi at tab + 16 * KR.
// Every thread of the block must call this before any of them returns.
template <int KR>
__device__ __forceinline__ void load_tables_padded(const uint32_t* lo,
                                                   const uint32_t* hi, int K,
                                                   uint32_t* tab,
                                                   const uint32_t*& LO,
                                                   const uint32_t*& HI) {
  LO = lo;
  HI = hi;
  if constexpr (KR > 0) {
    for (int i = threadIdx.x; i < KR * 16; i += kSegThreads) {
      const bool live = i < K * 16;
      tab[i] = live ? lo[i] : 0u;
      tab[KR * 16 + i] = live ? hi[i] : 0u;
    }
    __syncthreads();
    LO = tab;
    HI = tab + KR * 16;
  }
}

// `init`, with the state and masks of limbs K..KR-1 zero.
template <int KR>
__device__ __forceinline__ void init_padded(Limbs<KR>& st,
                                            const uint32_t* sm,
                                            const uint32_t* em,
                                            uint32_t* state, int t, int row,
                                            int K) {
  init<KR>(st, sm, em, state, t, row, K);
  if constexpr (KR > 0) {
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      if (k >= K) {
        st.m[k] = 0u;
        st.sm[k] = 0u;
        st.em[k] = 0u;
      }
    }
  }
}

// `step` over limbs [0, KR) (the K limbs of the spill path): the funnel
// shift forms (m << 1) | (the old m of the limb below >> 31) at once.
template <int KR, typename F>
__device__ __forceinline__ void step_padded(Limbs<KR>& st, const uint32_t* LO,
                                            const uint32_t* HI, int K,
                                            uint32_t b, F&& on_limb) {
  if constexpr (KR == 0) {
    step<0>(st, LO, HI, K, b, on_limb);
  } else {
    const uint32_t* lo = LO + (b & 15u);
    const uint32_t* hi = HI + (b >> 4);
    uint32_t below = 0u;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const uint32_t old = st.m[k];
      const uint32_t nm = (__funnelshift_l(below, old, 1) | st.sm[k]) &
                          lo[16 * k] & hi[16 * k];
      below = old;
      st.m[k] = nm;
      on_limb(k, nm);
    }
  }
}

// Dynamic shared memory of a segmented block: the padded tables, then the
// ring.
inline size_t seg_shmem_bytes(int KR) {
  return static_cast<size_t>(KR) * 32 * sizeof(uint32_t) +
         static_cast<size_t>(kRing) * kSegThreads * sizeof(uint32_t);
}

inline int seg_blocks_for(int S, int P) {
  return (S * P + kSegThreads - 1) / kSegThreads;
}

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
