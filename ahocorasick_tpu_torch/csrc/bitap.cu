// Exact bit-parallel shift-AND scan for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   G1  ahocorasick_tpu/ops/bitap.py::_make_kernel        -> bitap_generic_scan
//       tables at run time, positions masked to the window [n0, n),
//       extract writes the end word of every limb: [tiles, L, K, 8, 128];
//   G2  ahocorasick_tpu/ops/bitap.py::_make_baked_kernel  -> bitap_baked_scan
//       the haystack is padded with a byte whose charmask is zero in every
//       limb, so no position mask; extract writes only the end-bearing
//       limbs, in limb order: [tiles, L, Ke, 8, 128].
// Both compute, per stream s (an L-byte block at s*L, warmed up over the
// H bytes before it), for every byte b and limb k:
//   cm = lo[k][b & 15] & hi[k][b >> 4]
//   m' = ((m << 1) | (m[k-1] >> 31) | start[k]) & cm
// and count popc(m' & end[k]) (or write it as the end word). G2 differs
// from G1 only by the missing mask and the dense end-limb word axis; the
// TPU version's compile-time constant tables are later work, so both
// take their tables at run time here.
//
// What bounds it on an H100: integer issue. Each byte costs about
// 2 + 8K int32 operations (two nybble-table loads, and, shift, two ors,
// and, popc/and per limb) against one byte read from HBM, so with K >= 1
// the ALU rate (64 INT32 lanes per SM) and not the 3.35 TB/s of memory
// is the floor. Extraction adds 4K (G1) or 4Ke (G2) bytes written per
// byte scanned, which stays below the ALU time for small K.
//
// Design:
//   - One thread per stream. The thread walks the halo and then the body
//     itself, which takes the place of the TPU's sequential chunk axis and
//     of the VMEM state scratch carried across it.
//   - Lanes are laid out as in the JAX package (stream-major words
//     body[w][s]), so a warp's 32 loads of one word row are one coalesced
//     128-byte transaction, and the end words [.., t, k, lane] are written
//     lane-fastest, coalesced too.
//   - The shift-AND step, the register buckets over K, the shared-memory
//     nybble tables and the spill path beyond 64 limbs are the shared
//     core in shift_and.cuh. Decollided chain packing can spread an
//     eligible set over up to 2048 limbs (256 three-byte patterns give
//     K = 229), which the spill path serves.
//   - Known weakness: the JAX layout gives 32 tiles x 1024 = 32,768
//     streams at 64 MiB, i.e. 32,768 threads on a card with 270,336
//     resident thread slots (12% occupancy); the kernel is latency-bound
//     there. Kept so raw outputs compare directly with the JAX kernels.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError() so the caller can
// raise on a refused launch.

#include "shift_and.cuh"

namespace {

using namespace shift_and;

struct Params {
  const uint32_t* lo;     // [K, 16]
  const uint32_t* hi;     // [K, 16]
  const uint32_t* sm;     // [K] chain-start bits
  const uint32_t* em;     // [K] chain-end bits
  const uint32_t* halo;   // [Hw, S] words, stream-major
  const uint32_t* body;   // [Wb, S] words, stream-major
  int32_t* counts;        // [S]
  int32_t* words;         // [tiles, L, kdim, 1024] or null (count only)
  uint32_t* state;        // [K, S] scratch for K > 64, else null
  int K;
  int Hw;
  int Wb;
  int S;
  int kdim;
  long long n0;           // count window [n0, n) (G1 only)
  long long n;
};

template <int KR, bool BAKED, bool EXTRACT>
__global__ void __launch_bounds__(kThreads) scan_kernel(Params p) {
  extern __shared__ uint32_t tab[];  // lo [K*16] then hi [K*16]
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables<KR>(p.lo, p.hi, K, tab, LO, HI);
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.S) return;

  Limbs<KR> st;
  init<KR>(st, p.sm, p.em, p.state, s, p.S, K);
  // Warm-up over the halo (the tail of stream s-1): no hits counted.
  walk_halo<KR>(st, LO, HI, K, p.halo, p.Hw, s, p.S, [](int, uint32_t) {});
  // Stream 0's halo wraps around to the end of the buffer: no history.
  if (s == 0) reset<KR>(st, K);

  const long long L = 4LL * p.Wb;
  const long long pos0 = static_cast<long long>(s) * L;
  const size_t tile = static_cast<size_t>(s / kLanes);
  const int lane = s % kLanes;
  int cnt = 0;
  for (int w = 0; w < p.Wb; ++w) {
    const uint32_t word = p.body[static_cast<size_t>(w) * p.S + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long t = 4LL * w + jj;
      bool ok = true;
      if constexpr (!BAKED) {
        ok = pos0 + t >= p.n0 && pos0 + t < p.n;
      }
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = p.words + ((tile * L + t) * p.kdim) * kLanes + lane;
      }
      int slot = 0;
      step<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u,
               [&](int k, uint32_t nm) {
                 uint32_t h = nm & st.end(k);
                 if constexpr (!BAKED) {
                   h = ok ? h : 0u;
                 }
                 cnt += __popc(h);
                 if constexpr (EXTRACT) {
                   if constexpr (BAKED) {
                     if (st.end(k) != 0u) {
                       wrow[static_cast<size_t>(slot) * kLanes] =
                           static_cast<int32_t>(h);
                       ++slot;
                     }
                   } else {
                     wrow[static_cast<size_t>(k) * kLanes] =
                         static_cast<int32_t>(h);
                   }
                 }
               });
    }
  }
  p.counts[s] = cnt;
}

template <bool BAKED, bool EXTRACT>
void launch(const Params& p, cudaStream_t stream) {
  SHIFT_AND_FOR_BUCKET(
      p.K, scan_kernel<KR, BAKED, EXTRACT>
               <<<blocks_for(p.S), kThreads, shmem_bytes(KR, p.K), stream>>>(
                   p));
}

Params make_params(const void* lo, const void* hi, const void* sm,
                   const void* em, int K, const void* halo, int Hw,
                   const void* body, int Wb, int S, void* counts,
                   void* words, int kdim, void* state) {
  Params p;
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.halo = static_cast<const uint32_t*>(halo);
  p.body = static_cast<const uint32_t*>(body);
  p.counts = static_cast<int32_t*>(counts);
  p.words = static_cast<int32_t*>(words);
  p.state = static_cast<uint32_t*>(state);
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.kdim = kdim;
  p.n0 = 0;
  p.n = 0;
  return p;
}

}  // namespace

extern "C" {

// G1. words: [tiles, L, K, 1024] int32 or null for a count-only scan.
int bitap_generic_scan(const void* lo, const void* hi, const void* sm,
                       const void* em, int K, const void* halo, int Hw,
                       const void* body, int Wb, int S, long long n0,
                       long long n, void* counts, void* words, void* state,
                       void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, counts,
                         words, K, state);
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr) {
    launch<false, true>(p, st);
  } else {
    launch<false, false>(p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// G2. words: [tiles, L, Ke, 1024] int32 or null for a count-only scan.
int bitap_baked_scan(const void* lo, const void* hi, const void* sm,
                     const void* em, int K, int Ke, const void* halo, int Hw,
                     const void* body, int Wb, int S, void* counts,
                     void* words, void* state, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, counts,
                         words, Ke, state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr) {
    launch<true, true>(p, st);
  } else {
    launch<true, false>(p, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
