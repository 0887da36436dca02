// The staged engine's two scans for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   G3  ahocorasick_tpu/ops/staged.py::_make_flags_kernel     -> staged_flags
//       stage 1: a shift-AND over the patterns' <= 4-byte prefix chains
//       (Kf limbs, usually 1) on a pad-byte padded haystack, no mask. The
//       flag of a stream is the OR of m' & end[k] over its halo AND its
//       body (a prefix that ends in the halo still flags the stream, since
//       the full match may end in the body). Stream 0's halo wraps around
//       the buffer: its state and its halo flag are zeroed after the halo;
//       its body hits still count. Output: one int32 word per stream,
//       [tiles, 8, 128], 0 or the OR of the hit words (kept as a word, not
//       0/1, so raw flags compare with the JAX kernel's).
//   G4  ahocorasick_tpu/ops/staged.py::_make_gathered_kernel  -> staged_gathered
//       stage 2: the exact scan over compacted candidate streams. Lane s
//       carries the id sid[s] of the stream it rescans (-1: a pad lane,
//       which counts and writes nothing); positions sid*L + t are masked to
//       [n0, n) in the original coordinates; the state resets after the
//       halo where sid == 0. Per-lane popcount of the masked end hits, and
//       in extract mode the masked end words of the end-bearing limbs, in
//       limb order, [tiles_c, L, Ke, 8, 128]. The full set's tables can
//       need more than 64 limbs (decollided packing), which the shared
//       spill path serves.
// The TPU kernels bake the tables into the code as constants; these take
// them at run time, which computes the same function (the Pallas pruned
// select trees only skip lookups whose result is zero).
//
// What bounds them on an H100: instruction issue, as for G1/G2. At the
// least G3 costs 2 integer operations per byte and, per limb, a funnel
// shift and three three-input logic operations (the step's two and
// flag |= m & end) and two shared-memory loads (step_cycles in
// chip_smoke.py; Kf = 1: ~0.024 ms at 64 MiB against ~0.02 ms of HBM
// time). G4 does a count's step per byte of the candidate streams only,
// plus 4Ke bytes of end words per byte when extracting.
//
// Design: one thread per stream walking halo then body (walk_halo), the
// guarded step, stream-major words, registers for K <= 64, lo/hi in
// shared memory (shift_and.cuh). Stage 1 uses STAGED_L = 512-byte
// streams, so 64 MiB gives 131,072 threads, about half the card's
// resident thread slots. Stage 2 runs cap lanes (a power of two >= 1024),
// one per candidate stream. G1/G2's segments and guard-free step are not
// applied here yet.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include "shift_and.cuh"

namespace {

using namespace shift_and;

struct Params {
  const uint32_t* lo;     // [K, 16]
  const uint32_t* hi;     // [K, 16]
  const uint32_t* sm;     // [K] chain-start bits
  const uint32_t* em;     // [K] chain-end bits
  const int32_t* sid;     // [S] original stream of each lane (G4)
  const uint32_t* halo;   // [Hw, S] words, stream-major
  const uint32_t* body;   // [Wb, S] words, stream-major
  int32_t* out;           // G3: flags [S]; G4: counts [S]
  int32_t* words;         // G4: [tiles, L, Ke, 1024] or null (count only)
  uint32_t* state;        // [K, S] scratch for K > 64, else null
  int K;
  int Ke;
  int Hw;
  int Wb;
  int S;
  long long n0;           // G4 count window [n0, n)
  long long n;
};

template <int KR>
__global__ void __launch_bounds__(kThreads) flags_kernel(Params p) {
  extern __shared__ uint32_t tab[];
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables<KR>(p.lo, p.hi, K, tab, LO, HI);
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.S) return;

  Limbs<KR> st;
  init<KR>(st, p.sm, p.em, p.state, s, p.S, K);
  uint32_t fl = 0u;
  auto hit = [&](int k, uint32_t nm) { fl |= nm & st.end(k); };
  walk_halo<KR>(st, LO, HI, K, p.halo, p.Hw, s, p.S, hit);
  if (s == 0) {
    reset<KR>(st, K);
    fl = 0u;
  }
  for (int w = 0; w < p.Wb; ++w) {
    const uint32_t word = p.body[static_cast<size_t>(w) * p.S + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      step<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u, hit);
    }
  }
  p.out[s] = static_cast<int32_t>(fl);
}

template <int KR, bool EXTRACT>
__global__ void __launch_bounds__(kThreads) gathered_kernel(Params p) {
  extern __shared__ uint32_t tab[];
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables<KR>(p.lo, p.hi, K, tab, LO, HI);
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= p.S) return;

  const int sid = p.sid[s];
  Limbs<KR> st;
  init<KR>(st, p.sm, p.em, p.state, s, p.S, K);
  walk_halo<KR>(st, LO, HI, K, p.halo, p.Hw, s, p.S, [](int, uint32_t) {});
  // Original stream 0: its halo wrapped around the buffer, no history.
  if (sid == 0) reset<KR>(st, K);

  const long long L = 4LL * p.Wb;
  const long long pos0 = static_cast<long long>(sid) * L;
  const size_t tile = static_cast<size_t>(s / kLanes);
  const int lane = s % kLanes;
  int cnt = 0;
  for (int w = 0; w < p.Wb; ++w) {
    const uint32_t word = p.body[static_cast<size_t>(w) * p.S + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const long long t = 4LL * w + jj;
      const bool ok = sid >= 0 && pos0 + t >= p.n0 && pos0 + t < p.n;
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = p.words + ((tile * L + t) * p.Ke) * kLanes + lane;
      }
      int slot = 0;
      step<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u,
               [&](int k, uint32_t nm) {
                 const uint32_t e = st.end(k);
                 const uint32_t h = ok ? (nm & e) : 0u;
                 cnt += __popc(h);
                 if constexpr (EXTRACT) {
                   if (e != 0u) {
                     wrow[static_cast<size_t>(slot) * kLanes] =
                         static_cast<int32_t>(h);
                     ++slot;
                   }
                 }
               });
    }
  }
  p.out[s] = cnt;
}

Params make_params(const void* lo, const void* hi, const void* sm,
                   const void* em, int K, const void* halo, int Hw,
                   const void* body, int Wb, int S, void* out, void* state) {
  Params p{};
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.halo = static_cast<const uint32_t*>(halo);
  p.body = static_cast<const uint32_t*>(body);
  p.out = static_cast<int32_t*>(out);
  p.state = static_cast<uint32_t*>(state);
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  return p;
}

}  // namespace

extern "C" {

// G3. flags: [S] int32.
int staged_flags(const void* lo, const void* hi, const void* sm,
                 const void* em, int K, const void* halo, int Hw,
                 const void* body, int Wb, int S, void* flags, void* state,
                 void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, flags,
                         state);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SHIFT_AND_FOR_BUCKET(
      K, flags_kernel<KR>
             <<<blocks_for(S), kThreads, shmem_bytes(KR, K), st>>>(p));
  return static_cast<int>(cudaGetLastError());
}

// G4. counts: [S] int32; words: [tiles, L, Ke, 1024] int32 or null for a
// count-only scan.
int staged_gathered(const void* lo, const void* hi, const void* sm,
                    const void* em, int K, int Ke, const void* sid,
                    const void* halo, int Hw, const void* body, int Wb,
                    int S, long long n0, long long n, void* counts,
                    void* words, void* state, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, halo, Hw, body, Wb, S, counts,
                         state);
  p.sid = static_cast<const int32_t*>(sid);
  p.words = static_cast<int32_t*>(words);
  p.Ke = Ke;
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr) {
    SHIFT_AND_FOR_BUCKET(
        K, gathered_kernel<KR, true>
               <<<blocks_for(S), kThreads, shmem_bytes(KR, K), st>>>(p));
  } else {
    SHIFT_AND_FOR_BUCKET(
        K, gathered_kernel<KR, false>
               <<<blocks_for(S), kThreads, shmem_bytes(KR, K), st>>>(p));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
