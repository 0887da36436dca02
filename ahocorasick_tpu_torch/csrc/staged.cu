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
//       which counts nothing and writes zero words); positions sid*L + t
//       are masked to [n0, n) in the original coordinates; the state resets
//       after the halo where sid == 0. Per-lane popcount of the masked end
//       hits, and in extract mode the masked end words of the end-bearing
//       limbs, in limb order, [tiles_c, L, Ke, 8, 128]. The full set's
//       tables can need more than 64 limbs (decollided packing), which the
//       shared spill path serves.
// The TPU kernels bake the tables into the code as constants; these take
// them at run time, which computes the same function (the Pallas pruned
// select trees only skip lookups whose result is zero).
//
// Input: the haystack words as uploaded, row s = the L bytes of stream s
// ([ns, Wb] int32). The TPU kernels read a stream-major copy (words
// [w][s], for their vector lanes) and G4 a gathered stream-major copy of
// the candidate rows, which the JAX package builds on every call; the
// halo of stream s is the last Hw words of row s - 1. A GPU thread reads
// its own stream's bytes, so here no copy is made: a segment's walk,
// warm-up included, is the contiguous run of words
// [s*Wb + w0 - Hw, s*Wb + w0 + nw), and G4 reads row sid itself.
//
// What bounds them on an H100: instruction issue, as for G1/G2. At the
// least G3 costs 2 integer operations per byte and, per limb, a funnel
// shift and three three-input logic operations (the step's two and
// flag |= m & end) and two shared-memory loads (step_cycles in
// chip_smoke.py; Kf = 1: ~0.024 ms at 64 MiB against ~0.02 ms of HBM
// time). G4 does a count's step per byte of the candidate streams only,
// plus 4Ke bytes of end words per byte when extracting.
//
// Design (the G1 design, bitap.cu, on row-major words):
//   - One thread per (segment, lane): segment_plan cuts each L-byte stream
//     into P segments of Ls bytes, Ls a multiple of 32 so each segment's
//     body starts and ends on a ring slot. Segment 0 warms up over the
//     halo, segment j > 0 over the H bytes before it. Stream 0's segment 0
//     (G4: sid == 0) skips its warm-up, which wraps around the buffer:
//     zeroing the state and the halo flag after it, as the JAX kernels do,
//     is the same as not walking it.
//   - G3: every segment ORs its hits, warm-up included, into zeroed flags
//     (atomicOr). A segment j > 0 warms up from a zero state, so its
//     warm-up hits are a subset of the true hits at those positions, which
//     segment j - 1 ORs in anyway; segment 0's warm-up is the halo, whose
//     hits count.
//   - G4: counts are integer atomicAdds into zeroed counts; end words of
//     positions [j*Ls, (j+1)*Ls) are written by segment j alone; a warp is
//     32 consecutive lanes of one segment, so its end-word stores coalesce.
//     The window test is per 16-byte quad: a 16-bit mask of its positions
//     inside [n0, n), folded into the three-input AND of the hit.
//   - Words come through the row-major cp.async ring (walk_run): 32 bytes
//     per slot, two slots in flight. The step runs every limb of the
//     register bucket with no per-limb guard (step_rows); each word's
//     nybbles are split once (Nybbles) and the tables and the ring are
//     static shared arrays, so a byte's table rows cost a byte permutation
//     each, their offsets folded into the shared loads.
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
  const uint32_t* x;      // [ns, Wb] words, row-major (row = stream)
  int32_t* out;           // G3: flags [S]; G4: counts [S]; both zeroed
  int32_t* words;         // G4: [tiles, L, Ke, 1024] or null (count only)
  uint32_t* state;        // [K, state_row] scratch (K > 64) or null
  int state_row;          // words per limb row of state, >= S*P
  int K;
  int Ke;
  int Hw;
  int Wb;
  int S;                  // lanes: streams (G3) or candidate lanes (G4)
  int P;                  // segments per stream, Wb / P a multiple of 8
  long long n0;           // G4 count window [n0, n)
  long long n;
};

// Step byte jj of `word` (nybbles split once per word for register
// limbs), calling on_limb(k, m') as step_padded does.
template <int KR, typename F>
__device__ __forceinline__ void step_byte(Limbs<KR>& st, const uint32_t* LO,
                                          const uint32_t* HI, int K,
                                          uint32_t word, const Nybbles& nb,
                                          int jj, F&& on_limb) {
  if constexpr (KR > 0) {
    step_rows<KR>(st, nb.lo_row(LO, jj), nb.hi_row(HI, jj), on_limb);
  } else {
    step_padded<KR>(st, LO, HI, K, (word >> (8 * jj)) & 255u, on_limb);
  }
}

// Step the four bytes of `word` in order.
template <int KR, typename F>
__device__ __forceinline__ void step_word(Limbs<KR>& st, const uint32_t* LO,
                                          const uint32_t* HI, int K,
                                          uint32_t word, F&& on_limb) {
  const Nybbles nb(word);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    step_byte<KR>(st, LO, HI, K, word, nb, jj, on_limb);
  }
}

template <int KR>
__global__ void __launch_bounds__(kSegThreads) flags_kernel(Params p) {
  __shared__ uint32_t tab[KR > 0 ? 32 * KR : 1];  // lo [KR*16], hi [KR*16]
  __shared__ uint4 ring[kRunRing * 2 * kSegThreads];
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables_padded<KR>(p.lo, p.hi, K, tab, LO, HI);
  Segment g;
  if (!segment_of(p.S, p.P, p.Wb, g)) return;

  Limbs<KR> st;
  init_padded<KR>(st, p.sm, p.em, p.state, g.t, p.state_row, K);
  uint32_t fl = 0u;
  auto word = [&](uint32_t w) {
    step_word<KR>(st, LO, HI, K, w,
                  [&](int k, uint32_t nm) { fl |= nm & st.end(k); });
  };
  const long long body = static_cast<long long>(g.s) * p.Wb + g.w0;
  const long long start = g.s == 0 && g.j == 0 ? body : body - p.Hw;
  walk_run(p.x, start, body + g.nw, ring,
           [&](long long, uint32_t w) { word(w); },
           [&](long long, uint4 v) {
             word(v.x);
             word(v.y);
             word(v.z);
             word(v.w);
           });
  if (fl != 0u) atomicOr(reinterpret_cast<uint32_t*>(p.out) + g.s, fl);
}

template <int KR, bool EXTRACT>
__global__ void __launch_bounds__(kSegThreads) gathered_kernel(Params p) {
  __shared__ uint32_t tab[KR > 0 ? 32 * KR : 1];  // lo [KR*16], hi [KR*16]
  __shared__ uint4 ring[kRunRing * 2 * kSegThreads];
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables_padded<KR>(p.lo, p.hi, K, tab, LO, HI);
  Segment g;
  if (!segment_of(p.S, p.P, p.Wb, g)) return;

  const long long L = 4LL * p.Wb;
  const size_t tile = static_cast<size_t>(g.s / kLanes);
  const int lane = g.s % kLanes;
  // End words of the lane: position t, slot e at wout[(t*Ke + e)*kLanes].
  int32_t* wout = nullptr;
  if constexpr (EXTRACT) {
    wout = p.words + tile * static_cast<size_t>(L) * p.Ke * kLanes + lane;
  }
  const int sid = p.sid[g.s];
  if (sid < 0) {  // a pad lane: no count, zero end words
    if constexpr (EXTRACT) {
      const int Ls = 4 * g.nw;
      int32_t* w = wout + static_cast<size_t>(4 * g.w0) * p.Ke * kLanes;
      for (int i = 0; i < Ls * p.Ke; ++i) {
        w[static_cast<size_t>(i) * kLanes] = 0;
      }
    }
    return;
  }

  Limbs<KR> st;
  init_padded<KR>(st, p.sm, p.em, p.state, g.t, p.state_row, K);
  const long long row = static_cast<long long>(sid) * p.Wb;
  const long long body = row + g.w0;
  const long long start = sid == 0 && g.j == 0 ? body : body - p.Hw;
  int cnt = 0;
  auto warm = [&](uint32_t w) {
    step_word<KR>(st, LO, HI, K, w, [](int, uint32_t) {});
  };
  // Scan the word at flat index w: its byte jj lies at position
  // 4*w + jj of the haystack (rows are contiguous) and at t = 4*(w - row)
  // + jj of the stream; ok holds one bit per byte, set inside [n0, n).
  auto scan = [&](long long w, uint32_t word, uint32_t ok) {
    const Nybbles nb(word);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      // All ones for a byte inside the window, else zero.
      const uint32_t keep =
          static_cast<uint32_t>(static_cast<int32_t>(ok << (31 - jj)) >> 31);
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = wout + static_cast<size_t>(4 * (w - row) + jj) * p.Ke * kLanes;
      }
      int slot = 0;
      step_byte<KR>(st, LO, HI, K, word, nb, jj, [&](int k, uint32_t nm) {
        const uint32_t e = st.end(k);
        const uint32_t h = nm & e & keep;
        cnt += __popc(h);
        if constexpr (EXTRACT) {
          if (e != 0u) {
            wrow[static_cast<size_t>(slot) * kLanes] = static_cast<int32_t>(h);
            ++slot;
          }
        }
      });
    }
  };
  walk_run(
      p.x, start, body + g.nw, ring,
      [&](long long, uint32_t w) { warm(w); },  // leading words: warm-up
      [&](long long w, uint4 v) {
        if (w < body) {
          warm(v.x);
          warm(v.y);
          warm(v.z);
          warm(v.w);
          return;
        }
        // Bytes [lo, hi) of the quad's 16 lie inside [n0, n).
        const long long b0 = 4 * w;
        const int lo = static_cast<int>(
            p.n0 <= b0 ? 0 : (p.n0 - b0 >= 16 ? 16 : p.n0 - b0));
        const int hi = static_cast<int>(
            p.n <= b0 ? 0 : (p.n - b0 >= 16 ? 16 : p.n - b0));
        const uint32_t ok = (0xFFFFu >> (16 - hi)) & (0xFFFFu << lo);
        scan(w, v.x, ok);
        scan(w + 1, v.y, ok >> 4);
        scan(w + 2, v.z, ok >> 8);
        scan(w + 3, v.w, ok >> 12);
      });
  if (cnt != 0) atomicAdd(p.out + g.s, cnt);
}

Params make_params(const void* lo, const void* hi, const void* sm,
                   const void* em, int K, const void* x, int Hw, int Wb,
                   int S, int P, void* out, void* state, int state_row) {
  Params p{};
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.x = static_cast<const uint32_t*>(x);
  p.out = static_cast<int32_t*>(out);
  p.state = static_cast<uint32_t*>(state);
  p.state_row = state_row;
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.P = P;
  return p;
}

}  // namespace

extern "C" {

// G3. x: [ns, Wb] words (Wb a multiple of 8), S = ns streams, P segments
// per stream; flags: [S] int32, zeroed; state: [K, state_row] for K > 64.
int staged_flags(const void* lo, const void* hi, const void* sm,
                 const void* em, int K, const void* x, int Hw, int Wb, int S,
                 int P, void* flags, void* state, int state_row,
                 void* stream) {
  Params p = make_params(lo, hi, sm, em, K, x, Hw, Wb, S, P, flags, state,
                         state_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  SHIFT_AND_FOR_BUCKET(
      K, flags_kernel<KR><<<seg_blocks_for(S, P), kSegThreads,
                            0, st>>>(p));
  return static_cast<int>(cudaGetLastError());
}

// G4. sid: [S] int32 stream ids (< ns) or -1; x: [ns, Wb] words; counts:
// [S] int32, zeroed; words: [tiles, L, Ke, 1024] int32 or null for a
// count-only scan; P segments per lane; state: [K, state_row] for K > 64.
int staged_gathered(const void* lo, const void* hi, const void* sm,
                    const void* em, int K, int Ke, const void* sid,
                    const void* x, int Hw, int Wb, int S, int P,
                    long long n0, long long n, void* counts, void* words,
                    void* state, int state_row, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, x, Hw, Wb, S, P, counts, state,
                         state_row);
  p.sid = static_cast<const int32_t*>(sid);
  p.words = static_cast<int32_t*>(words);
  p.Ke = Ke;
  p.n0 = n0;
  p.n = n;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (words != nullptr) {
    SHIFT_AND_FOR_BUCKET(
        K, gathered_kernel<KR, true><<<seg_blocks_for(S, P), kSegThreads,
                                       0, st>>>(p));
  } else {
    SHIFT_AND_FOR_BUCKET(
        K, gathered_kernel<KR, false><<<seg_blocks_for(S, P), kSegThreads,
                                        0, st>>>(p));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
