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
//       tables, and on keyword lists the prefixes' too, often need more
//       than 64 limbs (decollided packing puts about one chain per limb:
//       100 words of 8-16 bytes give Kf = 75, K = 83), which the limb
//       groups below serve.
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
//   - One thread per (segment, lane): scan_plan cuts each L-byte stream
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
//   - Beyond 64 limbs, limb groups as in G1/G2 (group_flags_kernel,
//     group_gathered_kernel; the helpers in shift_and.cuh): G lanes of a
//     warp per (segment, lane), KR = 32 limbs each in registers (64 past
//     1,024 limbs), the carry between lanes by one shuffle per byte,
//     S * P * G threads, 256 per block, tables in bank-padded shared
//     memory (from device memory past what fits). The G lanes of a stream
//     read its row through one ring column (walk_run_group). Stream 0's
//     segment 0 (G4: sid == 0) walks its warm-up like the others of its
//     warp, on word 0 in place of the wrapped words, then resets its
//     state (and G3 its flag): the shuffles need the warp's lanes in
//     step. G3 ORs each lane's hits, warm-up included, and the group's
//     flag word is the OR over its lanes (__shfl_xor_sync), one atomicOr.
//     G4 sums the group's counts into one atomicAdd; its end-bearing limbs
//     are numbered across the group once per thread (a shuffle scan of
//     the counts of the lanes below), so each lane writes its own slots.
//     A warp whose lanes are all pad lanes (sid -1, at the tail of the
//     candidates) writes its zero words and leaves; a pad lane in a warp
//     with live lanes walks row 0 with an empty window: it counts nothing
//     and writes zero words.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include "shift_and.cuh"

namespace {

using namespace shift_and;

struct Params {
  const uint32_t* lo;     // [K, 16] (group tables in device memory: the
  const uint32_t* hi;     //  allocation holds whole slices of KR limbs)
  const uint32_t* sm;     // [K] chain-start bits
  const uint32_t* em;     // [K] chain-end bits
  const int32_t* sid;     // [S] original stream of each lane (G4)
  const uint32_t* x;      // [ns, Wb] words, row-major (row = stream)
  int32_t* out;           // G3: flags [S]; G4: counts [S]; both zeroed
  int32_t* words;         // G4: [tiles, L, Ke, 1024] or null (count only)
  int K;
  int Ke;
  int Hw;
  int Wb;
  int S;                  // lanes: streams (G3) or candidate lanes (G4)
  int P;                  // segments per stream, Wb / P a multiple of 8
  int G;                  // lanes per stream: 1, or a limb group's 4..32
  long long n0;           // G4 count window [n0, n)
  long long n;
};

// Step the four bytes of `word` in order (nybbles split once per word),
// calling on_limb(k, m') as step_rows does.
template <int KR, typename F>
__device__ __forceinline__ void step_word(Limbs<KR>& st, const uint32_t* LO,
                                          const uint32_t* HI, uint32_t word,
                                          F&& on_limb) {
  const Nybbles nb(word);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    step_rows<KR>(st, nb.lo_row(LO, jj), nb.hi_row(HI, jj), on_limb);
  }
}

template <int KR>
__global__ void __launch_bounds__(kSegThreads) flags_kernel(Params p) {
  __shared__ uint32_t tab[32 * KR];  // lo [KR*16], hi [KR*16]
  __shared__ uint4 ring[kRunRing * 2 * kSegThreads];
  const int K = p.K;
  const uint32_t* LO;
  const uint32_t* HI;
  load_tables_padded<KR>(p.lo, p.hi, K, tab, LO, HI);
  Segment g;
  if (!segment_of(p.S, p.P, p.Wb, g)) return;

  Limbs<KR> st;
  init_padded<KR>(st, p.sm, p.em, K);
  uint32_t fl = 0u;
  auto word = [&](uint32_t w) {
    step_word<KR>(st, LO, HI, w,
                  [&](int k, uint32_t nm) { fl |= nm & st.em[k]; });
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

// The 16-bit mask of the bytes of the quad at word w (bytes 4w .. 4w+15
// of the haystack) that lie inside [n0, n).
__device__ __forceinline__ uint32_t window_bits(long long w, long long n0,
                                                long long n) {
  const long long b0 = 4 * w;
  const int lo = static_cast<int>(n0 <= b0 ? 0 : (n0 - b0 >= 16 ? 16
                                                                 : n0 - b0));
  const int hi = static_cast<int>(n <= b0 ? 0 : (n - b0 >= 16 ? 16 : n - b0));
  return (0xFFFFu >> (16 - hi)) & (0xFFFFu << lo);
}

// All ones where bit jj of ok is set, else zero.
__device__ __forceinline__ uint32_t keep_bit(uint32_t ok, int jj) {
  return static_cast<uint32_t>(static_cast<int32_t>(ok << (31 - jj)) >> 31);
}

template <int KR, bool EXTRACT>
__global__ void __launch_bounds__(kSegThreads) gathered_kernel(Params p) {
  __shared__ uint32_t tab[32 * KR];  // lo [KR*16], hi [KR*16]
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
  init_padded<KR>(st, p.sm, p.em, K);
  const long long row = static_cast<long long>(sid) * p.Wb;
  const long long body = row + g.w0;
  const long long start = sid == 0 && g.j == 0 ? body : body - p.Hw;
  int cnt = 0;
  auto warm = [&](uint32_t w) {
    step_word<KR>(st, LO, HI, w, [](int, uint32_t) {});
  };
  // Scan the word at flat index w: its byte jj lies at position
  // 4*w + jj of the haystack (rows are contiguous) and at t = 4*(w - row)
  // + jj of the stream; ok holds one bit per byte, set inside [n0, n).
  auto scan = [&](long long w, uint32_t word, uint32_t ok) {
    const Nybbles nb(word);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint32_t keep = keep_bit(ok, jj);
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = wout + static_cast<size_t>(4 * (w - row) + jj) * p.Ke * kLanes;
      }
      int slot = 0;
      step_rows<KR>(st, nb.lo_row(LO, jj), nb.hi_row(HI, jj),
                    [&](int k, uint32_t nm) {
        const uint32_t e = st.em[k];
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
        const uint32_t ok = window_bits(w, p.n0, p.n);
        scan(w, v.x, ok);
        scan(w + 1, v.y, ok >> 4);
        scan(w + 2, v.z, ok >> 8);
        scan(w + 3, v.w, ok >> 12);
      });
  if (cnt != 0) atomicAdd(p.out + g.s, cnt);
}

// ---------------------------------------------------------------------------
// Limb groups (K > 64)
// ---------------------------------------------------------------------------
// Dynamic shared memory of a limb-group block: the ring, then lo and hi,
// one slice per lane that holds a live limb (if the tables are in shared
// memory).
inline size_t group_shmem_bytes(int K, int KR, int G, bool shared_tables) {
  const size_t live = (K + KR - 1) / KR;
  const size_t tables =
      shared_tables ? 2 * live * static_cast<size_t>(group_stride(KR, G))
                    : 0;
  return static_cast<size_t>(group_ring_quads(G)) * sizeof(uint4) +
         tables * sizeof(uint32_t);
}

// Word i of a quad (a select chain: a runtime index into the vector would
// put it in local memory).
__device__ __forceinline__ uint32_t quad_word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// A lane's tables and limb masks: (LO, HI) its slice of the group's tables
// (slice 0's for a lane past the last live limb), in shared memory past
// the ring or in device memory.
template <int KR, bool SHARED_TABLES>
struct GroupLane {
  GroupSegment q;
  const uint32_t* LO;
  const uint32_t* HI;
  Limbs<KR> st;

  // False for the threads past the launch's S * P * G. Every thread of the
  // block must call it (it fills the shared tables).
  __device__ __forceinline__ bool init(const Params& p, uint4* smem) {
    const int stride = SHARED_TABLES ? group_stride(KR, p.G) : 16 * KR;
    LO = p.lo;
    HI = p.hi;
    if constexpr (SHARED_TABLES) {
      uint32_t* tab =
          reinterpret_cast<uint32_t*>(smem + group_ring_quads(p.G));
      load_group_tables<KR>(p.lo, p.hi, p.K, stride, tab);
      LO = tab;
      HI = tab + (p.K + KR - 1) / KR * stride;
    }
    if (!group_of(p.S, p.P, p.G, p.Wb, q)) return false;
    const int k0 = q.g * KR;
    LO += (k0 < p.K ? q.g : 0) * stride;
    HI += (k0 < p.K ? q.g : 0) * stride;
    init_padded<KR>(st, p.sm, p.em, p.K, k0);
    return true;
  }

  // Step the four bytes of `word`, as step_word does, each with the carry
  // from the lane below.
  template <typename F>
  __device__ __forceinline__ void word(uint32_t w, int G, F&& on_limb) {
    const Nybbles nb(w);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      step_rows<KR>(st, nb.lo_row(LO, jj), nb.hi_row(HI, jj), on_limb,
                    group_carry<KR>(st, q.g, G));
    }
  }
};

template <int KR, bool SHARED_TABLES>
__global__ void __launch_bounds__(kGroupThreads) group_flags_kernel(
    Params p) {
  extern __shared__ uint4 gsmem[];  // the ring, then the table slices
  GroupLane<KR, SHARED_TABLES> ln;
  if (!ln.init(p, gsmem)) return;
  const int G = p.G;
  const GroupSegment& q = ln.q;
  uint32_t fl = 0u;
  auto word = [&](uint32_t w) {
    ln.word(w, G, [&](int k, uint32_t nm) { fl |= nm & ln.st.em[k]; });
  };
  const long long body = static_cast<long long>(q.s) * p.Wb + q.w0;
  // Stream 0's halo wraps around the buffer: no history and no flag.
  const bool reset_at_body = q.s == 0 && q.j == 0;
  // A quad's four words in a loop, not unrolled: a word's 4 * KR limb
  // steps are the unrolled unit, as in bitap.cu (16 * KR at KR = 64 made
  // the build take minutes per instance).
  walk_run_group(p.x, body - p.Hw, body + q.nw, gsmem, G,
                           [&](long long, uint32_t w) { word(w); },
                           [&](long long w, uint4 v) {
                             if (reset_at_body && w == body) {
                               reset<KR>(ln.st);
                               fl = 0u;
                             }
#pragma unroll 1
                             for (int i = 0; i < 4; ++i) {
                               word(quad_word(v, i));
                             }
                           });
  fl = group_or(fl, G);
  if (q.g == 0 && fl != 0u) {
    atomicOr(reinterpret_cast<uint32_t*>(p.out) + q.s, fl);
  }
}

template <int KR, bool SHARED_TABLES, bool EXTRACT>
__global__ void __launch_bounds__(kGroupThreads) group_gathered_kernel(
    Params p) {
  extern __shared__ uint4 gsmem[];  // the ring, then the table slices
  GroupLane<KR, SHARED_TABLES> ln;
  if (!ln.init(p, gsmem)) return;
  const int G = p.G;
  const GroupSegment& q = ln.q;
  const long long L = 4LL * p.Wb;
  const size_t tile = static_cast<size_t>(q.s / kLanes);
  const int col = q.s % kLanes;
  // End words of the lane: position t, slot e at wout[(t*Ke + e)*kLanes];
  // this lane's end-bearing limbs take slots [slot0, slot0 + mine).
  int32_t* wout = nullptr;
  int slot0 = 0;
  int mine = 0;
  if constexpr (EXTRACT) {
    wout = p.words + tile * static_cast<size_t>(L) * p.Ke * kLanes + col;
#pragma unroll
    for (int k = 0; k < KR; ++k) mine += ln.st.em[k] != 0u ? 1 : 0;
    slot0 = group_sum_below(mine, q.g, G);
  }
  const int sid = p.sid[q.s];
  if (__all_sync(kWarp, sid < 0)) {  // pad lanes only: zero end words
    if constexpr (EXTRACT) {
      int32_t* w = wout + static_cast<size_t>(4 * q.w0) * p.Ke * kLanes;
      for (int t = 0; t < 4 * q.nw; ++t) {
        for (int e = slot0; e < slot0 + mine; ++e) {
          w[(static_cast<size_t>(t) * p.Ke + e) * kLanes] = 0;
        }
      }
    }
    return;
  }
  // A pad lane beside live ones walks row 0 with an empty window.
  const long long row = static_cast<long long>(sid < 0 ? 0 : sid) * p.Wb;
  const long long n = sid < 0 ? 0 : p.n;
  const long long body = row + q.w0;
  const bool reset_at_body = sid == 0 && q.j == 0;
  int cnt = 0;
  auto warm = [&](uint32_t w) { ln.word(w, G, [](int, uint32_t) {}); };
  // As in gathered_kernel: byte jj of the word at flat index w is position
  // 4*w + jj of the haystack and t = 4*(w - row) + jj of the stream.
  auto scan = [&](long long w, uint32_t word, uint32_t ok) {
    const Nybbles nb(word);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint32_t keep = keep_bit(ok, jj);
      int32_t* wrow = nullptr;
      if constexpr (EXTRACT) {
        wrow = wout + static_cast<size_t>(4 * (w - row) + jj) * p.Ke * kLanes;
      }
      int slot = slot0;
      step_rows<KR>(
          ln.st, nb.lo_row(ln.LO, jj), nb.hi_row(ln.HI, jj),
          [&](int k, uint32_t nm) {
            const uint32_t e = ln.st.em[k];
            const uint32_t h = nm & e & keep;
            cnt += __popc(h);
            if constexpr (EXTRACT) {
              if (e != 0u) {
                wrow[static_cast<size_t>(slot) * kLanes] =
                    static_cast<int32_t>(h);
                ++slot;
              }
            }
          },
          group_carry<KR>(ln.st, q.g, G));
    }
  };
  walk_run_group(
      p.x, body - p.Hw, body + q.nw, gsmem, G,
      [&](long long, uint32_t w) { warm(w); },  // leading words: warm-up
      [&](long long w, uint4 v) {
        // A word at a time, as in group_flags_kernel.
        if (w < body) {
#pragma unroll 1
          for (int i = 0; i < 4; ++i) warm(quad_word(v, i));
          return;
        }
        if (reset_at_body && w == body) reset<KR>(ln.st);
        const uint32_t ok = window_bits(w, p.n0, n);
#pragma unroll 1
        for (int i = 0; i < 4; ++i) {
          scan(w + i, quad_word(v, i), ok >> (4 * i));
        }
      });
  cnt = group_sum(cnt, G);
  if (q.g == 0 && cnt != 0) atomicAdd(p.out + q.s, cnt);
}

enum Mode { kFlags, kCount, kExtract };

template <int KR, bool SHARED_TABLES, Mode MODE>
cudaError_t launch_group(const Params& p, cudaStream_t stream) {
  const size_t bytes = group_shmem_bytes(p.K, KR, p.G, SHARED_TABLES);
  void (*kernel)(Params);
  if constexpr (MODE == kFlags) {
    kernel = group_flags_kernel<KR, SHARED_TABLES>;
  } else {
    kernel = group_gathered_kernel<KR, SHARED_TABLES, MODE == kExtract>;
  }
  static int opted[kMaxDevices] = {};
  const cudaError_t e = opt_in_shared(kernel, bytes, opted);
  if (e != cudaSuccess) return e;
  const long long threads = static_cast<long long>(p.S) * p.P * p.G;
  kernel<<<static_cast<int>((threads + kGroupThreads - 1) / kGroupThreads),
           kGroupThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// G = 1: one thread per (segment, lane), the register bucket over K
// (K <= 64). G > 1: limb groups of G lanes with KR (32 or 64) limbs each.
template <Mode MODE>
cudaError_t launch(const Params& p, int KR, bool shared_tables,
                   cudaStream_t stream) {
  if (p.G == 1) {
    if constexpr (MODE == kFlags) {
      SHIFT_AND_FOR_BUCKET(
          p.K, flags_kernel<KR><<<seg_blocks_for(p.S, p.P), kSegThreads, 0,
                                  stream>>>(p));
    } else {
      SHIFT_AND_FOR_BUCKET(
          p.K, gathered_kernel<KR, MODE == kExtract>
                   <<<seg_blocks_for(p.S, p.P), kSegThreads, 0, stream>>>(p));
    }
    return cudaGetLastError();
  }
  if (p.G > 32 || (p.G & (p.G - 1)) != 0 || p.G * KR < p.K) {
    return cudaErrorInvalidValue;
  }
  // KR = 32 (K <= 1024) always fits its tables in shared memory; only
  // KR = 64 may not.
  if (KR == 32 && shared_tables) {
    return launch_group<32, true, MODE>(p, stream);
  }
  if (KR == 64) {
    return shared_tables ? launch_group<64, true, MODE>(p, stream)
                         : launch_group<64, false, MODE>(p, stream);
  }
  return cudaErrorInvalidValue;
}

Params make_params(const void* lo, const void* hi, const void* sm,
                   const void* em, int K, const void* x, int Hw, int Wb,
                   int S, int P, int G, void* out) {
  Params p{};
  p.lo = static_cast<const uint32_t*>(lo);
  p.hi = static_cast<const uint32_t*>(hi);
  p.sm = static_cast<const uint32_t*>(sm);
  p.em = static_cast<const uint32_t*>(em);
  p.x = static_cast<const uint32_t*>(x);
  p.out = static_cast<int32_t*>(out);
  p.K = K;
  p.Hw = Hw;
  p.Wb = Wb;
  p.S = S;
  p.P = P;
  p.G = G;
  return p;
}

}  // namespace

extern "C" {

// G3. x: [ns, Wb] words (Wb a multiple of 8), S = ns streams, P segments
// per stream, G lanes per stream (1, or a limb group of KR limbs per lane,
// the tables in shared memory if tables_in_shared, else read from an
// allocation of whole slices); flags: [S] int32, zeroed.
int staged_flags(const void* lo, const void* hi, const void* sm,
                 const void* em, int K, const void* x, int Hw, int Wb, int S,
                 int P, int G, int KR, int tables_in_shared, void* flags,
                 void* stream) {
  const Params p = make_params(lo, hi, sm, em, K, x, Hw, Wb, S, P, G, flags);
  return static_cast<int>(launch<kFlags>(p, KR, tables_in_shared != 0,
                                         static_cast<cudaStream_t>(stream)));
}

// G4. sid: [S] int32 stream ids (< ns) or -1; x: [ns, Wb] words; counts:
// [S] int32, zeroed; words: [tiles, L, Ke, 1024] int32 or null for a
// count-only scan; P, G, KR and tables_in_shared as for G3.
int staged_gathered(const void* lo, const void* hi, const void* sm,
                    const void* em, int K, int Ke, const void* sid,
                    const void* x, int Hw, int Wb, int S, int P, int G,
                    int KR, int tables_in_shared, long long n0, long long n,
                    void* counts, void* words, void* stream) {
  Params p = make_params(lo, hi, sm, em, K, x, Hw, Wb, S, P, G, counts);
  p.sid = static_cast<const int32_t*>(sid);
  p.words = static_cast<int32_t*>(words);
  p.Ke = Ke;
  p.n0 = n0;
  p.n = n;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = tables_in_shared != 0;
  return static_cast<int>(words != nullptr
                              ? launch<kExtract>(p, KR, shared, st)
                              : launch<kCount>(p, KR, shared, st));
}

}  // extern "C"
