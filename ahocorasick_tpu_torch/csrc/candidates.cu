// The candidate stages after the fingerprint bitmap, for Hopper (sm_90a).
//
// In the JAX package these stages are jnp code that XLA fuses with the
// bitmap kernel (G5/G6) into one dispatch per pass:
//   S1  ahocorasick_tpu/ops/fingerprint.py::_rank_select (over
//       ops/compaction.py::select_set_bits)                   -> cand_select
//       the first `cap` set bits of the bitmap [tiles, L/32, 8, 128] int32
//       in flat word order, then bit order, decoded to haystack positions
//       stream * L + t32 * 32 + bit, and the count of every set bit;
//   S2  ahocorasick_tpu/ops/fingerprint.py::_device_verify with
//       _gather_windows                                        -> fp_verify
//       per candidate and length class (ascending): the class's
//       multiplicative hash of the window's fingerprint bytes, two cuckoo
//       probes, one pattern-group row, the byte compare of each member and
//       the bounds;
//   S3  ahocorasick_tpu/ops/cascade.py::_probe (its exact classes and the
//       LONG probe of _probe_expand_verify)                    -> cascade_probe
//       per candidate and class: the (lo, hi) key of the window, two record
//       probes with the occupancy test; per exact class (hit, pid, end) and
//       the summed duplicate counts of the hits; for LONG the hit's group
//       size, pid base and start;
//   S4  ahocorasick_tpu/ops/cascade.py::_expand_gid and the tail verify of
//       _probe_expand_verify                                   -> cascade_long_verify
//       per expansion row: its group (binary search of the inclusive cumsum
//       of S3's LONG counts), the member's pid, the masked compare of the
//       window words past the 8 key bytes, and the bounds.
//
// Each output equals the plain PyTorch version in
// ops/candidate_kernels.py bit for bit, in the same order, also in the
// slots that are not live (the plain version's values there are part of
// its output).
//
// What bounds them on an H100: bytes. S1 reads the bitmap (n/8 bytes) and
// writes 9 bytes per cap slot; S2-S4 read a window (at most 64 bytes) and a
// few table rows per candidate or row, each a gather of whole 32-byte
// sectors. All of it is below a few tens of MB per pass, a few microseconds
// of HBM time, so a launch's fixed cost is of the same order.
//
// Design: right and simple first. S1 is three kernels: per block of 2,048
// words the popcount sum; one block's exclusive scan of those sums (the
// blocks' rank offsets, and the total); then per block a scan of its
// threads' counts from its offset, each thread decoding the set bits of
// its 8 words while their ranks are below cap, and the slots from the count
// to cap zeroed. S2-S4 run one thread per candidate or expansion row, read the
// window bytes straight from the verify buffer (FP_LEN zero bytes, the
// haystack, W guard bytes; a window anchored at e - (FP_LEN - 1) starts at
// index e + 1), gather the table rows from device memory, and add their
// match counts per block into a total the entry point zeroes first. No
// shuffles: block reductions and scans go through shared memory.
//
// Each entry point launches on the caller's stream, never synchronises,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFpLen = 8;         // FP_LEN: bytes before a window's anchor
constexpr int kThreads = 256;     // threads per block, every kernel
constexpr int kSelWords = 8;      // bitmap words per S1 thread
constexpr int kSelBlockWords = kThreads * kSelWords;
constexpr int kMaxClasses = 9;    // length classes 1..8, and LONG

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

// Sum of v over the block (every thread passes its value; thread 0 gets
// the sum). red: kThreads slots of shared memory.
__device__ long long block_sum(long long v, long long* red) {
  const int t = threadIdx.x;
  red[t] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  const long long out = red[0];
  __syncthreads();
  return out;
}

// Inclusive scan of v over the block (Hillis-Steele). scan: kThreads slots
// of shared memory, free again when it returns.
__device__ long long block_scan(long long v, long long* scan) {
  const int t = threadIdx.x;
  scan[t] = v;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    const long long u = t >= off ? scan[t - off] : 0;
    __syncthreads();
    scan[t] += u;
    __syncthreads();
  }
  const long long out = scan[t];
  __syncthreads();
  return out;
}

// Thread 0 of the block adds the block's sum of v into *total.
__device__ void add_to_total(long long v, unsigned long long* total) {
  __shared__ long long red[kThreads];
  const long long s = block_sum(v, red);
  if (threadIdx.x == 0 && s != 0) {
    atomicAdd(total, static_cast<unsigned long long>(s));
  }
}

// ---------------------------------------------------------------- S1
__global__ void __launch_bounds__(kThreads)
select_count_kernel(const uint32_t* bmp, long long* sums) {
  __shared__ long long red[kThreads];
  const long long w0 =
      (long long)blockIdx.x * kSelBlockWords + threadIdx.x * kSelWords;
  const uint4* q = reinterpret_cast<const uint4*>(bmp + w0);
  const uint4 a = q[0], b = q[1];
  const int p = __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w) +
                __popc(b.x) + __popc(b.y) + __popc(b.z) + __popc(b.w);
  const long long s = block_sum(p, red);
  if (threadIdx.x == 0) sums[blockIdx.x] = s;
}

// One block: sums[0, nblocks) become the blocks' exclusive offsets,
// sums[nblocks] and *ncand the total.
__global__ void __launch_bounds__(kThreads)
select_scan_kernel(long long* sums, int nblocks, long long* ncand) {
  __shared__ long long scan[kThreads];
  long long carry = 0;
  for (int base = 0; base < nblocks; base += kThreads) {
    const int i = base + threadIdx.x;
    const long long v = i < nblocks ? sums[i] : 0;
    const long long incl = block_scan(v, scan);
    if (i < nblocks) sums[i] = carry + incl - v;
    // The last thread's inclusive sum is the chunk's; pass it to all.
    if (threadIdx.x == kThreads - 1) scan[0] = incl;
    __syncthreads();
    carry += scan[0];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    sums[nblocks] = carry;
    *ncand = carry;
  }
}

__global__ void __launch_bounds__(kThreads)
select_write_kernel(const uint32_t* bmp, const long long* offsets,
                    int nblocks, int L, long long cap, long long* e_pos,
                    uint8_t* live) {
  __shared__ long long scan[kThreads];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const long long all = offsets[nblocks];
  // Blocks past the bitmap's (the grid also covers cap) only zero slots.
  if (b < nblocks && offsets[b] < cap) {
    const long long w0 = (long long)b * kSelBlockWords + t * kSelWords;
    const uint4* q = reinterpret_cast<const uint4*>(bmp + w0);
    const uint4 a = q[0], c = q[1];
    uint32_t w[kSelWords] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
    int p = 0;
    for (int k = 0; k < kSelWords; ++k) p += __popc(w[k]);
    long long r = offsets[b] + block_scan(p, scan) - p;
    const int L32 = L / 32;
    for (int k = 0; k < kSelWords && r < cap; ++k) {
      uint32_t x = w[k];
      if (!x) continue;
      // Flat word index -> (tile, t32, row, column) of [tiles, L/32, 8, 128].
      const long long wi = w0 + k;
      const long long col = wi % 128;
      const long long row = (wi / 128) % 8;
      const long long t32 = (wi / 1024) % L32;
      const long long tile = wi / (1024LL * L32);
      const long long stream = (tile * 8 + row) * 128 + col;
      const long long base = stream * L + t32 * 32;
      while (x && r < cap) {
        const int bit = __ffs(x) - 1;
        x &= x - 1;
        e_pos[r] = base + bit;
        live[r] = 1;
        ++r;
      }
    }
  }
  // Past the count: position 0, not live.
  for (long long i = (long long)b * kThreads + t; i < cap;
       i += (long long)gridDim.x * kThreads) {
    if (i >= all) {
      e_pos[i] = 0;
      live[i] = 0;
    }
  }
}

// ---------------------------------------------------------------- S2
struct FpClass {
  const long long* tkeys;   // [T] cuckoo keys (uint32 values), 0 = empty
  const uint8_t* grow;      // [T, gmax * (W + 8)] packed pattern groups
  long long out_off;        // first output slot of the class
  uint32_t mult, ha, hb;
  int c, logT, gmax;
};

struct FpArgs {
  const uint8_t* u8f;       // verify buffer
  const long long* e_pos;   // [C]
  const uint8_t* live;      // [C]
  uint8_t* ok;              // [sum C * gmax] (extract)
  int32_t* pid;
  long long* end;
  unsigned long long* total;
  long long n;
  int C, W, nclasses, extract;
  FpClass cls[kMaxClasses];
};

__global__ void __launch_bounds__(kThreads) fp_verify_kernel(FpArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  long long count = 0;
  if (i < a.C) {
    const long long e = a.e_pos[i];
    const bool lv = a.live[i] != 0;
    const uint8_t* wnd = a.u8f + e + 1;
    const int W = a.W;
    for (int k = 0; k < a.nclasses; ++k) {
      const FpClass& q = a.cls[k];
      uint32_t h = 0;
      for (int j = kFpLen - q.c; j < kFpLen; ++j) h = h * q.mult + wnd[j];
      const int sh = 32 - q.logT;
      const uint32_t s1 = (h * q.ha) >> sh;
      const uint32_t s2 = (h * q.hb) >> sh;
      const bool use1 = q.tkeys[s1] == (long long)h;
      const bool use2 = q.tkeys[s2] == (long long)h;
      const uint32_t gi = use1 ? s1 : s2;
      const bool hit = (use1 || use2) && lv;
      const long long sp = e - (q.c - 1);
      const int gmax = q.gmax;
      const uint8_t* row = q.grow + (long long)gi * gmax * (W + 8);
      const int off = kFpLen - q.c;
      for (int g = 0; g < gmax; ++g) {
        const int32_t pid = (int32_t)le32(row + gmax * W + 4 * g);
        const int32_t len = (int32_t)le32(row + gmax * (W + 4) + 4 * g);
        const uint8_t* pat = row + g * W;
        bool eq = true;
        const int stop = off + len < W ? off + len : W;
        for (int j = off; j < stop && eq; ++j) eq = wnd[j] == pat[j];
        const bool ok =
            hit && pid >= 0 && eq && sp >= 0 && sp + len <= a.n;
        count += ok;
        if (a.extract) {
          const long long o = q.out_off + (long long)i * gmax + g;
          a.ok[o] = ok;
          a.pid[o] = pid;
          a.end[o] = sp + len;
        }
      }
    }
  }
  add_to_total(count, a.total);
}

// ---------------------------------------------------------------- S3
struct CasClass {
  const long long* rec;     // [T, 4] (key lo, key hi, pid, count) as uint32
  uint32_t a1, a2, b1, b2;
  int c, q, kb, logT;       // class (0 = LONG), prefix, key bytes, log2 T
};

struct ProbeArgs {
  const uint8_t* u8f;
  const long long* e_pos;
  const uint8_t* live;
  uint8_t* ok;              // [nexact, C] (extract)
  long long* pid;
  long long* end;
  long long* counts;        // [C] LONG group sizes (hits), else 0
  long long* lbase;         // [C] LONG record's pid base
  long long* lsp;           // [C] LONG start
  unsigned long long* total;
  long long n;
  int C, nexact, has_long, extract;
  CasClass cls[kMaxClasses];  // exact classes ascending, then LONG
};

__global__ void __launch_bounds__(kThreads) cascade_probe_kernel(ProbeArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  long long count = 0;
  if (i < a.C) {
    const long long e = a.e_pos[i];
    const bool lv = a.live[i] != 0;
    const uint8_t* wnd = a.u8f + e + 1;
    for (int k = 0; k < a.nexact + a.has_long; ++k) {
      const CasClass& q = a.cls[k];
      const int col0 = kFpLen - q.q;
      uint32_t lo = 0, hi = 0;
      const int nlo = q.kb < 4 ? q.kb : 4;
      for (int j = 0; j < nlo; ++j) lo = (lo << 8) | wnd[col0 + j];
      for (int j = 4; j < q.kb; ++j) hi = (hi << 8) | wnd[col0 + j];
      const long long sp = e - (q.q - 1);
      const int sh = 32 - q.logT;
      const uint32_t s1 = (lo * q.a1 + hi * q.a2) >> sh;
      const uint32_t s2 = (lo * q.b1 + hi * q.b2) >> sh;
      const long long* r1 = q.rec + 4LL * s1;
      const long long* r2 = q.rec + 4LL * s2;
      const bool h1 = r1[0] == (long long)lo && r1[1] == (long long)hi &&
                      r1[3] > 0;
      const bool h2 = r2[0] == (long long)lo && r2[1] == (long long)hi &&
                      r2[3] > 0;
      const long long* r = h1 ? r1 : r2;
      const bool valid = lv && sp >= 0 && sp + q.kb <= a.n;
      const bool hit = (h1 || h2) && valid;
      if (k < a.nexact) {
        count += hit ? r[3] : 0;
        if (a.extract) {
          const long long o = (long long)k * a.C + i;
          a.ok[o] = hit;
          a.pid[o] = r[2];
          a.end[o] = sp + q.c;
        }
      } else {
        a.counts[i] = hit ? r[3] : 0;
        a.lbase[i] = r[2];
        a.lsp[i] = sp;
      }
    }
  }
  add_to_total(count, a.total);
}

// ---------------------------------------------------------------- S4
struct LongArgs {
  const uint8_t* u8f;
  const long long* e_pos;   // [C]
  const long long* ends;    // [C] inclusive cumsum of the LONG counts
  const long long* lbase;   // [C]
  const long long* lsp;     // [C]
  const long long* pidarr;  // [npids] prefix-sorted pids
  const int32_t* pv;        // [P, 2 * Ww + 1] words, care masks, length
  uint8_t* ok;              // [cap_e] (extract)
  long long* pid;
  long long* end;
  unsigned long long* total;
  long long n, cap_e;
  int C, Ww, tail_w0, extract;
};

__global__ void __launch_bounds__(kThreads)
cascade_long_verify_kernel(LongArgs a) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long count = 0;
  if (j < a.cap_e) {
    const long long total_e = a.ends[a.C - 1];
    const bool lv = j < total_e;
    int gid = 0;
    if (lv) {  // the first group whose inclusive end passes j
      int lo = 0, hi = a.C;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a.ends[mid] <= j) lo = mid + 1; else hi = mid;
      }
      gid = lo;
    }
    const long long start = gid ? a.ends[gid - 1] : 0;
    const long long pidx = lv ? a.lbase[gid] + (j - start) : 0;
    const long long pid = a.pidarr[pidx];
    const long long sp = a.lsp[gid];
    const int32_t* prow = a.pv + pid * (2LL * a.Ww + 1);
    const uint8_t* wnd = a.u8f + a.e_pos[gid] + 1;
    bool eq = true;
    for (int w = a.tail_w0; w < a.Ww; ++w) {
      eq = eq && (((int32_t)le32(wnd + 4 * w) & prow[a.Ww + w]) == prow[w]);
    }
    const int32_t plen = prow[2 * a.Ww];
    const bool ok = lv && eq && sp >= 0 && sp + plen <= a.n;
    count = ok;
    if (a.extract) {
      a.ok[j] = ok;
      a.pid[j] = pid;
      a.end[j] = sp + plen;
    }
  }
  add_to_total(count, a.total);
}

int blocks_for(long long threads) {
  return static_cast<int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// S1. bmp: [nwords] int32, nwords a multiple of 2,048 (a bitmap of whole
// [L/32, 8, 128] tiles, L a multiple of 128 from 128 up); block_sums:
// [nwords / 2048 + 1] int64 scratch; e_pos [cap] int64, live [cap] bool,
// ncand 0-d int64.
int cand_select(const void* bmp, long long nwords, int L, long long cap,
                void* block_sums, void* e_pos, void* live, void* ncand,
                void* stream) {
  if (nwords <= 0 || nwords % kSelBlockWords || L % 128 || cap <= 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblocks = static_cast<int>(nwords / kSelBlockWords);
  const uint32_t* words = static_cast<const uint32_t*>(bmp);
  long long* sums = static_cast<long long*>(block_sums);
  select_count_kernel<<<nblocks, kThreads, 0, st>>>(words, sums);
  select_scan_kernel<<<1, kThreads, 0, st>>>(
      sums, nblocks, static_cast<long long*>(ncand));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // Enough blocks for the bitmap and for zeroing cap slots.
  const int grid = nblocks > blocks_for(cap) ? nblocks : blocks_for(cap);
  select_write_kernel<<<grid, kThreads, 0, st>>>(
      words, sums, nblocks, L, cap, static_cast<long long*>(e_pos),
      static_cast<uint8_t*>(live));
  return cudaGetLastError();
}

// S2. params: nclasses rows of 9 int64 (tkeys, grow, out_off, mult, ha,
// hb, c, logT, gmax), classes ascending; ok/pid/end: the concatenation of
// [C, gmax] per class (extract), else unused; total 0-d int64 (zeroed
// here).
int fp_verify(const void* u8f, const void* e_pos, const void* live, int C,
              int W, long long n, const long long* params, int nclasses,
              int extract, void* ok, void* pid, void* end, void* total,
              void* stream) {
  if (nclasses < 1 || nclasses > kMaxClasses || C < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FpArgs a{};
  a.u8f = static_cast<const uint8_t*>(u8f);
  a.e_pos = static_cast<const long long*>(e_pos);
  a.live = static_cast<const uint8_t*>(live);
  a.ok = static_cast<uint8_t*>(ok);
  a.pid = static_cast<int32_t*>(pid);
  a.end = static_cast<long long*>(end);
  a.total = static_cast<unsigned long long*>(total);
  a.n = n;
  a.C = C;
  a.W = W;
  a.nclasses = nclasses;
  a.extract = extract;
  for (int k = 0; k < nclasses; ++k) {
    const long long* r = params + 9 * k;
    FpClass& q = a.cls[k];
    q.tkeys = reinterpret_cast<const long long*>(r[0]);
    q.grow = reinterpret_cast<const uint8_t*>(r[1]);
    q.out_off = r[2];
    q.mult = static_cast<uint32_t>(r[3]);
    q.ha = static_cast<uint32_t>(r[4]);
    q.hb = static_cast<uint32_t>(r[5]);
    q.c = static_cast<int>(r[6]);
    q.logT = static_cast<int>(r[7]);
    q.gmax = static_cast<int>(r[8]);
  }
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(long long), st);
  if (err != cudaSuccess) return err;
  fp_verify_kernel<<<blocks_for(C), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// S3. params: (nexact + has_long) rows of 9 int64 (rec, a1, a2, b1, b2, c,
// q, kb, logT), the exact classes ascending, then LONG; ok [nexact, C]
// bool, pid/end [nexact, C] int64 (extract); counts, lbase, lsp [C] int64
// (has_long); total 0-d int64 (zeroed here).
int cascade_probe(const void* u8f, const void* e_pos, const void* live,
                  int C, long long n, const long long* params, int nexact,
                  int has_long, int extract, void* ok, void* pid, void* end,
                  void* counts, void* lbase, void* lsp, void* total,
                  void* stream) {
  if (nexact < 0 || nexact + has_long > kMaxClasses || C < 1) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ProbeArgs a{};
  a.u8f = static_cast<const uint8_t*>(u8f);
  a.e_pos = static_cast<const long long*>(e_pos);
  a.live = static_cast<const uint8_t*>(live);
  a.ok = static_cast<uint8_t*>(ok);
  a.pid = static_cast<long long*>(pid);
  a.end = static_cast<long long*>(end);
  a.counts = static_cast<long long*>(counts);
  a.lbase = static_cast<long long*>(lbase);
  a.lsp = static_cast<long long*>(lsp);
  a.total = static_cast<unsigned long long*>(total);
  a.n = n;
  a.C = C;
  a.nexact = nexact;
  a.has_long = has_long;
  a.extract = extract;
  for (int k = 0; k < nexact + has_long; ++k) {
    const long long* r = params + 9 * k;
    CasClass& q = a.cls[k];
    q.rec = reinterpret_cast<const long long*>(r[0]);
    q.a1 = static_cast<uint32_t>(r[1]);
    q.a2 = static_cast<uint32_t>(r[2]);
    q.b1 = static_cast<uint32_t>(r[3]);
    q.b2 = static_cast<uint32_t>(r[4]);
    q.c = static_cast<int>(r[5]);
    q.q = static_cast<int>(r[6]);
    q.kb = static_cast<int>(r[7]);
    q.logT = static_cast<int>(r[8]);
  }
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(long long), st);
  if (err != cudaSuccess) return err;
  cascade_probe_kernel<<<blocks_for(C), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// S4. ends: [C] inclusive cumsum of S3's counts; ok [cap_e] bool, pid/end
// [cap_e] int64 (extract); total 0-d int64 (zeroed here).
int cascade_long_verify(const void* u8f, const void* e_pos, const void* ends,
                        const void* lbase, const void* lsp, int C,
                        const void* pidarr, const void* pv, int Ww,
                        int tail_w0, long long n, long long cap_e,
                        int extract, void* ok, void* pid, void* end,
                        void* total, void* stream) {
  if (C < 1 || cap_e < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LongArgs a{};
  a.u8f = static_cast<const uint8_t*>(u8f);
  a.e_pos = static_cast<const long long*>(e_pos);
  a.ends = static_cast<const long long*>(ends);
  a.lbase = static_cast<const long long*>(lbase);
  a.lsp = static_cast<const long long*>(lsp);
  a.pidarr = static_cast<const long long*>(pidarr);
  a.pv = static_cast<const int32_t*>(pv);
  a.ok = static_cast<uint8_t*>(ok);
  a.pid = static_cast<long long*>(pid);
  a.end = static_cast<long long*>(end);
  a.total = static_cast<unsigned long long*>(total);
  a.n = n;
  a.cap_e = cap_e;
  a.C = C;
  a.Ww = Ww;
  a.tail_w0 = tail_w0;
  a.extract = extract;
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(long long), st);
  if (err != cudaSuccess) return err;
  cascade_long_verify_kernel<<<blocks_for(cap_e), kThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
