// Native Aho-Corasick construction: trie + BFS failure fill.
//
// C++ twin of the Python builder in
// ahocorasick_tpu/automata/noncontiguous.py — bit-for-bit identical
// output arrays (same host-ID allocation order, same BFS byte-sorted
// child order, same match-copy timing, same final ID remapping), so the
// two builders are interchangeable and cross-checked in tests. This
// plays the role of the reference's native construction path
// (aho-corasick/src/nfa/noncontiguous.rs, which builds 100k-pattern
// automatons in ~240ms): pattern-set compilation is host-side, scalar,
// and branchy — exactly what native code is for. The compiled tables are
// then uploaded to the TPU by the Python layer.
//
// Exposed via a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t HOST_DEAD = -1;
constexpr int kMatchStandard = 0;
constexpr int kMatchLeftmostFirst = 1;
constexpr int kMatchLeftmostLongest = 2;

inline uint8_t OppositeAsciiCase(uint8_t b) {
  if (b >= 0x41 && b <= 0x5A) return b + 32;
  if (b >= 0x61 && b <= 0x7A) return b - 32;
  return b;
}

// Flat open-addressing map over (state << 8 | byte) keys: O(1) trie
// edge find-or-insert with zero per-state allocation. Edges are
// appended to flat arrays during the trie build and counting-sorted
// into a byte-ordered CSR afterwards — replacing the former per-state
// sorted-vector inserts, which dominated the 100k-pattern build
// (0.66 s -> the reference's noncontiguous build is 240 ms,
// src/ahocorasick.rs:46-55).
//
// Both the trie build and the BFS failure fill are DRAM-latency-bound
// on these probes (the 100k-pattern map exceeds any cache), so the map
// comes in two layouts behind one interface: the compact one packs
// (key, value) into ONE uint64 slot — half the miss traffic — and
// serves every automaton whose host-state ids fit 24 bits (16.7M
// states; a 100k-word dictionary uses ~1.07M); the wide layout is the
// unbounded fallback. Compile() is templated over the choice.
struct TrieMap {
  struct Entry {
    int64_t key;  // -1 = empty
    int32_t val;
    int32_t pad;
  };  // 16 bytes: one cache line covers the entry (and its neighbor)
  std::vector<Entry> slots;
  uint64_t mask = 0;

  void Init(uint64_t want) {
    uint64_t cap = 64;
    while (cap < want) cap <<= 1;
    slots.assign(cap, Entry{-1, 0, 0});
    mask = cap - 1;
  }
  static inline uint64_t Hash(uint64_t k) {
    k *= 0x9E3779B97F4A7C15ull;
    k ^= k >> 29;
    return k;
  }
  // Pointer to the value slot; *found = false iff newly inserted.
  int32_t* FindOrInsert(int64_t key, bool* found) {
    uint64_t i = Hash(static_cast<uint64_t>(key)) & mask;
    while (true) {
      Entry& e = slots[i];
      if (e.key == key) {
        *found = true;
        return &e.val;
      }
      if (e.key < 0) {
        e.key = key;
        *found = false;
        return &e.val;
      }
      i = (i + 1) & mask;
    }
  }
  int32_t Find(int64_t key) const {
    uint64_t i = Hash(static_cast<uint64_t>(key)) & mask;
    while (true) {
      const Entry& e = slots[i];
      if (e.key == key) return e.val;
      if (e.key < 0) return -1;
      i = (i + 1) & mask;
    }
  }
  void Prefetch(int64_t key) const {
    __builtin_prefetch(&slots[Hash(static_cast<uint64_t>(key)) & mask]);
  }
};

// Compact layout: slot = (key + 1) << 32 | value (0 = empty). Keys are
// (state << 8 | byte) with state < 2^24, so key + 1 fits 32 bits.
struct CompactTrieMap {
  std::vector<uint64_t> slots;
  uint64_t mask = 0;

  void Init(uint64_t want) {
    uint64_t cap = 64;
    while (cap < want) cap <<= 1;
    slots.assign(cap, 0);
    mask = cap - 1;
  }
  int32_t* FindOrInsert(int64_t key, bool* found) {
    const uint64_t tag = (static_cast<uint64_t>(key) + 1) << 32;
    uint64_t i = TrieMap::Hash(static_cast<uint64_t>(key)) & mask;
    while (true) {
      uint64_t& e = slots[i];
      if ((e & 0xFFFFFFFF00000000ull) == tag) {
        *found = true;
        return reinterpret_cast<int32_t*>(&e);  // low half (LE host)
      }
      if (e == 0) {
        e = tag;
        *found = false;
        return reinterpret_cast<int32_t*>(&e);
      }
      i = (i + 1) & mask;
    }
  }
  int32_t Find(int64_t key) const {
    const uint64_t tag = (static_cast<uint64_t>(key) + 1) << 32;
    uint64_t i = TrieMap::Hash(static_cast<uint64_t>(key)) & mask;
    while (true) {
      const uint64_t e = slots[i];
      if ((e & 0xFFFFFFFF00000000ull) == tag)
        return static_cast<int32_t>(e & 0xFFFFFFFFull);
      if (e == 0) return -1;
      i = (i + 1) & mask;
    }
  }
  void Prefetch(int64_t key) const {
    __builtin_prefetch(
        &slots[TrieMap::Hash(static_cast<uint64_t>(key)) & mask]);
  }
};

struct BuildResult {
  int32_t num_states = 0;
  int32_t alphabet_len = 0;
  int32_t max_match_id = 0;
  int32_t start_unanchored_id = 0;
  int32_t start_anchored_id = 0;
  int32_t start_loop_open = 1;
  int32_t min_pattern_len = 0;
  int32_t max_pattern_len = 0;
  std::vector<int32_t> fail;
  std::vector<int32_t> depth;
  std::vector<int32_t> match_starts;
  std::vector<int32_t> match_pids;
  std::vector<int32_t> trans_starts;
  std::vector<uint8_t> trans_bytes;
  std::vector<int32_t> trans_next;
  std::vector<uint8_t> classes;  // 256
  std::vector<int32_t> pattern_lens;
};

template <class Map>
BuildResult* CompileImpl(const uint8_t* pat_bytes,
                         const int64_t* pat_offsets, int64_t n_patterns,
                         int match_kind, int case_insensitive) {
  const bool leftmost = match_kind != kMatchStandard;
  const bool leftmost_first = match_kind == kMatchLeftmostFirst;

  bool boundary[256] = {false};
  bool any_boundary = false;
  auto set_class_boundary = [&](uint8_t b) {
    any_boundary = true;
    if (b > 0) boundary[b - 1] = true;
    boundary[b] = true;
  };

  auto* out = new BuildResult();
  out->pattern_lens.resize(n_patterns);
  int64_t min_len = INT32_MAX, max_len = 0;

  // --- trie build (matches Python compile_nfa) ---------------------
  const int64_t total_bytes = pat_offsets[n_patterns];
  const int64_t max_edges =
      (case_insensitive ? 2 : 1) * total_bytes + 8;
  Map map;
  // Sized to the byte-count upper bound: worst-case load <= 0.8 after
  // the power-of-two round-up, typical dictionaries dedup far below
  // that. Smaller tables beat lower load factors here — the probe cost
  // is cache misses, not collisions.
  map.Init(static_cast<uint64_t>(max_edges) + max_edges / 4);
  std::vector<int32_t> depths(1, 0);
  depths.reserve(total_bytes + 1);
  // Own (trie-time) matches as flat parallel appends + per-state counts
  // — no per-state vectors anywhere on the fast path.
  std::vector<int32_t> own_count(1, 0);
  own_count.reserve(total_bytes + 1);
  std::vector<int32_t> own_state, own_pid;
  // Appended edges; sorted into a byte-ordered CSR after the build.
  std::vector<int32_t> estate, enext;
  std::vector<uint8_t> ebyte;
  estate.reserve(max_edges);
  enext.reserve(max_edges);
  ebyte.reserve(max_edges);

  for (int64_t pid = 0; pid < n_patterns; ++pid) {
    const uint8_t* p = pat_bytes + pat_offsets[pid];
    const int64_t plen = pat_offsets[pid + 1] - pat_offsets[pid];
    out->pattern_lens[pid] = static_cast<int32_t>(plen);
    if (plen < min_len) min_len = plen;
    if (plen > max_len) max_len = plen;
    int32_t prev = 0;
    bool saw_match = false;
    bool pruned = false;
    for (int64_t d = 0; d < plen; ++d) {
      uint8_t b = p[d];
      saw_match = saw_match || own_count[prev] != 0;
      if (leftmost_first && saw_match) {
        pruned = true;
        break;
      }
      set_class_boundary(b);
      if (case_insensitive) set_class_boundary(OppositeAsciiCase(b));
      bool found;
      int32_t* slot =
          map.FindOrInsert((static_cast<int64_t>(prev) << 8) | b, &found);
      int32_t next;
      if (found) {
        next = *slot;
      } else {
        next = static_cast<int32_t>(depths.size());
        depths.push_back(static_cast<int32_t>(d + 1));
        own_count.push_back(0);
        *slot = next;
        estate.push_back(prev);
        ebyte.push_back(b);
        enext.push_back(next);
        if (case_insensitive) {
          uint8_t ob = OppositeAsciiCase(b);
          if (ob != b) {
            bool f2;
            int32_t* s2 = map.FindOrInsert(
                (static_cast<int64_t>(prev) << 8) | ob, &f2);
            if (!f2) {
              *s2 = next;
              estate.push_back(prev);
              ebyte.push_back(ob);
              enext.push_back(next);
            }
          }
        }
      }
      prev = next;
    }
    if (!pruned) {
      ++own_count[prev];
      own_state.push_back(prev);
      own_pid.push_back(static_cast<int32_t>(pid));
    }
  }
  if (n_patterns == 0) min_len = 0;
  out->min_pattern_len = static_cast<int32_t>(min_len);
  out->max_pattern_len = static_cast<int32_t>(max_len);

  // --- edge CSR (state-major, byte-sorted rows) --------------------
  const int64_t n_host_states = static_cast<int64_t>(depths.size());
  const int64_t m_edges = static_cast<int64_t>(estate.size());
  std::vector<int32_t> estarts(n_host_states + 1, 0);
  for (int64_t i = 0; i < m_edges; ++i) ++estarts[estate[i] + 1];
  for (int64_t s_i = 0; s_i < n_host_states; ++s_i)
    estarts[s_i + 1] += estarts[s_i];
  std::vector<uint8_t> cbyte(m_edges);
  std::vector<int32_t> cnext(m_edges);
  {
    std::vector<int32_t> cur(estarts.begin(), estarts.end() - 1);
    for (int64_t i = 0; i < m_edges; ++i) {
      int32_t at = cur[estate[i]]++;
      cbyte[at] = ebyte[i];
      cnext[at] = enext[i];
    }
    // Rows are tiny (avg fanout ~2); insertion-sort each by byte.
    for (int64_t s_i = 0; s_i < n_host_states; ++s_i) {
      const int32_t lo = estarts[s_i], hi = estarts[s_i + 1];
      for (int32_t i = lo + 1; i < hi; ++i) {
        uint8_t kb = cbyte[i];
        int32_t kn = cnext[i];
        int32_t j = i - 1;
        while (j >= lo && cbyte[j] > kb) {
          cbyte[j + 1] = cbyte[j];
          cnext[j + 1] = cnext[j];
          --j;
        }
        cbyte[j + 1] = kb;
        cnext[j + 1] = kn;
      }
    }
  }
  estate.clear();
  estate.shrink_to_fit();
  ebyte.clear();
  ebyte.shrink_to_fit();
  enext.clear();
  enext.shrink_to_fit();

  // Own-match CSR (stable counting sort of the (state, pid) appends).
  std::vector<int64_t> ooff(n_host_states + 1, 0);
  for (int32_t s : own_state) ++ooff[s + 1];
  for (int64_t s_i = 0; s_i < n_host_states; ++s_i)
    ooff[s_i + 1] += ooff[s_i];
  std::vector<int32_t> opid(own_state.size());
  {
    std::vector<int64_t> cur(ooff.begin(), ooff.end() - 1);
    for (size_t i = 0; i < own_state.size(); ++i)
      opid[cur[own_state[i]]++] = own_pid[i];
  }

  // Dense root row: failure-chain walks overwhelmingly terminate at the
  // root, so its follow is a flat array instead of a map probe.
  int32_t root_follow[256];
  for (int b = 0; b < 256; ++b) root_follow[b] = 0;  // self-loop
  for (int32_t ei = estarts[0]; ei < estarts[1]; ++ei)
    root_follow[cbyte[ei]] = cnext[ei];

  // --- byte classes ------------------------------------------------
  out->classes.resize(256, 0);
  if (any_boundary) {
    uint8_t cls = 0;
    for (int b = 0; b < 256; ++b) {
      out->classes[b] = cls;
      if (boundary[b] && b < 255) ++cls;
    }
    out->alphabet_len = out->classes[255] + 1;
  } else {
    out->alphabet_len = 1;
  }

  // --- BFS failure fill (matches Python compile_nfa) ---------------
  // Pass 1 computes failure links only (the chain follow probes the
  // trie map: one cache line instead of a CSR binary search); match
  // lists are finalized afterwards into a flat CSR with sequential
  // memcpys — the per-state vector inserts used to cost as much as the
  // whole trie build.
  const int64_t n_host = n_host_states;
  std::vector<int32_t> fail(n_host, 0);
  std::vector<int32_t> bfs_order;
  bfs_order.reserve(n_host);
  std::vector<uint8_t> copy_flag(n_host, 0);
  // Final match counts (final(s) = own(s) ++ final(fail(s))) are
  // computed DURING discovery: fail[next] is final right here, its
  // fcnt resolved a level earlier, and the BFS already has the state's
  // cache lines hot — a separate per-level counts pass cost ~30 ms of
  // re-misses on the 100k build. Root-own-match (empty pattern) builds
  // take the order-sensitive replay path instead and skip this.
  const bool fuse_fcnt = own_count[0] == 0;
  std::vector<int64_t> fcnt(fuse_fcnt ? n_host : 0, 0);
  std::vector<uint8_t> seen(case_insensitive ? n_host : 0, 0);
  const bool use_seen = case_insensitive != 0;

  auto follow_host = [&](int32_t sid, uint8_t b) -> int32_t {
    if (sid == 0) return root_follow[b];
    int32_t next = map.Find((static_cast<int64_t>(sid) << 8) | b);
    if (next >= 0) return next;
    return -2;  // FAIL
  };

  for (int32_t ei = estarts[0]; ei < estarts[1]; ++ei) {  // byte-sorted
    int32_t next = cnext[ei];
    if (next == 0 || (use_seen && seen[next])) continue;
    bfs_order.push_back(next);
    if (use_seen) seen[next] = 1;
    if (leftmost && own_count[next] != 0) fail[next] = HOST_DEAD;
    if (fuse_fcnt) fcnt[next] = own_count[next];
  }
  // Level-parallel BFS: a state's failure link depends only on strictly
  // shallower states, so each level's edges resolve independently. Each
  // thread handles a contiguous run of parents and collects its
  // discoveries locally; concatenating the runs in parent order
  // reproduces the sequential BFS order bit-for-bit. A child state is
  // reachable from exactly one parent (case twins share the parent), so
  // all fail/copy_flag/seen writes are race-free.
  // Oversubscribed: each BFS worker stalls on dependent DRAM probes,
  // so 4x-cores threads buy memory-level parallelism the same way the
  // native walk's shards do (measured 146 -> ~70 ms on 2 cores).
  const int32_t kBfsThreads = std::min<int32_t>(
      16, std::max<int32_t>(1, 4 * std::thread::hardware_concurrency()));
  auto resolve_run = [&](size_t p_lo, size_t p_hi,
                         std::vector<int32_t>& found) {
    // Lookahead cursor issuing map prefetches PF edges ahead: the
    // first failure-chain probe of child (sid, b) is at key
    // (fail[sid] << 8 | b), known before the walk reaches it.
    constexpr int kPf = 16;
    size_t qa = p_lo;
    int32_t ea = (qa < p_hi) ? estarts[bfs_order[qa]] : 0;
    auto prefetch_next = [&] {
      while (qa < p_hi && ea >= estarts[bfs_order[qa] + 1]) {
        ++qa;
        if (qa < p_hi) ea = estarts[bfs_order[qa]];
      }
      if (qa < p_hi) {
        const int32_t f = fail[bfs_order[qa]];
        if (f > 0)
          map.Prefetch((static_cast<int64_t>(f) << 8) | cbyte[ea]);
        ++ea;
      }
    };
    for (int i = 0; i < kPf; ++i) prefetch_next();
    for (size_t qi = p_lo; qi < p_hi; ++qi) {
      int32_t sid = bfs_order[qi];
      for (int32_t ei = estarts[sid]; ei < estarts[sid + 1]; ++ei) {
        prefetch_next();
        int32_t next = cnext[ei];
        uint8_t b = cbyte[ei];
        if (use_seen && seen[next]) continue;
        found.push_back(next);
        if (use_seen) seen[next] = 1;
        if (leftmost && own_count[next] != 0) {
          fail[next] = HOST_DEAD;
          if (fuse_fcnt) fcnt[next] = own_count[next];
          continue;
        }
        int32_t f = fail[sid];
        if (f == HOST_DEAD) {
          fail[next] = HOST_DEAD;
          if (fuse_fcnt) fcnt[next] = own_count[next];
          continue;
        }
        int32_t nf;
        while (true) {
          nf = follow_host(f, b);
          if (nf != -2) break;
          f = fail[f];
          if (f == HOST_DEAD) {
            nf = HOST_DEAD;
            break;
          }
        }
        fail[next] = nf;
        if (nf != HOST_DEAD) copy_flag[next] = 1;
        if (fuse_fcnt)
          fcnt[next] = own_count[next]
                       + (nf != HOST_DEAD ? fcnt[nf] : 0);
      }
    }
  };
  std::vector<std::pair<size_t, size_t>> levels;  // [begin, end) runs
  {
    size_t lvl_lo = 0;
    while (lvl_lo < bfs_order.size()) {
      const size_t lvl_hi = bfs_order.size();
      levels.emplace_back(lvl_lo, lvl_hi);
      const size_t width = lvl_hi - lvl_lo;
      if (width < 4096 || kBfsThreads <= 1) {
        std::vector<int32_t> found;
        resolve_run(lvl_lo, lvl_hi, found);
        bfs_order.insert(bfs_order.end(), found.begin(), found.end());
      } else {
        const size_t chunk = (width + kBfsThreads - 1) / kBfsThreads;
        std::vector<std::vector<int32_t>> found(kBfsThreads);
        std::vector<std::thread> ths;
        for (int32_t t = 0; t < kBfsThreads; ++t) {
          const size_t lo = lvl_lo + t * chunk;
          const size_t hi = std::min(lvl_hi, lo + chunk);
          if (lo >= hi) break;
          ths.emplace_back(
              [&, lo, hi, t] { resolve_run(lo, hi, found[t]); });
        }
        for (auto& th : ths) th.join();
        for (auto& f : found)
          bfs_order.insert(bfs_order.end(), f.begin(), f.end());
      }
      lvl_lo = lvl_hi;
    }
  }

  // Chunked parallel-for for output passes whose writes are disjoint
  // per state (remap is a permutation); reads are random-access table
  // lookups, so the same oversubscription that helps the BFS helps
  // here.
  auto parallel_for = [&](int64_t n_items, auto&& body) {
    if (n_items < 16384 || kBfsThreads <= 1) {
      body(int64_t{0}, n_items);
      return;
    }
    const int64_t chunk = (n_items + kBfsThreads - 1) / kBfsThreads;
    std::vector<std::thread> ths;
    for (int32_t t = 0; t < kBfsThreads; ++t) {
      const int64_t lo = t * chunk;
      const int64_t hi = std::min<int64_t>(n_items, lo + chunk);
      if (lo >= hi) break;
      ths.emplace_back([&body, lo, hi] { body(lo, hi); });
    }
    for (auto& th : ths) th.join();
  };

  // --- match finalization (host-id CSR hoff/hpid) ------------------
  // final(s) = own(s) ++ final(fail(s)) (the copy the old code did at
  // discovery time; fail(s) is strictly shallower, so it is final by
  // the time s appears in BFS order). The standard kind additionally
  // appends the root's own matches at dequeue time — nonempty only
  // when an empty pattern exists, in which case the order-sensitive
  // interleaved replay below reproduces the historical order exactly.
  std::vector<int64_t> hoff(n_host + 1, 0);
  std::vector<int32_t> hpid;
  const bool root_own_matches = own_count[0] != 0;
  if (!root_own_matches) {
    // Per-level parallel (final(fail) is strictly shallower, so each
    // level's counts and fills are independent).
    auto per_level = [&](auto&& body) {
      for (const auto& lvl : levels) {
        const size_t width = lvl.second - lvl.first;
        if (width < 16384 || kBfsThreads <= 1) {
          body(lvl.first, lvl.second);
          continue;
        }
        const size_t chunk = (width + kBfsThreads - 1) / kBfsThreads;
        std::vector<std::thread> ths;
        for (int32_t t = 0; t < kBfsThreads; ++t) {
          const size_t lo = lvl.first + t * chunk;
          const size_t hi = std::min(lvl.second, lo + chunk);
          if (lo >= hi) break;
          ths.emplace_back([&body, lo, hi] { body(lo, hi); });
        }
        for (auto& th : ths) th.join();
      }
    };
    // fcnt was fused into the BFS discovery (see fuse_fcnt above).
    for (int64_t s = 0; s < n_host; ++s) hoff[s + 1] = hoff[s] + fcnt[s];
    hpid.resize(hoff[n_host]);
    per_level([&](size_t lo, size_t hi) {
      for (size_t qi = lo; qi < hi; ++qi) {
        int32_t s = bfs_order[qi];
        int64_t at = hoff[s];
        if (own_count[s]) {
          std::memcpy(hpid.data() + at, opid.data() + ooff[s],
                      own_count[s] * sizeof(int32_t));
          at += own_count[s];
        }
        if (copy_flag[s] && fcnt[fail[s]])
          std::memcpy(hpid.data() + at, hpid.data() + hoff[fail[s]],
                      fcnt[fail[s]] * sizeof(int32_t));
      }
    });
  } else {
    // Rare empty-pattern corner: replay the historical interleaving
    // (copy children's fail lists during the parent's dequeue, then
    // append the root matches to the dequeued state).
    std::vector<std::vector<int32_t>> match_lists(n_host);
    for (int64_t s = 0; s < n_host; ++s)
      match_lists[s].assign(opid.begin() + ooff[s],
                            opid.begin() + ooff[s + 1]);
    const std::vector<int32_t> rootm = match_lists[0];
    std::vector<uint8_t> seen2(use_seen ? n_host : 0, 0);
    // Depth-1 discoveries perform no copy; replay dequeues in order.
    if (use_seen)
      for (int32_t ei = estarts[0]; ei < estarts[1]; ++ei)
        if (cnext[ei] != 0) seen2[cnext[ei]] = 1;
    for (int32_t sid : bfs_order) {
      for (int32_t ei = estarts[sid]; ei < estarts[sid + 1]; ++ei) {
        int32_t next = cnext[ei];
        if (use_seen) {
          if (seen2[next]) continue;
          seen2[next] = 1;
        }
        if (copy_flag[next]) {
          auto& dst = match_lists[next];
          const auto& src = match_lists[fail[next]];
          dst.insert(dst.end(), src.begin(), src.end());
        }
      }
      if (!leftmost) {
        auto& dst = match_lists[sid];
        dst.insert(dst.end(), rootm.begin(), rootm.end());
      }
    }
    for (int64_t s = 0; s < n_host; ++s)
      hoff[s + 1] = hoff[s] + match_lists[s].size();
    hpid.resize(hoff[n_host]);
    for (int64_t s = 0; s < n_host; ++s) {
      int64_t at = hoff[s];
      for (int32_t pid : match_lists[s]) hpid[at++] = pid;
    }
  }
  auto final_count = [&](int64_t s) -> int64_t {
    return hoff[s + 1] - hoff[s];
  };

  const bool root_is_match = final_count(0) > 0;
  out->start_loop_open = !(leftmost && root_is_match);

  // --- final ID remapping (matches Python flatten) -----------------
  std::vector<int32_t> remap(n_host, 0);
  int32_t next_id = 2;
  int32_t n_match_nonroot = 0;
  for (int64_t s_i = 0; s_i < n_host; ++s_i) {
    if (s_i != 0 && final_count(s_i) > 0) {
      remap[s_i] = next_id++;
      ++n_match_nonroot;
    }
  }
  remap[0] = next_id;
  const int32_t su = next_id, sa = next_id + 1;
  next_id += 2;
  out->max_match_id = root_is_match ? sa : 1 + n_match_nonroot;
  for (int64_t s_i = 1; s_i < n_host; ++s_i) {
    if (final_count(s_i) == 0) remap[s_i] = next_id++;
  }
  const int32_t num_states = next_id;
  out->num_states = num_states;
  out->start_unanchored_id = su;
  out->start_anchored_id = sa;

  out->fail.assign(num_states, 0);
  out->depth.assign(num_states, 0);
  parallel_for(n_host, [&](int64_t lo, int64_t hi) {
    for (int64_t s_i = lo; s_i < hi; ++s_i) {
      int32_t f = fail[s_i];
      out->fail[remap[s_i]] = (f == HOST_DEAD) ? 0 : remap[f];
      out->depth[remap[s_i]] = depths[s_i];
    }
  });
  out->fail[su] = out->start_loop_open ? su : 0;
  out->fail[sa] = 0;

  // match CSR (anchored start shares root's matches)
  out->match_starts.assign(num_states + 1, 0);
  for (int64_t s_i = 0; s_i < n_host; ++s_i)
    out->match_starts[remap[s_i] + 1] =
        static_cast<int32_t>(final_count(s_i));
  out->match_starts[sa + 1] = static_cast<int32_t>(final_count(0));
  for (int32_t i = 0; i < num_states; ++i)
    out->match_starts[i + 1] += out->match_starts[i];
  out->match_pids.assign(out->match_starts[num_states], 0);
  parallel_for(n_host, [&](int64_t lo, int64_t hi) {
    for (int64_t s_i = lo; s_i < hi; ++s_i) {
      if (final_count(s_i))
        std::memcpy(out->match_pids.data() + out->match_starts[remap[s_i]],
                    hpid.data() + hoff[s_i],
                    final_count(s_i) * sizeof(int32_t));
    }
  });
  if (final_count(0))
    std::memcpy(out->match_pids.data() + out->match_starts[sa],
                hpid.data() + hoff[0],
                final_count(0) * sizeof(int32_t));

  // transition CSR: root materialized as a full 256-row with the
  // self-loop (or DEAD-closed) entries; anchored start = root's trie
  // edges only.
  const int32_t root_degree = estarts[1] - estarts[0];
  out->trans_starts.assign(num_states + 1, 0);
  for (int64_t s_i = 0; s_i < n_host; ++s_i)
    out->trans_starts[remap[s_i] + 1] =
        (s_i == 0) ? 256 : (estarts[s_i + 1] - estarts[s_i]);
  out->trans_starts[sa + 1] = root_degree;
  for (int32_t i = 0; i < num_states; ++i)
    out->trans_starts[i + 1] += out->trans_starts[i];
  const int64_t nnz = out->trans_starts[num_states];
  out->trans_bytes.assign(nnz, 0);
  out->trans_next.assign(nnz, 0);
  parallel_for(n_host, [&](int64_t p_lo, int64_t p_hi) {
   for (int64_t s_i = p_lo; s_i < p_hi; ++s_i) {
    int32_t lo = out->trans_starts[remap[s_i]];
    if (s_i == 0) {
      const int32_t loop_target = out->start_loop_open ? su : 0;
      int32_t row[256];
      for (int b = 0; b < 256; ++b) row[b] = loop_target;
      for (int32_t ei = estarts[0]; ei < estarts[1]; ++ei)
        row[cbyte[ei]] = remap[cnext[ei]];
      for (int b = 0; b < 256; ++b) {
        out->trans_bytes[lo + b] = static_cast<uint8_t>(b);
        out->trans_next[lo + b] = row[b];
      }
    } else {
      for (int32_t ei = estarts[s_i], k = 0; ei < estarts[s_i + 1];
           ++ei, ++k) {
        out->trans_bytes[lo + k] = cbyte[ei];
        out->trans_next[lo + k] = remap[cnext[ei]];
      }
    }
   }
  });
  {
    int32_t lo = out->trans_starts[sa];
    for (int32_t ei = estarts[0], k = 0; ei < estarts[1]; ++ei, ++k) {
      out->trans_bytes[lo + k] = cbyte[ei];
      out->trans_next[lo + k] = remap[cnext[ei]];
    }
  }
  return out;
}

BuildResult* Compile(const uint8_t* pat_bytes, const int64_t* pat_offsets,
                     int64_t n_patterns, int match_kind,
                     int case_insensitive) {
  // Host-state ids are bounded by total pattern bytes + 1; when they
  // fit 24 bits the compact single-word map halves probe traffic (the
  // build is DRAM-latency-bound on map probes: measured 100 ms trie +
  // 146 ms BFS of the 0.38 s 100k-pattern build were probe misses).
  const int64_t total_bytes = pat_offsets[n_patterns];
  if (total_bytes + 2 <= (int64_t{1} << 24)) {
    return CompileImpl<CompactTrieMap>(pat_bytes, pat_offsets, n_patterns,
                                       match_kind, case_insensitive);
  }
  return CompileImpl<TrieMap>(pat_bytes, pat_offsets, n_patterns,
                              match_kind, case_insensitive);
}

}  // namespace

extern "C" {

struct AcSizes {
  int32_t num_states;
  int32_t alphabet_len;
  int32_t max_match_id;
  int32_t start_unanchored_id;
  int32_t start_anchored_id;
  int32_t start_loop_open;
  int32_t min_pattern_len;
  int32_t max_pattern_len;
  int64_t match_nnz;
  int64_t trans_nnz;
};

void* ac_compile(const uint8_t* pat_bytes, const int64_t* pat_offsets,
                 int64_t n_patterns, int match_kind, int case_insensitive,
                 AcSizes* sizes) {
  BuildResult* r =
      Compile(pat_bytes, pat_offsets, n_patterns, match_kind,
              case_insensitive);
  sizes->num_states = r->num_states;
  sizes->alphabet_len = r->alphabet_len;
  sizes->max_match_id = r->max_match_id;
  sizes->start_unanchored_id = r->start_unanchored_id;
  sizes->start_anchored_id = r->start_anchored_id;
  sizes->start_loop_open = r->start_loop_open;
  sizes->min_pattern_len = r->min_pattern_len;
  sizes->max_pattern_len = r->max_pattern_len;
  sizes->match_nnz = static_cast<int64_t>(r->match_pids.size());
  sizes->trans_nnz = static_cast<int64_t>(r->trans_next.size());
  return r;
}

void ac_copy(void* handle, int32_t* fail, int32_t* depth,
             int32_t* match_starts, int32_t* match_pids,
             int32_t* trans_starts, uint8_t* trans_bytes,
             int32_t* trans_next, uint8_t* classes,
             int32_t* pattern_lens) {
  auto* r = static_cast<BuildResult*>(handle);
  std::memcpy(fail, r->fail.data(), r->fail.size() * 4);
  std::memcpy(depth, r->depth.data(), r->depth.size() * 4);
  std::memcpy(match_starts, r->match_starts.data(),
              r->match_starts.size() * 4);
  if (!r->match_pids.empty())
    std::memcpy(match_pids, r->match_pids.data(), r->match_pids.size() * 4);
  std::memcpy(trans_starts, r->trans_starts.data(),
              r->trans_starts.size() * 4);
  if (!r->trans_bytes.empty()) {
    std::memcpy(trans_bytes, r->trans_bytes.data(), r->trans_bytes.size());
    std::memcpy(trans_next, r->trans_next.data(), r->trans_next.size() * 4);
  }
  std::memcpy(classes, r->classes.data(), 256);
  if (!r->pattern_lens.empty())
    std::memcpy(pattern_lens, r->pattern_lens.data(),
                r->pattern_lens.size() * 4);
}

void ac_free(void* handle) { delete static_cast<BuildResult*>(handle); }

// ---------------------------------------------------------------------
// Native dense-DFA search: the host fallback engine for pattern sets
// beyond the bit-parallel kernel's bounds. This is the reference's hot
// loop shape (one dependent table load per byte, automaton.rs:1284-1420
// / dfa.rs:218-226) running at native speed (~1 GB/s), used when the
// TPU formulations cannot help (very large automatons are gather-bound
// and TPUs have no fast gather).

// Overlapping-match count: sum of match_count[state] over the walk.
//
// The walk is one dependent table load per byte; a single chain is
// latency-bound, so the haystack is split into `kLanes` segments walked
// in one interleaved loop (independent dependency chains hide the load
// latency — the same trick the blocked TPU scan uses with 1024 lanes).
// Each segment after the first warms up over a `halo` of preceding
// bytes (the suffix property; util/buffer.rs:113-123).
static int64_t DfaCountRange(const int32_t* trans, const uint8_t* classes,
                             const int32_t* match_count, const uint8_t* hay,
                             int64_t b, int64_t e, int64_t a,
                             int32_t start_id, int64_t halo) {
  constexpr int kLanes = 8;
  const int64_t len = e - b;
  if (len <= 0) return 0;
  if (len < kLanes * (halo + 64)) {  // tiny range: single chain
    int64_t total = 0;
    int32_t s = start_id;
    for (int64_t i = std::max<int64_t>(0, b - halo); i < b; ++i) {
      s = trans[static_cast<int64_t>(s) * a + classes[hay[i]]];
    }
    for (int64_t i = b; i < e; ++i) {
      s = trans[static_cast<int64_t>(s) * a + classes[hay[i]]];
      total += match_count[s];
    }
    return total;
  }
  const int64_t seg = (len + kLanes - 1) / kLanes;
  int64_t begin[kLanes], end[kLanes];
  int32_t s[kLanes];
  int64_t total = 0;
  for (int lane = 0; lane < kLanes; ++lane) {
    begin[lane] = b + lane * seg;
    end[lane] = std::min(e, begin[lane] + seg);
    // Halo warmup (not counted; a segment at the true start of the
    // haystack gets no warmup and starts at the unanchored start state).
    int32_t st = start_id;
    for (int64_t i = std::max<int64_t>(0, begin[lane] - halo);
         i < begin[lane]; ++i) {
      st = trans[static_cast<int64_t>(st) * a + classes[hay[i]]];
    }
    s[lane] = st;
  }
  for (int64_t off = 0; off < seg; ++off) {
    for (int lane = 0; lane < kLanes; ++lane) {
      const int64_t i = begin[lane] + off;
      if (i < end[lane]) {
        s[lane] =
            trans[static_cast<int64_t>(s[lane]) * a + classes[hay[i]]];
        total += match_count[s[lane]];
      }
    }
  }
  return total;
}

int64_t ac_dfa_count(const int32_t* trans, const uint8_t* classes,
                     const int32_t* match_count, const uint8_t* hay,
                     int64_t n, int32_t alphabet_len, int32_t start_id,
                     int64_t halo) {
  return DfaCountRange(trans, classes, match_count, hay, 0, n,
                       alphabet_len, start_id, halo);
}

// Multithreaded count: contiguous haystack shards, one per thread, each
// warmed up over `halo` preceding bytes — the host-core analog of the
// multi-chip shard_map path (parallel/shard.py), with the same stitching
// contract as the stream roll buffer (util/buffer.rs:113-123).
int64_t ac_dfa_count_mt(const int32_t* trans, const uint8_t* classes,
                        const int32_t* match_count, const uint8_t* hay,
                        int64_t n, int32_t alphabet_len, int32_t start_id,
                        int64_t halo, int32_t n_threads) {
  if (n_threads > n / (halo + 4096) + 1) {
    n_threads = static_cast<int32_t>(n / (halo + 4096) + 1);
  }
  if (n_threads <= 1) {
    return DfaCountRange(trans, classes, match_count, hay, 0, n,
                         alphabet_len, start_id, halo);
  }
  std::vector<int64_t> totals(n_threads, 0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min(n, b + chunk);
    threads.emplace_back([=, &totals] {
      totals[t] = DfaCountRange(trans, classes, match_count, hay, b, e,
                                alphabet_len, start_id, halo);
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t v : totals) total += v;
  return total;
}

// Compacted match positions: writes 1-based end offsets and state IDs
// for every position whose state is a match state (2 <= s <=
// max_match_id). Returns the total number of match positions; only the
// first `cap` are written (caller re-calls with a larger cap if
// needed).
int64_t ac_dfa_positions(const int32_t* trans, const uint8_t* classes,
                         const uint8_t* hay, int64_t n,
                         int32_t alphabet_len, int32_t start_id,
                         int32_t max_match_id, int64_t* out_pos,
                         int32_t* out_sid, int64_t cap) {
  int64_t cnt = 0;
  int32_t s = start_id;
  const int64_t a = alphabet_len;
  for (int64_t i = 0; i < n; ++i) {
    s = trans[static_cast<int64_t>(s) * a + classes[hay[i]]];
    if (s >= 2 && s <= max_match_id) {
      if (cnt < cap) {
        out_pos[cnt] = i + 1;
        out_sid[cnt] = s;
      }
      ++cnt;
    }
  }
  return cnt;
}

// Multithreaded positions: per-thread shards with halo warmup collect
// into local buffers, merged in haystack order. Returns the total match
// position count; only the first `cap` pairs are written.
int64_t ac_dfa_positions_mt(const int32_t* trans, const uint8_t* classes,
                            const uint8_t* hay, int64_t n,
                            int32_t alphabet_len, int32_t start_id,
                            int32_t max_match_id, int64_t halo,
                            int64_t* out_pos, int32_t* out_sid,
                            int64_t cap, int32_t n_threads) {
  if (n_threads > n / (halo + 4096) + 1) {
    n_threads = static_cast<int32_t>(n / (halo + 4096) + 1);
  }
  if (n_threads <= 1) {
    return ac_dfa_positions(trans, classes, hay, n, alphabet_len,
                            start_id, max_match_id, out_pos, out_sid,
                            cap);
  }
  const int64_t a = alphabet_len;
  struct Local {
    std::vector<int64_t> pos;
    std::vector<int32_t> sid;
  };
  std::vector<Local> locals(n_threads);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t b = t * chunk;
    const int64_t e = std::min(n, b + chunk);
    threads.emplace_back([=, &locals] {
      Local& lc = locals[t];
      int32_t s = start_id;
      for (int64_t i = std::max<int64_t>(0, b - halo); i < b; ++i) {
        s = trans[static_cast<int64_t>(s) * a + classes[hay[i]]];
      }
      for (int64_t i = b; i < e; ++i) {
        s = trans[static_cast<int64_t>(s) * a + classes[hay[i]]];
        if (s >= 2 && s <= max_match_id) {
          lc.pos.push_back(i + 1);
          lc.sid.push_back(s);
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t cnt = 0;
  for (const Local& lc : locals) {
    for (size_t i = 0; i < lc.pos.size(); ++i) {
      if (cnt < cap) {
        out_pos[cnt] = lc.pos[i];
        out_sid[cnt] = lc.sid[i];
      }
      ++cnt;
    }
  }
  return cnt;
}

}  // extern "C"
