"""Drive the PyTorch port's main paths on an NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N]

Runs `ahocorasick_tpu_torch` (never JAX, never the JAX package) on the
card: builds the Hopper kernels from csrc/bitap.cu (G1, G2), csrc/staged.cu
(G3, G4), csrc/fingerprint.cu (G5, G6), csrc/candidates.cu (S1-S4: the
candidate stages after G5/G6) and csrc/dfa_walk.cu (W1, W2: the blocked
DFA walk) with nvcc, one compiler per source, all started together; drives the facade at full size on each route
the JAX facade takes, every engine mode included, and the packed searcher,
the debug CLI and sharded search over a mesh; holds every result
against host truth (`bytes.find`, or the port's native C++ walk for the
name dictionaries); holds each
kernel bit for bit against its plain PyTorch version at the shapes the
facade gave it; and times each kernel (CUDA events around a CUDA graph of
launches) beside its bound.

Phases, each raising on a mismatch (launch counts are read around each
facade call; kernel-vs-plain launches are not counted):
  1. environment (card, power limit, torch, CUDA, nvcc);
  2. build (and the ptxas register/spill report);
  3. staged count, five names, 64 MiB: G3 over the 131,072 uploaded rows,
     then G4 over the candidates' rows; raw flags and per-lane counts
     against the plain versions, both kernels split into P > 1 segments;
  4. G2: a 2 MiB count; the single-pass extraction (engine="bitap") of
     16 MiB in two 8 MiB chunks, raw words against the plain version;
  5. G1: count at 594,915 bytes (and its single-pass find_iter), a 64 MiB
     count of a set with no pad byte, a K = 229 set at 1 MiB;
 5b. limb groups, G1/G2 beyond 64 limbs: the facade's count of a 128-word
     set (K = 103, G2) and of the K = 229 set (G1) over 64 MiB, its
     extraction (engine="bitap", G2) over 2 MiB, counts at K = 461 (G2)
     and K = 1,121 (G1) over 4 MiB, each against host truth; every
     LIMB_ROWS launch (G1 and G2 at K = 461 and 1,121 too) against its
     plain version on the layout the facade gave it, the 64 MiB counts
     included (G1 at K = 229 runs P = 1 in several waves);
  6. fingerprint fused extract of the five names: find_overlapping_iter
     and find_iter over 16 MiB (G6, then S1 selects the candidates and S2
     verifies them on the device), find_iter at 594,915 bytes (G5, S1,
     S2); S1/S2 launches against their plain versions on the call's own
     inputs: the first, second and last of each call (as in phases 8-12
     and 14), so every launch of a call that makes at most three;
  7. staged extract, 16 MiB: the five names plus a 70-byte pattern (no
     device verify, so the staged route; G3 and G4 in extract mode);
 7b. the staged route beyond 64 limbs: 100 random words of 8-16 bytes
     (Kf = 75, K = 83) over 64 MiB of prose, count (G3 and G4 in limb
     groups of 4 lanes), and with the 70-byte pattern over 16 MiB,
     find_overlapping_iter (G4 in extract mode at K = 85, Ke = 83), each
     against host truth, every launch of both calls against its plain
     version on the call's own inputs;
  8. dict1k: a 1,000-entry case-insensitive name dictionary over 64 MiB of
     prose, count and find_overlapping_iter (G6, S1, S2), and a 512 KiB
     count (G5, S1, S2);
  9. cascade, dict100k: 100,000 case-insensitive names (the reference's
     signature build shape) over 64 MiB of prose through the `auto` facade,
     which takes the cascade engine: count and find_overlapping_iter (G6
     over the deduped prefixes, then S1, the class probes S3, the cumsum
     and the LONG expansion and verify S4), the coarse bitmap against the
     plain version;
 10. the same dictionary plus a 70-byte pattern (the cascade's side
     bit-parallel engine: G6 and G2 in one count; the extraction's side
     chunks add G1), and a forced engine="cascade" set with no pad byte
     over 4 MiB (G5 over the window (0, n));
 11. the blocked device DFA walk (engine="dfa-scan"): the dict1k count
     (W2) and find_overlapping_iter (W1) over the 64 MiB text, the five
     names' count over the 64 MiB English-like text (W2, its table in
     shared memory) and, with a halo longer than a block, count and
     extraction over a 128 KiB haystack that fills its bucket; every W
     launch held against its plain version on the call's own inputs, and
     the plain walk never run inside a call; and engine="device-only"
     over the dict1k text, which takes the fingerprint engine (G6, S1,
     S2; the S launches held as in phase 6);
 12. the packed searcher (`ahocorasick_tpu_torch.packed`) on the card:
     `Searcher.new` of the five names over 16 MiB (G2 chunks and a G1
     tail), a 128-name set of over 2,048 pattern bytes over 16 MiB of
     prose (the fingerprint engine, G6, S1, S2), and `only_teddy` (its
     fingerprint in torch on the card, host verify), each equal to the
     leftmost-first facade and the host truth; each kernel of these
     calls held bit for bit against its plain version on the inputs of
     its second and last launch (the wrappers' arguments recorded);
 13. the debug CLI (`python3 -m ahocorasick_tpu_torch.cli`) in a process
     of its own on files under chiprun_out/ (removed afterwards): dict1k
     over the 64 MiB prose with --count-only and --overlapping, and
     --engine cascade over 4 MiB, each count equal to the native walk's;
 14. sharded search over a mesh of four entries of the card (and of every
     card where there are several): the staged count (G3, G4), the
     bit-parallel count and pairs (G1), the fingerprint pairs (G5, then
     S1 per shard, host verify), the cascade pairs (G6, S1, S3, S4 per
     shard), the stream replace (G1) and the device walk's count of
     dict1k over 64 MiB (W2 per shard), each equal to the single-device
     truth and timed beside the single-device call; each kernel held
     against its plain version on the row and window of shard 1 and of
     the last shard (S1-S4 of shard 0 too), as the call launched it;
 15. timing of each kernel at those shapes, with the thread count and the
     segment plan (P segments of Ls bytes per stream) that each wrapper
     records at launch; the device time of the copies that the staged
     kernels no longer need (the stream-major layout and the candidate
     gather, as torch operations);
      the limb rows (LIMB_ROWS, STAGED_ROWS) with their group size G;
     whole facade calls (host clock, median of 7) with a torch.profiler
     trace of one call each for the device's idle share (not measured
     where the trace misses the haystack's upload or reaches outside the
     call); the parts of the
     64 MiB staged counts (five names, 100 words), of the dict100k
     cascade count and extraction, of the dict1k fingerprint count and
     extraction, with the S kernels as their steps, and of the dict1k
     device walk's count and extraction (pack, upload, W2 or W1,
     compaction, decode); S1-S4 timed at the facade's shapes (dict100k,
     dict1k) beside their byte bounds; W1 and W2 at the facade's shapes
     (dict1k and five names over 64 MiB) with their thread plans;
 16. a `kernels` JSON line (launches from the facade calls, errors, times,
     bounds), then the card's name and power limit, then the final
     `{"ok": true, ...}` line.

Exits non-zero without the final line when no CUDA device is present or
anything fails. Details go to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --limb-rows [--port-root DIR]

builds csrc/bitap.cu and csrc/staged.cu alone and prints the times of the
LIMB_ROWS and STAGED_ROWS launches (G1-G4 beyond 64 limbs) and of the
facade's 64 MiB counts of the 128 and the 100 words as one JSON line,
with the port found under DIR: run with another tree's checkout and with
this one in turns, within one call, it compares the two trees' kernels
on the same card and the same bytes.
"""

import argparse
import io
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

NAMES = [b"Sherlock Holmes", b"John Watson", b"Irene Adler",
         b"Inspector Lestrade", b"Professor Moriarty"]
LONG = bytes(range(65, 91)) * 2 + b"abcdefghijklmnopqr"  # 70 bytes > W_MAX
WORDS = (
    "the quick brown fox jumps over lazy dog time of day it was best "
    "worst epoch belief incredulity season light darkness hope despair"
).split()
# The dict1k generator of the JAX package's bench (its BASELINE config #3).
NAME_SYLLABLES = (
    "bar bel bor dan dar del dor fan far gar gor hal han har kar kel "
    "kor lan lor mar mor nal nar nor pal par ral ran rok sar sel sor "
    "tan tar tor val van var vor wan war zan zor"
).split()
PROSE_SYLLABLES = (
    "a be ce de e fi ge hi i je ke li me ni o pe qui re si te u ve "
    "we xi ye ze tion ing ed er ly un de re in con com pro per"
).split()
MIB = 1 << 20
HEADLINE_N = 594_915      # the reference's own headline corpus size
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# Per SM and clock on Hopper (CUDA C++ Programming Guide, throughput of
# native arithmetic instructions, compute capability 9.0): 32-bit logic,
# shifts and adds 64; population count 16; shared memory 32 four-byte
# loads (128 bytes); four schedulers issue one warp instruction each.
ALU_PER_CLK = 64
POPC_PER_CLK = 16
LDS_PER_CLK = 32
ISSUE_PER_CLK = 128
CASCADE_PATTERNS = 100_000  # dict100k (the JAX package's bench.py:271-327)
CASCADE_N = 64 * MIB       # its haystack
REPS = 20                  # kernel launches per timed CUDA graph
RUNS = 7                   # facade calls per end-to-end median
KERNELS = ("G1", "G2", "G3", "G4", "G5", "G6", "S1", "S2", "S3", "S4",
           "W1", "W2")
# The candidate-stage kernels each engine runs after its bitmap.
FP_STAGES = ("S1", "S2")


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def _concat_words(vocab, pick, n: int, rng) -> bytes:
    """n bytes of words from ``vocab`` (each ending in a space), drawn by
    ``pick(rng, count)``, assembled with vectorised gathers in 8 MiB
    blocks."""
    flat = np.frombuffer(b"".join(vocab), np.uint8)
    lens = np.array([len(v) for v in vocab], np.int64)
    offs = np.cumsum(lens) - lens
    out, size = [], 0
    while size < n:
        idx = pick(rng, (8 * MIB) // 5)
        ln = lens[idx]
        dst = np.cumsum(ln) - ln
        gather = np.arange(int(ln.sum())) + np.repeat(offs[idx] - dst, ln)
        block = flat[gather]
        out.append(block)
        size += len(block)
    return np.concatenate(out)[:n].tobytes()


def english(n: int, rng: np.random.Generator, name_p: float = 0.001):
    """English-like text with the five names at rate ``name_p`` per
    word."""
    vocab = [w.encode() + b" " for w in WORDS] + [p + b" " for p in NAMES]
    p = np.full(len(vocab), (1 - name_p) / len(WORDS))
    p[len(WORDS):] = name_p / len(NAMES)
    return _concat_words(vocab, lambda r, k: r.choice(len(vocab), size=k,
                                                      p=p), n, rng)


def build_words(count, seed, syllables, capitalize=0.0):
    rng = np.random.default_rng(seed)
    pats = set()
    while len(pats) < count:
        ns = int(rng.integers(2, 5))
        w = "".join(syllables[int(rng.integers(len(syllables)))]
                    for _ in range(ns))
        if capitalize and rng.random() < capitalize:
            w = w.capitalize()
        pats.add(w.encode())
    return sorted(pats)


def build_dictionary(count=1000, seed=99):
    """A 1K-entry mixed-case name dictionary: prefix-sharing entries, the
    shape of real dictionaries (gazetteers, name lists)."""
    return build_words(count, seed, NAME_SYLLABLES, capitalize=0.3)


def build_dict_text(n, pats, seed=7, density=0.002):
    """Prose-shaped text with planted dictionary hits: each word is a
    dictionary entry with probability ``density``, else one of 4,000
    filler words, words separated by one space (the JAX package's bench
    generator, drawn in bulk)."""
    filler = build_words(4000, seed + 1, PROSE_SYLLABLES)
    vocab = [w + b" " for w in pats] + [w + b" " for w in filler]
    P = len(pats)

    def pick(r, k):
        hit = r.random(k) < density
        return np.where(hit, r.integers(0, P, k),
                        P + r.integers(0, len(filler), k))
    return _concat_words(vocab, pick, n, np.random.default_rng(seed))


def random_with(pats, n: int, inserts: int, rng):
    """Uniform random bytes with ``inserts`` copies of the patterns."""
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    pos = rng.choice(n - 128, size=inserts, replace=False)
    for i, at in enumerate(np.sort(pos)):
        p = pats[i % len(pats)]
        buf[at:at + len(p)] = np.frombuffer(p, np.uint8)
    return buf.tobytes()


def limb_sets():
    """{K: patterns} of the sets whose chains pack into more than 64 limbs
    (G1/G2's limb groups), defined once for this script and the tests in
    tests/test_torch_limb_sets.py (numpy alone, so any checkout of the port
    may be timed beside it): 128 words of 4-8 bytes (K = 103, pad byte 0,
    no staged route: the shape of a mid-size keyword list), 256
    three-byte patterns (K = 229, no pad byte), 488 words of 3 bytes
    (K = 461) and every one-byte pattern with 896 two-byte ones
    (K = 1,121, 2,048 bytes, no pad byte)."""
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_limb_sets import limb_sets as sets
    return sets()


# The limb-group rows (K > 64): (name, K, haystack bytes, kernel,
# extract). The 64 MiB counts, the 2 MiB extraction (engine="bitap") and
# the 4 MiB counts of G2 at K = 461 and G1 at K = 1,121 are the facade's
# own launches; G1 at K = 461 and G2 at K = 1,121 run every group size
# (4, 8, 16 lanes of 32 limbs, 32 of 64) through both kernels.
LIMB_ROWS = (
    ("G1 count 1 MiB, K=229", 229, MIB, "G1", False),
    ("G1 count 64 MiB, K=229, no pad byte", 229, 64 * MIB, "G1", False),
    ("G2 count 64 MiB, K=103 (128 words)", 103, 64 * MIB, "G2", False),
    ("G2 extract 2 MiB, K=103 (engine='bitap')", 103, 2 * MIB, "G2", True),
    ("G2 count 4 MiB, K=461", 461, 4 * MIB, "G2", False),
    ("G1 count 4 MiB, K=461", 461, 4 * MIB, "G1", False),
    ("G1 count 4 MiB, K=1121, no pad byte", 1121, 4 * MIB, "G1", False),
    ("G2 count 4 MiB, K=1121", 1121, 4 * MIB, "G2", False),
)


def staged_sets():
    """{name: patterns} of the staged route beyond 64 limbs, defined in
    tests/test_torch_limb_sets.py: 100 random lowercase words of 8-16
    bytes ("w100": Kf = 75, K = 83, staged-eligible) and the same with
    the 70-byte LONG ("w100_long": Kf = 76, K = 85, Ke = 83, halo 128)."""
    limb_sets()  # puts tests/ on the path
    from test_torch_limb_sets import STAGED_SETS
    return STAGED_SETS


# The staged limb-group rows (G3/G4 beyond 64 limbs): (name, key of
# staged_layouts, kernel, extract). The facade's own launches for the 100
# words: the 64 MiB count (G3 over every row, G4 over the candidates) and
# the 16 MiB extraction with LONG (G4 in extract mode).
STAGED_ROWS = (
    ("G3 flags 64 MiB, Kf=75 (100 words)", "count", "G3", False),
    ("G4 count 64 MiB, K=83 (100 words), facade candidates", "count", "G4",
     False),
    ("G4 extract 16 MiB, K=85, Ke=83 (100 words + LONG)", "extract", "G4",
     True),
)


def staged_hay(pats, n: int, seed: int, longs: int = 0) -> bytes:
    """Prose-shaped text (build_dict_text) with the patterns planted as
    words at rate 0.002, and ``longs`` copies of LONG, from a generator of
    its own, so every tree that times the rows scans the same bytes."""
    hay = build_dict_text(n, pats, seed=seed + 31)
    if not longs:
        return hay
    buf = bytearray(hay)
    rng = np.random.default_rng([seed, n])
    for at in rng.choice(n - 200, longs, replace=False):
        buf[at:at + len(LONG)] = LONG
    return bytes(buf)


def staged_layouts(TS, dev, seed):
    """{"count" | "extract": (engine, prepared haystack, sid, haystack)}:
    the 100 words over 64 MiB and the 100 words + LONG over 16 MiB, with
    the candidate ids at the cap the facade's count settles on."""
    sets, out = staged_sets(), {}
    for key, name, n, longs in (("count", "w100", 64 * MIB, 0),
                                ("extract", "w100_long", 16 * MIB, 500)):
        pats = sets[name] if key == "count" else sets["w100"]
        hay = staged_hay(pats, n, seed, longs)
        st = TS.StagedEngine(sets[name], False, dev)
        ph = st.prepare(hay)
        cap = max(1024, 1 << max(ph.tiles * 1024 // 8 - 1, 0).bit_length())
        while True:
            ncand, cand = st.candidates(ph, cap)
            if ncand <= cap:
                break
            cap *= 2
        out[key] = (st, ph, cand.to(torch.int32).reshape(-1, 8, 128), hay)
    return out


def staged_args(layout, kernel, extract):
    """The wrapper arguments of a staged row's launch (G4: the window
    [0, n))."""
    st, ph, sid, _ = layout
    (flo, fhi, fsm, fem), (lo, hi, sm, em) = st._args()
    if kernel == "G3":
        return (flo, fhi, fsm, fem, ph.rows, st.halo)
    return (lo, hi, sm, em, st.full.end_limbs, sid, ph.rows, st.halo, 0,
            ph.n, extract)


def time_staged_rows(SK, layouts, sm_hz, card, with_plain):
    """Time every STAGED_ROWS launch on ``layouts`` (staged_layouts)
    through the wrappers of ``SK`` (this tree's staged_kernels or another
    tree's), with the plain version's time where ``with_plain``."""
    rows = {}
    for name, key, kernel, extract in STAGED_ROWS:
        st, ph, sid, _ = layouts[key]
        a = staged_args(layouts[key], kernel, extract)
        lanes = sid.numel()
        ncand = int((sid >= 0).sum())
        if kernel == "G3":
            wrap, plain = SK.staged_flags, SK.staged_flags_plain
            spec = dict(K=st.fp.k, n=ph.n, lanes=ph.tiles * 1024,
                        out_per_byte=0, popc=False, extra_in=0)
        else:
            wrap, plain = SK.staged_gathered, SK.staged_gathered_plain
            Ke = len(st.full.end_limbs)
            spec = dict(K=st.full.k, n=ncand * ph.L, lanes=lanes,
                        out_per_byte=4 * Ke if extract else 0, popc=True,
                        extra_in=4 * lanes)
        rows[name] = timed_row(
            name, spec["K"], spec["n"], spec["lanes"], spec["out_per_byte"],
            lambda: wrap(*a), (lambda: plain(*a)) if with_plain else None,
            (lambda: SK.flags_plan) if kernel == "G3" else (
                lambda: SK.gathered_plan), sm_hz, card, spec["popc"],
            spec["extra_in"])
        rows[name]["candidates"] = ncand
    return rows


def limb_haystack(pats, K: int, n: int, seed: int) -> bytes:
    """Random bytes with one pattern copy per 3,300 bytes (at least 3,000),
    from a generator of its own, so every tree that times the rows scans
    the same bytes."""
    return random_with(pats, n, max(3000, n // 3300),
                       np.random.default_rng([seed, K, n]))


def limb_layouts(TB, dev, seed):
    """{(K, n, kernel): (engine, prepared haystack, haystack)} of
    LIMB_ROWS, G2 on a buffer padded with the set's pad byte where it has
    one (as the facade packs it), G1 on a zero-padded one."""
    sets, hays, out = limb_sets(), {}, {}
    for _, K, n, kernel, _ in LIMB_ROWS:
        if (K, n) not in hays:
            hays[K, n] = limb_haystack(sets[K], K, n, seed)
        eng = TB.BitapEngine(sets[K], False, dev)
        assert eng.tables.k == K, (K, eng.tables.k)
        out[K, n, kernel] = (eng, eng.prepare(hays[K, n],
                                              baked=kernel == "G2"),
                             hays[K, n])
    return out


def limb_args(eng, ph, kernel, extract):
    """The wrapper arguments of a limb row's launch (G1: the window [0, n))."""
    lo, hi, sm, em = eng._args()
    if kernel == "G1":
        return (lo, hi, sm, em, ph.halo_a, ph.body, 0, ph.n, extract)
    return (lo, hi, sm, em, eng.tables.end_limbs, ph.halo_a, ph.body,
            extract)


def host_pairs(pats, hay: bytes):
    """All overlapping (pid, start, end), by repeated bytes.find."""
    out = []
    for pid, p in enumerate(pats):
        i = hay.find(p)
        while i >= 0:
            out.append((pid, i, i + len(p)))
            i = hay.find(p, i + 1)
    return out


def overlapping_order(pats, pairs):
    """Report order of an overlapping search: end asc, then length desc,
    then pattern id asc."""
    return sorted(pairs, key=lambda t: (t[2], -len(pats[t[0]]), t[0]))


def leftmost_first(pairs):
    """Leftmost-first find_iter from the overlapping set: the leftmost
    start at or after the previous match's end, ties by pattern id."""
    out, cursor = [], 0
    for t in sorted(pairs, key=lambda t: (t[1], t[0])):
        if t[1] >= cursor:
            out.append(t)
            cursor = t[2]
    return out


def pair_list(got):
    """(pids, ends) arrays as a list of (pid, end)."""
    return list(zip(got[0].tolist(), got[1].tolist()))


def standard_nonoverlapping(pats, pairs):
    """Standard-semantics find_iter from the overlapping set: the
    earliest-ending match that starts at or after the previous match's
    end, ties by the overlapping report order."""
    out, cursor = [], 0
    for t in overlapping_order(pats, pairs):
        if t[1] >= cursor:
            out.append(t)
            cursor = t[2]
    return out


# ---------------------------------------------------------------------------
# Environment and build
# ---------------------------------------------------------------------------
def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def ptxas_summary(report: str):
    """One line per compiled kernel: demangled-enough name, registers,
    spills."""
    lines, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            raw = m.group(1)
            k = re.search(r"\d+([a-z_]+_kernel)ILi(\d+)E((?:Lb[01]E)*)", raw)
            if k:
                flags = "".join(re.findall(r"Lb([01])E", k.group(3)))
                name = f"{k.group(1)}<KR={k.group(2)}{',' if flags else ''}" \
                       f"{','.join(flags)}>"
            else:
                name = raw
        elif "spill" in ln or "Used" in ln:
            lines.append(f"  {name}: {ln.split(':', 1)[-1].strip()}")
    return lines


def word_loop(sass: str, kernel: str):
    """Opcode counts of the longest loop (a backward branch and the
    instructions from its target to it) of the kernel function whose
    mangled name holds ``kernel``, in ``cuobjdump -sass`` output."""
    fn = next(f for f in sass.split("Function : ")[1:]
              if kernel in f.split("\n", 1)[0])
    ins = [(int(a, 16), re.sub(r"^@!?U?P\w+\s+", "", t))
           for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", fn)]
    at = {a: i for i, (a, _) in enumerate(ins)}
    best = []
    for i, (a, t) in enumerate(ins):
        m = re.match(r"BRA\b.*0x([0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            body = ins[at[int(m.group(1), 16)]:i + 1]
            best = body if len(body) > len(best) else best
    counts = {}
    for _, t in best:
        op = t.split()[0].split(".")[0]
        counts[op] = counts.get(op, 0) + 1
    return counts


def step_issue(sass: str, kernel: str, a: int = 4, b: int = 8):
    """(instructions per limb and byte step, by opcode) that a compiled
    shift-AND step issues: the growth of the kernel's word loop from its
    KR = a to its KR = b instantiation (``kernel`` holds %d for KR), over
    b - a limbs times the byte steps of the loop, which the growth of the
    shared-memory loads gives (two per limb and step)."""
    ha, hb = word_loop(sass, kernel % a), word_loop(sass, kernel % b)
    steps = (hb.get("LDS", 0) - ha.get("LDS", 0)) / (2 * (b - a))
    d = {op: (hb.get(op, 0) - ha.get(op, 0)) / ((b - a) * steps)
         for op in set(ha) | set(hb)}
    d = {op: v for op, v in sorted(d.items(), key=lambda kv: -kv[1]) if v}
    return sum(d.values()), d


# ---------------------------------------------------------------------------
# Checks and timing
# ---------------------------------------------------------------------------
def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if w is None:
            continue
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {w.shape}")
        e = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
        err = max(err, e)
    if err:
        raise AssertionError(f"kernel disagrees with plain version: {err}")
    return err


def events_ms(fn):
    """Device time of ``fn`` on the current stream (CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def kernel_ms(fn):
    """Per-launch device time of a kernel wrapper: launches captured in one
    CUDA graph, so the wrapper's host-side checks and the launch path are
    out of the measurement; mean of 5 replays after a warm one. A graph
    holds REPS launches, or as many as take about 2 ms where one launch
    takes longer than 0.1 ms (each launch keeps its outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    reps = max(1, min(REPS, int(2.0 / max(events_ms(fn), 1e-3))))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = events_ms(lambda: [graph.replay() for _ in range(5)])
    del graph
    return ms / (5 * reps)


def step_cycles(K, popc):
    """SM cycles per scanned byte that a shift-AND step over K limbs needs
    at the least on Hopper, each class of operation over its own rate:
    per byte, two integer operations (the two nybble indices); per limb, a
    funnel shift (m << 1 with the carry of the limb below), two
    three-input logic operations ((x | start) & lo & hi), two shared-memory
    loads (lo, hi) and the output: one logic operation (any |= m & end),
    or, for a count (``popc``), m & end, a popc and half an add (one
    three-input add sums two popcs)."""
    alu = 2 + K * (3 + (1.5 if popc else 1))
    pop = K if popc else 0
    lds = 2 * K
    return max(alu / ALU_PER_CLK, pop / POPC_PER_CLK, lds / LDS_PER_CLK,
               (alu + pop + lds) / ISSUE_PER_CLK)


def bound(K, n, lanes, out_per_byte, sm_hz, popc, extra_in=0):
    """(bound_ms, bound_by) for a shift-AND scan of the n haystack bytes
    it must read: the larger of the bytes it must move (the n bytes, the
    tables and ``extra_in`` read once; per-lane outputs, 4 bytes each, and
    ``out_per_byte`` output bytes per scanned byte written once) over the
    memory rate, and the operations (``step_cycles`` per scanned byte)
    over ``sm_hz``, the SM cycles per second of the whole card. Padding and
    the halo's warm-up bytes are layout overhead, charged nothing."""
    moved = n + 34 * K * 4 + extra_in + lanes * 4 + n * out_per_byte
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = n * step_cycles(K, popc) / sm_hz * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def timed_row(name, K, n, lanes, out_per_byte, kern, plain, seg, sm_hz,
              card, popc=True, extra_in=0):
    """One timed kernel beside its bound; ``seg`` reads the (threads, P,
    Ls[, G]) that the kernel's wrapper recorded at its last launch (G = 1
    where it records none). ``plain`` (None: not timed) runs the plain
    version."""
    ms = kernel_ms(kern)
    threads, P, Ls, *G = seg()
    G = G[0] if G else 1
    bms, by = bound(K, n, lanes, out_per_byte, sm_hz, popc, extra_in)
    r = dict(name=name, K=K, bytes=n, ms=ms,
             plain_ms=None if plain is None else events_ms(plain),
             bound_ms=bms, bound_by=by,
             gbps=n / ms / 1e6, share_of_bound=bms / ms, threads=threads,
             P=P, Ls=Ls, G=G)
    plain_txt = ("" if plain is None else
                 f"plain {r['plain_ms']:.1f} ms, ")
    log(f"[time] {name}: {ms:.4f} ms ({r['gbps']:.1f} GB/s), {plain_txt}"
        f"bound {bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of bound; "
        f"{threads} threads, P={P} x Ls={Ls} B, G={G} | {card}")
    return r


def limb_fns(TK, kernel):
    """(wrapper, plain version) of a limb row's kernel in ``TK``."""
    if kernel == "G1":
        return TK.bitap_scan_generic, TK.bitap_scan_generic_plain
    return TK.bitap_scan_baked, TK.bitap_scan_baked_plain


def limb_against_plain(TK, layout, kernel, extract):
    """(kernel outputs, plain outputs) of one LIMB_ROWS launch, on the
    layout the facade gave it."""
    eng, ph, _ = layout
    a = limb_args(eng, ph, kernel, extract)
    wrap, plain = limb_fns(TK, kernel)
    return wrap(*a), plain(*a)


def time_limb_rows(TK, layouts, sm_hz, card, with_plain):
    """Time every LIMB_ROWS launch on ``layouts`` (limb_layouts) through
    the wrappers of ``TK`` (this tree's bitap_kernels, or another tree's for
    a before/after comparison in one process), with the plain version's
    time where ``with_plain``."""
    rows = {}
    for name, K, n, kernel, extract in LIMB_ROWS:
        eng, ph, _ = layouts[K, n, kernel]
        a = limb_args(eng, ph, kernel, extract)
        wrap, plain_fn = limb_fns(TK, kernel)
        kdim = len(eng.tables.end_limbs) if kernel == "G2" else K
        rows[name] = timed_row(
            name, K, n, ph.tiles * 1024, 4 * kdim if extract else 0,
            lambda: wrap(*a), (lambda: plain_fn(*a)) if with_plain else None,
            (lambda: TK.generic_plan) if kernel == "G1" else (
                lambda: TK.baked_plan), sm_hz, card)
    return rows


def trace(fn):
    """One call under torch.profiler: (call ms, device-busy ms, the busy
    time by device activity, (first, last) device timestamp in ms from
    the call's start on the host). Busy time is the union of the device's
    kernel and copy intervals in the trace, which holds this call alone
    (the call's own annotation, which the profiler also lays on the
    device timeline, is left out). The device numbers are None (not
    measured) when the trace holds no device activity, when any of it
    lies outside the call's range on the host, or when it shows no
    host-to-device copy (every traced call uploads its haystack): a trace
    that lost records would give too high an idle share."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke_call"):
            fn()
            torch.cuda.synchronize()
    evs = prof.events()
    call = next(e for e in evs if e.name == "chip_smoke_call")
    c0, c1 = call.time_range.start, call.time_range.end
    dev = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in evs
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name != "chip_smoke_call")
    call_ms = (c1 - c0) / 1e3
    if not dev:
        return call_ms, None, {}, None
    busy, end, by = 0.0, dev[0][0], {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by[name] = by.get(name, 0.0) + (b - a) / 1e3
    span = ((dev[0][0] - c0) / 1e3, (end - c0) / 1e3)
    if span[0] < 0 or end > c1:
        log(f"[trace] device activity from {span[0]:.3f} to {span[1]:.3f} "
            f"ms lies outside the {call_ms:.3f} ms call: not measured")
        return call_ms, None, by, span
    if not any(k.startswith("Memcpy HtoD") for k in by):
        log("[trace] the trace holds no record of the haystack's upload: "
            "not measured")
        return call_ms, None, by, span
    return call_ms, busy / 1e3, by, span


def log_trace(name, call_ms, busy_ms, by, span, idle_med=None):
    """The [trace] line of one traced call."""
    if busy_ms is None:
        log(f"[trace] {name}: call {call_ms:.3f} ms, device busy not "
            f"measured")
        return
    top = sorted(by.items(), key=lambda kv: -kv[1])[:4]
    med = ("" if idle_med is None else
           f", {100 * idle_med:.1f}% of the median call")
    log(f"[trace] {name}: call {call_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle {100 * (1 - busy_ms / call_ms):.1f}% of "
        f"the traced call{med}; device activity from {span[0]:.3f} to "
        f"{span[1]:.3f} ms of the call; "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))


def host_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def card_rates():
    """(device name, nvidia-smi name and power limit, SM cycles per second
    of the whole card at its maximum SM clock)."""
    max_mhz = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (torch.cuda.get_device_name(0), smi("name,power.limit"),
            sms * max_mhz * 1e6)


def build_all(libs):
    """Build the libraries, one nvcc each, all started together; raises
    the first build's error. Returns each library's build seconds."""
    errors, seconds = [], {}

    def build(lib):
        t0 = time.time()
        try:
            lib.load()
        except Exception as e:  # re-raised below, in the main thread
            errors.append(e)
        seconds[lib.stem] = time.time() - t0
    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return seconds


def e2e_call(name, fn, card):
    """(median ms of RUNS host-clock calls, trace) of one facade call."""
    ms = float(np.median([host_ms(fn) for _ in range(RUNS)]))
    log(f"[e2e] {name}: {ms:.3f} ms (median of {RUNS}, host clock) | {card}")
    traced = trace(fn)
    log_trace(name, *traced)
    return ms, dict(zip(("call_ms", "busy_ms", "ms_by_name", "span_ms"),
                        traced))


def limb_rows_main(args) -> int:
    """--limb-rows: build csrc/bitap.cu and csrc/staged.cu alone, hold
    every LIMB_ROWS and STAGED_ROWS launch against its plain version and
    time it, with the port under --port-root (default: this checkout). Run
    once with another tree's checkout and once with this one, in turns
    within one call, it gives both trees' times on the same card and the
    same bytes."""
    if args.port_root:
        sys.path.insert(0, os.path.abspath(args.port_root))
    try:
        from ahocorasick_tpu_torch import AhoCorasick
        from ahocorasick_tpu_torch.ops import bitap as TB
        from ahocorasick_tpu_torch.ops import bitap_kernels as TK
        from ahocorasick_tpu_torch.ops import staged as TS
        from ahocorasick_tpu_torch.ops import staged_kernels as SK
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    kind, card, sm_hz = card_rates()
    built = build_all((TK.LIBRARY, SK.LIBRARY))
    log(f"[limb rows] {os.path.dirname(TK.__file__)}: " + ", ".join(
        f"{k}.cu built in {v:.1f} s" for k, v in built.items())
        + f" (in parallel) | {card}")
    dev = torch.device("cuda")
    layouts = limb_layouts(TB, dev, args.seed)
    for name, K, n, kernel, extract in LIMB_ROWS:
        max_abs_err(*limb_against_plain(TK, layouts[K, n, kernel], kernel,
                                        extract))
    slayouts = staged_layouts(TS, dev, args.seed)
    for name, key, kernel, extract in STAGED_ROWS:
        a = staged_args(slayouts[key], kernel, extract)
        fns = ((SK.staged_flags, SK.staged_flags_plain) if kernel == "G3"
               else (SK.staged_gathered, SK.staged_gathered_plain))
        got, want = fns[0](*a), fns[1](*a)
        max_abs_err(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))
    log("[limb rows] every launch = plain")
    rows = time_limb_rows(TK, layouts, sm_hz, card, with_plain=False)
    srows = time_staged_rows(SK, slayouts, sm_hz, card, with_plain=False)
    # The facade's 64 MiB counts of the 128 words (one G2 launch) and of
    # the 100 words (staged: G3, G4), host clock ending in a synchronise,
    # median of RUNS.
    _, _, hay = layouts[103, 64 * MIB, "G2"]
    ac = AhoCorasick(limb_sets()[103], device="cuda")
    call_ms, traced = e2e_call("128 words (K=103) count_matches 64 MiB",
                               lambda: ac.count_matches(hay), card)
    hay_w = slayouts["count"][3]
    ac_w = AhoCorasick(staged_sets()["w100"], device="cuda")
    w_ms, w_traced = e2e_call("100 words (Kf=75, K=83) count_matches 64 MiB",
                              lambda: ac_w.count_matches(hay_w), card)
    print(json.dumps({"limb_rows": rows, "staged_rows": srows,
                      "k103_count_ms": call_ms, "k103_count_trace": traced,
                      "w100_count_ms": w_ms, "w100_count_trace": w_traced,
                      "port": os.path.dirname(TK.__file__), "card": card,
                      "kind": kind}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--limb-rows", action="store_true",
                    help="time only the K > 64 rows of G1-G4 and two "
                    "facade counts, and print them as one JSON line")
    ap.add_argument("--port-root", default=None,
                    help="with --limb-rows: the directory holding the "
                    "ahocorasick_tpu_torch to time (another tree's "
                    "checkout); default this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.limb_rows:
        return limb_rows_main(args)
    try:
        from ahocorasick_tpu_torch import AhoCorasick, MatchKind, _build
        from ahocorasick_tpu_torch.packed import Config as PackedConfig
        from ahocorasick_tpu_torch.packed import Searcher
        from ahocorasick_tpu_torch.parallel.shard import (
            Mesh,
            make_mesh,
            sharded_bitap_count,
            sharded_bitap_match_pairs,
            sharded_cascade_match_pairs,
            sharded_count_matches,
            sharded_fp_match_pairs,
            sharded_staged_count,
            sharded_stream_replace_all,
        )
        from ahocorasick_tpu_torch.stream import stream_replace_all
        from ahocorasick_tpu_torch.ops import bitap as TB
        from ahocorasick_tpu_torch.ops import bitap_kernels as TK
        from ahocorasick_tpu_torch.ops import candidate_kernels as CK
        from ahocorasick_tpu_torch.ops import cascade as TC
        from ahocorasick_tpu_torch.ops import fingerprint as TF
        from ahocorasick_tpu_torch.ops import fingerprint_kernels as FK
        from ahocorasick_tpu_torch.ops import staged as TS
        from ahocorasick_tpu_torch.ops import staged_kernels as SK
        from ahocorasick_tpu_torch.ops import walk_kernels as WK
        from ahocorasick_tpu_torch.ops.compaction import (
            select_matches,
            select_nonzero_words,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    t_start = time.time()
    rng = np.random.default_rng(args.seed)
    dev = torch.device("cuda")
    report = {"seed": args.seed}

    # 1. Environment ---------------------------------------------------------
    kind, card, sm_hz = card_rates()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = sm_hz / sms / 1e6
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True).stdout
    log(f"[env] device: {kind} | nvidia-smi: {card}")
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"[env] nvcc: {nvcc.strip().splitlines()[-1]}")
    log(f"[env] {sms} SMs x {max_mhz:.0f} MHz max SM clock: 32-bit logic "
        f"{ALU_PER_CLK * sm_hz / 1e12:.2f} Tops/s, popc "
        f"{POPC_PER_CLK * sm_hz / 1e12:.2f}, shared loads "
        f"{LDS_PER_CLK * sm_hz / 1e12:.2f} T/s")
    report["env"] = dict(kind=kind, smi=card, torch=torch.__version__,
                         cuda=torch.version.cuda, max_sm_mhz=max_mhz)

    # 2. Build: one nvcc per source, all started together ---------------------
    t0 = time.time()
    libs = (TK.LIBRARY, SK.LIBRARY, FK.LIBRARY, CK.LIBRARY, WK.LIBRARY)
    built = build_all(libs)
    log(f"[build] bitap.cu, staged.cu, fingerprint.cu, candidates.cu, "
        f"dfa_walk.cu -> sm_90a in "
        f"{time.time() - t0:.1f} s (in parallel: " + ", ".join(
            f"{k}.cu {v:.1f} s" for k, v in built.items()) + ")")
    report["build_s"] = built
    report["ptxas"] = {}
    for lib in libs:
        rep = lib.report()
        report["ptxas"][lib.stem] = rep
        for ln in ptxas_summary(rep):
            if ("spill" in ln and " 0 bytes spill" not in ln) or (
                    "group_" in ln):
                log(f"[build] {lib.stem}:{ln}")
    # What the compiled step issues per limb and byte step, warm-up and
    # scanned steps alike, beside the least that the bound counts
    # (step_cycles: 5 in a warm-up step, 6 in a scanned one, 7.5 with a
    # popc).
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    report["sass"] = {}
    sass_of = {}
    for name, lib, kernel in (
            ("G6", FK.LIBRARY, "bitmap_kernelILi%dELb0E"),
            ("G4 count", SK.LIBRARY, "gathered_kernelILi%dELb0E"),
            ("G2 count", TK.LIBRARY, "scan_kernelILi%dELb1ELb0E"),
            ("G1 count", TK.LIBRARY, "scan_kernelILi%dELb0ELb0E")):
        if lib.stem not in sass_of:
            sass_of[lib.stem] = subprocess.run(
                [cuobjdump, "-sass", lib.path], capture_output=True,
                text=True, timeout=300, check=True).stdout
        sass = sass_of[lib.stem]
        total, by_op = step_issue(sass, kernel)
        report["sass"][name] = dict(per_limb_byte=total, by_opcode=by_op)
        log(f"[sass] {name} ({kernel % 8}, against KR=4): {total:.3f} "
            f"instructions per limb and byte step: " + ", ".join(
                f"{op} {v:.3f}" for op, v in by_op.items()))
    # The limb groups (K > 64): the growth from KR = 32 to KR = 64 gives
    # what a limb costs; the whole loop of KR = 32 over its byte steps and
    # 32 limbs counts the per-byte work too (the shuffle once per byte).
    # G3/G4's limb groups are read on their shared-table instances, the
    # ones the staged rows launch.
    sass_of[SK.LIBRARY.stem] = subprocess.run(
        [cuobjdump, "-sass", SK.LIBRARY.path], capture_output=True,
        text=True, timeout=300, check=True).stdout
    for name, lib, kernel in (
            ("G1 count", TK.LIBRARY, "group_kernelILi%dELb0ELb0ELb1E"),
            ("G2 count", TK.LIBRARY, "group_kernelILi%dELb1ELb0ELb1E"),
            ("G3 flags", SK.LIBRARY, "group_flags_kernelILi%dELb1EE"),
            ("G4 count", SK.LIBRARY, "group_gathered_kernelILi%dELb1ELb0EE"),
            ("G4 extract", SK.LIBRARY,
             "group_gathered_kernelILi%dELb1ELb1EE")):
        growth, _ = step_issue(sass_of[lib.stem], kernel, 32, 64)
        loop = word_loop(sass_of[lib.stem], kernel % 32)
        steps = round(loop.get("LDS", 0) / (2 * 32))
        whole = sum(loop.values()) / (steps * 32)
        shfl = loop.get("SHFL", 0) / steps
        report["sass"][f"{name} limb groups"] = dict(
            per_limb_byte=growth, per_limb_byte_with_byte_work=whole,
            shuffles_per_byte=shfl, loop=loop)
        log(f"[sass] {name}, limb groups ({kernel % 32}): {growth:.3f} "
            f"instructions per limb and byte step (KR=32 -> 64), {whole:.3f} "
            f"with the per-byte work spread over a lane's 32 limbs; "
            f"{shfl:.2f} SHFL per byte step")

    errs = {k: 0 for k in KERNELS}
    launches = {k: 0 for k in KERNELS}
    # W1 and W2 each have two instances, the table in shared memory or
    # read through the read-only path, chosen by its size; each instance
    # keeps its own launches and error. A call walks one automaton, so
    # all its W launches take one instance, the one of the last launch.
    walk_insts = {(k, sh): dict(launches=0, err=0)
                  for k in ("W1", "W2") for sh in (False, True)}

    def walk_inst(k):
        return walk_insts[k, (WK.walk_shape if k == "W1"
                              else WK.count_shape)[4]]

    def counts():
        return dict(G1=TK.generic_launches, G2=TK.baked_launches,
                    G3=SK.flags_launches, G4=SK.gathered_launches,
                    G5=FK.generic_launches, G6=FK.baked_launches,
                    S1=CK.select_launches, S2=CK.verify_launches,
                    S3=CK.probe_launches, S4=CK.long_launches,
                    W1=WK.walk_launches, W2=WK.count_launches)

    plain_walks = {"walk_states_plain": 0, "walk_count_plain": 0}

    def drive(fn, expect):
        """Run one main-path facade call with every launch count set to 0
        just before it and read just after; the counts are kept. Raises
        unless exactly the kernels in ``expect`` were launched, or where
        the call ran a plain version of the walk (the wrappers' CPU
        path)."""
        TK.reset_counts()
        SK.reset_counts()
        FK.reset_counts()
        CK.reset_counts()
        WK.reset_counts()
        real_plain = {k: getattr(WK, k) for k in plain_walks}

        def plain_spy(k):
            def call(*a):
                plain_walks[k] += 1
                return real_plain[k](*a)
            return call
        for k in plain_walks:
            plain_walks[k] = 0
            setattr(WK, k, plain_spy(k))
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            for k, f in real_plain.items():
                setattr(WK, k, f)
        if any(plain_walks.values()):
            raise AssertionError(f"the call ran a plain walk: {plain_walks}")
        got = counts()
        for k, v in got.items():
            launches[k] += v
            if k in ("W1", "W2") and v:
                walk_inst(k)["launches"] += v
        ran = {k for k, v in got.items() if v}
        if ran != set(expect):
            raise AssertionError(f"launched {got}, expected {expect}")
        return out, got

    def check(name, got, want):
        """A count or a list of triples against host truth."""
        if got != want:
            size = len if isinstance(want, list) else int
            raise AssertionError(f"{name}: {size(got)} vs host truth "
                                 f"{size(want)}")

    def flat(x):
        """A kernel's outputs as a flat tuple (S3 nests its LONG part)."""
        if not isinstance(x, tuple):
            return (x,)
        return tuple(y for z in x for y in flat(z))

    def err(k, got, want):
        g, w = flat(got), flat(want)
        if len(g) != len(w) or any((a is None) != (b is None)
                                   for a, b in zip(g, w)):
            raise AssertionError(f"{k}: outputs differ in kind from the "
                                 f"plain version's")
        e = max_abs_err(g, w)
        errs[k] = max(errs[k], e)
        if k in ("W1", "W2"):
            walk_inst(k)["err"] = max(walk_inst(k)["err"], e)

    # Each kernel's wrapper (module, name) and its plain version, which
    # takes the wrapper's own arguments.
    wrappers = {
        "G1": (TK, "bitap_scan_generic", TK.bitap_scan_generic_plain),
        "G2": (TK, "bitap_scan_baked", TK.bitap_scan_baked_plain),
        "G3": (SK, "staged_flags", SK.staged_flags_plain),
        "G4": (SK, "staged_gathered", SK.staged_gathered_plain),
        "G5": (FK, "fp_bitmap_generic",
               lambda *a: FK.fp_bitmap_plain(*a[:6], tuple(a[6:]))),
        "G6": (FK, "fp_bitmap_baked",
               lambda *a: FK.fp_bitmap_plain(*a, None)),
        "S1": (CK, "cand_select", CK.cand_select_plain),
        "S2": (CK, "fp_verify", CK.fp_verify_plain),
        "S3": (CK, "cascade_probe", CK.cascade_probe_plain),
        "S4": (CK, "cascade_long_verify", CK.cascade_long_verify_plain),
        "W1": (WK, "walk_states", lambda *a: WK.walk_states_plain(*a[:7])),
        "W2": (WK, "walk_count", lambda *a: WK.walk_count_plain(*a[:10])),
    }

    def drive_held(fn, expect, only=None):
        """drive(fn, expect) with the arguments of every wrapper call
        recorded; then, per kernel (of ``only`` where given), some of its
        launches run again through the wrapper and its plain version on
        the same inputs, outside the counted run: for G1-G6 the second and
        the last (on a mesh of four, shard 1 and the last shard), for
        S1-S4 the first as well, so every S launch of a call that makes at
        most three (and the first pass's, at the smallest caps). Returns
        drive's result and the launches held per kernel."""
        seen = {k: [] for k in wrappers}
        real = {k: getattr(m, name) for k, (m, name, _) in wrappers.items()}

        def spy(k):
            def call(*a):
                seen[k].append(a)
                return real[k](*a)
            return call
        for k, (m, name, _) in wrappers.items():
            setattr(m, name, spy(k))
        try:
            out = drive(fn, expect)
        finally:
            for k, (m, name, _) in wrappers.items():
                setattr(m, name, real[k])
        held = {}
        for k, args in seen.items():
            if only is not None and k not in only:
                continue
            picks = (0, 1, -1) if k.startswith("S") else (1, -1)
            at = sorted({j % len(args) for j in picks}) if args else []
            for j in at:
                err(k, real[k](*args[j]), wrappers[k][2](*args[j]))
            if at:
                held[k] = at
        return out, held

    def cascade_stages(pats):
        """The candidate stages of a cascade pass over ``pats``: S4 runs
        where a main pattern is longer than the exact keys (LONG)."""
        return ("S1", "S3") + (("S4",) if any(
            CK.KEY_LEN < len(p) <= TC.W_CASCADE for p in pats) else ())

    triples = lambda it: [m.astuple() for m in it]  # noqa: E731
    names = [p.decode() for p in NAMES]
    ac = AhoCorasick(names, device=dev)
    ac_bitap = AhoCorasick(names, device=dev, engine="bitap")
    eng = ac._bitap_engine()
    lo, hi, sm, em = eng._args()

    # 3. Staged count, 64 MiB ---------------------------------------------------
    t0 = time.time()
    hay64 = english(64 * MIB, rng)
    truth64 = host_pairs(NAMES, hay64)
    got, c = drive(lambda: ac.count_matches(hay64), ["G3", "G4"])
    check("staged count 64 MiB", got, len(truth64))
    st = ac._staged
    sph = st.prepare(hay64)
    (flo, fhi, fsm, fem), (slo, shi, ssm, sem) = st._args()
    fargs = (flo, fhi, fsm, fem, sph.rows, st.halo)
    err("G3", SK.staged_flags(*fargs), SK.staged_flags_plain(*fargs))
    ns = sph.tiles * 1024
    cap64 = max(1024, TB._pow2(ns // 8))
    ncand64, cand64 = st.candidates(sph, cap64)
    assert ncand64 <= cap64, (ncand64, cap64)
    sid64 = cand64.to(torch.int32).reshape(-1, 8, 128)
    gargs = lambda ex: (slo, shi, ssm, sem, st.full.end_limbs,  # noqa: E731
                        sid64, sph.rows, st.halo, 0, sph.n, ex)
    for ex in (False, True):
        err("G4", SK.staged_gathered(*gargs(ex)),
            SK.staged_gathered_plain(*gargs(ex)))
    assert SK.flags_plan[1] > 1 and SK.gathered_plan[1] > 1, (
        SK.flags_plan, SK.gathered_plan)
    log(f"[staged count] 64 MiB: {got} matches = host truth; launches "
        f"G3 {c['G3']} G4 {c['G4']}; Kf={st.fp.k} K={st.full.k}, "
        f"{ns} streams of {sph.L} B, {ncand64} candidates in cap {cap64}; "
        f"G3 flags (P={SK.flags_plan[1]}) and G4 counts/words "
        f"(P={SK.gathered_plan[1]}) = plain ({time.time() - t0:.1f} s)")

    # 4. G2: 2 MiB count, single-pass extraction -------------------------------
    t0 = time.time()
    hay2 = hay64[:2 * MIB]
    got, _ = drive(lambda: ac.count_matches(hay2), ["G2"])
    check("G2 count 2 MiB", got, len(host_pairs(NAMES, hay2)))
    ph2 = eng.prepare(hay2)
    a2 = lambda ex: (lo, hi, sm, em, eng.tables.end_limbs,  # noqa: E731
                     ph2.halo_a, ph2.body, ex)
    err("G2", TK.bitap_scan_baked(*a2(False)),
        TK.bitap_scan_baked_plain(*a2(False)))
    hay16 = hay64[:16 * MIB]
    truth16 = host_pairs(NAMES, hay16)
    want_ov16 = overlapping_order(NAMES, truth16)
    want_it16 = standard_nonoverlapping(NAMES, truth16)
    # Two 8 MiB chunks on G2; the chunk loop re-splits the overlapped
    # second chunk, as the JAX package does, leaving a short tail for G1.
    got, c = drive(lambda: triples(ac_bitap.find_overlapping_iter(hay16)),
                   ["G1", "G2"])
    check("G2 single-pass extract 16 MiB", got, want_ov16)
    chunk = eng.prepare(hay16[:TB.MAX_EXTRACT_CHUNK])
    ax = lambda ex: (lo, hi, sm, em, eng.tables.end_limbs,  # noqa: E731
                     chunk.halo_a, chunk.body, ex)
    err("G2", TK.bitap_scan_baked(*ax(True)), TK.bitap_scan_baked_plain(
        *ax(True)))
    log(f"[G2] 2 MiB count = host truth; single-pass extract 16 MiB "
        f"(engine='bitap'): {len(got)} overlapping = host truth, launches "
        f"G2 {c['G2']} G1 {c['G1']}; kernel = plain (count, extract) "
        f"({time.time() - t0:.1f} s)")

    # 5. G1 ------------------------------------------------------------------------
    t0 = time.time()
    hay_h = hay64[:HEADLINE_N]
    truth_h = host_pairs(NAMES, hay_h)
    got, _ = drive(lambda: ac.count_matches(hay_h), ["G1"])
    check("G1 count 594,915 B", got, len(truth_h))
    got, _ = drive(lambda: triples(ac_bitap.find_iter(hay_h)), ["G1"])
    check("G1 find_iter 594,915 B", got,
          standard_nonoverlapping(NAMES, truth_h))
    ph_h = eng.prepare(hay_h)
    hx = lambda ex: (lo, hi, sm, em, ph_h.halo_a, ph_h.body,  # noqa: E731
                     0, HEADLINE_N, ex)
    for ex in (False, True):
        err("G1", TK.bitap_scan_generic(*hx(ex)),
            TK.bitap_scan_generic_plain(*hx(ex)))
    # The count window [0, 594,915) ends inside a segment of its stream.
    _, _, Ls_h, _ = TK.generic_plan
    assert (HEADLINE_N % ph_h.L) % Ls_h, (ph_h.L, Ls_h)

    nopad = [bytes(range(8 * i, 8 * i + 8)) for i in range(32)]
    ac_np = AhoCorasick(nopad, device=dev)
    eng_np = ac_np._bitap_engine()
    assert eng_np.tables.pad_byte is None
    hay_np = random_with(nopad, 64 * MIB, 20_000, rng)
    got, _ = drive(lambda: ac_np.count_matches(hay_np), ["G1"])
    n_np = len(host_pairs(nopad, hay_np))
    check("G1 no-pad count 64 MiB", got, n_np)
    ph_np = eng_np.prepare(hay_np)
    a_np = eng_np._args() + (ph_np.halo_a, ph_np.body, 0, len(hay_np), False)
    err("G1", TK.bitap_scan_generic(*a_np), TK.bitap_scan_generic_plain(
        *a_np))

    k229 = [bytes([i]) + b"ab" for i in range(256)]
    ac_k = AhoCorasick(k229, device=dev)
    eng_k = ac_k._bitap_engine()
    assert eng_k.tables.k == 229
    hay_k = random_with(k229, 1 * MIB, 3000, rng)
    got, _ = drive(lambda: ac_k.count_matches(hay_k), ["G1"])
    check("G1 K=229 count", got, len(host_pairs(k229, hay_k)))
    ph_k = eng_k.prepare(hay_k)  # the layout the facade launched
    for ex in (False, True):
        a = eng_k._args() + (ph_k.halo_a, ph_k.body, 0, len(hay_k), ex)
        err("G1", TK.bitap_scan_generic(*a), TK.bitap_scan_generic_plain(*a))
    _, P_k, _, G_k = TK.generic_plan
    assert P_k > 1 and G_k == 8
    log(f"[G1] 594,915 B count and single-pass find_iter (window ending "
        f"{(HEADLINE_N % ph_h.L) % Ls_h} B into a {Ls_h}-byte segment), "
        f"64 MiB no pad byte K={eng_np.tables.k}, K=229 at 1 MiB (limb "
        f"groups of {G_k} lanes, P={P_k}): all = host truth; kernel = plain "
        f"({time.time() - t0:.1f} s)")

    # 5b. Limb groups: G1/G2 beyond 64 limbs ----------------------------
    # The facade's own launches at K = 103 (64 MiB count, G2; 2 MiB
    # extraction with engine="bitap", G2), 229 (64 MiB count, no pad byte,
    # G1), 461 (4 MiB count, G2) and 1,121 (4 MiB count, G1), each against
    # host truth; then every LIMB_ROWS launch against its plain version at
    # the layout the facade gave it, with the facade's plan where the row is
    # one of its launches, the 64 MiB counts included (the plain version
    # steps over every stream at once: its time goes with the stream
    # length, not with the haystack's).
    t0 = time.time()
    lsets = limb_sets()
    layouts = limb_layouts(TB, dev, args.seed)
    facade_limbs = (
        ("count 64 MiB", 103, 64 * MIB, "G2", False),
        ("count 64 MiB, no pad byte", 229, 64 * MIB, "G1", False),
        ("find_overlapping_iter 2 MiB, engine='bitap'", 103, 2 * MIB, "G2",
         True),
        ("count 4 MiB", 461, 4 * MIB, "G2", False),
        ("count 4 MiB, no pad byte", 1121, 4 * MIB, "G1", False),
    )
    counts_of, facade_plans = {}, {}
    for what, K, n, kernel, extract in facade_limbs:
        pats = lsets[K]
        _, _, hay = layouts[K, n, kernel]
        truth = host_pairs(pats, hay)
        counts_of[K, n] = len(truth)
        if extract:
            acl = AhoCorasick(pats, device=dev, engine="bitap")
            got, c = drive(lambda: triples(acl.find_overlapping_iter(hay)),
                           [kernel])
            check(f"K={K} {what}", got, overlapping_order(pats, truth))
            got = len(got)
        else:
            acl = AhoCorasick(pats, device=dev)
            assert acl._staged_engine(n) is None
            got, c = drive(lambda: acl.count_matches(hay), [kernel])
            check(f"K={K} {what}", got, len(truth))
        plan = TK.generic_plan if kernel == "G1" else TK.baked_plan
        assert c[kernel] == 1 and plan[3] == TK.limb_group(K)[0], (c, plan)
        facade_plans[K, n, kernel] = plan
        log(f"[limbs] K={K} {what}: {got} matches = host truth; one {kernel} "
            f"launch, {plan[0]} threads, P={plan[1]} x Ls={plan[2]} B, "
            f"G={plan[3]}")
    for name, K, n, kernel, extract in LIMB_ROWS:
        err(kernel, *limb_against_plain(TK, layouts[K, n, kernel], kernel,
                                        extract))
        plan = TK.generic_plan if kernel == "G1" else TK.baked_plan
        assert plan == facade_plans.get((K, n, kernel), plan), (
            plan, facade_plans[K, n, kernel])
        where = ("the facade's launch" if (K, n, kernel) in facade_plans
                 else "the facade's layout")
        log(f"[limbs] {name}: kernel = plain ({where}); {plan[0]} threads, "
            f"P={plan[1]} x Ls={plan[2]} B, G={plan[3]}")
    log(f"[limbs] every launch at K > 64 = host truth and plain "
        f"({time.time() - t0:.1f} s)")
    # The 64 MiB count of the 128-word set, timed end to end (section 15).
    ac_k103 = AhoCorasick(lsets[103], device=dev)
    eng_k103 = ac_k103._bitap_engine()
    _, _, hay_k103 = layouts[103, 64 * MIB, "G2"]
    n_k103 = counts_of[103, 64 * MIB]

    # 6. Fingerprint fused extract of the five names ----------------------------
    t0 = time.time()
    (got, c), h6 = drive_held(
        lambda: triples(ac.find_overlapping_iter(hay16)),
        ("G6",) + FP_STAGES, only=FP_STAGES)
    check("fingerprint find_overlapping_iter 16 MiB", got, want_ov16)
    (got_it, _), h6i = drive_held(lambda: triples(ac.find_iter(hay16)),
                                  ("G6",) + FP_STAGES, only=FP_STAGES)
    check("fingerprint find_iter 16 MiB", got_it, want_it16)
    fp = ac._fp
    assert fp.dv is not None
    ph16 = fp.prepare(hay16)
    assert ph16.baked and ph16.u8f is not None
    f16 = fp._args() + (ph16.halo_a, ph16.body)
    err("G6", FK.fp_bitmap_baked(*f16), FK.fp_bitmap_plain(*f16, None))
    (got_h, c5), h5 = drive_held(lambda: triples(ac.find_iter(hay_h)),
                                 ("G5",) + FP_STAGES, only=FP_STAGES)
    check("fingerprint find_iter 594,915 B", got_h,
          standard_nonoverlapping(NAMES, truth_h))
    phh = fp.prepare(hay_h)
    assert not phh.baked and phh.u8f is not None
    fh = fp._args() + (phh.halo_a, phh.body)
    err("G5", FK.fp_bitmap_generic(*fh, 0, HEADLINE_N),
        FK.fp_bitmap_plain(*fh, (0, HEADLINE_N)))
    log(f"[fingerprint] five names, K={fp.tables.k}, W={fp.dv.W}: 16 MiB "
        f"{len(got)} overlapping, {len(got_it)} find_iter (G6 {c['G6']} "
        f"S1 {c['S1']} S2 {c['S2']} launches, caps {fp.last_caps}); "
        f"594,915 B {len(got_h)} find_iter (G5 {c5['G5']} S1 {c5['S1']} S2 "
        f"{c5['S2']}); all = host truth; bitmaps = plain; S1/S2 = plain at "
        f"launches {h6}, {h6i}, {h5} ({time.time() - t0:.1f} s)")

    # 7. Staged extract with a pattern beyond the device-verify window ----------
    t0 = time.time()
    pats7 = NAMES + [LONG]
    ac7 = AhoCorasick([p.decode() for p in pats7], device=dev)
    buf = bytearray(hay16)
    for at in rng.choice(len(buf) - 200, 500, replace=False):
        buf[at:at + len(LONG)] = LONG
    hay7 = bytes(buf)
    truth7 = host_pairs(pats7, hay7)
    got, c = drive(lambda: triples(ac7.find_overlapping_iter(hay7)),
                   ["G3", "G4"])
    check("staged extract 16 MiB", got, overlapping_order(pats7, truth7))
    assert ac7._fp is not None and ac7._fp.dv is None
    st7 = ac7._staged
    ph7 = st7.prepare(hay7)
    ncand7, cand7 = st7.candidates(ph7, st7._cap_s)
    sid7 = cand7.to(torch.int32).reshape(-1, 8, 128)
    _, (l7, h7, s7, e7) = st7._args()
    g7 = (l7, h7, s7, e7, st7.full.end_limbs, sid7, ph7.rows, st7.halo, 0,
          ph7.n, True)
    err("G4", SK.staged_gathered(*g7), SK.staged_gathered_plain(*g7))
    assert SK.gathered_plan[1] > 1, SK.gathered_plan
    log(f"[staged extract] 16 MiB, 5 names + a {len(LONG)}-byte pattern: "
        f"{len(got)} overlapping = host truth; launches G3 {c['G3']} G4 "
        f"{c['G4']}; {ncand7} candidates in cap {st7._cap_s}; G4 words = "
        f"plain (P={SK.gathered_plan[1]}, H={st7.halo}) "
        f"({time.time() - t0:.1f} s)")

    # 7b. The staged route beyond 64 limbs: 100 words ---------------------
    # The facade's count of 100 random words of 8-16 bytes over 64 MiB of
    # prose (staged: G3 at Kf = 75 over every row, G4 at K = 83 over the
    # candidates' rows, both in limb groups of 4 lanes) and its
    # find_overlapping_iter with LONG over 16 MiB (staged extract: G4 at
    # K = 85, Ke = 83, halo 128), each against host truth; every launch
    # of both calls held against its plain version on the call's own
    # inputs, at full size.
    t0 = time.time()
    ssets = staged_sets()
    slayouts = staged_layouts(TS, dev, args.seed)
    w100, w100_long = ssets["w100"], ssets["w100_long"]
    hay_w100 = slayouts["count"][3]
    n_w100 = len(host_pairs(w100, hay_w100))
    ac_w100 = AhoCorasick(w100, device=dev)
    all_launches = tuple(range(16))
    (got, c), held = drive_held(lambda: ac_w100.count_matches(hay_w100),
                                ["G3", "G4"], all_launches)
    check("100 words staged count 64 MiB", got, n_w100)
    w_plans = (SK.flags_plan, SK.gathered_plan)
    st_w100 = ac_w100._staged
    assert (st_w100.fp.k, st_w100.full.k) == (75, 83), (st_w100.fp.k,
                                                        st_w100.full.k)
    # G3 runs once per candidate cap the count tries: the first cap is an
    # eighth of the streams, and more flagged streams than that grow it.
    assert c["G3"] >= 1 and c["G4"] == 1, c
    assert w_plans[0][3] == w_plans[1][3] == 4, w_plans
    log(f"[staged groups] 100 words count 64 MiB: {got} matches = host "
        f"truth; launches G3 {c['G3']} G4 {c['G4']} (cap "
        f"{slayouts['count'][2].numel()}); Kf={st_w100.fp.k} "
        f"K={st_w100.full.k}; G3 {w_plans[0][0]} threads, P={w_plans[0][1]} x "
        f"Ls={w_plans[0][2]} B, G={w_plans[0][3]}; G4 {w_plans[1][0]} "
        f"threads, P={w_plans[1][1]} x Ls={w_plans[1][2]} B, "
        f"G={w_plans[1][3]}; kernel = plain at launches {held}")
    hay_wl = slayouts["extract"][3]
    truth_wl = overlapping_order(w100_long, host_pairs(w100_long, hay_wl))
    ac_wl = AhoCorasick(w100_long, device=dev)
    (got, c), held = drive_held(
        lambda: triples(ac_wl.find_overlapping_iter(hay_wl)), ["G3", "G4"],
        all_launches)
    check("100 words + LONG staged extract 16 MiB", got, truth_wl)
    assert ac_wl._fp is not None and ac_wl._fp.dv is None
    st_wl = ac_wl._staged
    assert (st_wl.full.k, len(st_wl.full.end_limbs), st_wl.halo) == (
        85, 83, 128), (st_wl.full.k, st_wl.halo)
    wl_plan = SK.gathered_plan
    assert wl_plan[3] == 4, wl_plan
    log(f"[staged groups] 100 words + LONG find_overlapping_iter 16 MiB: "
        f"{len(got)} overlapping = host truth; launches G3 {c['G3']} G4 "
        f"{c['G4']}; K={st_wl.full.k} Ke={len(st_wl.full.end_limbs)} "
        f"H={st_wl.halo}; G4 {wl_plan[0]} threads, P={wl_plan[1]} x "
        f"Ls={wl_plan[2]} B, G={wl_plan[3]}; kernel = plain at launches "
        f"{held} ({time.time() - t0:.1f} s)")

    # 8. dict1k ----------------------------------------------------------------------
    t0 = time.time()
    dict1k = build_dictionary()
    hay_d = build_dict_text(64 * MIB, dict1k)
    ac_d = AhoCorasick(dict1k, ascii_case_insensitive=True, device=dev)
    # Host truth: the native C++ DFA walk (no device engine below the
    # threshold).
    native = AhoCorasick(dict1k, ascii_case_insensitive=True, device="cpu",
                         device_threshold=1 << 62)
    t1 = time.time()
    truth_d = triples(native.find_overlapping_iter(hay_d))
    native_s = time.time() - t1
    assert native.count_matches(hay_d) == len(truth_d)
    assert ac_d._bitap_engine() is None
    (got, cd), hd = drive_held(lambda: ac_d.count_matches(hay_d),
                               ("G6",) + FP_STAGES, only=FP_STAGES)
    check("dict1k count 64 MiB", got, len(truth_d))
    (got_d, _), hdx = drive_held(
        lambda: triples(ac_d.find_overlapping_iter(hay_d)),
        ("G6",) + FP_STAGES, only=FP_STAGES)
    check("dict1k find_overlapping_iter 64 MiB", got_d, truth_d)
    fpd = ac_d._fp
    phd = fpd.prepare(hay_d)
    fd = fpd._args() + (phd.halo_a, phd.body)
    err("G6", FK.fp_bitmap_baked(*fd), FK.fp_bitmap_plain(*fd, None))
    hay_d5 = hay_d[:512 * 1024]
    (got, _), hd5 = drive_held(lambda: ac_d.count_matches(hay_d5),
                               ("G5",) + FP_STAGES, only=FP_STAGES)
    check("dict1k count 512 KiB", got, native.count_matches(hay_d5))
    phd5 = fpd.prepare(hay_d5)
    fd5 = fpd._args() + (phd5.halo_a, phd5.body)
    err("G5", FK.fp_bitmap_generic(*fd5, 0, len(hay_d5)),
        FK.fp_bitmap_plain(*fd5, (0, len(hay_d5))))
    log(f"[dict1k] {len(dict1k)} patterns, K={fpd.tables.k} (level "
        f"{fpd.level}), W={fpd.dv.W}, L={phd.L} x {phd.tiles} tiles: 64 MiB "
        f"{len(truth_d)} matches (native walk {native_s:.1f} s) = count = "
        f"find_overlapping_iter, G6 {cd['G6']} S1 {cd['S1']} S2 {cd['S2']} "
        f"launches per call, caps {fpd.last_caps}; 512 KiB = native; "
        f"bitmaps = plain; S1/S2 = plain at launches {hd}, {hdx}, {hd5} "
        f"({time.time() - t0:.1f} s)")
    # 9. Cascade: 100,000 names through the auto facade ------------------------
    t0 = time.time()
    dict100k = build_words(CASCADE_PATTERNS, 99, NAME_SYLLABLES,
                           capitalize=0.3)
    hay_c = build_dict_text(CASCADE_N, dict100k)
    t1 = time.time()
    ac_c = AhoCorasick(dict100k, ascii_case_insensitive=True, device=dev)
    native_c = AhoCorasick(dict100k, ascii_case_insensitive=True,
                           device="cpu", device_threshold=1 << 62)
    build_s = time.time() - t1
    t1 = time.time()
    truth_c = triples(native_c.find_overlapping_iter(hay_c))
    native_c_s = time.time() - t1
    assert native_c.count_matches(hay_c) == len(truth_c)
    assert ac_c._bitap_engine() is None
    c_stages = cascade_stages(dict100k)
    first = {}

    def first_count():
        t1 = time.time()
        out = ac_c.count_matches(hay_c)
        first["s"] = time.time() - t1
        return out
    (got, cc), hc = drive_held(first_count, ("G6",) + c_stages,
                               only=c_stages)
    first_s = first["s"]
    check("dict100k count", got, len(truth_c))
    cas = ac_c._cascade
    # The facade took the cascade (it leads above CASCADE_MIN_PATTERNS):
    # the engine ran a pass and was not found hostile, and the
    # fingerprint engine it also built never verified a candidate.
    if (cas is None or cas.hostile or cas.last_caps is None
            or getattr(ac_c._fp, "last_caps", None) is not None):
        raise AssertionError("dict100k did not take the cascade engine")
    (got_c, cx), hcx = drive_held(
        lambda: triples(ac_c.find_overlapping_iter(hay_c)),
        ("G6",) + c_stages, only=c_stages)
    check("dict100k find_overlapping_iter", got_c, truth_c)
    tc = cas.tables
    ph_c = cas.prepare(hay_c)
    assert ph_c.baked
    fc = tc.device_tensors(dev)["coarse"] + (ph_c.halo_a, ph_c.body)
    err("G6", FK.fp_bitmap_baked(*fc), FK.fp_bitmap_plain(*fc, None))
    log(f"[cascade] dict100k: {len(dict100k)} case-insensitive names, "
        f"{len(hay_c)} B: {len(truth_c)} matches (native walk "
        f"{native_c_s:.1f} s) = count = find_overlapping_iter; K="
        f"{tc.coarse.k} (level {cas.level}), {tc.num_prefixes} deduped "
        f"q={tc.q} prefixes, classes {sorted(tc.classes)}, W={tc.W}, caps "
        f"(c, e, m) {cas.last_caps}; launches per call (count, extract): "
        + ", ".join(f"{k} {cc[k]} {cx[k]}" for k in ("G6",) + c_stages)
        + f"; bitmap = plain; S kernels = plain at launches {hc}, {hcx}; "
        f"searchers built in "
        f"{build_s:.1f} s, first call {first_s:.1f} s (filter engines "
        f"built) ({time.time() - t0:.1f} s)")

    # 10. The cascade's side engine, and a set with no pad byte ---------------
    t0 = time.time()
    pats_s = dict100k + [LONG]
    buf = bytearray(hay_c)
    for at in rng.choice(len(buf) - 200, 500, replace=False):
        buf[at:at + len(LONG)] = LONG
    hay_s = bytes(buf)
    del buf
    ac_s = AhoCorasick(pats_s, ascii_case_insensitive=True, device=dev)
    native_s = AhoCorasick(pats_s, ascii_case_insensitive=True,
                           device="cpu", device_threshold=1 << 62)
    truth_s = triples(native_s.find_overlapping_iter(hay_s))
    s_stages = cascade_stages(pats_s)
    (got, cs1), hs1 = drive_held(lambda: ac_s.count_matches(hay_s),
                                 ("G6", "G2") + s_stages, only=s_stages)
    check("dict100k + LONG count", got, len(truth_s))
    # The side engine's extraction runs in 8 MiB chunks (G2) whose
    # overlapped re-splits leave short tails (G1), as in the JAX package.
    (got_s, cs2), hs2 = drive_held(
        lambda: triples(ac_s.find_overlapping_iter(hay_s)),
        ("G6", "G2", "G1") + s_stages, only=s_stages)
    check("dict100k + LONG find_overlapping_iter", got_s, truth_s)
    cas_s = ac_s._cascade
    assert cas_s is not None and cas_s.side is not None
    assert cas_s.long_pids.tolist() == [len(dict100k)]
    n_long = sum(1 for t in got_s if t[0] == len(dict100k))
    assert n_long > 400, n_long

    names_n = build_words(200, 5, NAME_SYLLABLES)
    pats_n = nopad + names_n
    hay_n = random_with(pats_n, 4 * MIB, 20_000, rng)
    truth_n = host_pairs(pats_n, hay_n)
    ac_n = AhoCorasick(pats_n, engine="cascade", device=dev)
    n_stages = cascade_stages(pats_n)
    (got, cn), hn1 = drive_held(lambda: ac_n.count_matches(hay_n),
                                ("G5",) + n_stages, only=n_stages)
    check("no-pad cascade count 4 MiB", got, len(truth_n))
    (got_n, _), hn2 = drive_held(
        lambda: triples(ac_n.find_overlapping_iter(hay_n)),
        ("G5",) + n_stages, only=n_stages)
    check("no-pad cascade find_overlapping_iter 4 MiB", got_n,
          overlapping_order(pats_n, truth_n))
    cas_n = ac_n._cascade
    assert cas_n is not None and cas_n.pad_byte is None
    ph_n = cas_n.prepare(hay_n)
    assert not ph_n.baked
    fn = cas_n.tables.device_tensors(dev)["coarse"] + (ph_n.halo_a,
                                                        ph_n.body)
    err("G5", FK.fp_bitmap_generic(*fn, 0, len(hay_n)),
        FK.fp_bitmap_plain(*fn, (0, len(hay_n))))
    log(f"[cascade side] dict100k + a {len(LONG)}-byte pattern: {len(got_s)} "
        f"matches ({n_long} of it) = native; launches count G6 {cs1['G6']} "
        f"G2 {cs1['G2']}, extraction G6 {cs2['G6']} G2 {cs2['G2']} G1 "
        f"{cs2['G1']}; no pad byte, engine='cascade', {len(pats_n)} "
        f"patterns, 4 MiB: {len(got_n)} matches = host truth, K="
        f"{cas_n.tables.coarse.k}, G5 {cn['G5']} launch, bitmap = plain; "
        f"S kernels = plain at launches {hs1}, {hs2}, {hn1}, {hn2} "
        f"({time.time() - t0:.1f} s)")

    # 11. The blocked device DFA walk, and device-only ------------------------
    t0 = time.time()
    # Every W launch of these calls is held against its plain version on
    # its own inputs (one launch a call); drive raises where a call ran
    # the plain walk itself.
    ac_w = AhoCorasick(dict1k, ascii_case_insensitive=True, device=dev,
                       engine="dfa-scan")
    (got, cw), hw = drive_held(lambda: ac_w.count_matches(hay_d), ("W2",),
                               only=("W2",))
    check("dfa-scan count 64 MiB", got, len(truth_d))
    walk_plan_d = WK.count_shape
    (got_w, cwx), hwx = drive_held(
        lambda: triples(ac_w.find_overlapping_iter(hay_d)), ("W1",),
        only=("W1",))
    check("dfa-scan find_overlapping_iter 64 MiB", got_w, truth_d)
    walk = ac_w._dev_automaton
    assert walk is not None
    _, _, walk_L, walk_H = walk._prepare(b"x" * len(hay_d))
    ac_w5 = AhoCorasick(names, device=dev, engine="dfa-scan")
    (got, cw5), hw5 = drive_held(lambda: ac_w5.count_matches(hay64),
                                 ("W2",), only=("W2",))
    check("dfa-scan count, five names, 64 MiB", got, len(truth64))
    walk5 = ac_w5._dev_automaton
    walk_plan_5 = WK.count_shape
    if not walk_plan_5[4]:
        raise AssertionError(f"the five names' table "
                             f"({walk5.trans_flat.numel() * 4} B) was not "
                             f"in shared memory: {walk_plan_5}")
    for name, c in (("dict1k count", cw), ("dict1k find_overlapping_iter",
                                           cwx), ("five names count", cw5)):
        log(f"[device walk] {name}: launches " + ", ".join(
            f"{k} {v}" for k, v in c.items() if v) + ", plain walks "
            f"{sum(plain_walks.values())}")
    # A halo longer than a block (a 200-byte pattern, 128-byte blocks) on
    # a haystack that fills its bucket: the first blocks' halo steps
    # before the buffer's start are skipped, not wrapped onto its tail.
    long_h, hay_h = [b"a" * 200, b"ab"], b"a" * (128 << 10)
    ac_h = AhoCorasick(long_h, device=dev, engine="dfa-scan")
    truth_h = triples(AhoCorasick(long_h, device="cpu",
                                  device_threshold=1 << 62)
                      .find_overlapping_iter(hay_h))
    (got, _), hh1 = drive_held(lambda: ac_h.count_matches(hay_h), ("W2",),
                               only=("W2",))
    check("dfa-scan count, halo > block", got, len(truth_h))
    walk_plan_h = WK.count_shape
    (got, _), hh2 = drive_held(
        lambda: triples(ac_h.find_overlapping_iter(hay_h)), ("W1",),
        only=("W1",))
    check("dfa-scan find_overlapping_iter, halo > block", got, truth_h)
    _, _, hl, hh = ac_h._dev_automaton._prepare(hay_h)
    assert hh > hl and len(truth_h) == len(hay_h) - 199
    ac_o = AhoCorasick(dict1k, ascii_case_insensitive=True, device=dev,
                       engine="device-only")
    (got, _), ho1 = drive_held(lambda: ac_o.count_matches(hay_d),
                               ("G6",) + FP_STAGES, only=FP_STAGES)
    check("device-only count 64 MiB", got, len(truth_d))
    (got_o, _), ho2 = drive_held(
        lambda: triples(ac_o.find_overlapping_iter(hay_d)),
        ("G6",) + FP_STAGES, only=FP_STAGES)
    check("device-only find_overlapping_iter 64 MiB", got_o, truth_d)
    assert ac_o._fp is not None and ac_o._dev_automaton is None
    log(f"[device walk] dict1k engine='dfa-scan', {len(hay_d)} B: count (W2) "
        f"and find_overlapping_iter (W1) = native ({walk.num_states} states "
        f"x {walk.alphabet_len} classes, JAX layout blocks of {walk_L} B + a "
        f"{walk_H}-B halo; kernel plan (bytes, threads, sub-block, halo, "
        f"table in shared memory) {walk_plan_d}); five names over "
        f"{len(hay64)} B (W2, {walk5.num_states} states x "
        f"{walk5.alphabet_len} classes, plan {walk_plan_5}) = truth; "
        f"{len(hay_h)} B of b'a' against a 200-byte pattern (blocks of {hl} "
        f"B + a {hh}-B halo, plan {walk_plan_h}): {len(truth_h)} matches = "
        f"native; W = plain at launches {hw}, {hwx}, {hw5}, {hh1}, {hh2}; "
        f"engine='device-only': the fingerprint engine (G6, S1, S2) = "
        f"native, S1/S2 = plain at launches {ho1}, {ho2} "
        f"({time.time() - t0:.1f} s)")

    # 12. The packed searcher --------------------------------------------------
    t0 = time.time()
    want_lf16 = leftmost_first(truth16)
    ac_lf = AhoCorasick(names, match_kind=MatchKind.LEFTMOST_FIRST,
                        device=dev)
    check("facade leftmost-first 16 MiB", triples(ac_lf.find_iter(hay16)),
          want_lf16)
    packed = Searcher.new(NAMES)
    assert packed.device == dev and packed._bitap is not None
    # Two 8 MiB chunks on G2 and the re-split tail on G1, as in phase 4.
    (got, cp1), h1 = drive_held(lambda: triples(packed.find_iter(hay16)),
                                ["G1", "G2"])
    check("packed find_iter 16 MiB", got, want_lf16)
    names128 = [a + b" " + b for a, b in zip(dict1k[:128], dict1k[128:256])]
    assert sum(len(p) for p in names128) > 2048
    hay128 = build_dict_text(16 * MIB, names128, seed=8)
    want128 = leftmost_first(host_pairs(names128, hay128))
    packed128 = Searcher.new(names128)
    assert packed128._bitap is None
    (got, cp2), h2 = drive_held(
        lambda: triples(packed128.find_iter(hay128)), ("G6",) + FP_STAGES)
    check("packed find_iter 128 names 16 MiB", got, want128)
    assert packed128._fp.dv is not None and not packed128._fp.hostile
    check("facade leftmost-first 128 names 16 MiB", triples(AhoCorasick(
        names128, match_kind=MatchKind.LEFTMOST_FIRST,
        device=dev).find_iter(hay128)), want128)
    teddy = PackedConfig().only_teddy(True).builder().extend(NAMES).build()
    got, _ = drive(lambda: triples(teddy.find_iter(hay16)), [])
    check("packed only_teddy find_iter 16 MiB", got, want_lf16)
    log(f"[packed] five names 16 MiB: {len(want_lf16)} leftmost-first = "
        f"facade = host truth, launches G2 {cp1['G2']} G1 {cp1['G1']}; "
        f"{len(names128)} names of {sum(len(p) for p in names128)} B "
        f"(fingerprint engine, K={packed128._fp.tables.k}) 16 MiB: "
        f"{len(want128)} = facade = host truth, G6 {cp2['G6']} S1 "
        f"{cp2['S1']} S2 {cp2['S2']} launches; "
        f"kernel = plain at these inputs (launches held: {h1}, {h2}); "
        f"only_teddy 16 MiB (fingerprint in torch on the card, host "
        f"verify): = host truth ({time.time() - t0:.1f} s)")
    packed_ms = {
        name: float(np.median([host_ms(lambda: list(fn())) for _ in
                               range(3)]))
        for name, fn in (
            ("Searcher.new(five names).find_iter 16 MiB (G2, G1)",
             lambda: packed.find_iter(hay16)),
            ("facade leftmost-first find_iter, same input",
             lambda: ac_lf.find_iter(hay16)),
            ("Searcher.new(128 names).find_iter 16 MiB (G6)",
             lambda: packed128.find_iter(hay128)),
            ("only_teddy find_iter 16 MiB (torch fingerprint)",
             lambda: teddy.find_iter(hay16)))}
    report["packed_ms"] = packed_ms
    log("[packed] host clock, median of 3: " + "; ".join(
        f"{k} {v:.3f} ms" for k, v in packed_ms.items()) + f" | {card}")

    # 13. The debug CLI, in a process of its own ------------------------------
    t0 = time.time()
    cli_dir = os.path.join("chiprun_out", "cli")
    os.makedirs(cli_dir, exist_ok=True)
    try:
        dict_path = os.path.join(cli_dir, "dict1k.txt")
        with open(dict_path, "wb") as f:
            f.write(b"\n".join(dict1k) + b"\n")
        hay_path = os.path.join(cli_dir, "prose64.txt")
        with open(hay_path, "wb") as f:
            f.write(hay_d)
        hay4_path = os.path.join(cli_dir, "prose4.txt")
        with open(hay4_path, "wb") as f:
            f.write(hay_d[:4 * MIB])
        n4 = native.count_matches(hay_d[:4 * MIB])
        cli_runs = []
        for path, flags, want in (
                (hay_path, ["--count-only"], len(truth_d)),
                (hay_path, ["--overlapping"], len(truth_d)),
                (hay4_path, ["--engine", "cascade", "--count-only"], n4)):
            t1 = time.time()
            proc = subprocess.run(
                [sys.executable, "-m", "ahocorasick_tpu_torch.cli",
                 dict_path, path, "--ascii-case-insensitive",
                 "--device", str(dev), *flags],
                capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"cli {flags}: {proc.stderr[-2000:]}")
            check(f"cli {' '.join(flags)}", int(proc.stdout), want)
            search = [ln for ln in proc.stderr.splitlines()
                      if ln.startswith("search time")]
            cli_runs.append(f"{' '.join(flags)} = {want} ({search[0]}, "
                            f"process {time.time() - t1:.1f} s)")
    finally:
        shutil.rmtree(cli_dir, ignore_errors=True)
    log("[cli] python3 -m ahocorasick_tpu_torch.cli, dict1k "
        "--ascii-case-insensitive: " + "; ".join(cli_runs)
        + f" | {card} ({time.time() - t0:.1f} s)")

    # 14. Sharded search over a mesh -------------------------------------------
    t0 = time.time()
    want_p16 = [(p, e) for p, _, e in want_ov16]
    want_pd = [(p, e) for p, _, e in truth_d]
    want_pc = [(p, e) for p, _, e in truth_c]
    reps = [b"<%d>" % i for i in range(len(NAMES))]

    def replace(fn):
        out = io.BytesIO()
        fn(out)
        return out.getvalue()
    want_rep = replace(lambda out: stream_replace_all(
        ac, io.BytesIO(hay16), out, reps, chunk_size=MIB))
    cas_caps = dict(cas._caps)
    meshes = [Mesh([torch.device(dev.type, 0)] * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    shard_rows = []
    for mi, mesh in enumerate(meshes):
        calls = [
            ("sharded_staged_count, five names, 64 MiB", ["G3", "G4"],
             lambda: sharded_staged_count(st, hay64, mesh), len(truth64),
             lambda: ac.count_matches(hay64)),
            ("sharded_bitap_count, 32 no-pad patterns, 64 MiB", ["G1"],
             lambda: sharded_bitap_count(eng_np, hay_np, mesh), n_np,
             lambda: ac_np.count_matches(hay_np)),
            ("sharded_bitap_match_pairs, five names, 16 MiB", ["G1"],
             lambda: pair_list(sharded_bitap_match_pairs(eng, hay16, mesh)),
             want_p16, lambda: eng.match_pairs(hay16)),
            ("sharded_fp_match_pairs, dict1k, 64 MiB", ["G5", "S1"],
             lambda: pair_list(sharded_fp_match_pairs(fpd, hay_d, mesh)),
             want_pd, lambda: fpd.match_pairs(hay_d)),
            ("sharded_cascade_match_pairs, dict100k, 64 MiB",
             ("G6",) + c_stages,
             lambda: pair_list(sharded_cascade_match_pairs(cas, hay_c,
                                                           mesh)),
             want_pc, lambda: cas.match_pairs(hay_c)),
            ("sharded_stream_replace_all, five names, 16 MiB in 1 MiB "
             "chunks", ["G1"],
             lambda: replace(lambda out: sharded_stream_replace_all(
                 ac, io.BytesIO(hay16), out, reps, mesh=mesh,
                 chunk_size=MIB)), want_rep,
             lambda: replace(lambda out: stream_replace_all(
                 ac, io.BytesIO(hay16), out, reps, chunk_size=MIB))),
            ("sharded_count_matches, dict1k, 64 MiB (device walk)", ["W2"],
             lambda: sharded_count_matches(walk, hay_d, mesh),
             len(truth_d), lambda: ac_w.count_matches(hay_d)),
        ]
        for name, expect, call, want, single in calls:
            (got, c), held = drive_held(call, expect)
            check(f"{name} on {mesh}", got, want)
            if mi:
                continue
            ms = float(np.median([host_ms(call) for _ in range(3)]))
            ms1 = float(np.median([host_ms(single) for _ in range(3)]))
            shard_rows.append(dict(name=name, mesh=str(mesh), ms=ms,
                                   single_device_ms=ms1, launches=c,
                                   held_against_plain=held))
            log(f"[shard] {name}, {mesh.size} x {mesh.devices[0]}: = "
                f"single device = truth; launches " + ", ".join(
                    f"{k} {v}" for k, v in c.items() if v)
                + f"; kernel = plain at launches {held}; {ms:.3f} ms (median of 3, host clock) against "
                f"{ms1:.3f} ms on one device | {card}")
    assert cas._caps == cas_caps  # the sharded calls kept their caps
    report["sharded"] = shard_rows
    log(f"[shard] meshes {', '.join(str(m) for m in meshes)}: every call = "
        f"truth ({time.time() - t0:.1f} s)")

    log("[launches] facade calls: "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + "; W by the table's place: "
        + ", ".join(f"{k} {'shared' if sh else 'device'} {v['launches']}"
                    for (k, sh), v in walk_insts.items()))
    for k in KERNELS:
        if launches[k] == 0:
            raise AssertionError(f"{k} was never launched on a facade path")
    for (k, sh), inst in walk_insts.items():
        if inst["launches"] == 0:
            raise AssertionError(f"{k} with the table in "
                                 f"{'shared' if sh else 'device'} memory "
                                 f"was never launched on a facade path")

    # 15. Timing ------------------------------------------------------------------
    def row(name, K, n, lanes, out_per_byte, kern, plain, seg, popc=True,
            extra_in=0):
        return timed_row(name, K, n, lanes, out_per_byte, kern, plain, seg,
                         sm_hz, card, popc, extra_in)

    K3, Ke = eng.tables.k, len(eng.tables.end_limbs)
    L64 = sph.L
    # The single-pass G2 layout of the 64 MiB count, which the staged
    # route (G3, G4) now serves: timed beside it for comparison.
    ph64 = eng.prepare(hay64)
    a64 = (lo, hi, sm, em, eng.tables.end_limbs, ph64.halo_a, ph64.body,
           False)
    err("G2", TK.bitap_scan_baked(*a64), TK.bitap_scan_baked_plain(*a64))
    g1, g2 = (lambda: TK.generic_plan), (lambda: TK.baked_plan)
    g5, g6 = (lambda: FK.generic_plan), (lambda: FK.baked_plan)
    g3, g4 = (lambda: SK.flags_plan), (lambda: SK.gathered_plan)
    rows = {
        "G1": row(f"G1 count 594,915 B, K={K3}", K3, HEADLINE_N, ph_h.tiles
                  * 1024, 0, lambda: TK.bitap_scan_generic(*hx(False)),
                  lambda: TK.bitap_scan_generic_plain(*hx(False)),
                  g1),
        "G1 extract": row(f"G1 extract 594,915 B (find_iter), K={K3}", K3,
                          HEADLINE_N, ph_h.tiles * 1024, 4 * K3,
                          lambda: TK.bitap_scan_generic(*hx(True)),
                          lambda: TK.bitap_scan_generic_plain(*hx(True)),
                          g1),
        "G1 no pad": row(f"G1 count 64 MiB no pad byte, K={eng_np.tables.k}",
                         eng_np.tables.k, len(hay_np), ph_np.tiles * 1024, 0,
                         lambda: TK.bitap_scan_generic(*a_np),
                         lambda: TK.bitap_scan_generic_plain(*a_np),
                         g1),
        "G2": row(f"G2 count 2 MiB, K={K3}", K3, len(hay2), ph2.tiles * 1024,
                  0, lambda: TK.bitap_scan_baked(*a2(False)),
                  lambda: TK.bitap_scan_baked_plain(*a2(False)),
                  g2),
        "G2 64 MiB": row(f"G2 count 64 MiB (PR 1's shape), K={K3}", K3,
                         len(hay64), ph64.tiles * 1024, 0,
                         lambda: TK.bitap_scan_baked(*a64),
                         lambda: TK.bitap_scan_baked_plain(*a64),
                         g2),
        "G2 extract": row(f"G2 extract 8 MiB chunk, Ke={Ke}", K3,
                          chunk.n, chunk.tiles * 1024, 4 * Ke,
                          lambda: TK.bitap_scan_baked(*ax(True)),
                          lambda: TK.bitap_scan_baked_plain(*ax(True)),
                          g2),
        "G3": row(f"G3 flags 64 MiB, Kf={st.fp.k}, {ns} streams", st.fp.k,
                  sph.n, ns, 0, lambda: SK.staged_flags(*fargs),
                  lambda: SK.staged_flags_plain(*fargs), g3, popc=False),
        "G4": row(f"G4 count, {ncand64} candidates x {L64} B in {cap64} "
                  f"lanes, K={st.full.k}", st.full.k, ncand64 * L64, cap64,
                  0, lambda: SK.staged_gathered(*gargs(False)),
                  lambda: SK.staged_gathered_plain(*gargs(False)), g4,
                  extra_in=4 * cap64),
        "G4 extract": row(f"G4 extract, {ncand7} candidates x {ph7.L} B in "
                          f"{st7._cap_s} lanes, K={st7.full.k}", st7.full.k,
                          ncand7 * ph7.L, st7._cap_s,
                          4 * len(st7.full.end_limbs),
                          lambda: SK.staged_gathered(*g7),
                          lambda: SK.staged_gathered_plain(*g7), g4,
                          extra_in=4 * st7._cap_s),
        "G5": row(f"G5 bitmap 594,915 B, five names, K={fp.tables.k}",
                  fp.tables.k, HEADLINE_N, phh.tiles * 1024, 1 / 8,
                  lambda: FK.fp_bitmap_generic(*fh, 0, HEADLINE_N),
                  lambda: FK.fp_bitmap_plain(*fh, (0, HEADLINE_N)),
                  g5, popc=False),
        "G5 dict1k": row(f"G5 bitmap 512 KiB dict1k, K={fpd.tables.k}",
                         fpd.tables.k, len(hay_d5), phd5.tiles * 1024, 1 / 8,
                         lambda: FK.fp_bitmap_generic(*fd5, 0, len(hay_d5)),
                         lambda: FK.fp_bitmap_plain(*fd5, (0, len(hay_d5))),
                         g5, popc=False),
        "G6": row(f"G6 bitmap 64 MiB dict1k, K={fpd.tables.k}",
                  fpd.tables.k, len(hay_d), phd.tiles * 1024, 1 / 8,
                  lambda: FK.fp_bitmap_baked(*fd),
                  lambda: FK.fp_bitmap_plain(*fd, None),
                  g6, popc=False),
        "G6 names": row(f"G6 bitmap 16 MiB five names, K={fp.tables.k}",
                        fp.tables.k, len(hay16), ph16.tiles * 1024, 1 / 8,
                        lambda: FK.fp_bitmap_baked(*f16),
                        lambda: FK.fp_bitmap_plain(*f16, None),
                        g6, popc=False),
        "G6 dict100k": row(f"G6 bitmap 64 MiB dict100k cascade coarse, "
                           f"K={tc.coarse.k}", tc.coarse.k, len(hay_c),
                           ph_c.tiles * 1024, 1 / 8,
                           lambda: FK.fp_bitmap_baked(*fc),
                           lambda: FK.fp_bitmap_plain(*fc, None),
                           g6, popc=False),
        "G5 cascade": row(f"G5 bitmap 4 MiB no-pad cascade coarse, "
                          f"K={cas_n.tables.coarse.k}",
                          cas_n.tables.coarse.k, len(hay_n),
                          ph_n.tiles * 1024, 1 / 8,
                          lambda: FK.fp_bitmap_generic(*fn, 0, len(hay_n)),
                          lambda: FK.fp_bitmap_plain(*fn, (0, len(hay_n))),
                          g5, popc=False),
    }
    rows.update(time_limb_rows(TK, layouts, sm_hz, card, with_plain=True))
    srows = time_staged_rows(SK, slayouts, sm_hz, card, with_plain=True)
    for (name, *_), plan in zip(STAGED_ROWS, (*w_plans, wl_plan)):
        r = srows[name]
        assert (r["threads"], r["P"], r["Ls"], r["G"]) == plan, (r, plan)
    rows.update(srows)
    report["timings"] = rows
    report["launches"] = launches

    # End to end: host clock around one facade call that ends in a
    # synchronise, so packing, upload, layout, scans, compaction, verify and
    # the host-side decode all count. Median of RUNS calls; then one call
    # under the profiler for the device's busy time.
    def e2e(name, n, fn):
        ts = [host_ms(fn) for _ in range(RUNS)]
        ms = float(np.median(ts))
        call_ms, busy_ms, by, span = trace(fn)
        idle = None if busy_ms is None else 1 - busy_ms / call_ms
        idle_med = None if busy_ms is None else 1 - busy_ms / ms
        log(f"[e2e] {name}: {ms:.3f} ms ({n / ms / 1e6:.3f} GB/s of "
            f"haystack) | {card}")
        log_trace(name, call_ms, busy_ms, by, span, idle_med)
        return dict(name=name, bytes=n, ms=ms, runs_ms=ts,
                    gbps=n / ms / 1e6, traced_call_ms=call_ms,
                    device_busy_ms=busy_ms, device_idle_share=idle,
                    device_idle_share_of_median=idle_med,
                    device_ms_by_name=by, device_span_ms=span)

    report["end_to_end"] = [
        e2e("count_matches 64 MiB (staged: G3, G4)", len(hay64),
            lambda: ac.count_matches(hay64)),
        e2e("count_matches 2 MiB (G2)", len(hay2),
            lambda: ac.count_matches(hay2)),
        e2e("count_matches 594,915 B (G1)", len(hay_h),
            lambda: ac.count_matches(hay_h)),
        e2e("find_overlapping_iter 16 MiB (fingerprint: G6)", len(hay16),
            lambda: list(ac.find_overlapping_iter(hay16))),
        e2e("find_iter 594,915 B (fingerprint: G5)", len(hay_h),
            lambda: list(ac.find_iter(hay_h))),
        e2e("find_overlapping_iter 16 MiB, engine='bitap' (G2)",
            len(hay16), lambda: list(ac_bitap.find_overlapping_iter(hay16))),
        e2e("find_overlapping_iter 16 MiB + 70-byte pattern (staged: G3, "
            "G4)", len(hay7), lambda: list(ac7.find_overlapping_iter(hay7))),
        e2e("dict1k count_matches 64 MiB (fingerprint: G6)", len(hay_d),
            lambda: ac_d.count_matches(hay_d)),
        e2e("dict1k find_overlapping_iter 64 MiB (fingerprint: G6)",
            len(hay_d), lambda: list(ac_d.find_overlapping_iter(hay_d))),
        e2e("dict1k count_matches 512 KiB (fingerprint: G5)", len(hay_d5),
            lambda: ac_d.count_matches(hay_d5)),
        e2e("dict1k count_matches 64 MiB, engine='dfa-scan' (device walk: "
            "W2)", len(hay_d), lambda: ac_w.count_matches(hay_d)),
        e2e("dict1k find_overlapping_iter 64 MiB, engine='dfa-scan' (device "
            "walk: W1)", len(hay_d),
            lambda: list(ac_w.find_overlapping_iter(hay_d))),
        e2e("five names count_matches 64 MiB, engine='dfa-scan' (device "
            "walk: W2, table in shared memory)", len(hay64),
            lambda: ac_w5.count_matches(hay64)),
        e2e("dict100k count_matches 64 MiB (cascade: G6)", len(hay_c),
            lambda: ac_c.count_matches(hay_c)),
        e2e("dict100k find_overlapping_iter 64 MiB (cascade: G6)",
            len(hay_c), lambda: list(ac_c.find_overlapping_iter(hay_c))),
        e2e("dict100k + 70-byte pattern count_matches 64 MiB (cascade: G6, "
            "side G2)", len(hay_s), lambda: ac_s.count_matches(hay_s)),
        e2e("no-pad set count_matches 4 MiB, engine='cascade' (G5)",
            len(hay_n), lambda: ac_n.count_matches(hay_n)),
        e2e("128 words (K=103) count_matches 64 MiB (G2 limb groups)",
            len(hay_k103), lambda: ac_k103.count_matches(hay_k103)),
        e2e("100 words (Kf=75, K=83) count_matches 64 MiB (staged: G3, G4 "
            "limb groups)", len(hay_w100),
            lambda: ac_w100.count_matches(hay_w100)),
        e2e("100 words + LONG find_overlapping_iter 16 MiB (staged: G3, G4 "
            "limb groups)", len(hay_wl),
            lambda: list(ac_wl.find_overlapping_iter(hay_wl))),
    ]

    # The 64 MiB count of the 128-word set (K = 103), RUNS times, each run
    # beside a whole count_matches call: the host pack (BitapEngine._pack,
    # padded with the pad byte), the pageable upload, the stream-major
    # layout and G2 with the sum, each ended by a synchronise.
    wparts = {k: [] for k in ("count_matches", "sum_of_parts", "pack",
                              "upload", "layout", "G2_and_sum")}
    L_w, tiles_w = eng_k103._layout(len(hay_k103))
    for _ in range(RUNS):
        wparts["count_matches"].append(
            host_ms(lambda: ac_k103.count_matches(hay_k103)))
        t0 = time.perf_counter()
        x32 = torch.from_numpy(eng_k103._pack(
            hay_k103, L_w, tiles_w, pad=eng_k103.tables.pad_byte))
        t1 = time.perf_counter()
        xd = x32.to(dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        halo_w, body_w = TB._to_stream_major(xd, L_w, tiles_w,
                                             eng_k103.halo)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        cnt, _ = TK.bitap_scan_baked(*eng_k103._args(),
                                     eng_k103.tables.end_limbs, halo_w,
                                     body_w, False)
        assert int(cnt.sum()) == n_k103
        t4 = time.perf_counter()
        for k, a, b in (("pack", t0, t1), ("upload", t1, t2),
                        ("layout", t2, t3), ("G2_and_sum", t3, t4),
                        ("sum_of_parts", t0, t4)):
            wparts[k].append((b - a) * 1e3)
        del x32, xd, halo_w, body_w
    wmed = {k: float(np.median(v)) for k, v in wparts.items()}
    log("[e2e parts] 128 words (K=103) count_matches 64 MiB, medians of "
        f"{RUNS}: " + ", ".join(f"{k} {v:.3f} ms" for k, v in wmed.items())
        + f" | {card}")
    report["k103_count_parts"] = dict(runs_ms=wparts, median_ms=wmed)

    # The 64 MiB staged counts' steps (the five names; the 100 words,
    # whose kernels run limb groups), RUNS times, each run beside a whole
    # count_matches call: the host pack, the pageable upload (its rows are
    # what G3 and G4 read), G3 with the candidate compaction (again at a
    # larger cap where the candidates overflow the first, as the call
    # does), G4 over the candidates' rows and the sum, each ended by a
    # synchronise and read on the host clock, so the parts add up to their
    # sum.
    def staged_parts(name, acs, hay, truth):
        stp = acs._staged
        (qlo, qhi, qsm, qem), (rlo, rhi, rsm, rem) = stp._args()
        L_p, _, tiles_p = stp._layout(len(hay))
        nsp = tiles_p * 1024
        cap0 = max(1024, TB._pow2(nsp // 8))
        parts = {k: [] for k in ("count_matches", "sum_of_parts", "pack",
                                 "upload", "flags_and_select",
                                 "rescan_sum")}
        for _ in range(RUNS):
            parts["count_matches"].append(
                host_ms(lambda: acs.count_matches(hay)))
            t0 = time.perf_counter()
            buf = np.full(nsp * L_p, stp.full.pad_byte, np.uint8)
            buf[:len(hay)] = np.frombuffer(hay, np.uint8)
            x32 = torch.from_numpy(buf.view(np.int32))
            t1 = time.perf_counter()
            xd = x32.to(dev).view(nsp, L_p // 4)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            capp, tries = cap0, 0
            while True:
                fl = SK.staged_flags(qlo, qhi, qsm, qem, xd,
                                     stp.halo).reshape(-1)
                nc, widx, _, live = select_nonzero_words(fl, capp)
                tries += 1
                if nc <= capp:
                    break
                capp = max(capp * 2, TB._pow2(nc))
            cand = torch.where(live, widx, -1)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            cnt, _ = SK.staged_gathered(
                rlo, rhi, rsm, rem, stp.full.end_limbs,
                cand.to(torch.int32).reshape(-1, 8, 128), xd, stp.halo, 0,
                len(hay), False)
            assert int(cnt.sum()) == truth
            t4 = time.perf_counter()
            for k, a, b in (("pack", t0, t1), ("upload", t1, t2),
                            ("flags_and_select", t2, t3),
                            ("rescan_sum", t3, t4),
                            ("sum_of_parts", t0, t4)):
                parts[k].append((b - a) * 1e3)
            del buf, x32, xd, fl, cand
        med = {k: float(np.median(v)) for k, v in parts.items()}
        log(f"[e2e parts] {name} staged count_matches 64 MiB (G3 at {tries} "
            f"caps, the last {capp}), medians of {RUNS}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in med.items()) + f" | {card}")
        return dict(runs_ms=parts, median_ms=med, cap=capp, flag_passes=tries)

    report["staged_count_parts"] = staged_parts("five names", ac, hay64,
                                                len(truth64))
    report["w100_count_parts"] = staged_parts("100 words", ac_w100,
                                              hay_w100, n_w100)

    # The copies the staged call made before G3 and G4 read the upload's
    # rows, which the call no longer makes: the stream-major layout of the
    # rows (a roll and two transposes, the JAX package's _staged_layouts)
    # and the gather of the candidates' rows and halo rows into a
    # stream-major copy (two index_selects and two transposes), the same
    # torch operations at the same shapes, timed as the kernels are.
    def old_layout(rows, H):
        nsr, Wbr = rows.shape
        hrows = torch.roll(rows.reshape(-1), H // 4).reshape(nsr, Wbr)[
            :, :H // 4].contiguous()
        return hrows, (rows.T.reshape(Wbr, nsr // 128, 128).contiguous(),
                       hrows.T.reshape(H // 4, nsr // 128, 128).contiguous())

    def old_gather(rows, hrows, cand):
        safe, cap = cand.clamp(min=0), cand.shape[0]
        return [r.index_select(0, safe).T.reshape(-1, cap // 128, 128)
                .contiguous() for r in (rows, hrows)]
    hrows64, hrows7 = old_layout(sph.rows, st.halo)[0], old_layout(
        ph7.rows, st7.halo)[0]
    removed = {
        "layout 64 MiB": kernel_ms(lambda: old_layout(sph.rows, st.halo)),
        "gather (G4 count)": kernel_ms(
            lambda: old_gather(sph.rows, hrows64, cand64)),
        "gather (G4 extract)": kernel_ms(
            lambda: old_gather(ph7.rows, hrows7, cand7)),
    }
    del hrows64, hrows7
    log("[time] copies no longer made: " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in removed.items()) + f" | {card}")
    report["removed_copies_ms"] = removed

    # The dict100k cascade's and the dict1k fingerprint's 64 MiB count and
    # extraction, step by step, RUNS times, each run beside a whole
    # count_matches call, at the caps the facade settled: the host pack,
    # the pageable upload, the stream-major layout and the verify buffer,
    # G6, then the candidate kernels of the count (cascade: S1, S3, the
    # cumsum and S4 with the one read of the pass's scalars; fingerprint:
    # S1, S2 with the read), each ended by a synchronise; then the
    # extraction's stages over the same candidates (the S kernels in
    # extract mode with their read), its selection of the matches, and
    # the host's transfer (with the cascade's duplicate expansion) and
    # report-order lexsort.
    def pack_upload(eng, hay, L_p, tiles_p, mark):
        buf = np.full(tiles_p * TB.LANES * L_p, eng.pad_byte, np.uint8)
        buf[:len(hay)] = np.frombuffer(hay, np.uint8)
        x32 = torch.from_numpy(buf.view(np.int32))
        mark()
        x32 = x32.to(dev)
        mark()
        return x32

    def parts_log(name, parts, steps, count_steps):
        med = {k: float(np.median(v)) for k, v in parts.items()}
        log(f"[e2e parts] {name} 64 MiB, medians of {RUNS} (count: "
            f"{steps[0]} .. {count_steps[-1]}; extraction adds "
            f"{steps[len(count_steps)]} .. {steps[-1]}): " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in med.items()) + f" | {card}")
        return med

    n_c = len(hay_c)
    cap_c, cap_e, cap_m = cas.last_caps[:2] + (cas._caps["m"],)
    dvc = tc.device_tensors(dev)
    c_count = ("pack", "upload", "layout_and_verify_buffer", "G6",
               "S1_cand_select", "S3_cascade_probe",
               "S4_cumsum_long_verify_and_read")
    c_steps = c_count + ("S3_S4_extract_and_read", "select_matches",
                         "host_pairs", "lexsort")
    cparts = {k: [] for k in ("count_matches", "sum_of_count_parts")
              + c_steps}
    for _ in range(RUNS):
        cparts["count_matches"].append(
            host_ms(lambda: ac_c.count_matches(hay_c)))
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        L_c, tiles_c = cas._layout(n_c)
        x32 = pack_upload(cas, hay_c, L_c, tiles_c, mark)
        halo_c, body_c = TB._to_stream_major(x32, L_c, tiles_c, cas.halo)
        u8f = TF._verify_buffer(x32, tc.W, cas.ci)
        mark()
        _, bmp = FK.fp_bitmap_baked(*dvc["coarse"], halo_c, body_c)
        mark()
        ncand_t, e_pos, live = CK.cand_select(bmp, L_c, cap_c)
        mark()
        probe_c = (u8f, e_pos, live, n_c, dvc["classes"], tc.q, tc.W)
        _, _, _, tot3, long_c = CK.cascade_probe(*probe_c, False)
        mark()
        long_args = lambda lng, ex: (  # noqa: E731
            *lng, e_pos, u8f, dvc["pidarr"], dvc["pv"], n_c, cap_e,
            tc.tail_w0, tc.W, ex)
        _, _, _, tot4, tot_e = CK.cascade_long_verify(*long_args(long_c,
                                                                 False))
        ncand, cnt3, cnt4, ne = torch.stack([ncand_t, tot3, tot4,
                                             tot_e]).tolist()
        mark()
        assert ncand <= cap_c and ne <= cap_e
        assert cnt3 + cnt4 == len(truth_c), (cnt3, cnt4)
        ok3, pid3, end3, _, long_x = CK.cascade_probe(*probe_c, True)
        ok4, pid4, end4, t4x, _ = CK.cascade_long_verify(*long_args(long_x,
                                                                    True))
        assert int(t4x) == cnt4
        mark()
        out_pid, out_end = select_matches(
            torch.cat([ok3.reshape(-1), ok4]),
            torch.cat([pid3.reshape(-1), pid4]),
            torch.cat([end3.reshape(-1), end4]), cap_m)
        mark()
        hp, he = cas._host_pairs(out_pid, out_end)
        mark()
        order = np.lexsort((cas.pid_rank[hp], he))
        mark()
        assert len(order) == len(truth_c)
        for k, a, b in zip(c_steps, marks, marks[1:]):
            cparts[k].append((b - a) * 1e3)
        cparts["sum_of_count_parts"].append(
            (marks[len(c_count)] - marks[0]) * 1e3)
        del x32, halo_c, body_c
    cmed = parts_log("cascade dict100k", cparts, c_steps, c_count)
    report["cascade_parts"] = dict(runs_ms=cparts, median_ms=cmed,
                                   ncand=ncand, expanded=ne, caps=[
                                       cap_c, cap_e, cap_m])

    n_d = len(hay_d)
    fcap_c, fcap_m = fpd._caps["c"], fpd._caps["m"]
    dtabs = fpd.dv.device_tables(dev)
    f_count = ("pack", "upload", "layout_and_verify_buffer", "G6",
               "S1_cand_select", "S2_fp_verify_and_read")
    f_steps = f_count + ("S2_extract_and_read", "select_matches",
                         "host_pairs_and_lexsort")
    fparts = {k: [] for k in ("count_matches", "sum_of_count_parts")
              + f_steps}
    for _ in range(RUNS):
        fparts["count_matches"].append(
            host_ms(lambda: ac_d.count_matches(hay_d)))
        torch.cuda.synchronize()
        marks = [time.perf_counter()]

        def mark():
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        L_d, _, tiles_d = fpd._layout(n_d)
        x32 = pack_upload(fpd, hay_d, L_d, tiles_d, mark)
        halo_d, body_d = TB._to_stream_major(x32, L_d, tiles_d, fpd.halo)
        u8d = TF._verify_buffer(x32, fpd.dv.W, fpd.ci)
        mark()
        _, bmp_d = FK.fp_bitmap_baked(*fpd._args(), halo_d, body_d)
        mark()
        ncand_t, e_pos_d, live_d = CK.cand_select(bmp_d, L_d, fcap_c)
        mark()
        verify_d = (u8d, e_pos_d, live_d, n_d, dtabs, fpd.dv.W)
        _, _, _, tot2 = CK.fp_verify(*verify_d, False)
        ncand_d, cnt_d = torch.stack([ncand_t, tot2]).tolist()
        mark()
        assert ncand_d <= fcap_c and cnt_d == len(truth_d)
        ok2, pid2, end2, t2x = CK.fp_verify(*verify_d, True)
        assert int(t2x) == cnt_d <= fcap_m
        mark()
        out_pid, out_end = select_matches(ok2, pid2, end2, fcap_m)
        mark()
        pid_h, end_h = out_pid.cpu().numpy(), out_end.cpu().numpy()
        real = pid_h >= 0
        order = np.lexsort((fpd.verif.pid_rank[pid_h[real]], end_h[real]))
        mark()
        assert len(order) == len(truth_d)
        for k, a, b in zip(f_steps, marks, marks[1:]):
            fparts[k].append((b - a) * 1e3)
        fparts["sum_of_count_parts"].append(
            (marks[len(f_count)] - marks[0]) * 1e3)
        del x32, halo_d, body_d
    fmed = parts_log("fingerprint dict1k", fparts, f_steps, f_count)
    report["fingerprint_parts"] = dict(runs_ms=fparts, median_ms=fmed,
                                       ncand=ncand_d, caps=[fcap_c, fcap_m])

    # S1-S4 at those shapes: CUDA-graph time, the plain version's time, and
    # the bound: the bytes each must move (its inputs read once, every
    # gather a whole 32-byte sector, only for the live candidates and
    # expansion rows that this run's data has; its outputs written once)
    # over the memory rate. No PyTorch call computes these functions
    # (library: none).
    def sectors(nbytes):
        return -(-nbytes // 32) * 32

    launch_shape = {"S1": lambda: CK.select_shape,
                    "S2": lambda: CK.verify_shape,
                    "S3": lambda: CK.probe_shape,
                    "S4": lambda: CK.long_shape}

    def stage_row(name, per_call, kern, plain, moved, threads):
        """One timed S kernel; the wrapper's record of its last launch
        (``launch_shape``) beside it."""
        err(name[:2], kern(), plain())
        ms = kernel_ms(kern)
        shape = launch_shape[name[:2]]()
        plain_ms = events_ms(plain)
        bms = moved / HBM_BYTES_PER_S * 1e3
        r = dict(name=name, bytes=moved, ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by="bytes", share_of_bound=bms / ms,
                 launches_per_call=per_call, library_ms=None,
                 launch_shape=shape, threads=threads, P=None, Ls=None,
                 G=None)
        log(f"[time] {name}: {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bms:.4f} ms (bytes: {moved} B), {100 * bms / ms:.1f}% of "
            f"bound; {threads} threads, launch shape {shape}; {per_call} "
            f"launches per call; library: none | {card}")
        return r

    def s1_row(name, bmp_s, L_s, cap_s, nc, per_call):
        moved = bmp_s.numel() * 4 + cap_s * 9 + 8
        return stage_row(f"S1 cand_select {name}: {bmp_s.numel()} words, "
                         f"{nc} candidates in cap {cap_s}", per_call,
                         lambda: CK.cand_select(bmp_s, L_s, cap_s),
                         lambda: CK.cand_select_plain(bmp_s, L_s, cap_s),
                         moved, max(bmp_s.numel() // 8, cap_s))

    # The live candidates whose cuckoo probe hits, per class: a count
    # needs a class's group row only for those; an extraction writes every
    # slot's pid and end, so it reads each live candidate's row.
    w64_d = CK.gather_windows(u8d, e_pos_d, fpd.dv.W).to(torch.int64)
    hits_d = {c: int((CK.fp_probe(w64_d, c, *tab[:5])[0] & live_d).sum())
              for c, tab in dtabs.items()}
    del w64_d

    def s2_row(ex):
        C, W = fcap_c, fpd.dv.W
        live_n = min(ncand_d, C)
        moved = C * 9 + live_n * sectors(W) + 8
        for c, (_, _, _, _, _, gmax, _) in dtabs.items():
            rows_n = live_n if ex else hits_d[c]
            moved += live_n * 2 * 32 + rows_n * sectors(gmax * (W + 8))
            moved += C * gmax * 13 if ex else 0
        mode = "extract" if ex else "count"
        return stage_row(f"S2 fp_verify {mode} dict1k: {live_n} candidates "
                         f"in cap {C}, {len(dtabs)} classes (probe hits "
                         f"{sorted(hits_d.items())}), W={W}",
                         cd["S2"], lambda: CK.fp_verify(*verify_d, ex),
                         lambda: CK.fp_verify_plain(*verify_d, ex), moved, C)

    def s3_row(ex):
        C, W = cap_c, tc.W
        E = len(tc.classes) - int(TC.LONG in tc.classes)
        live_n = min(ncand, C)
        moved = (C * 9 + live_n * (sectors(W) + len(tc.classes) * 2 * 32)
                 + (E * C * 17 if ex else 0) + C * 24 + 8)
        mode = "extract" if ex else "count"
        return stage_row(f"S3 cascade_probe {mode} dict100k: {live_n} "
                         f"candidates in cap {C}, {E} exact classes + LONG",
                         cc["S3"], lambda: CK.cascade_probe(*probe_c, ex),
                         lambda: CK.cascade_probe_plain(*probe_c, ex), moved,
                         C)

    def s4_row(ex):
        lng = long_x if ex else long_c
        a = long_args(lng, ex)
        rows_n = min(ne, cap_e)
        groups = int((lng[0] > 0).sum())
        Ww = tc.W // 4
        moved = (cap_c * 32 + rows_n * (32 + sectors((2 * Ww + 1) * 4))
                 + groups * sectors(tc.W) + (cap_e * 17 if ex else 0) + 8)
        mode = "extract" if ex else "count"
        return stage_row(f"S4 cascade_long_verify {mode} dict100k: "
                         f"{rows_n} rows in cap {cap_e} from {groups} "
                         f"groups", cc["S4"],
                         lambda: CK.cascade_long_verify(*a),
                         lambda: CK.cascade_long_verify_plain(*a), moved,
                         cap_e)

    srows_s = {
        "S1": s1_row("dict100k", bmp, L_c, cap_c, ncand, cc["S1"]),
        "S1 dict1k": s1_row("dict1k", bmp_d, L_d, fcap_c, ncand_d,
                            cd["S1"]),
        "S2": s2_row(False),
        "S2 extract": s2_row(True),
        "S3": s3_row(False),
        "S3 extract": s3_row(True),
        "S4": s4_row(False),
        "S4 extract": s4_row(True),
    }
    rows.update(srows_s)
    stage_ms = {"cascade dict100k": sum(cmed[k] for k in c_count[4:]),
                "fingerprint dict1k": sum(fmed[k] for k in f_count[4:])}
    log("[e2e parts] 64 MiB counts, the stages after G6 (S1 .. the read of "
        "the scalars, medians): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in stage_ms.items()) + f" | {card}")
    report["stage_ms_after_G6"] = stage_ms

    # The device walk's calls, step by step (dict1k, 64 MiB; host clock, a
    # synchronise after each step, medians of RUNS): the count packs,
    # uploads, runs W2 and reads one scalar; the extraction packs,
    # uploads, runs W1, compacts the match states (torch.nonzero) and
    # reads them, and decodes them into the match set.
    from ahocorasick_tpu_torch import semantics as TSEM
    from ahocorasick_tpu_torch.ops import block_scan as TBS
    n_w = len(hay_d)
    w_steps = {"count": ("pack", "upload", "W2_and_read"),
               "extract": ("pack", "upload", "W1", "compaction_and_read",
                           "decode")}
    wparts = {"count_matches": [], "find_overlapping_iter": []}
    wparts.update({f"{m}_{k}": [] for m, ks in w_steps.items() for k in ks})
    for _ in range(RUNS):
        wparts["count_matches"].append(
            host_ms(lambda: ac_w.count_matches(hay_d)))
        wparts["find_overlapping_iter"].append(
            host_ms(lambda: list(ac_w.find_overlapping_iter(hay_d))))
        for mode, steps in w_steps.items():
            torch.cuda.synchronize()
            marks = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                marks.append(time.perf_counter())
            buf, _, L_w, halo_w = TBS.pack_haystack(hay_d, walk.halo)
            mark()
            buf_t = torch.from_numpy(buf).to(dev)
            mark()
            wa = (walk.trans_flat, walk.classes, buf_t, walk.alphabet_len,
                  walk.start_id, L_w, halo_w)
            if mode == "count":
                total = int(WK.walk_count(*wa, walk.match_count, 0, n_w))
                mark()
                assert total == len(truth_d)
            else:
                states = WK.walk_states(*wa)
                mark()
                pos, sids = TBS._compact_matches(states, n_w,
                                                 walk.max_match_id)
                ends, sids = pos.cpu().numpy() + 1, sids.cpu().numpy()
                mark()
                TSEM.extract_match_set_from_positions(walk.dfa, ends, sids,
                                                      0)
                mark()
                assert len(ends) <= len(truth_d)
                del states, pos
            for k, a, b in zip(steps, marks, marks[1:]):
                wparts[f"{mode}_{k}"].append((b - a) * 1e3)
            del buf_t
    wmed = {k: float(np.median(v)) for k, v in wparts.items()}
    log(f"[e2e parts] device walk dict1k 64 MiB, medians of {RUNS}: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in wmed.items())
        + f" | {card}")
    report["walk_parts"] = dict(runs_ms=wparts, median_ms=wmed)

    # W1 and W2 at the facade's shapes: CUDA-graph time, the plain walk's
    # time (the JAX layout, one torch step per byte of a block), and the
    # bound: the larger of the bytes each must move (the positions it
    # walks, the tables once, 256 classes; W1's states, W2's match counts
    # and partials written once) over the memory rate, and its loads (per
    # walked byte a class from shared memory and a table entry; W2 also a
    # match count) over LDS_PER_CLK loads per SM and clock. The halo's
    # warm-up bytes are layout overhead, charged nothing. No PyTorch call
    # computes a DFA walk (library: none).
    def walk_row(name, k, wa, window, per_call):
        if k == "W2":
            fn = lambda: WK.walk_count(*wa, *window)  # noqa: E731
            plain = lambda: WK.walk_count_plain(*wa, *window)  # noqa: E731
        else:
            fn = lambda: WK.walk_states(*wa)  # noqa: E731
            plain = lambda: WK.walk_states_plain(*wa)  # noqa: E731
        err(k, fn(), plain())
        shape = WK.count_shape if k == "W2" else WK.walk_shape
        ms = kernel_ms(fn)
        plain_ms = events_ms(plain)
        n_b, sa, A = wa[2].numel(), wa[0].numel(), wa[3]
        if k == "W2":
            walked = window[2] - window[1]
            out = 8 * (sa // A) + 8 * WK.count_blocks(n_b, shape[2])
        else:
            walked, out = n_b, 4 * n_b
        moved = walked + 4 * sa + 4 * 256 + out
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        loads = walked * (3 if k == "W2" else 2)
        t_ops = loads / (LDS_PER_CLK * sm_hz) * 1e3
        bms, by = ((t_ops, "operations") if t_ops > t_bytes
                   else (t_bytes, "bytes"))
        r = dict(name=name, bytes=moved, ms=ms, plain_ms=plain_ms,
                 bound_ms=bms, bound_by=by, share_of_bound=bms / ms,
                 launches_per_call=per_call, library_ms=None,
                 launch_shape=shape, threads=shape[1], P=None, Ls=shape[2],
                 G=None, table_in_shared=shape[4])
        log(f"[time] {name}: {ms:.4f} ms ({walked / ms / 1e6:.1f} GB/s), "
            f"plain {plain_ms:.1f} ms, bound {bms:.4f} ms ({by}: {moved} B, "
            f"{loads} loads), {100 * bms / ms:.1f}% of bound; {shape[1]} "
            f"threads of {shape[2]} B + a {shape[3]}-B halo, table "
            f"{4 * sa} B in {'shared' if shape[4] else 'device'} memory; "
            f"{per_call} launch per call; library: none | {card}")
        return r

    buf_d, n_dw, L_dw, H_dw = walk._prepare(hay_d)
    wa_d = (walk.trans_flat, walk.classes, buf_d, walk.alphabet_len,
            walk.start_id, L_dw, H_dw)
    buf_5, n_5w, L_5w, H_5w = walk5._prepare(hay64)
    wa_5 = (walk5.trans_flat, walk5.classes, buf_5, walk5.alphabet_len,
            walk5.start_id, L_5w, H_5w)
    rows.update({
        "W2": walk_row(f"W2 walk_count dict1k 64 MiB, {walk.num_states} "
                       f"states x {walk.alphabet_len} classes", "W2", wa_d,
                       (walk.match_count, 0, n_dw), cw["W2"]),
        "W2 names": walk_row(f"W2 walk_count five names 64 MiB, "
                             f"{walk5.num_states} states x "
                             f"{walk5.alphabet_len} classes", "W2", wa_5,
                             (walk5.match_count, 0, n_5w), cw5["W2"]),
        "W1": walk_row(f"W1 walk_states dict1k 64 MiB, {walk.num_states} "
                       f"states x {walk.alphabet_len} classes", "W1", wa_d,
                       (), cwx["W1"]),
        "W1 names": walk_row(f"W1 walk_states five names 64 MiB, "
                             f"{walk5.num_states} states x "
                             f"{walk5.alphabet_len} classes", "W1", wa_5, (),
                             cwx["W1"]),
    })
    # The table's place on one input: W2 over the five names' 64 MiB with
    # the table in shared memory (the wrapper's choice) and read through
    # the read-only path, alternating, three CUDA-graph means each.
    wc5 = (walk5.trans_flat, walk5.classes, buf_5, walk5.alphabet_len,
           walk5.start_id, H_5w, walk5.match_count, 0, n_5w,
           WK.walk_plan(buf_5.numel(), H_5w))
    place = {True: [], False: []}
    for _ in range(3):
        for sh in (True, False):
            if int(WK._count_on_card(*wc5, sh)) != len(truth64):
                raise AssertionError(f"W2 with shared={sh} != truth")
            place[sh].append(
                kernel_ms(lambda: WK._count_on_card(*wc5, sh)))
    log(f"[time] W2 five names 64 MiB, the table's place on one input "
        f"(alternating): shared memory "
        + ", ".join(f"{t:.4f}" for t in place[True]) + " ms; read-only "
        "path " + ", ".join(f"{t:.4f}" for t in place[False])
        + f" ms | {card}")
    report["walk_table_place_ms"] = dict(shared=place[True],
                                         read_only=place[False])
    del buf_d, buf_5

    # 16. Result lines ---------------------------------------------------------------
    def entry(k, fn, src, line, r):
        inst = (walk_insts[k, r["table_in_shared"]] if k in ("W1", "W2")
                else dict(launches=launches[k], err=errs[k]))
        return dict(name=f"{k} {fn}", route="cuda",
                    source=f"ahocorasick_tpu_torch/csrc/{src}",
                    replaces=line, launches=inst["launches"],
                    max_abs_err=inst["err"], ms=r["ms"],
                    plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    share=r["share_of_bound"], library_ms=None,
                    shape=r["name"], threads=r["threads"], P=r["P"],
                    Ls=r["Ls"], G=r["G"])
    kernels = [
        entry("G1", "bitap_generic_scan", "bitap.cu",
              "ahocorasick_tpu/ops/bitap.py:284", rows["G1"]),
        entry("G2", "bitap_baked_scan", "bitap.cu",
              "ahocorasick_tpu/ops/bitap.py:400", rows["G2"]),
        entry("G3", "staged_flags", "staged.cu",
              "ahocorasick_tpu/ops/staged.py:77", rows["G3"]),
        entry("G4", "staged_gathered", "staged.cu",
              "ahocorasick_tpu/ops/staged.py:152", rows["G4"]),
        entry("G5", "fp_bitmap (masked)", "fingerprint.cu",
              "ahocorasick_tpu/ops/fingerprint.py:369", rows["G5"]),
        entry("G6", "fp_bitmap (pad-byte padded)", "fingerprint.cu",
              "ahocorasick_tpu/ops/fingerprint.py:434", rows["G6"]),
        entry("S1", "cand_select", "candidates.cu",
              "ahocorasick_tpu/ops/fingerprint.py:547", rows["S1"]),
        entry("S2", "fp_verify", "candidates.cu",
              "ahocorasick_tpu/ops/fingerprint.py:765", rows["S2"]),
        entry("S3", "cascade_probe", "candidates.cu",
              "ahocorasick_tpu/ops/cascade.py:364", rows["S3"]),
        entry("S4", "cascade_long_verify", "candidates.cu",
              "ahocorasick_tpu/ops/cascade.py:395", rows["S4"]),
        entry("W1", "walk_states", "dfa_walk.cu",
              "ahocorasick_tpu/ops/block_scan.py:239", rows["W1"]),
        entry("W1", "walk_states, table in shared memory", "dfa_walk.cu",
              "ahocorasick_tpu/ops/block_scan.py:239", rows["W1 names"]),
        entry("W2", "walk_count", "dfa_walk.cu",
              "ahocorasick_tpu/ops/block_scan.py:286", rows["W2"]),
        entry("W2", "walk_count, table in shared memory", "dfa_walk.cu",
              "ahocorasick_tpu/ops/block_scan.py:286", rows["W2 names"]),
    ]
    # The limb-group rows beyond 64 limbs, G1-G4.
    for k, fn, src, line, row in (
            ("G1", "bitap_generic_scan, limb groups", "bitap.cu",
             "ahocorasick_tpu/ops/bitap.py:284",
             "G1 count 64 MiB, K=229, no pad byte"),
            ("G2", "bitap_baked_scan, limb groups", "bitap.cu",
             "ahocorasick_tpu/ops/bitap.py:400",
             "G2 count 64 MiB, K=103 (128 words)"),
            *((k, f"{fn}, limb groups", "staged.cu", line, name)
              for (name, _, k, _), fn, line in zip(
                  STAGED_ROWS,
                  ("staged_flags", "staged_gathered", "staged_gathered"),
                  ("ahocorasick_tpu/ops/staged.py:77",
                   "ahocorasick_tpu/ops/staged.py:152",
                   "ahocorasick_tpu/ops/staged.py:152")))):
        kernels.append(entry(k, fn, src, line, rows[row]))
    report["kernels"] = kernels
    report["seconds"] = time.time() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"[done] {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
