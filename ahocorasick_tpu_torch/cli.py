"""Debug CLI — the aho-corasick-debug analog.

Usage:
    python -m ahocorasick_tpu_torch.cli <dict-file> <haystack-file> [options]

Reads one pattern per line from <dict-file>, builds an automaton with the
requested configuration on the torch device named by --device (default
cuda), and counts matches in <haystack-file>, printing build/search
timings and memory usage (aho-corasick-debug/main.rs:6-98).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ahocorasick-tpu-torch-debug", description=__doc__
    )
    ap.add_argument("dictionary", help="file with one pattern per line")
    ap.add_argument("haystack", help="file to search")
    ap.add_argument(
        "--match-kind",
        choices=["standard", "leftmost-first", "leftmost-longest"],
        default="standard",
    )
    ap.add_argument(
        "--kind",
        choices=["auto", "noncontiguous-nfa", "contiguous-nfa", "dfa"],
        default="auto",
    )
    ap.add_argument("--start-kind",
                    choices=["unanchored", "anchored", "both"],
                    default="unanchored")
    ap.add_argument("--ascii-case-insensitive", action="store_true")
    ap.add_argument("--no-prefilter", action="store_true")
    ap.add_argument("--no-byte-classes", action="store_true")
    ap.add_argument("--overlapping", action="store_true",
                    help="count overlapping matches")
    ap.add_argument("--anchored", action="store_true")
    ap.add_argument("--debug", action="store_true",
                    help="print the full automaton dump instead of"
                         " searching (NFA + dense DFA)")
    ap.add_argument("--debug-states", type=int, default=None,
                    help="cap the number of states printed by --debug")
    ap.add_argument(
        "--engine",
        choices=["auto", "oracle", "device-only", "bitap", "fingerprint",
                 "cascade", "dfa-scan"],
        default="auto",
    )
    ap.add_argument("--count-only", action="store_true",
                    help="device-reduced overlapping count (fastest)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the scans run on (cuda, cuda:1, "
                         "cpu); cuda fails without a CUDA device")
    args = ap.parse_args(argv)

    from . import AhoCorasick, AhoCorasickKind, Anchored, Input, MatchKind, StartKind

    with open(args.dictionary, "rb") as f:
        patterns = [line.rstrip(b"\r\n") for line in f if line.rstrip(b"\r\n")]
    with open(args.haystack, "rb") as f:
        haystack = f.read()

    kind = None if args.kind == "auto" else AhoCorasickKind(args.kind)
    t0 = time.perf_counter()
    ac = AhoCorasick(
        patterns,
        match_kind=MatchKind(args.match_kind),
        start_kind=StartKind(args.start_kind),
        ascii_case_insensitive=args.ascii_case_insensitive,
        kind=kind,
        prefilter=not args.no_prefilter,
        byte_classes=not args.no_byte_classes,
        engine=args.engine,
        device=args.device,
    )
    build_s = time.perf_counter() - t0
    print(f"build time: {build_s:.3f}s", file=sys.stderr)
    print(f"patterns: {ac.patterns_len()}", file=sys.stderr)
    print(f"kind: {ac.kind().value}", file=sys.stderr)
    print(f"memory usage: {ac.memory_usage()} bytes", file=sys.stderr)

    if args.debug:
        # Full automaton dump (NFA + dense DFA), the reference
        # aho-corasick-debug's primary output (main.rs:14-19).
        print(ac.debug_str(max_states=args.debug_states))
        return 0

    inp = Input(
        haystack,
        anchored=Anchored.YES if args.anchored else Anchored.NO,
    )
    t0 = time.perf_counter()
    if args.count_only:
        count = ac.count_matches(inp)
    elif args.overlapping:
        count = sum(1 for _ in ac.try_find_overlapping_iter(inp))
    else:
        count = sum(1 for _ in ac.try_find_iter(inp))
    search_s = time.perf_counter() - t0
    print(f"search time: {search_s:.4f}s"
          f" ({len(haystack) / max(search_s, 1e-9) / 1e9:.3f} GB/s)",
          file=sys.stderr)
    print(count)
    return 0


if __name__ == "__main__":
    sys.exit(main())
