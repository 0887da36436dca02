"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root (``python3 -m portbench.run`` works as well).
The last line of standard output is the result's JSON object; the numbers
that decide ``correct`` are the last lines of standard error. Exits
non-zero, with no result, where there is no CUDA device, where the cell
asks for more cards than there are, where the port cannot be imported
from this checkout, or where JAX or the JAX package is loaded once the
window has closed.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# Run as a script, the benchmark's own folder would lead sys.path and its
# modules would shadow the standard library's (profile).
if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT,
                                                             "portbench"):
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None, **where) -> int:
    """Parse the command line, run the cell, print the checks and the
    result line. ``where`` (root, device, require_cuda) serves the tests
    on a machine without a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench.harness import HarnessError, log, run
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t_process=T_PROCESS, **{"root": ROOT, **where})
    except HarnessError as e:
        log(f"[portbench] no result: {e}")
        return 2
    for name, c in out["checks"].items():
        lim = " ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        log(f"[check] {name} {c['value']} ({lim})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
