"""setup_s: from the process's start to the first timed call: imports,
CUDA initialisation, a checkout's first kernel build, data generation,
the searcher's build and the warm-up calls (host clock)."""


def read(run):
    return run.setup_s
