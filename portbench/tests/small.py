"""Small cells for the CPU tests: a checkout-like root in a temporary
directory that holds copies of BENCHMARK.json and the benchmark's data
files, and new cells and a configuration added as files and entries
only."""

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DICT_TEXT = {"generator": "dict_text", "density": 0.002,
             "filler_words": 4000, "filler_seed": 8}
# name: (config, operation, haystack bytes, pool, text)
CELLS = {
    "names.find_iter.small": ("name-alt1", "find_iter", 300_000, 4,
                              {"generator": "english", "name_rate": 0.02}),
    "dict5k.count.small": ("dict5k", "count_matches", 1 << 18, 2,
                           DICT_TEXT),
    "dict5k.overlapping.small": ("dict5k", "find_overlapping_iter",
                                 1 << 18, 2, DICT_TEXT),
}
COPIED = ("configs", "workloads", "metrics", "generators", "operations",
          "searchers")
# A 5,000-name dictionary, searched ignoring ASCII case with standard
# semantics: the cascade and fingerprint routes at a small size.
DICT5K = {
    "name": "dict5k",
    "searcher": "facade",
    "patterns": {"generator": "syllable_names", "count": 5000, "seed": 99,
                 "syllables": "name", "capitalize": 0.3},
    "semantics": {"match_kind": "standard", "ascii_case_insensitive": True},
    "control": {"breaks": "ASCII case-insensitive", "case_sensitive": True},
    "roofline": {"filter_limbs": 6, "table_bytes": 816},
    "reduced": [],
}


def _dump(path, obj):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def small_root(tmp) -> str:
    """A root with the repository's benchmark files and the CELLS (a
    5,000-name dictionary config among them) added as new files."""
    root = os.path.join(str(tmp), "root")
    os.makedirs(os.path.join(root, "portbench"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    for d in COPIED:
        shutil.copytree(os.path.join(REPO, "portbench", d),
                        os.path.join(root, "portbench", d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    _dump(os.path.join(root, "portbench", "configs", "dict5k.json"), DICT5K)
    bench["configs"].append({"name": "dict5k", "source": "tests",
                             "file": "portbench/configs/dict5k.json",
                             "reduced": [], "why": "tests"})
    for name, (config, op, n, pool, text) in CELLS.items():
        _dump(os.path.join(root, "portbench", "workloads", f"{name}.json"),
              {"config": config, "operation": op, "haystack_bytes": n,
               "pool": pool, "text": text, "warmup_rounds": 1,
               "check_every": 1, "profile_calls": 2})
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name, "chips": 1,
                                   "why": "tests"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if "workloads" in m:
                m["workloads"].append(name)
    _dump(os.path.join(root, "BENCHMARK.json"), bench)
    return root
