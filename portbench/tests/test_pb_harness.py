"""The harness on the CPU at small sizes: cells, configurations and
metrics found by name in new files, the import check, a missing span,
and the result line's keys."""

import ast
import io
import json
import os
import shutil
import subprocess
import sys
import time
import types
from contextlib import redirect_stderr, redirect_stdout

import pytest

from portbench import harness, run as run_py

from .small import COPIED, REPO, small_root

CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def cpu_run(root, cell, trace=False, seconds=1.0, **kw):
    return harness.run(cell, 2**31 + 99, seconds, trace,
                       t_process=time.perf_counter(), root=root,
                       device="cpu", require_cuda=False, **kw)


def test_cell_config_and_metric_added_as_new_files(tmp_path):
    root = small_root(tmp_path)
    # A new end-to-end metric for a new cell: a reader file and an entry.
    with open(os.path.join(root, "portbench", "metrics",
                           "calls_per_s.py"), "w") as f:
        f.write("def read(run):\n"
                "    return len(run.durations) / run.window_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["end_to_end"].append({
        "name": "calls_per_s", "unit": "1/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["dict5k.count.small"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    # Every file the repository has is still byte-identical.
    for d in COPIED:
        src = os.path.join(REPO, "portbench", d)
        for name in os.listdir(src):
            if name.endswith((".json", ".py")):
                with open(os.path.join(src, name), "rb") as a, open(
                        os.path.join(root, "portbench", d, name),
                        "rb") as b:
                    assert a.read() == b.read(), name
    out = cpu_run(root, "dict5k.count.small")
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"scan_GBps", "call_p95_ms", "setup_s",
                                   "calls_per_s"}
    assert out["metrics"]["calls_per_s"]["unit"] == "1/s"
    assert out["checks"]["checked_calls"]["value"] == out["attempted"]


def _write(root, rel, text):
    with open(os.path.join(root, "portbench", rel), "w") as f:
        f.write(text)


def test_generator_and_operation_added_as_new_files(tmp_path):
    """A traffic mix with haystacks of several sizes and an operation the
    harness had not known, each a new file, in a new cell."""
    root = small_root(tmp_path)
    _write(root, "generators/english_sized.py",
           "from portbench import gen\n\n\n"
           "def pool(spec, patterns, size, count, seed):\n"
           "    rng = gen.rng_of(seed)\n"
           "    return [gen.english(int(rng.integers(size // 4, size)), rng,"
           " patterns, spec['name_rate']) for _ in range(count)]\n")
    _write(root, "operations/count_found.py",
           "def consumer(searcher):\n"
           "    return lambda h: sum(1 for _ in searcher.find_iter(h))\n\n\n"
           "def keep(result):\n    return result\n\n\n"
           "def expected(reference, hay):\n"
           "    return len(reference.find_iter(hay))\n\n\n"
           "def gap(got, want):\n    return abs(got - want)\n\n\n"
           "def matches(want):\n    return want\n")
    name = "names.count_found.sized"
    with open(os.path.join(root, "portbench", "workloads", f"{name}.json"),
              "w") as f:
        json.dump({"config": "name-alt1", "operation": "count_found",
                   "haystack_bytes": 200_000, "pool": 3,
                   "text": {"generator": "english_sized",
                            "name_rate": 0.002}}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": name, "config": "name-alt1",
                               "traffic": "count_found.sized", "chips": 1,
                               "why": "tests"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = cpu_run(root, name)
    assert out["correct"] is True and out["failed"] == 0
    assert out["checks"]["checked_calls"]["value"] == out["attempted"]
    sizes = {len(h) for h in harness.make_inputs(
        root, json.load(open(os.path.join(
            root, "portbench", "configs", "name-alt1.json"))),
        json.load(open(os.path.join(root, "portbench", "workloads",
                                    f"{name}.json"))), 5)[1]}
    assert len(sizes) == 3 and max(sizes) < 200_000
    got = out["metrics"]["scan_GBps"]["value"]
    assert got > 0


def test_unknown_cell_is_refused(tmp_path):
    with pytest.raises(harness.HarnessError):
        cpu_run(small_root(tmp_path), "no.such.cell")


def test_import_check_compares_top_level_names_whole():
    assert harness.forbidden_modules(
        ["ahocorasick_tpu_torch", "ahocorasick_tpu_torch.ops.cascade",
         "numpy", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "jaxlib", "flax.linen", "ahocorasick_tpu.ops",
         "torch"]) == ["ahocorasick_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bench = os.path.join(REPO, "portbench")
    for dirpath, _, files in os.walk(bench):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                assert not harness.forbidden_modules(_imports(path)), path
    # The reference imports nothing of the program either.
    ref = set(_imports(os.path.join(bench, "reference.py")))
    assert ref <= {"__future__", "typing", "numpy", "torch"}, ref
    for other in ("bench", "chip_smoke", "benchmarks"):
        for dirpath, _, files in os.walk(bench):
            for name in files:
                if name.endswith(".py"):
                    path = os.path.join(dirpath, name)
                    assert other not in set(_imports(path)), path


def test_a_run_with_jax_loaded_gives_no_result(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(harness.HarnessError, match="jax"):
        cpu_run(small_root(tmp_path), "dict5k.count.small", seconds=0.2)


def test_a_missing_span_leaves_its_metrics_out(tmp_path, monkeypatch):
    root = small_root(tmp_path)
    out = cpu_run(root, "names.find_iter.small", trace=True)
    assert {"facade_ms", "prepare_ms", "engine_pass_ms"} <= set(
        out["metrics"])
    monkeypatch.setattr(harness, "SPAN_METHODS",
                        {"renamed_prepare": "prepare"})
    err = io.StringIO()
    with redirect_stderr(err):
        out = cpu_run(root, "names.find_iter.small", trace=True)
    assert out["correct"] is True
    assert not {"facade_ms", "prepare_ms", "engine_pass_ms"} & set(
        out["metrics"])
    assert "facade_ms: nothing to read" in err.getvalue()
    assert all(v["value"] is not None for v in out["metrics"].values())


def test_the_last_line_has_the_contract_keys(tmp_path):
    root = small_root(tmp_path)
    for trace in ("0", "1"):
        out, err = io.StringIO(), io.StringIO()
        with redirect_stdout(out), redirect_stderr(err):
            rc = run_py.main(["--workload", "dict5k.overlapping.small",
                              "--seed", str(2**33 + 1), "--seconds", "0.5",
                              "--trace", trace],
                             root=root, device="cpu", require_cuda=False)
        assert rc == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert list(line)[:5] == CONTRACT_KEYS
        assert list(line)[-1] == "checks"
        assert set(line) - set(CONTRACT_KEYS) <= {"checks", "breakdown"}
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
            line["device"])
        if trace == "1":
            assert {"busy_s", "window_s"} <= set(line["device"])
        names = json.load(open(os.path.join(root, "BENCHMARK.json")))[
            "end_to_end" if trace == "0" else "per_layer"]
        assert set(line["metrics"]) <= {m["name"] for m in names}
        last = err.getvalue().strip().splitlines()[-len(line["checks"]):]
        assert [s.split()[1] for s in last] == list(line["checks"])


def _no_result(cwd):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "name-alt1.find_iter.sherlock", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout


def test_without_a_card_there_is_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    _no_result(REPO)


def test_without_the_program_there_is_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(tmp_path)
