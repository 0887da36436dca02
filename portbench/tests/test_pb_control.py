"""The control and the planted faults come out not correct.

On the CPU at small sizes: the control (the reference with one guarantee
of the configuration broken) and the port with its answer altered, or
with half of each haystack left out, in the program's place. On the card
(``cuda``): the control at each cell's own size, on three seeds."""

import json
import os
import time

import pytest

from portbench import harness
from portbench.control import control_searcher

from .small import CELLS, REPO, small_root

FAULTS = ("answer_altered", "half_left_out")


def cpu_run(root, cell, **kw):
    return harness.run(cell, 2**32 + 5, 1.0, False,
                       t_process=time.perf_counter(), root=root,
                       device="cpu", require_cuda=False, **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct_and_control_is_not(root, cell):
    assert cpu_run(root, cell)["correct"] is True
    out = cpu_run(root, cell, searcher_factory=control_searcher)
    assert out["correct"] is False
    assert out["checks"]["wrong_calls"]["value"] > 0


def _plant(monkeypatch, fault):
    """Break every engine's count_matches and match_pairs of the port."""
    from ahocorasick_tpu_torch.ops import cascade, fingerprint

    for cls in (cascade.CascadeEngine, fingerprint.FingerprintEngine):
        for meth in ("count_matches", "match_pairs"):
            orig = getattr(cls, meth)

            def broken(self, hs, _orig=orig, _meth=meth):
                if fault == "half_left_out":
                    return _orig(self, hs[:len(hs) // 2])
                got = _orig(self, hs)
                if _meth == "count_matches":
                    return got + 1
                pids, ends = got
                ends = ends.copy()
                ends[len(ends) // 2] += 1
                return pids, ends
            monkeypatch.setattr(cls, meth, broken)


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_planted_fault_is_not_correct(root, cell, fault, monkeypatch):
    _plant(monkeypatch, fault)
    out = cpu_run(root, cell)
    assert out["correct"] is False
    assert out["checks"]["worst_gap"]["value"] > 0


with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    BENCH_CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", BENCH_CELLS)
def test_control_at_the_cell_size_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    readings = []
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        out = harness.run(cell, seed, 5.0, False,
                          t_process=time.perf_counter(), root=REPO,
                          searcher_factory=control_searcher)
        readings.append(out["checks"])
        assert out["correct"] is False, out["checks"]
    print(json.dumps({"cell": cell, "control": readings}))
