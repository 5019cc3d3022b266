"""The port's engine phase profile (dynamo_tpu_torch/profiling/
profile_engine.py) held against the reference's benchmarks/
profile_engine.py on the CPU: the four attribution functions and the phase
tuples equal the reference's on the same synthetic ``profile_snapshot``
dicts; ``main(["--cpu", ...])`` profiles a live engine and prints the
reference's top-level keys; without a GPU and without ``--cpu`` it raises.
"""

import json

import pytest
import torch

from benchmarks import profile_engine as jpe
from dynamo_tpu_torch.profiling import profile_engine as tpe

pytestmark = pytest.mark.unit

# the keys of the reference's printed report (benchmarks/profile_engine.py
# ``out``), "spec" only when the engine verified drafts
REPORT_KEYS = ["concurrency", "window_s", "model_steps", "requests_done", "accounted_s",
               "phases", "readmission", "dispatch", "overhead", "eager_readmits"]


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rec(secs, calls):
    return {"secs": secs, "calls": calls}


SNAPS = {
    "empty": ({}, 0, 0.0, {"verifies": 0, "drafted": 0, "accepted": 0, "rejected": 0,
                           "acceptance_rate": None}),
    "no spec": ({
        "dispatch": _rec(0.31, 120), "admit_loop": _rec(0.05, 40),
        "packed_prefill": _rec(0.42, 12), "complete_admissions": _rec(0.07, 12),
        "materialize": _rec(0.02, 5), "readmit_wait": _rec(0.01, 3),
        "eager_readmit": _rec(0.5, 9), "process": _rec(1.1, 120), "idle": _rec(0.2, 30),
        "readmit.admit_wait": _rec(0.012, 48), "readmit.prefill_dispatch": _rec(0.3, 48),
        "readmit.first_token": _rec(0.0, 0),
        "dispatch.dispatches": _rec(0.0, 184), "dispatch.compile": _rec(0.0, 0),
        "dispatch.d2h_wait": _rec(0.0, 0), "readmit.d2h_wait": _rec(0.0, 0),
    }, 2880, 5.03, {"verifies": 0, "drafted": 0, "accepted": 0, "rejected": 0,
                    "acceptance_rate": None}),
    "spec": ({
        "dispatch": _rec(0.2, 80), "spec.draft": _rec(0.013, 80),
        "spec.verify": _rec(0.44, 80), "spec.rollback": _rec(0.0021, 33),
        "packed_prefill": _rec(0.1, 4), "dispatch.dispatches": _rec(0.0, 90),
        "dispatch.compile": _rec(1.25, 2), "readmit.first_token": _rec(0.0123, 7),
    }, 80, 2.0, {"verifies": 80, "drafted": 400, "accepted": 171, "rejected": 229,
                 "acceptance_rate": 0.4275}),
    "d2h waits in both places": ({
        "dispatch": _rec(0.11, 50), "dispatch.d2h_wait": _rec(0.0571, 17),
        "readmit.d2h_wait": _rec(0.0333, 9), "complete_admissions": _rec(0.09, 9),
        "materialize": _rec(0.04, 4), "dispatch.dispatches": _rec(0.0, 63),
        "dispatch.compile": _rec(0.0, 0),
    }, 1200, 0.0, {"verifies": 3, "drafted": 9, "accepted": 0, "rejected": 9,
                   "acceptance_rate": 0.0}),
}


@pytest.mark.parametrize("case", list(SNAPS))
def test_attributions_equal_the_reference(case):
    snap, steps, window, counters = SNAPS[case]
    assert tpe.readmission_attribution(snap) == jpe.readmission_attribution(snap)
    assert tpe.dispatch_attribution(snap, steps) == jpe.dispatch_attribution(snap, steps)
    assert tpe.spec_attribution(snap, counters) == jpe.spec_attribution(snap, counters)
    assert tpe.dispatch_overhead(snap, window, steps) == jpe.dispatch_overhead(
        snap, window, steps)


def test_phase_tuples_are_the_references():
    assert (tpe.READMIT_PHASES, tpe.DISPATCH_ISSUE_PHASES, tpe.SPEC_PHASES) == (
        jpe.READMIT_PHASES, jpe.DISPATCH_ISSUE_PHASES, jpe.SPEC_PHASES)


def test_main_on_the_cpu_profiles_a_live_engine(capsys):
    tpe.main(["--cpu", "--secs", "1", "--warm-secs", "0.5", "--concurrency", "2"])
    captured = capsys.readouterr()
    out = json.loads(captured.out)
    assert list(out) == REPORT_KEYS
    assert out["concurrency"] == 2 and out["model_steps"] > 0 and out["phases"]
    assert out["dispatch"]["compile_events"] == 0  # no graphs on the CPU
    assert "dispatch" in out["phases"] and "dispatch.dispatches" in out["phases"]
    assert out["overhead"]["model_steps"] == out["model_steps"]
    launches = json.loads(captured.err.split("ENGINE_LAUNCHES ", 1)[1].splitlines()[0])
    assert launches["steps"] >= out["model_steps"] and launches["replays"] == 0


def test_main_without_gpu_or_cpu_flag_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device available"):
        tpe.main(["--secs", "1"])
