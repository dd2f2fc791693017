"""Each cell at its own size on the card: the control (the program's own
path at the next lower value type) comes out not correct, and a traced run
reads a complete trace whose shares stay within 100%.

Needs an NVIDIA GPU and skips without one:

    python -m pytest -p no:cacheprovider -q benchmark/tests/test_bench_card.py
"""
import pytest
import torch

from benchmark import harness
from benchmark.readings import control_dtype

from .tiny import workloads

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.parametrize("workload", workloads())
def test_the_control_is_not_correct(cuda, workload):
    out = harness.run(workload, 4000000001, 1.0, False,
                      dtype=control_dtype(workload))
    assert out["attempted"] > 0 and not out["correct"], out["check"]


@pytest.mark.parametrize("workload", workloads())
def test_a_traced_run_reads_a_complete_trace(cuda, workload):
    out = harness.run(workload, 4000000002, 1.0, True)
    assert out["correct"], out["check"]
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    names = set(out["metrics"])
    if workload.endswith(".cg50"):
        assert {"convert_s", "capture_ms", "idle_pct.solve"} <= names
    else:
        assert {"convert_s", "idle_pct", "glue_pct",
                "product_roofline"} <= names
        assert 0 < out["metrics"]["product_roofline"]["value"] <= 100
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
