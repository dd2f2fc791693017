"""The port's command line: ``python -m singlespmv_tpu_torch bench`` and
``formats`` on the CPU.

``bench --device cpu --quick`` prints the report block and exits 0; it
exits 1 when Verify fails; ``--jsonl`` appends the report; ``--profiling``
adds the phase keys; argparse offers only the value types the port runs.
"""
import json
import os
import subprocess
import sys

import pytest

from singlespmv_tpu.core.mmio import write_matrix_market
from singlespmv_tpu.data.generators import powerlaw
from singlespmv_tpu_torch import cli
from singlespmv_tpu_torch.harness import driver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mtx(tmp_path):
    path = tmp_path / "pl600.mtx"
    write_matrix_market(str(path), powerlaw(600, 4000, seed=1))
    return str(path)


def _block(text):
    lines = text.splitlines()
    start = lines.index("+" * 40)
    return {ln.split("\t")[0].strip(): ln.split("\t")[1]
            for ln in lines[start + 1: lines.index("-" * 40, start)]}


def test_bench_prints_the_block(mtx, capsys):
    rc = cli.main(["bench", mtx, "--device", "cpu", "--quick",
                   "--format", "slab"])
    block = _block(capsys.readouterr().out)
    assert rc == 0
    assert block["Matrix"] == "pl600" and block["MatrixFormat"] == "slab" \
        .upper() and block["Verify"] == "PASS"
    assert block["Architecture"] == "CPU" and block["LoopCount"] == "3"


def test_bench_exits_1_on_a_failed_verify(mtx, capsys, monkeypatch):
    monkeypatch.setattr(driver, "verify_result", lambda *a, **k: (
        False, {"max_abs_err": 1.0, "max_rel_err": 1.0}))
    rc = cli.main(["bench", mtx, "--device", "cpu", "--quick"])
    assert rc == 1 and _block(capsys.readouterr().out)["Verify"] == "FAIL"
    assert cli.main(["bench", mtx, "--device", "cpu", "--quick",
                     "--no-verify"]) == 0


def test_bench_appends_jsonl_and_profiles(mtx, tmp_path, capsys):
    out = str(tmp_path / "runs.jsonl")
    for _ in range(2):
        assert cli.main(["bench", mtx, "--device", "cpu", "--quick",
                         "--format", "csr", "--profiling",
                         "--jsonl", out]) == 0
    rows = [json.loads(line) for line in open(out)]
    assert len(rows) == 2 and rows[0]["Matrix"] == "pl600"
    assert rows[0]["PhaseTime-Mul(s)"] > 0 and "SumPerf" in rows[0]
    assert "PhaseTime-Sum(s)" in _block(capsys.readouterr().out)


def test_bench_trace(mtx, tmp_path, capsys):
    trace = tmp_path / "trace"
    assert cli.main(["bench", mtx, "--device", "cpu", "--quick",
                     "--trace", str(trace)]) == 0
    assert [p.suffix for p in trace.iterdir()] == [".json"]


def test_only_the_ported_value_types(mtx, capsys):
    # bfloat16 SpMV is ported: the bench runs and verifies at it
    assert cli.main(["bench", mtx, "--dtype", "bfloat16", "--device", "cpu",
                     "--quick"]) == 0
    block = _block(capsys.readouterr().out)
    assert block["Dtype"] == "bfloat16" and block["Verify"] == "PASS"
    with pytest.raises(SystemExit):
        cli.main(["bench", mtx, "--dtype", "float16"])
    assert "invalid choice" in capsys.readouterr().err


def test_module_entry_lists_the_formats():
    out = subprocess.run(
        [sys.executable, "-m", "singlespmv_tpu_torch", "formats"],
        capture_output=True, text=True, cwd=REPO, check=True,
        env=dict(os.environ, PYTHONPATH=REPO)).stdout.split()
    assert {"auto", "csr", "slab", "xch", "hyb", "ss", "css"} <= set(out)
    assert "cache" not in out
