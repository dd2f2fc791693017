"""The port's campaign layer against the JAX package's: the log formatter
(``parse_blocks``, ``format_logs`` in Python and native, ``sum_gflops``),
the sweep (its todo table, idempotence and manifest resume), the suite
(``run_suite`` over tiny .mtx files named as suite matrices,
``summarize``), the headline's JSON line, the CLI's subcommands on the
CPU, and the data tools (fixtures, ``structure_metrics``, the spy plot,
``extract_mtx``).  Nothing full-size is synthesized: the suite reads
.mtx files under suite names.
"""
import ast
import io
import json
import os
import tarfile

import numpy as np
import pytest

from singlespmv_tpu.core.mmio import write_matrix_market
from singlespmv_tpu.data import fixtures as ref_fx
from singlespmv_tpu.data import suitesparse as ref_ss
from singlespmv_tpu.data import tools as ref_tools
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.harness import logfmt as ref_logfmt
from singlespmv_tpu.harness import report as ref_report
from singlespmv_tpu.harness import suite as ref_suite
from singlespmv_tpu.harness import sweep as ref_sweep
from singlespmv_tpu_torch import bench, cli
from singlespmv_tpu_torch.config import Config
from singlespmv_tpu_torch.core import native
from singlespmv_tpu_torch.data import fixtures, suitesparse, tools
from singlespmv_tpu_torch.harness import calibrate, logfmt, report, suite
from singlespmv_tpu_torch.harness import sweep
from singlespmv_tpu_torch.harness.driver import run_benchmark
from torch_parity import port_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log_text():
    """Report blocks of three runs, out of nnz order, with noise between
    them and one block with a key the defaults lack."""
    blocks = []
    for name, n, fmt in (("b", 900, "csr"), ("a", 300, "coo"),
                         ("c", 600, "ell")):
        coo = port_coo(powerlaw(n, 4 * n, seed=n))
        res = run_benchmark(coo, Config(format=fmt), name=name, quick=True,
                            device="cpu", log=lambda m: None)
        blocks.append(res.block)
    return "noise line\n" + "\nbetween\n".join(blocks) + "\n"


@pytest.fixture(scope="module")
def log_text():
    return _log_text()


def test_parse_blocks_is_the_reference(log_text):
    got = report.parse_blocks(log_text)
    assert got == ref_report.parse_blocks(log_text)
    assert [b["Matrix"] for b in got] == ["b", "a", "c"]


@pytest.mark.parametrize("keys", [None, ["MatrixFormat", "Verify", "K"]])
def test_format_logs_native_and_python_agree(log_text, keys):
    assert native.format_logs("", []) is not None     # the library built
    py = logfmt.format_logs(log_text, keys, use_native=False)
    nat = logfmt.format_logs(log_text, keys)
    assert nat == py
    assert py == ref_logfmt.format_logs(log_text, keys, use_native=False)
    rows = py.splitlines()
    assert rows[0].split("\t")[:7] == logfmt.DEFAULT_KEYS
    assert [r.split("\t")[0] for r in rows[1:]] == ["a", "c", "b"]  # nnz


def test_sum_gflops(log_text):
    total = sum(float(b["Performance(GFLOPS)"])
                for b in report.parse_blocks(log_text))
    assert logfmt.sum_gflops(log_text) == pytest.approx(total, rel=1e-12)
    assert logfmt.sum_gflops(log_text) == ref_logfmt.sum_gflops(log_text)


def test_todo_table_is_the_reference():
    assert sweep.default_todo() == ref_sweep.default_todo()
    rows = sweep.parse_todo(sweep.default_todo())
    assert rows == ref_sweep.parse_todo(ref_sweep.default_todo())
    for row in rows:
        want = ref_sweep.config_from_row(row)
        assert sweep.config_from_row(row).__dict__ == want.__dict__


@pytest.fixture
def mtx_dir(tmp_path):
    d = tmp_path / "mtx"
    d.mkdir()
    for name, n in (("raefsky3", 300), ("lhr34", 200)):
        write_matrix_market(str(d / f"{name}.mtx"),
                            powerlaw(n, 6 * n, seed=n))
    return d


def test_sweep_is_idempotent_and_resumes(mtx_dir, tmp_path):
    todo = "prefix,format,sigma\ncrs,csr,\ncoo,coo,\ncsr5-s4,csr5,4\n"
    mats = sorted(str(p) for p in mtx_dir.iterdir())
    out = tmp_path / "log"
    run = lambda: sweep.run_sweep(todo, mats, str(out), quick=True,  # noqa
                                  device="cpu", log=lambda m: None)
    assert run() == 0
    manifest = json.loads((out / "manifest.json").read_text())
    assert sorted(manifest) == sorted(
        f"{p}::{n}" for p in ("crs", "coo", "csr5-s4")
        for n in ("lhr34", "raefsky3"))
    assert set(manifest.values()) == {"done"}
    blocks = report.parse_blocks((out / "coo.log").read_text())
    assert [b["MatrixFormat"] for b in blocks] == ["COO", "COO"]
    assert len((out / "csr5-s4.jsonl").read_text().splitlines()) == 2
    assert run() == 0                                  # nothing to do
    assert len(report.parse_blocks((out / "coo.log").read_text())) == 2
    del manifest["coo::lhr34"]                         # resume one pair
    (out / "manifest.json").write_text(json.dumps(manifest))
    assert run() == 0
    blocks = report.parse_blocks((out / "coo.log").read_text())
    assert [b["Matrix"] for b in blocks] == ["lhr34", "raefsky3", "lhr34"]
    assert len(report.parse_blocks((out / "crs.log").read_text())) == 2


def test_run_suite_and_summarize(mtx_dir, tmp_path):
    out = str(tmp_path / "suite.tsv")
    kw = dict(cfg=Config(format="csr", calibrate_seconds=0.002,
                         n_trials=2), matrix_dir=str(mtx_dir), out=out,
              device="cpu", log=lambda m: None)
    rows = suite.run_suite(["raefsky3", "lhr34"], **kw)
    assert [r["Matrix"] for r in rows] == ["raefsky3", "lhr34"]
    assert all(r["Verify"] == "PASS" and r["ChosenFormat"] == "CRS"
               for r in rows)
    assert rows[0]["BaselineGFLOPS"] == ref_suite.BASELINE_AVX2["raefsky3"]
    assert suite.BASELINE_AVX2 == ref_suite.BASELINE_AVX2
    assert suite.TSV_COLS == ref_suite.TSV_COLS
    assert suite.summarize(rows) == ref_suite.summarize(rows)
    # a matrix that raises gets an ERROR row and the campaign goes on; an
    # appended run skips the rows the TSV holds
    more = suite.run_suite(["raefsky3", "lhr34", "torso1"], append=True,
                           synth=lambda n, s: 1 / 0, **kw)
    assert [r["Matrix"] for r in more] == ["synth-torso1"]
    assert more[0]["Verify"] == "ERROR:ZeroDivisionError"
    table = suite.read_tsv(out)
    assert [r["Matrix"] for r in table] == ["raefsky3", "lhr34",
                                            "synth-torso1"]
    assert table[0]["GFLOPS"] == rows[0]["GFLOPS"]
    assert suite.summarize(table)["n"] == 3
    assert suite.suite_order()[:2] == ["g7jac200sc", "lhr34"]


def _bench_py_keys():
    """The keys of the JSON line that the root bench.py prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "line":
            return [k.value for k in node.value.keys]
    raise AssertionError("no JSON line in bench.py")


def test_headline_prints_bench_py_keys(monkeypatch, capsys, tmp_path):
    rows = [{"Matrix": "synth-raefsky3", "GFLOPS": 44.39,
             "ChosenFormat": "SLAB"},
            {"Matrix": "synth-lhr34", "GFLOPS": 4.25,
             "ChosenFormat": "XCH"},
            {"Matrix": "synth-torso1", "GFLOPS": "", "ChosenFormat": ""}]
    seen = {}

    def fake_run_suite(names, **kw):
        seen.update(kw, names=names)
        return rows

    monkeypatch.setattr(suite, "run_suite", fake_run_suite)
    assert bench.main(["--names", "torso1", "raefsky3", "lhr34",
                       "--device", "cpu", "--prefetch", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == _bench_py_keys()
    assert line["metric"] == "natural_suite_full26_median_vs_csr5avx2"
    assert seen["names"] == ["lhr34", "raefsky3", "torso1"]   # nnz order
    cfg = seen["cfg"]
    assert (cfg.format, cfg.dtype, cfg.calibrate_seconds, cfg.n_trials) == (
        "auto", "float32", 0.4, 5)
    assert seen["device"] == "cpu"
    assert line["detail"] == {"raefsky3": 44.39, "lhr34": 4.25,
                              "torso1": 0.0}
    assert line["chosen_format"] == {"raefsky3": "SLAB", "lhr34": "XCH",
                                     "torso1": "ERROR"}
    lhr = round(4.25 / 17.075, 3)
    assert line["per_matrix_ratio"] == {"raefsky3": 2.0, "lhr34": lhr,
                                        "torso1": 0.0}
    assert (line["wins"], line["losses"]) == (1, 2)
    assert line["vs_baseline"] == lhr and line["value"] == 4.25


def _mtx(tmp_path, coo, name="m"):
    path = str(tmp_path / f"{name}.mtx")
    write_matrix_market(path, coo)
    return path


def test_cli_info_spy_gen(tmp_path, capsys):
    path = _mtx(tmp_path, ref_fx.fixture_10x10())
    assert cli.main(["info", path]) == 0
    out = capsys.readouterr().out
    assert "empty_rows\t3" in out and "row_max\t8" in out
    assert cli.main(["spy", path, "--size", "5"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "% 10 x 10, nnz=27" and len(out) == 6
    gen = str(tmp_path / "band.mtx")
    assert cli.main(["gen", "band", "64", "5", "--seed", "1",
                     "--out", gen]) == 0
    from singlespmv_tpu_torch.core.mmio import read_matrix_market

    got = read_matrix_market(gen)
    want = generate("band", 64, 5, seed=1)
    assert got.nnz == want.nnz and np.array_equal(got.col, want.col)


def test_cli_format_logs(tmp_path, capsys, log_text):
    path = tmp_path / "run.log"
    path.write_text(log_text)
    assert cli.main(["format-logs", str(path), "--keys", "Verify"]) == 0
    assert capsys.readouterr().out.strip() == logfmt.format_logs(
        log_text, ["Verify"])
    assert cli.main(["format-logs", str(path), "--sum"]) == 0
    assert float(capsys.readouterr().out) == pytest.approx(
        logfmt.sum_gflops(log_text), rel=1e-6)


def test_cli_confirm_all_pass(capsys):
    assert cli.main(["confirm", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.strip().endswith("confirm: ALL PASS")
    ran = {ln.split()[0] for ln in out.splitlines()[:-1]}
    assert ran == {"auto", "bcoo", "bkt", "bsr", "coo", "csr", "csr5", "css",
                   "dense", "dia", "ell", "ellg", "hostlib", "hyb", "jds",
                   "mkl", "slab", "ss", "xch"}
    assert len(out.splitlines()) == 19 * 8 + 1


def test_cli_confirm_fails_on_a_failure(capsys, monkeypatch):
    from singlespmv_tpu_torch.harness import driver

    monkeypatch.setattr(driver, "verify_result", lambda *a, **k: (
        False, {"max_abs_err": 1.0, "max_rel_err": 1.0}))
    assert cli.main(["confirm", "--device", "cpu", "--formats", "coo"]) == 1
    assert "8 FAILURES" in capsys.readouterr().out


def test_cli_suite(tmp_path, capsys):
    assert cli.main(["suite", "test", "--out", str(tmp_path / "t")]) == 0
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        f"{n}.mtx" for n in fixtures.ALL_FIXTURES)
    assert cli.main(["suite", "artificial", "--sizes", "64",
                     "--out", str(tmp_path / "a")]) == 0
    assert sorted(os.listdir(tmp_path / "a")) == [
        "band-64.mtx", "dense-64.mtx", "random-64.mtx", "unbalance-64.mtx"]
    capsys.readouterr()
    assert cli.main(["suite", "natural", "--out", str(tmp_path / "n")]) == 2
    assert "not ported" in capsys.readouterr().err
    assert not (tmp_path / "n").exists()


def test_cli_sweep_and_calibrate(tmp_path, mtx_dir, monkeypatch):
    import torch

    mats = sorted(str(p) for p in mtx_dir.iterdir())
    out = tmp_path / "log"
    assert cli.main(["sweep", "--todo", "prefix,format\nell,ell\n",
                     "--matrices", *mats, "--out", str(out), "--quick",
                     "--device", "cpu"]) == 0
    assert len(report.parse_blocks((out / "ell.log").read_text())) == 2
    vals = {"hbm_bps": 3.0e12, "step_fixed_s": 1e-7, "base_slot_s": 1e-11,
            "sel_slot_s": 7e-13, "route_slot_s": 1e-12,
            "scatter_rate": 1.0e11}
    monkeypatch.setattr(calibrate, "device_of", lambda d: torch.device("cpu"))
    monkeypatch.setattr(calibrate, "measure", lambda device: vals)
    cal = tmp_path / "c.json"
    assert cli.main(["calibrate", "--out", str(cal)]) == 0
    assert json.loads(cal.read_text()) == vals


def test_fixtures_and_tools_are_the_reference():
    assert list(fixtures.ALL_FIXTURES) == list(ref_fx.ALL_FIXTURES)
    mats = [fixtures.ALL_FIXTURES[n]() for n in fixtures.ALL_FIXTURES]
    for name, got in zip(fixtures.ALL_FIXTURES, mats):
        want = ref_fx.ALL_FIXTURES[name]()
        assert (got.n_row, got.n_col) == (want.n_row, want.n_col), name
        for k in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for coo in mats + [port_coo(powerlaw(800, 6000, seed=1)),
                       port_coo(generate("band", 500, 9, seed=2))]:
        assert tools.structure_metrics(coo) == \
            ref_tools.structure_metrics(coo)
        assert tools.spy_plot(coo, size=12) == ref_tools.spy_plot(coo, 12)


def test_fixtures_write_all(tmp_path):
    fixtures.write_all(str(tmp_path))
    from singlespmv_tpu_torch.core.mmio import read_matrix_market

    got = read_matrix_market(str(tmp_path / "rect_wide.mtx"))
    assert (got.n_row, got.n_col, got.nnz) == (8, 32, 7)


def test_suitesparse_extract_and_shapes(tmp_path):
    assert suitesparse.NATURAL_SUITE == ref_ss.NATURAL_SUITE
    assert suitesparse.PUBLISHED_SHAPES == ref_ss.PUBLISHED_SHAPES
    body = open(_mtx(tmp_path, ref_fx.fixture_5x5(), "lhr34"), "rb").read()
    tar_path = tmp_path / "lhr34.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        info = tarfile.TarInfo("lhr34/lhr34.mtx")
        info.size = len(body)
        tf.addfile(info, io.BytesIO(body))
    dest = tmp_path / "out"
    dest.mkdir()
    got = suitesparse.extract_mtx(str(tar_path), str(dest))
    assert got == str(dest / "lhr34.mtx")
    assert open(got, "rb").read() == body
    with pytest.raises(KeyError):
        suitesparse.synthesize("not-a-suite-matrix", structured=False)
