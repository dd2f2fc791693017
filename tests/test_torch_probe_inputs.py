"""Port probes at inputs the probes never make: the plain versions of
``dynslice_accum``, ``sublane_gather`` and the bfloat16 ``lane_gather``
against the reference's Pallas kernels in interpret mode, and the model of
the accumulate kernel's order of sums (``dynslice_accum_chunks_ref``)
against the plain version.

Each case runs one probe of ``singlespmv_tpu/harness/microbench.py`` once,
eagerly, with ``pallas_call`` in interpret mode, keeps the Pallas kernel,
its arguments and the call built from them, and calls it again on inputs of
its own: offs unsorted, all equal, under 0 and past rows − 8 (the clamp of
a dynamic slice), T 1 and 3, y of 16 rows (the reference's kernel built at
that out shape); idx on the first and the last row of x.  float32 sums
agree to 1e-5·max|out| (another order of adds), the gathers exactly.
"""
import jax
import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from singlespmv_tpu.harness import microbench as ref_mb
from singlespmv_tpu_torch.ops import probes

TOL = 1e-5
LANES = 128
BF16 = np.dtype("bfloat16")


@pytest.fixture
def pallas(monkeypatch):
    """Runs the reference's probes eagerly, once each, with every
    pallas_call in interpret mode; returns the list that collects
    {"kernel", "kw", "call", "args", "out"} per Pallas call."""
    seen = []
    real = jpl.pallas_call

    def pallas_call(kernel, **kw):
        kw = kw | {"interpret": True}
        call = real(kernel, **kw)

        def run(*args):
            out = call(*args)
            seen.append({"kernel": kernel, "kw": kw, "call": call,
                         "args": [np.asarray(x) for x in args],
                         "out": np.asarray(out)})
            return out

        return run

    monkeypatch.setattr(jpl, "pallas_call", pallas_call)
    monkeypatch.setattr(ref_mb, "_chained", lambda body: (
        lambda carry, n, *consts: body(
            carry, jax.numpy.float32(np.finfo(np.float32).tiny), *consts)))
    monkeypatch.setattr(ref_mb, "_time",
                        lambda run_n, carry, consts=(), **kw: (
                            run_n(carry, 1, *consts), 1.0)[1])
    return seen


def _close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL * np.abs(want).max())


# --------------------------------------------------------- dynslice_accum --

def dyn_offs(kind: str, rows: int, T: int = 64) -> np.ndarray:
    """offs of the accumulate's odd inputs at y of ``rows``."""
    rng = np.random.default_rng(rows + T)
    sorted_ = np.sort(rng.integers(0, rows - 7, T))
    return {"sorted": sorted_,
            "permuted": rng.permutation(sorted_),
            "equal": np.full(T, (rows - 8) // 2),
            "clamped": rng.integers(-64, rows + 76, T),
            "T1": rng.integers(-64, rows + 76, 1),
            "T3": np.array([rows + 5, -3, rows // 2]),
            }[kind].astype(np.int32)


DYN_KINDS = ("sorted", "permuted", "equal", "clamped", "T1", "T3")


def _dyn_inputs(kind, rows):
    offs = dyn_offs(kind, rows)
    v = np.random.default_rng(len(offs)).standard_normal(
        (8 * len(offs), LANES)).astype(np.float32)
    return offs, v


@pytest.mark.parametrize("rows", [16, 1024])
@pytest.mark.parametrize("kind", DYN_KINDS)
def test_dynslice_plain_version_matches_pallas(pallas, kind, rows):
    """The reference's kernel, built at T steps and, at rows 16, at an out
    of 16 rows (its own shape is 1,024), on offs it never draws."""
    offs, v = _dyn_inputs(kind, rows)
    ref_mb.probe_dynslice_accum(T=len(offs))
    (rec,) = pallas
    kw = rec["kw"] | {"out_shape": jax.ShapeDtypeStruct((rows, LANES),
                                                        np.float32)}
    want = jpl.pallas_call(rec["kernel"], **kw)(offs, v)
    got = probes.dynslice_accum_ref(torch.from_numpy(offs),
                                    torch.from_numpy(v), rows)
    _close(got, want)
    assert torch.equal(probes.dynslice_accum(torch.from_numpy(offs),
                                             torch.from_numpy(v), rows), got)


@pytest.mark.parametrize("chunk", [1, 16, 64])
@pytest.mark.parametrize("rows", [16, 1024])
@pytest.mark.parametrize("kind", DYN_KINDS)
def test_dynslice_chunk_model_matches_plain_version(kind, rows, chunk):
    """The kernel's window of 8 rows and its flush rule add every step into
    y once, whatever the offs."""
    offs, v = _dyn_inputs(kind, rows)
    offs, v = torch.from_numpy(offs), torch.from_numpy(v)
    got, added = probes.dynslice_accum_chunks_ref(offs, v, rows, chunk)
    _close(got, probes.dynslice_accum_ref(offs, v, rows))
    runs = -(-len(offs) // chunk)
    assert 8 * runs <= added <= 8 * len(offs)


def test_dynslice_chunk_model_adds_each_row_once_a_chunk_on_sorted_offs():
    """The probe's sorted offs: a run of steps adds each row it touches
    once, rows first off … last off + 7, fewer rows than there are steps
    (one add an element before)."""
    offs = torch.from_numpy(np.sort(np.random.default_rng(6).integers(
        0, 1016, 4096)).astype(np.int32))
    v = torch.ones(8 * 4096, LANES)
    _, added = probes.dynslice_accum_chunks_ref(offs, v, 1024, 16)
    spans = offs.view(-1, 16)
    assert added == int((spans[:, -1] - spans[:, 0] + 8).sum())
    assert added < 4096


# --------------------------------------------------------- sublane_gather --

@pytest.mark.parametrize("where", ["first", "last", "both"])
@pytest.mark.parametrize("rows", [8, 64, 1024])
def test_sublane_plain_version_matches_pallas(pallas, rows, where):
    """idx on the first row of x, on its last, and on both in turn (lane
    parity), at small G."""
    ref_mb.probe_sublane_gather(G=16, rows=rows)
    (rec,) = pallas
    rng = np.random.default_rng(rows)
    idx = rng.integers(0, rows, (16, LANES)).astype(np.int32)
    first = {"first": [0], "last": [rows - 1], "both": [0, rows - 1]}[where]
    idx[:8] = np.resize(first, (8, LANES))
    val = rng.standard_normal((16, LANES)).astype(np.float32)
    x = rng.standard_normal((rows, LANES)).astype(np.float32)
    want = np.asarray(rec["call"](idx, val, x))
    got = probes.sublane_gather_ref(*map(torch.from_numpy, (idx, val, x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got[:8].numpy(), val[:8] * x[np.resize(first, (8, LANES)),
                                     np.arange(LANES)])


# ------------------------------------------------- lane_gather, bfloat16 --

@pytest.mark.parametrize("w,table_rows", [(128, 1), (1024, 1), (128, 0),
                                          (1024, 0)])
def test_lane_gather_bf16_plain_version_matches_pallas(pallas, w,
                                                       table_rows):
    """bfloat16 with int16 col at widths and tables the probes run only in
    float32: each product rounded once, so exact."""
    ref_mb.probe_lane_gather(w=w, G=w // 8, dtype=BF16,
                             table_rows=table_rows)
    (rec,) = pallas
    args = [torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
            if a.dtype == BF16 else torch.from_numpy(np.array(a))
            for a in rec["args"]]
    got = probes.lane_gather_ref(*args, table_rows=table_rows)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  rec["out"].view(np.int16))
