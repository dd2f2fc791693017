"""Port probes, plain path: ``singlespmv_tpu_torch.ops.probes`` on CPU
tensors against the reference's Pallas probes in interpret mode.

Each case runs one probe of ``singlespmv_tpu/harness/microbench.py`` at a
small size with its chained loop made one eager call (``_chained``,
``_time``) and ``pallas_call`` forced into interpret mode, captures the
Pallas call's own inputs and output, and feeds those inputs to the port's
plain version.  float32 outputs agree to 1e-5·max|out| (the one-hot route
and the accumulate sum in another order), bfloat16 ones exactly.  The
XLA-only probes' bodies are held against their torch counterparts the same
way, the staged slab probe (``scripts/probe_slab.py``) at every stage on the
units its steps visit, and ``PROBES`` against the reference's names and
arguments.
"""
import importlib.util
import os

import jax
import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from singlespmv_tpu.harness import microbench as ref_mb
from singlespmv_tpu_torch.harness import microbench, probe_slab
from singlespmv_tpu_torch.ops import probes

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_probe_slab():
    """The reference's ``scripts/probe_slab.py`` as a module (scripts/ is
    no package)."""
    spec = importlib.util.spec_from_file_location(
        "ref_probe_slab", os.path.join(REPO, "scripts", "probe_slab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def capture(monkeypatch):
    """Runs the reference's probes eagerly, once each, with every
    pallas_call in interpret mode; returns the list that collects
    {"args", "out"} per Pallas call and {"body", "carry", "consts"} per
    chained loop."""
    seen = []
    real = jpl.pallas_call

    def pallas_call(*a, **kw):
        call = real(*a, **(kw | {"interpret": True}))

        def run(*args):
            out = call(*args)
            seen.append({"args": [np.asarray(x) for x in args],
                         "out": np.asarray(out)})
            return out

        return run

    def chained(body):
        def run_n(carry, n, *consts):
            seen.append({"body": body, "carry": carry, "consts": consts})
            return body(carry, jax.numpy.float32(np.finfo(np.float32).tiny),
                        *consts)

        return run_n

    def once(run_n, carry, consts=(), **kw):
        run_n(carry, 1, *consts)
        return 1.0

    monkeypatch.setattr(jpl, "pallas_call", pallas_call)
    monkeypatch.setattr(ref_mb, "_chained", chained)
    monkeypatch.setattr(ref_mb, "_time", once)
    return seen


def _t(a):
    """A captured numpy array as a torch tensor (bfloat16 by its bits)."""
    a = np.array(a)              # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _same(got, want):
    assert got.shape == want.shape
    if want.dtype.name == "bfloat16":
        np.testing.assert_array_equal(_np(got), want.view(np.int16))
        return
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL * np.abs(want).max())


# probe of the reference, its small arguments, the port's plain version
# taking the Pallas call's inputs
BF16 = np.dtype("bfloat16")
CASES = {
    "lane_w128": (ref_mb.probe_lane_gather, dict(w=128, G=16),
                  lambda a: probes.lane_gather_ref(*a, table_rows=1)),
    "lane_w512": (ref_mb.probe_lane_gather, dict(w=512, G=64),
                  lambda a: probes.lane_gather_ref(*a, table_rows=1)),
    "lane_table8_w128": (ref_mb.probe_lane_gather,
                         dict(w=128, G=16, table_rows=0),
                         lambda a: probes.lane_gather_ref(*a, table_rows=0)),
    "lane_w1024_tab0": (ref_mb.probe_lane_gather,
                        dict(w=1024, G=128, table_rows=0),
                        lambda a: probes.lane_gather_ref(*a, table_rows=0)),
    "lane_w512_bf16": (ref_mb.probe_lane_gather,
                       dict(w=512, G=64, dtype=BF16),
                       lambda a: probes.lane_gather_ref(*a, table_rows=1)),
    "gather_8way": (ref_mb.probe_gather1024, dict(G=16, levels=8),
                    lambda a: probes.gather1024_ref(*a, levels=8)),
    "gather_2way": (ref_mb.probe_gather1024, dict(G=16, levels=2),
                    lambda a: probes.gather1024_ref(*a, levels=2)),
    "gather_16way_w1024": (ref_mb.probe_gather1024,
                           dict(G=128, levels=16, w=1024),
                           lambda a: probes.gather1024_ref(*a, levels=16)),
    "gather_8way_w4096": (ref_mb.probe_gather1024,
                          dict(G=256, levels=8, w=4096),
                          lambda a: probes.gather1024_ref(*a, levels=8)),
    "sublane_1024": (ref_mb.probe_sublane_gather, dict(G=16, rows=1024),
                     lambda a: probes.sublane_gather_ref(*a)),
    "sublane_8": (ref_mb.probe_sublane_gather, dict(G=16, rows=8),
                  lambda a: probes.sublane_gather_ref(*a)),
    "palette_w1024": (ref_mb.probe_palette_gather,
                      dict(w=1024, G=128, CBX=64),
                      lambda a: probes.palette_gather_ref(*a, per=1)),
    "palette_w512": (ref_mb.probe_palette_gather, dict(w=512, G=64, CBX=64),
                     lambda a: probes.palette_gather_ref(*a, per=1)),
    "palette_w1024_per8": (ref_mb.probe_palette_gather,
                           dict(w=1024, G=128, CBX=64, per=8),
                           lambda a: probes.palette_gather_ref(*a, per=8)),
    "pal2step_k1": (ref_mb.probe_pal2step, dict(w=512, G=64, CBX=64, K=1),
                    lambda a: probes.pal2step_ref(*a)),
    "pal2step_k3": (ref_mb.probe_pal2step, dict(w=256, G=32, CBX=64, K=3),
                    lambda a: probes.pal2step_ref(*a)),
    "onehot_inkernel": (ref_mb.probe_onehot_inkernel, dict(G=32),
                        lambda a: probes.onehot_bins_ref(*a)),
    "onehot_inkernel_g8": (ref_mb.probe_onehot_inkernel, dict(G=8),
                           lambda a: probes.onehot_bins_ref(*a)),
    "onehot_inkernel_g64": (ref_mb.probe_onehot_inkernel, dict(G=64),
                            lambda a: probes.onehot_bins_ref(*a)),
    "dynslice_accum": (ref_mb.probe_dynslice_accum, dict(T=64),
                       lambda a: probes.dynslice_accum_ref(*a)),
    "seg_scan": (ref_mb.probe_seg_scan, dict(G=32),
                 lambda a: probes.seg_scan_ref(*a, steps=7)),
    "seg_scan_roll_7": (ref_mb.probe_seg_scan_roll, dict(G=32, steps=7),
                        lambda a: probes.seg_scan_ref(*a, steps=7)),
    "seg_scan_roll_4": (ref_mb.probe_seg_scan_roll, dict(G=32, steps=4),
                        lambda a: probes.seg_scan_ref(*a, steps=4)),
    "seg_scan_roll_2": (ref_mb.probe_seg_scan_roll, dict(G=32, steps=2),
                        lambda a: probes.seg_scan_ref(*a, steps=2)),
    "tile_transpose": (ref_mb.probe_pallas_tile_transpose,
                       dict(CB=16, NU=24, S=128),
                       lambda a: probes.tile_transpose_ref(*a, 24, 128)),
    "tile_transpose_s4": (ref_mb.probe_pallas_tile_transpose,
                          dict(CB=8, NU=16, S=4),
                          lambda a: probes.tile_transpose_ref(*a, 16, 4)),
    "tile_transpose_s8": (ref_mb.probe_pallas_tile_transpose,
                          dict(CB=24, NU=8, S=8),
                          lambda a: probes.tile_transpose_ref(*a, 8, 8)),
    "tile_transpose_s32": (ref_mb.probe_pallas_tile_transpose,
                           dict(CB=16, NU=16, S=32),
                           lambda a: probes.tile_transpose_ref(*a, 16, 32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_probe_plain_version_matches_pallas(capture, case):
    probe, kw, plain = CASES[case]
    probe(**kw)
    calls = [c for c in capture if "args" in c]
    assert len(calls) == 1
    got = plain([_t(a) for a in calls[0]["args"]])
    _same(got, calls[0]["out"])


@pytest.mark.parametrize("cb,nu,s", [(5, 7, 1), (9, 3, 3), (1, 13, 3),
                                     (11, 16, 2)])
def test_transpose_plain_version_at_shapes_the_tpu_could_not_take(cb, nu, s):
    """S 1, 2 and 3, CB or NU not a multiple of 8: the plain version copies
    runs, which a strided view of the input checks."""
    a = torch.from_numpy(np.random.default_rng(cb).standard_normal(
        (cb, nu * s)).astype(np.float32))
    want = a.view(cb, nu, s).transpose(0, 1).reshape(nu, cb * s)
    assert torch.equal(probes.tile_transpose_ref(a, nu, s), want)
    assert torch.equal(probes.tile_transpose(a, nu, s), want)


@pytest.mark.parametrize("G", [8, 40])
def test_onehot_plain_version_matches_the_iota_compare(G):
    """A numpy copy of the TPU kernel's arithmetic: per (8, 128) tile the
    (8, 128, 128) one-hot of an iota compare, contracted with the tile's
    values; bins -1, 128 and 200 match no iota and add nowhere."""
    rng = np.random.default_rng(G)
    bins = rng.integers(0, 128, (G, 128)).astype(np.int32)
    bins.flat[rng.choice(G * 128, 3 * G, replace=False)] = np.repeat(
        [-1, 128, 200], G)
    val = rng.standard_normal((G, 128)).astype(np.float32)
    iota = np.arange(128)[None, None, :]
    want = np.empty((G, 128))
    for t in range(G // 8):
        oh = (bins[8 * t:8 * t + 8].reshape(8, 128, 1) == iota)
        r = val[8 * t:8 * t + 8].reshape(1, 1024).astype(np.float64) \
            @ oh.reshape(1024, 128)
        want[8 * t:8 * t + 8] = r
    got = probes.onehot_bins_ref(torch.from_numpy(bins),
                                 torch.from_numpy(val)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_probe_wrappers_on_the_cpu_run_the_plain_versions(capture):
    """On CPU tensors a wrapper returns its plain version's result and
    counts no launch."""
    for case, wrapper in (("lane_w512_bf16", probes.lane_gather),
                          ("palette_w1024_per8", probes.palette_gather),
                          ("pal2step_k3", probes.pal2step),
                          ("onehot_inkernel", probes.onehot_bins),
                          ("dynslice_accum", probes.dynslice_accum),
                          ("seg_scan_roll_4", probes.seg_scan_roll),
                          ("tile_transpose", probes.tile_transpose)):
        probe, kw, plain = CASES[case]
        capture.clear()
        probe(**kw)
        args = [_t(a) for a in [c for c in capture if "args" in c][0]["args"]]
        extra = {"lane_w512_bf16": (1,), "palette_w1024_per8": (8,),
                 "seg_scan_roll_4": (4,), "tile_transpose": (24, 128)}
        before = wrapper.launches
        got = wrapper(*args, *extra.get(case, ()))
        assert wrapper.launches == before
        assert torch.equal(got, plain(args))


def test_probe_wrappers_check_their_inputs():
    col = torch.zeros(16, 128, dtype=torch.int32)
    val = torch.ones(16, 128)
    x = torch.ones(8, 128)
    with pytest.raises(TypeError):
        probes.lane_gather(col, val.double(), x.double())
    with pytest.raises(TypeError):
        probes.lane_gather(col, val.bfloat16(), x.bfloat16())  # int16 col
    with pytest.raises(ValueError):
        probes.gather1024(col[:12], val[:12], x)               # 8 ∤ h
    with pytest.raises(ValueError):
        probes.palette_gather(torch.zeros(2, dtype=torch.int32), col, val,
                              x, per=3)
    with pytest.raises(ValueError):
        probes.tile_transpose(val, 3, 128)
    with pytest.raises(ValueError, match="cuda"):
        probes.seg_scan(col.to("meta"), val.to("meta"))
    with pytest.raises(ValueError, match="stage"):
        probes.slab_step(*(None,) * 8, 1, 16, "everything")


XLA_BODIES = {
    "stream": (ref_mb.probe_stream, dict(G=64),
               lambda c, tiny: microbench.stream_body(c, tiny)),
    "hbm_read": (ref_mb.probe_hbm_read, dict(G=64),
                 lambda c, tiny, a: microbench.hbm_read_body(c, tiny, a)),
    "xla_transpose": (ref_mb.probe_xla_transpose, dict(CB=8, NU=16, S=8),
                      microbench.xla_transpose_body(8, 16, 8)),
    "onehot_mxu": (ref_mb.probe_onehot_mxu, dict(G=64),
                   lambda c, tiny, oh: microbench.onehot_mxu_body(c, tiny,
                                                                  oh)),
}


@pytest.mark.parametrize("case", list(XLA_BODIES))
def test_xla_probe_bodies_match(capture, case):
    probe, kw, body = XLA_BODIES[case]
    probe(**kw)
    (loop,) = [c for c in capture if "body" in c]
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(loop["body"](loop["carry"], jax.numpy.float32(tiny),
                                   *loop["consts"]))
    got = body(_t(np.asarray(loop["carry"])), torch.tensor(tiny),
               *[_t(np.asarray(c)) for c in loop["consts"]])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _dtype_name(d):
    return str(d).replace("torch.", "")


def test_probes_are_the_references(monkeypatch):
    called = []
    for name in dir(ref_mb):
        if name.startswith("probe_"):
            monkeypatch.setattr(
                ref_mb, name,
                lambda *a, _n=name, **kw: called.append((_n, kw)) or (0, 1.0))
    for fn in ref_mb.PROBES.values():
        fn()
    assert list(microbench.PROBES) == list(ref_mb.PROBES)
    assert len(microbench.PROBES) == 35
    for (name, kw), (fn, port_kw) in zip(called, microbench.PROBES.values()):
        assert fn.__name__ == name
        norm = {k: _dtype_name(v) if k == "dtype" else v
                for k, v in kw.items()}
        assert {k: _dtype_name(v) if k == "dtype" else v
                for k, v in port_kw.items()} == norm


def test_kernel_cases_are_the_probes_calls(monkeypatch):
    """``KERNEL_CASES`` builds, for every probe of ``PROBES`` that times a
    kernel and for ``probe_pal2step``, the very call the probe times."""
    xla = {microbench.probe_stream, microbench.probe_hbm_read,
           microbench.probe_xla_transpose, microbench.probe_onehot_mxu}
    kernel_probes = {n for n, (fn, _) in microbench.PROBES.items()
                     if fn not in xla}
    assert set(microbench.KERNEL_CASES) == kernel_probes | {
        "pal2step_w1024_k1"}
    timed = []
    monkeypatch.setattr(microbench, "_time_kernel",
                        lambda case, *a, **kw: timed.append(case) or 1.0)
    probe_of = dict(microbench.PROBES,
                    pal2step_w1024_k1=(microbench.probe_pal2step, {}))
    for name, (case, ckw) in microbench.KERNEL_CASES.items():
        fn, kw = probe_of[name]
        fn(**kw, device="cpu")
        want_fn, want_args, want_kw = timed.pop()
        got_fn, got_args, got_kw = case(**ckw, device="cpu")
        assert got_fn is want_fn and got_kw == want_kw
        assert all(torch.equal(g, w) for g, w in zip(got_args, want_args))


def test_run_writes_the_references_columns(tmp_path):
    out = tmp_path / "micro.tsv"
    rows = microbench.run(["seg_scan_roll_2"], str(out), target_s=1e-4,
                          device="cpu", log=lambda m: None)
    assert [r[0] for r in rows] == ["seg_scan_roll_2"]
    lines = out.read_text().splitlines()
    assert lines[0].split("\t") == ["probe", "elements", "seconds",
                                    "Gelem_per_s"]
    name, elems, sec, rate = lines[1].split("\t")
    assert name == "seg_scan_roll_2" and int(elems) == 8192 * 128
    assert float(sec) > 0 and float(rate) > 0


@pytest.mark.parametrize("n", [1, 5, 70])
@pytest.mark.parametrize("body", ["stream", "hbm_read", "seg_scan"])
def test_chained_on_the_cpu_is_the_loop(body, n):
    """On the CPU ``chained`` runs the host loop: n calls, each output the
    next carry, equal to a loop written out (70 passes the card's chain of
    64 calls)."""
    rng = np.random.default_rng(n)
    carry = torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32))
    if body == "stream":
        fn, consts = microbench.stream_body, ()
    elif body == "hbm_read":
        fn = microbench.hbm_read_body
        consts = (torch.from_numpy(rng.standard_normal((256, 128)).astype(
            np.float32)),)
    else:
        heads = torch.from_numpy(rng.integers(0, 2, (64, 128)).astype(
            np.int32))

        def fn(c, tiny, heads):
            return probes.seg_scan(heads, c)

        consts = (heads,)
    tiny = torch.tensor(np.finfo(np.float32).tiny)
    want = carry
    for _ in range(n):
        want = fn(want, tiny, *consts)
    got = microbench.chained(fn)(carry, n, *consts)
    assert torch.equal(got, want)
    assert torch.equal(microbench.loop_chain(fn)(carry, n, *consts), want)


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        microbench.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_slab.main()


# ------------------------------------------------------------ probe_slab ---

@pytest.mark.parametrize("s8", [2, 8])
@pytest.mark.parametrize("stage", probes.STAGES)
def test_probe_slab_matches_pallas(monkeypatch, s8, stage):
    """n_steps 8, T 16, CB 64; units 1 and 4 of NU 5 are never visited and
    left out of the comparison (the TPU leaves them unwritten)."""
    ref = _ref_probe_slab()
    real = jpl.pallas_call
    monkeypatch.setattr(jpl, "pallas_call",
                        lambda *a, **kw: real(*a, **(kw | {"interpret": True})))
    n_steps, T, CB, NU = 8, 16, 64, 5
    rng = np.random.default_rng(s8)
    arrs = list(probe_slab.make_inputs(rng, n_steps, T, s8, CB, 4))
    arrs[0] = np.array([0, 0, 2, 2, 3, 3, 3, 3], np.int32)
    call, H = ref.make_call(n_steps, T, s8, CB, NU, np.float32, stage=stage)
    assert H == n_steps * T
    want = np.asarray(call(*arrs))
    pcall, _ = probe_slab.make_call(n_steps, T, s8, CB, NU, stage=stage)
    tens = [torch.from_numpy(a) for a in arrs]
    before = probes.slab_step.launches
    got = pcall(*tens).numpy()
    assert probes.slab_step.launches == before
    assert got.shape == want.shape == (NU * 8, 128)
    visited = np.repeat(np.isin(np.arange(NU), arrs[0]), 8)
    _same(torch.from_numpy(got[visited]), want[visited])
    assert not got[~visited].any()
