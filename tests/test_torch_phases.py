"""The port's profiling phases and scan steps against the JAX package's on
the same inputs: csr's Mul/Sum, xch's Mul/Sum, ss's Mul/Sum1/Sum2, css's
MulScan/Sum2 and ss's ``step_fns``.

Each phase of the port gets the input the reference's phase got (the
reference's output of the phase before), so a phase is held alone.  The
reference runs its Pallas kernels in interpret mode, the port the kernels'
plain versions; they agree to rtol 1e-5 with atol 1e-5·max|out| in float32
(the port sums prefixes and run totals in another order).  The port's
phases compose to its ``spmv``.  On an xch state with a peeled diagonal
both packages leave the peel out of the phases (ROADMAP C.10): Mul then Sum
plus ``_dia_part`` is the spmv.
"""
import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import powerlaw
from singlespmv_tpu.formats import csr as ref_csr
from singlespmv_tpu.formats import css as ref_css
from singlespmv_tpu.formats import ss as ref_ss
from singlespmv_tpu.formats import xch as ref_xch
from singlespmv_tpu_torch.formats import csr, css, ss, xch
from torch_parity import port_cfg, port_coo

RTOL = 1e-5


def _scattered(n, nnz, seed, diag=False):
    """Uniformly scattered entries (an xch state with no long-row state);
    with ``diag`` a full diagonal, which xch peels."""
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    if diag:
        r = np.concatenate([np.arange(n), r])
        c = np.concatenate([np.arange(n), c])
    return COOMatrix.from_triplets(n, n, r, c, rng.uniform(0.1, 1.0, len(r)),
                                   sort=True, sum_duplicates=True)


def _x(coo, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, coo.n_col).astype(
        np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _run_phases(ref_phases, port_phases, ref_state, port_state, x):
    """Each phase of both packages on the reference's input of that phase;
    returns the port's outputs, chained on its own outputs, and the
    reference's last output."""
    assert list(ref_phases) == list(port_phases)
    cur = x
    for name in ref_phases:
        want = jax.jit(ref_phases[name])(ref_state, cur)
        got = port_phases[name](port_state, _t(cur))
        _close(got.numpy(), want)
        cur = np.asarray(want)
    return cur


CSR_MATS = [("powerlaw", lambda: powerlaw(2000, 12000, seed=3)),
            ("scattered", lambda: _scattered(1500, 6000, 4))]


@pytest.mark.parametrize("label,make", CSR_MATS)
def test_csr_phases_match_the_reference(label, make):
    coo = make()
    cfg = Config(format="csr")
    ref_state = ref_csr.convert(coo, cfg)
    st = csr.convert(port_coo(coo), port_cfg(cfg))
    x = _x(coo)
    _run_phases(ref_csr.phases(ref_state), csr.phases(st), ref_state, st, x)
    y = csr.reduce(st, csr.mul(st, _t(x)))
    assert torch.equal(y, csr.spmv(st, _t(x)))


SCAN = {"ss": (ss, ref_ss), "css": (css, ref_css)}


@pytest.mark.parametrize("seed", [3, 5])
@pytest.mark.parametrize("fmt", sorted(SCAN))
def test_scan_phases_match_the_reference(fmt, seed):
    mod, ref = SCAN[fmt]
    coo = powerlaw(2000, 12000, seed=seed)
    cfg = Config(format=fmt, segment_width=256)
    ref_state = ref.convert(coo, cfg)
    st = mod.convert(port_coo(coo), port_cfg(cfg))
    x = _x(coo)
    names = list(mod.phases(st))
    assert names == (["Mul", "Sum1", "Sum2"] if fmt == "ss"
                     else ["MulScan", "Sum2"])
    _run_phases(ref.phases(ref_state), mod.phases(st), ref_state, st, x)
    cur = _t(x)
    for fn in mod.phases(st).values():
        cur = fn(st, cur)
    assert torch.equal(cur, mod.spmv(st, _t(x)))


def _xch_states(coo):
    cfg = Config(format="xch")
    return (ref_xch.convert(coo, cfg),
            xch.convert(port_coo(coo), port_cfg(cfg)))


@pytest.mark.parametrize("seed", [1, 2])
def test_xch_phases_match_the_reference(seed):
    coo = _scattered(4000, 16000, seed)
    ref_state, st = _xch_states(coo)
    assert st.long is None and st.dia_vals is None and st.n_slots1
    x = _x(coo)
    y = _run_phases(ref_xch.phases(ref_state), xch.phases(st), ref_state, st,
                    x)
    ph = xch.phases(st)
    got = ph["Sum"](st, ph["Mul"](st, _t(x)))
    assert torch.equal(got, xch.spmv(st, _t(x)))
    _close(got.numpy(), y)


def test_xch_phases_leave_out_the_peel_on_both_sides():
    coo = _scattered(4000, 16000, 1, diag=True)
    ref_state, st = _xch_states(coo)
    assert st.dia_vals is not None and st.long is None
    x = _x(coo)
    ref_y = _run_phases(ref_xch.phases(ref_state), xch.phases(st), ref_state,
                        st, x)
    ph = xch.phases(st)
    got = ph["Sum"](st, ph["Mul"](st, _t(x)))
    peel = xch._dia_part(st, _t(x))
    full = xch.spmv(st, _t(x))
    # the phases miss the peel, as the reference's do (C.10)
    assert float((full - got).abs().max()) > 0.1 * float(full.abs().max())
    _close((got + peel).numpy(), full.numpy())
    ref_full = np.asarray(jax.jit(ref_xch.spmv)(ref_state, x))
    ref_peel = np.asarray(jax.jit(ref_xch._dia_part)(ref_state, x))
    _close(ref_y + ref_peel, ref_full)
    _close(peel.numpy(), ref_peel)


def test_xch_with_a_long_row_state_has_no_phases():
    from test_torch_xch_ops import long_rows_matrix

    ref_state, st = _xch_states(long_rows_matrix())
    assert st.long is not None
    assert xch.phases(st) is None and ref_xch.phases(ref_state) is None


@pytest.mark.parametrize("width", [128, 512])
def test_ss_steps_match_the_reference_step_by_step(width):
    coo = powerlaw(2000, 12000, seed=6)
    cfg = Config(format="ss", segment_width=width)
    ref_state = ref_ss.convert(coo, cfg)
    st = ss.convert(port_coo(coo), port_cfg(cfg))
    x = _x(coo)
    want = np.asarray(jax.jit(ref_ss.step_init)(ref_state, x))
    got = ss.step_init(st, _t(x))
    _close(got.numpy(), want)
    ref_steps, steps = ref_ss.step_fns(ref_state), ss.step_fns(st)
    assert [n for n, _ in steps] == [n for n, _ in ref_steps]
    assert len(steps) == st.n_step
    for (name, fn), (_, ref_fn) in zip(steps, ref_steps):
        got = fn(st, _t(want))           # each step on the reference's carry
        want = np.asarray(jax.jit(ref_fn)(ref_state, want))
        _close(got.numpy(), want)
    # the last step's values are the Sum1 scan of both packages
    scanned = ss.scan(st, ss.mul(st, _t(x)))
    _close(scanned.numpy(), want[0])
    ref_scanned = np.asarray(jax.jit(ref_ss.scan)(
        ref_state, jax.jit(ref_ss.mul)(ref_state, x)))
    _close(want[0], ref_scanned)


def test_css_steps_are_ss_steps():
    assert css.step_init is ss.step_init and css.step_fns is ss.step_fns
