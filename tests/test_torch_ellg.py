"""The port's ellg against the JAX package's.

``convert`` gives the reference's passes array for array (members, lane,
src, val, blocks and every scalar) and the same rest, on cases that
between them plan one and several members a row (m = 1 and m > 1), full
and non-full levels, several x panels (``X_BLOCKS`` cut to 4 col-blocks
in both packages) and a bkt_g and a csr rest.  The spmv agrees with the
reference's spmv (its Pallas ``block_gather_mul`` in interpret mode) to
1e-6·max|y| and passes the float64 COO oracle (1e-6 abs-or-rel).  auto
never offers ellg, and float64 is refused, as the reference's ellg refuses
it (bfloat16 runs: ``tests/test_torch_bf16.py``).
"""
import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu import formats as ref_formats
from singlespmv_tpu.config import Config
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate
from singlespmv_tpu.formats import ellg as ref_ellg
from singlespmv_tpu_torch.core.oracle import verify_result
from singlespmv_tpu_torch.formats import auto, ellg
from singlespmv_tpu_torch.ops import bucket
from torch_parity import port_cfg, port_coo

TOL = 1e-6
CFG = Config(format="ellg")


def local_rows(n=3000, per_row=5, width=60, seed=0):
    """Light local rows, the class ellg was built for."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), per_row)
    c = np.clip(r + rng.integers(-width, width + 1, r.size), 0, n - 1)
    return COOMatrix.from_triplets(n, n, r, c, rng.uniform(-1, 1, r.size),
                                   sort=True, sum_duplicates=True)


def mixed_tail(n=1000, seed=4):
    """A local body and a few heavy rows: levels of m 2 and of m 1, the
    later ones not full, and a bkt_g rest."""
    rng = np.random.default_rng(seed)
    base = local_rows(n, 4, 40, seed=seed)
    hr = np.repeat(rng.choice(n, 4, replace=False), 600)
    hc = rng.integers(0, n, hr.size)
    return COOMatrix.from_triplets(
        n, n, np.concatenate([base.row, hr]), np.concatenate([base.col, hc]),
        np.concatenate([base.val, rng.uniform(-1, 1, hr.size)]), sort=True,
        sum_duplicates=True)


def with_empty_rows(seed=5):
    """Odd rows empty: a csr rest."""
    rng = np.random.default_rng(seed)
    n = 600
    r = rng.integers(0, n // 2, 1500) * 2
    c = np.clip(r + rng.integers(-30, 31, r.size), 0, n - 1)
    return COOMatrix.from_triplets(n, n, r, c, rng.uniform(size=r.size),
                                   sort=True, sum_duplicates=True)


CASES = {
    "tail": mixed_tail,
    "band": lambda: generate("band", 700, 9, seed=1),
    "empty-rows": with_empty_rows,
    "local": lambda: local_rows(800, 4, 30, seed=9),
    "panels": lambda: local_rows(2000, 5, 400, seed=3),
}
SPMV_CASES = ("tail", "band")   # the reference's spmv in interpret mode


@pytest.fixture
def panels(request, monkeypatch):
    """Cuts the x panel to 4 col-blocks in both packages for "panels"."""
    if request.node.callspec.params["label"] == "panels":
        monkeypatch.setattr(ref_ellg, "X_BLOCKS", 4)
        monkeypatch.setattr(ellg, "X_BLOCKS", 4)


def _x(coo):
    return np.random.default_rng(3).uniform(-1, 1, coo.n_col).astype(
        np.float32)


def _arr(a):
    return None if a is None else np.asarray(a)


def _convert_both(coo):
    return ref_formats.convert(coo, CFG), ellg.convert(port_coo(coo),
                                                       port_cfg(CFG))


@pytest.mark.parametrize("label", sorted(CASES))
def test_convert_matches_reference(label, panels):
    coo = CASES[label]()
    ref, st = _convert_both(coo)
    for k in ("n_row", "n_col", "nnz", "rest_fmt", "rest_nnz", "n_slots",
              "n_levels"):
        assert getattr(st, k) == getattr(ref, k), k
    assert len(st.passes) == len(ref.passes) > 0
    for p, q in zip(st.passes, ref.passes):
        for k in ("t", "m", "n_blocks", "panel_base", "panel_cb", "full"):
            assert getattr(p, k) == getattr(q, k), k
        for k in ("members", "lane", "src", "val", "blocks"):
            want = _arr(getattr(q, k))
            got = getattr(p, k)
            if want is None:
                assert got is None, k
            else:
                assert got.numpy().dtype == want.dtype, k
                np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    assert ellg.report_fields(st, port_cfg(CFG)) == \
        ref_ellg.report_fields(ref, CFG)
    assert ellg.traffic_bytes(st, port_cfg(CFG)) == \
        ref_ellg.traffic_bytes(ref, CFG)
    x = _x(coo)
    y = ellg.spmv(st, torch.from_numpy(x)).numpy()
    ok, det = verify_result(port_coo(coo), x, y, dtype=np.float32)
    assert ok, det
    back = ellg.to_coo(st)
    np.testing.assert_allclose(back.to_dense(), coo.to_dense(), rtol=1e-6,
                               atol=1e-7)


def test_cases_cover_the_plans():
    """Between them: m = 1 and m > 1, a non-full level, several panels,
    a bkt_g and a csr rest."""
    states = {k: ellg.convert(port_coo(f()), port_cfg(CFG))
              for k, f in CASES.items() if k != "panels"}
    tail = states["tail"]
    assert {p.m for p in tail.passes} >= {1, 2}
    assert not all(p.full for p in tail.passes)
    assert tail.rest_fmt == "bkt_g"
    assert states["empty-rows"].rest_fmt == "csr"
    assert all(p.m == 1 and p.src is None for p in states["band"].passes)


@pytest.mark.parametrize("label", SPMV_CASES)
def test_spmv_matches_reference(label):
    coo = CASES[label]()
    ref, st = _convert_both(coo)
    x = _x(coo)
    want = np.asarray(jax.jit(ref_formats.spmv_fn(CFG))(ref, x))
    got = ellg.spmv(st, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())
    # the reference's state, carried over, gives the same y
    carried = ellg.state_from_reference(_reference_arrays(ref))
    assert torch.equal(ellg.spmv(carried, torch.from_numpy(x)),
                       torch.from_numpy(got))


def _reference_arrays(st):
    """A reference ELLGState as numpy arrays and scalars, as
    state_from_reference takes it."""
    import dataclasses

    def host(obj):
        if dataclasses.is_dataclass(obj):
            return {f.name: host(getattr(obj, f.name))
                    for f in dataclasses.fields(obj)}
        if isinstance(obj, tuple):
            return tuple(host(v) for v in obj)
        return np.asarray(obj) if hasattr(obj, "shape") else obj

    return host(st)


def test_to_moves_every_pass():
    """``state.to`` moves the tensors of every pass and of the rest; a
    pass's missing src and blocks stay None."""
    st = ellg.convert(port_coo(CASES["tail"]()), port_cfg(CFG))
    moved = st.to("meta")
    for p, q in zip(moved.passes, st.passes):
        for k in ("members", "lane", "src", "val", "blocks"):
            if getattr(q, k) is None:
                assert getattr(p, k) is None, k
            else:
                assert getattr(p, k).device.type == "meta", k
    assert moved.rest_state.val.device.type == "meta"


def test_spmm_is_the_column_loop():
    coo = CASES["local"]()
    st = ellg.convert(port_coo(coo), port_cfg(CFG))
    X = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (coo.n_col, 3)).astype(np.float32))
    Y = ellg.spmm(st, X)
    for b in range(3):
        assert torch.equal(Y[:, b], ellg.spmv(st, X[:, b].contiguous()))


def test_auto_withholds_ellg():
    coo = port_coo(local_rows(50000, 3, 120, seed=8))
    costs = auto.estimate_costs(coo, port_cfg(Config(dtype="float32")))
    assert "ellg" not in costs and "slab" in costs


def test_float64_is_refused():
    coo = port_coo(CASES["band"]())
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        ellg.convert(coo, port_cfg(CFG.replace(dtype="float64")))
    st = ellg.convert(coo, port_cfg(CFG))
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        ellg.spmv(st, torch.zeros(coo.n_col, dtype=torch.float64))


def test_stage_a_takes_no_src_at_one_member():
    """At m = 1 ``block_gather_mul`` takes src None (the kernel gets a null
    pointer) and gives what a zero src plane gives; at m > 1 it needs
    src."""
    rng = np.random.default_rng(0)
    h, w, cb = 8, 1024, 6
    lane = torch.from_numpy(rng.integers(0, 128, (h, w)).astype(np.int8))
    val = torch.from_numpy(rng.uniform(-1, 1, (h, w)).astype(np.float32))
    xt = torch.from_numpy(rng.uniform(-1, 1, (cb, 128)).astype(np.float32))
    mem = torch.from_numpy(rng.integers(0, cb, h * w // 128).astype(np.int32))
    got = bucket.block_gather_mul(mem, lane, None, val, xt, 1, gran=128)
    zeros = torch.zeros(h, w, dtype=torch.int8)
    assert torch.equal(got, bucket.block_gather_mul(mem, lane, zeros, val,
                                                    xt, 1, gran=128))
    with pytest.raises(ValueError, match="needs src"):
        bucket.block_gather_mul(mem.repeat(2), lane, None, val, xt, 2,
                                gran=128)
