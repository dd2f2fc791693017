"""Port bkt, csr, dense and bsr formats against the reference's.

bkt: the port's ``estimate`` and ``convert`` are copies of the reference's,
so one COO gives the same plan and equal arrays; its spmv (the plain
versions of the bucket kernels on the CPU) agrees with the reference's spmv
on CPU JAX to 1e-5·max|y| and passes the float64 oracle; ``to_coo`` gives the
matrix back; float64 is refused, as the reference's bkt refuses it on its
chip.  csr, dense and bsr are plain torch in the port, as they are XLA in
the reference: equal layouts, the same y to 1e-5·max|y| (float32) and
1e-12·max|y| (float64), the same reports.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from singlespmv_tpu.config import Config
from singlespmv_tpu.core import verify_result
from singlespmv_tpu.core.oracle import reference_spmv
from singlespmv_tpu.core.types import COOMatrix
from singlespmv_tpu.data.generators import generate, powerlaw
from singlespmv_tpu.formats import base as ref_base
from singlespmv_tpu.formats import bkt as ref_bkt
from singlespmv_tpu.formats import bsr as ref_bsr
from singlespmv_tpu.formats import csr as ref_csr
from singlespmv_tpu.formats import dense as ref_dense
from singlespmv_tpu_torch import formats
from singlespmv_tpu_torch.formats import bkt, bsr, csr, dense
from test_torch_bkt_ops import _scattered
from torch_parity import port_cfg, port_coo

TOL = {"float32": 1e-5, "float64": 1e-12}
BKT_ARRAYS = ("members", "mem_tab", "lane", "src", "val", "hm1", "idx",
              "lo_a", "src_lane", "src_chunk")
BKT_META = ("n_row", "n_col", "nnz", "rb_pad", "cb", "g_tot", "s", "g", "k",
            "m", "n_slots", "n_ghost", "balanced", "row_group", "n_chunks")


def _x(n, dtype, seed=3):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(dtype)


def _close(got, want, dtype):
    assert got.dtype == np.dtype(dtype) and got.shape == want.shape
    assert np.abs(got - want).max() <= TOL[dtype] * np.abs(want).max()


BKT = [
    ("powerlaw-ru1", lambda: powerlaw(3000, 30000, seed=2), 128, True),
    ("scatter-ru1-unbalanced", lambda: _scattered(3000, 30000, 7), 128,
     False),
    # ~230 nonzeros per 128 × 128 bucket: S = 256, two stream rows a bucket
    ("deep-ru1-unbalanced", lambda: _scattered(2000, 60000, 9), 128, False),
    ("powerlaw-ru8", lambda: powerlaw(3000, 30000, seed=2), 1024, True),
    ("scatter-ru8-m4", lambda: _scattered(9000, 18000, 5), 1024, True),
    ("scatter-ru8-m4-unbalanced", lambda: _scattered(9000, 18000, 5), 1024,
     False),
    ("band-ru8", lambda: generate("band", 2500, 8, seed=1), 1024, True),
]


def _bkt_cfg(rg, bal, fmt="bkt"):
    return Config(format=fmt, bkt_row_group=rg, bkt_balance=bal)


@pytest.mark.parametrize("label,make,rg,bal", BKT, ids=[b[0] for b in BKT])
def test_bkt_matches_reference(label, make, rg, bal):
    coo, cfg = make(), _bkt_cfg(rg, bal)
    pcoo, pcfg = port_coo(coo), port_cfg(cfg)
    assert bkt.estimate(pcoo, pcfg) == ref_bkt.estimate(coo, cfg)
    ref, port = ref_bkt.convert(coo, cfg), bkt.convert(pcoo, pcfg)
    for k in BKT_META:
        assert getattr(port, k) == getattr(ref, k), k
    for k in BKT_ARRAYS:
        want = np.asarray(getattr(ref, k))
        got = getattr(port, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    if label == "deep-ru1-unbalanced":
        assert port.s > 128 and not port.balanced
    x = _x(coo.n_col, np.float32)
    y = bkt.spmv(port, torch.from_numpy(x)).numpy()
    _close(y, np.asarray(jax.jit(ref_bkt.spmv)(ref, x)), "float32")
    ok, det = verify_result(coo, x, y, dtype=np.float32)
    assert ok, det
    carried = bkt.state_from_reference(
        {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})
    np.testing.assert_array_equal(
        bkt.spmv(carried, torch.from_numpy(x)).numpy(), y)
    assert formats.report_fields(port, pcfg) == ref_bkt.report_fields(ref,
                                                                      cfg)
    assert formats.traffic_bytes(port, pcfg) == ref_bkt.traffic_bytes(ref,
                                                                      cfg)
    back = formats.to_coo(port, pcfg)
    np.testing.assert_allclose(back.to_dense(), coo.to_dense(), rtol=1e-6)


def test_bkt_refuses_float64_and_what_the_reference_refuses():
    coo = powerlaw(1500, 9000, seed=4)
    with pytest.raises(TypeError, match="float32"):
        bkt.convert(port_coo(coo), port_cfg(Config(dtype="float64")))
    st = bkt.convert(port_coo(coo), port_cfg(Config()))
    with pytest.raises(TypeError, match="float32"):
        bkt.spmv(st, torch.zeros(coo.n_col, dtype=torch.float64))
    # too hyper-sparse for dense bucketing: both refuse with ValueError
    thin = _scattered(9000, 18000, 5)
    cfg = _bkt_cfg(128, True)
    with pytest.raises(ValueError, match="PAD_LIMIT"):
        ref_bkt.convert(thin, cfg)
    with pytest.raises(ValueError, match="PAD_LIMIT"):
        bkt.convert(port_coo(thin), port_cfg(cfg))
    with pytest.raises(ValueError, match="128 or 1024"):
        bkt.convert(port_coo(coo), port_cfg(_bkt_cfg(256, True)))


def test_bkt_state_moves_to_a_device():
    st = bkt.convert(port_coo(powerlaw(1500, 9000, seed=4)),
                     port_cfg(_bkt_cfg(1024, True)))
    meta = st.to("meta")
    assert meta.idx.device.type == "meta" and meta.src_lane.device.type \
        == "meta"
    assert meta.idx.dtype == torch.int16 and meta.k == st.k


PLAIN = [
    ("csr", ref_csr, csr), ("dense", ref_dense, dense), ("bsr", ref_bsr, bsr),
]
PLAIN_MATS = [
    ("band", lambda: generate("band", 700, 6, seed=1)),
    ("powerlaw", lambda: powerlaw(900, 6000, seed=3)),
    ("rect", lambda: generate("random", 600, 5000, seed=5)),
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fmt,ref_mod,mod", PLAIN, ids=[p[0] for p in PLAIN])
def test_plain_formats_match_reference(fmt, ref_mod, mod, dtype):
    for _, make in PLAIN_MATS:
        coo = make()
        cfg = Config(format=fmt, dtype=dtype)
        pcfg = port_cfg(cfg)
        ref, port = ref_mod.convert(coo, cfg), mod.convert(port_coo(coo),
                                                           pcfg)
        for f in dataclasses.fields(port):
            want = getattr(ref, f.name)
            got = getattr(port, f.name)
            if isinstance(got, torch.Tensor):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                              err_msg=f.name)
                assert got.numpy().dtype == np.asarray(want).dtype, f.name
            else:
                assert got == want, f.name
        x = _x(coo.n_col, dtype)
        y = mod.spmv(port, torch.from_numpy(x)).numpy()
        _close(y, np.asarray(jax.jit(ref_mod.spmv)(ref, x)), dtype)
        want = reference_spmv(coo, x)
        assert np.abs(y - want).max() <= TOL[dtype] * np.abs(want).max()
        assert formats.report_fields(port, pcfg) == \
            ref_base.report_fields(ref, cfg)
        assert formats.traffic_bytes(port, pcfg) == \
            ref_base.traffic_bytes(ref, cfg)
        back = formats.to_coo(port, pcfg)
        np.testing.assert_array_equal(back.to_dense(),
                                      coo.to_dense().astype(dtype))


def test_plain_format_guards():
    coo = _scattered(9000, 18000, 5)
    with pytest.raises(ValueError, match="block storage"):
        bsr.convert(port_coo(coo), port_cfg(Config()))
    big = COOMatrix.from_triplets(20000, 20000, [0], [0], [1.0])
    with pytest.raises(ValueError, match="density guard"):
        dense.convert(port_coo(big), port_cfg(Config()))
    with pytest.raises(NotImplementedError, match="float16 is not"):
        csr.convert(port_coo(coo), port_cfg(Config(dtype="float16")))
    # bfloat16 is ported: csr converts it and verifies
    sb = csr.convert(port_coo(coo), port_cfg(Config(dtype="bfloat16")))
    x = np.random.default_rng(0).uniform(size=coo.n_col)
    yb = csr.spmv(sb, torch.from_numpy(x).to(torch.bfloat16))
    assert sb.val.dtype == yb.dtype == torch.bfloat16
    assert verify_result(coo, x, yb.float().numpy(), dtype="bfloat16")[0]
    empty = COOMatrix.from_triplets(50, 40, [], [], [])
    st = csr.convert(port_coo(empty), port_cfg(Config()))
    y = csr.spmv(st, torch.ones(40))
    assert y.shape == (50,) and not y.any()
