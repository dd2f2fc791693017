"""The plain reference against the program's products at a small size, and
its CG against a numpy CG; the structure generators against their sources."""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.program import Port
from benchmark.structures import kronecker, stencil27

from .tiny import BENCH


def _conf(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def web():
    conf = _conf("graph500-s20.csr5.f32") | {"name": "kron-ref", "scale": 10}
    return kronecker.build(conf, 11, "cpu")


@pytest.mark.parametrize("fmt", ["xch", "csr", "slab", "auto"])
@pytest.mark.parametrize("columns", [1, 5])
def test_reference_matches_the_ports_product(web, fmt, columns):
    """At float64 the port's product and the reference's agree to
    rounding, row by row in units of Σ|a_ij x_j| (1e-9: the CPU versions
    of slab's and xch's routes take run totals as differences of a stream
    row's prefix sums, whose rounding is the prefix's, not the row's), and
    the reference over the port's ``to_coo`` triplets is the reference
    over the benchmark's."""
    port = Port()
    cfg, state = port.convert(web, fmt=fmt, dtype="float64",
                              spmm_b=columns if columns > 1 else 0,
                              device=torch.device("cpu"))
    gen = torch.Generator().manual_seed(5)
    x = torch.rand((web.n_col, columns) if columns > 1 else (web.n_col,),
                   generator=gen, dtype=torch.float64) * 2 - 1
    y = port.product(cfg, columns)(state, x)
    op = reference.Operator(web, "cpu")
    assert reference.row_error(y, op.matvec(x), op.abs_sums(x)) < 1e-9
    coo = port.formats.to_coo(state, cfg)
    order = np.lexsort((coo.col, coo.row))
    back = reference.Matrix(coo.n_row, coo.n_col,
                            coo.row[order].astype(np.int64),
                            coo.col[order].astype(np.int64), coo.val[order])
    assert np.array_equal(back.val, web.val)
    assert torch.equal(reference.Operator(back, "cpu").matvec(x),
                       op.matvec(x))


def test_reference_cg_is_plain_cg():
    conf = _conf("hpcg-104.f64") | {"grid": [6, 5, 4]}
    m = stencil27.build(conf, 0, "cpu")
    a = np.zeros((m.n_row, m.n_col))
    a[m.row, m.col] = m.val
    b = np.linspace(-1.0, 1.0, m.n_row)
    x, r = np.zeros_like(b), b.copy()
    p, rz = r.copy(), r @ r
    for _ in range(7):
        ap = a @ p
        alpha = rz / (p @ ap)
        x, r = x + alpha * p, r - alpha * ap
        rz, rz_old = r @ r, rz
        p = r + rz / rz_old * p
    got = reference.cg(reference.Operator(m, "cpu"), torch.from_numpy(b), 7)
    assert np.allclose(got.numpy(), x, rtol=0, atol=1e-13)


def test_hpcg_operator_is_hpcgs():
    conf = _conf("hpcg-104.f64")
    small = conf | {"grid": [4, 3, 5]}
    m = stencil27.build(small, 0, "cpu")
    nx, ny, nz = small["grid"]
    assert m.nnz == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    key = m.row * m.n_col + m.col
    assert np.all(np.diff(key) > 0)
    assert np.all(m.val[m.row == m.col] == 26.0)
    assert np.all(m.val[m.row != m.col] == -1.0)
    # a row's neighbours are the grid's: |dx|, |dy|, |dz| <= 1
    pos = lambda i: np.stack([i % nx, i // nx % ny, i // (nx * ny)])
    assert np.abs(pos(m.row) - pos(m.col)).max() == 1
    # the configuration's counts are the full grid's
    g = conf["grid"]
    assert conf["nnz"] == np.prod([3 * n - 2 for n in g])
    assert conf["n_row"] == np.prod(g)


def test_kronecker_draws_are_graph500s():
    """Each bit of the generator's i is 1 with probability C + D, and of
    j with D / (C + D) where i's is 1 and B / (A + B) where it is 0
    (``kronecker_generator.m``)."""
    a, b, c = _conf("graph500-s20.csr5.f32")["initiator"]
    d = 1 - a - b - c
    gen = torch.Generator().manual_seed(3)
    i, j = kronecker.pairs(3, 400_000, (a, b, c), gen, "cpu")
    for bit in range(3):
        ib, jb = (i >> bit) & 1, (j >> bit) & 1
        assert abs(ib.double().mean() - (c + d)) < 0.005
        assert abs(jb[ib == 1].double().mean() - d / (c + d)) < 0.005
        assert abs(jb[ib == 0].double().mean() - b / (a + b)) < 0.005


def test_kronecker_matrix_is_the_undirected_graph():
    """The symmetric adjacency of the undirected graph, no self-loops and
    no duplicates, row-major; one weight an edge at (i, j) and (j, i),
    from the run's seed, in [0, 1) and exact in the value type; the edges
    from the configuration alone."""
    conf = _conf("graph500-s20.csr5.f32") | {"name": "kron-test", "scale": 9}
    m = kronecker.build(conf, 7, "cpu")
    n = 1 << 9
    assert m.n_row == m.n_col == n and m.nnz % 2 == 0 and m.nnz > 4 * n
    key = m.row * n + m.col
    assert np.all(np.diff(key) > 0) and np.all(m.row != m.col)
    tkey = m.col * n + m.row
    back = np.argsort(tkey)
    assert np.array_equal(tkey[back], key)
    assert np.array_equal(m.val[back], m.val)
    assert np.all((m.val >= 0) & (m.val < 1))
    assert np.array_equal(m.val, m.val.astype(np.float32))
    other = kronecker.build(conf, 8, "cpu")
    assert np.array_equal(other.row, m.row) and np.array_equal(
        other.col, m.col)
    assert not np.array_equal(other.val, m.val)
