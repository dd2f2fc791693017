"""The yardstick: the CSR-minimum bytes read the same whatever format holds
the matrix, and the kernel names come from the program's sources."""
import numpy as np
import pytest
import torch

from benchmark import yardstick
from benchmark.program import CSRC, Port
from benchmark.structures import kronecker

FORMATS = ["csr", "coo", "ell", "xch", "slab", "ss", "css", "bkt", "dia",
           "hyb", "jds", "csr5"]


@pytest.fixture(scope="module")
def web():
    conf = {"name": "kron-test", "scale": 10, "edgefactor": 16,
            "initiator": [0.57, 0.19, 0.19], "structure_seed": 0,
            "dtype": "float32"}
    return kronecker.build(conf, 3, "cpu")


def test_csr_min_bytes_by_hand():
    # 10 nonzeros, 4 rows, 5 columns, float64, B 2
    assert yardstick.csr_min_bytes(4, 5, 10, "float64", 2) == (
        10 * 12 + 5 * 4 + (5 + 4) * 8 * 2)
    assert yardstick.csr_min_bytes(4, 5, 10, "float32") == (
        10 * 8 + 5 * 4 + (5 + 4) * 4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_bytes_are_the_same_for_every_format(web, fmt):
    port = Port()
    cfg, state = port.convert(web, fmt=fmt, dtype="float32", spmm_b=0,
                              device=torch.device("cpu"))
    coo = port.formats.to_coo(state, cfg)
    key = np.sort(coo.row.astype(np.int64) * web.n_col + coo.col)
    assert np.array_equal(key, web.row * web.n_col + web.col)
    for b in (1, 8):
        assert yardstick.csr_min_bytes(coo.n_row, coo.n_col, coo.nnz,
                                       "float32", b) == \
            yardstick.csr_min_bytes(web.n_row, web.n_col, web.nnz,
                                    "float32", b)


def test_kernel_names_are_the_sources_globals():
    names = yardstick.kernel_names(CSRC)
    assert {"xch_route4_rows_kernel", "xch_route4_rows_merge_kernel",
            "xch_mul_panel_kernel", "xch_route4_panel_kernel",
            "slab_rows_kernel", "probe_slab_kernel"} <= names
    assert yardstick.kernel_of(
        "void xch_route4_rows_kernel<StreamGather<double>, short>"
        "(int, double const*)") == "xch_route4_rows_kernel"
    assert yardstick.kernel_of(
        "void (anonymous namespace)::xch_route4_rows_kernel<(anonymous "
        "namespace)::StreamGather<float>, short>(int)") == \
        "xch_route4_rows_kernel"
    assert yardstick.kernel_of(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>>(int)") == "vectorized_elementwise_kernel"


def test_peaks_of_the_card():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] \
        == 3.35e12
    assert yardstick.peaks("a card the table lacks") is None
