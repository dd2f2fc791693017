"""Port calibration kernels on the card: ``xch_route`` and the probe kernels
of ``ops/probes.py`` against their plain versions, at the shapes that
``harness/calibrate``, ``harness/microbench`` and ``harness/probe_slab``
give them, each counting its launch.

Needs an NVIDIA GPU and skips without one.  This file imports no jax, so it
runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_probes.py

float32 kernels agree with their plain versions to 1e-5·max|out| (prefix
sums by warp shuffles, accumulation with atomics in run-dependent order);
``slab_step`` and ``xch_route`` also at chunks of rows that split units
over blocks (``probes.unit_rows`` forced), at units that the wrappers'
sizes never give;
the bfloat16 lane gather and the gathers without sums agree exactly, on
the probes' inputs and on odd ones (sublane tables of every size, inputs
off 16 bytes through the C entry, the accumulate's offs in any order and
past both ends of y).
"""
import numpy as np
import pytest
import torch

from singlespmv_tpu_torch.harness import calibrate, driver, microbench
from singlespmv_tpu_torch.harness import probe_slab
from singlespmv_tpu_torch.ops import _build, probes
from singlespmv_tpu_torch.ops import xch as ops

pytestmark = pytest.mark.cuda

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _close(got, want, exact=False):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.is_cuda
    if exact:
        assert torch.equal(got, want)
        return
    scale = float(want.abs().max())
    assert scale > 0
    assert float((got - want).abs().max()) <= TOL * scale


def _launched(wrapper, *args, **kw):
    before = wrapper.launches
    out = wrapper(*args, **kw)
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("planes", [8, 16])
def test_xch_route_on_calibrate_args(cuda, planes):
    a, ngb = calibrate._route_args(np.random.default_rng(0), 16 * 1024,
                                   planes, 1, 64, device=cuda)
    got = _launched(ops.xch_route, *a, ngb, 1, planes, 64)
    _close(got, ops.xch_route_ref(*a, ngb, 1, planes, 64))


def test_xch_route_prunes_by_groups(cuda):
    a, _ = calibrate._route_args(np.random.default_rng(1), 4096, 16, 8, 32,
                                 device=cuda)
    n_steps = a[0].shape[0]
    rng = np.random.default_rng(2)
    a[1] = (a[0] // 2).contiguous()
    ngb = int(a[1][-1]) + 1
    a[3] = torch.from_numpy(rng.integers(-2, 18, n_steps).astype(
        np.int32)).to(cuda)
    a[4] = torch.from_numpy(rng.integers(-2, 18, n_steps).astype(
        np.int32)).to(cuda)
    got = _launched(ops.xch_route, *a, ngb, 8, 16, 32, 2, 4)
    _close(got, ops.xch_route_ref(*a, ngb, 8, 16, 32, 2, 4))


@pytest.mark.parametrize("name", list(microbench.KERNEL_CASES))
def test_probe_kernel_at_its_probes_shapes(cuda, name):
    case, kw = microbench.KERNEL_CASES[name]
    fn, args, fkw = case(**kw, device=cuda)
    got = _launched(fn, *args, **fkw)
    want = getattr(probes, fn.__name__ + "_ref")(*args, **fkw)
    sums = fn in (probes.onehot_bins, probes.dynslice_accum)
    _close(got, want, exact=not sums)


@pytest.mark.parametrize("cb,nu,s,offset", [
    (13, 11, 3, 0), (40, 24, 1, 0), (9, 300, 12, 0), (3, 5, 4, 0),
    (17, 9, 8, 1), (24, 40, 128, 1), (256, 256, 128, 0)])
def test_transpose_at_any_shape(cuda, cb, nu, s, offset):
    """S not a multiple of 4, CB and NU not multiples of 8 (partial
    bricks), and inputs one float past 16 bytes: the kernel's scalar path;
    a copy, so exact."""
    a = torch.from_numpy(np.random.default_rng(cb).standard_normal(
        cb * nu * s + offset).astype(np.float32)).to(cuda)[offset:]
    a = a.view(cb, nu * s)
    assert a.data_ptr() % 16 == 4 * offset
    got = _launched(probes.tile_transpose, a, nu, s)
    _close(got, probes.tile_transpose_ref(a, nu, s), exact=True)
    _close(got, a.view(cb, nu, s).transpose(0, 1).reshape(nu, cb * s),
           exact=True)


@pytest.mark.parametrize("G,lo,hi", [(8, 0, 128), (8, -8, 200),
                                     (8192, -8, 200), (64, 0, 3),
                                     (8192, 0, 16)])
def test_onehot_bins_any_bins(cuda, G, lo, hi):
    """One tile, bins outside [0, 128) (which add nowhere), and bins that
    pile onto 16 or 3 (the lanes left after the bidding rounds summed by the
    shuffle tree)."""
    rng = np.random.default_rng(G + hi)
    bins = torch.from_numpy(rng.integers(lo, hi, (G, 128)).astype(
        np.int32)).to(cuda)
    val = torch.from_numpy(rng.standard_normal((G, 128)).astype(
        np.float32)).to(cuda)
    _close(_launched(probes.onehot_bins, bins, val),
           probes.onehot_bins_ref(bins, val))


def test_onehot_bins_refuses_misaligned_inputs(cuda):
    bins = torch.zeros(8 * 128 + 1, dtype=torch.int32, device=cuda)[1:]
    val = torch.zeros(8, 128, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.onehot_bins(bins.view(8, 128), val)


def _events_a_call(fn, match=""):
    """Device events (kernels, memsets, copies) whose name holds ``match``
    in one call of ``fn``, from a complete trace of three calls."""
    for _ in range(3):
        counts, _ = driver.device_trace(fn, match, 3)
        if driver.trace_refusal(counts, 3) is None:
            return counts[0]
    pytest.fail("no complete trace in three")


def _dyn_case(cuda, kind, rows, T):
    rng = np.random.default_rng(rows + T)
    sorted_ = np.sort(rng.integers(0, rows - 7, T))
    offs = {"sorted": sorted_, "permuted": rng.permutation(sorted_),
            "equal": np.full(T, (rows - 8) // 2),
            "clamped": rng.integers(-64, rows + 76, T),
            "negative": rng.integers(-2 * rows, 0, T)}[kind]
    v = rng.standard_normal((8 * T, 128)).astype(np.float32)
    return (torch.from_numpy(offs.astype(np.int32)).to(cuda),
            torch.from_numpy(v).to(cuda))


@pytest.mark.parametrize("T", [1, 3, 300, 4096])
@pytest.mark.parametrize("rows", [16, 1024])
@pytest.mark.parametrize("kind", ["sorted", "permuted", "equal", "clamped",
                                  "negative"])
def test_dynslice_any_offs(cuda, kind, rows, T):
    """Offs sorted (the probe's), permuted, all equal, past both ends of y
    and negative (counted from y's end, then clamped); T 1 and 3, and T 300
    (a last run of 12 steps: a bulk copy of 8 and one of 4).  Held to the
    plain version and to the model of the kernel's sums, whose order it
    shares but for the adds into y."""
    offs, v = _dyn_case(cuda, kind, rows, T)
    got = _launched(probes.dynslice_accum, offs, v, rows)
    _close(got, probes.dynslice_accum_ref(offs, v, rows))
    model, _ = probes.dynslice_accum_chunks_ref(offs.cpu(), v.cpu(), rows)
    _close(got, model.to(cuda))


def test_dynslice_one_kernel_a_call(cuda):
    """y's zeroing and one kernel; v off 16 bytes is refused."""
    offs, v = _dyn_case(cuda, "sorted", 1024, 4096)
    call = lambda: probes.dynslice_accum(offs, v)  # noqa: E731
    assert _events_a_call(call) == 2
    assert _events_a_call(call, "dynslice") == 1
    bad = torch.zeros(8 * 128 + 1, device=cuda)[1:].view(8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.dynslice_accum(offs[:1], bad)


# (x rows, G): the whole table (rows ≤ 128), slices of every row (rows ≤
# 1,816), device memory past that; G not a multiple of the blocks' rows
SUBLANE_SHAPES = [(8, 8192), (64, 8192), (128, 296), (129, 296),
                  (1000, 296), (1024, 8192), (1816, 296), (1817, 296),
                  (3000, 8)]


@pytest.mark.parametrize("rows,G", SUBLANE_SHAPES)
def test_sublane_gather_any_table(cuda, rows, G):
    """idx on x's first and last rows in the first tile, at random
    elsewhere; exact (one product an element)."""
    rng = np.random.default_rng(rows + G)
    idx = rng.integers(0, rows, (G, 128)).astype(np.int32)
    idx[:8] = np.resize([0, rows - 1], (8, 128))
    val = rng.standard_normal((G, 128)).astype(np.float32)
    x = rng.standard_normal((rows, 128)).astype(np.float32)
    idx, val, x = (torch.from_numpy(a).to(cuda) for a in (idx, val, x))
    got = _launched(probes.sublane_gather, idx, val, x)
    _close(got, probes.sublane_gather_ref(idx, val, x), exact=True)


@pytest.mark.parametrize("name", [
    "lane_gather_w128", "lane_gather_w512_bf16", "gather8way_w1024",
    "palette_w1024_per8", "pal2step_w1024_k1", "sublane_gather_1024",
    "sublane_gather_64", "sublane_gather_8"])
def test_gather_one_kernel_a_call(cuda, name):
    case, kw = microbench.KERNEL_CASES[name]
    fn, args, fkw = case(**kw, device=cuda)
    assert _events_a_call(lambda: fn(*args, **fkw)) == 1


def _off_by_one(t):
    """A copy of ``t`` one element past 16 bytes."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    flat.copy_(t.reshape(-1))
    return flat.view(t.shape)


@pytest.mark.parametrize("name", [
    "lane_gather_w128", "lane_gather_w512_bf16", "lane_gather_w1024_tab0",
    "gather8way_w1024", "palette_w1024_per8", "pal2step_w1024_k1",
    "sublane_gather_1024", "sublane_gather_64"])
def test_gather_scalar_path_off_16_bytes(cuda, name):
    """The wrappers refuse col, val or x off 16 bytes; the C entry takes
    them, one element a thread (the sublane table staged by elements)."""
    case, kw = microbench.KERNEL_CASES[name]
    fn, args, fkw = case(**kw, device=cuda)
    want = getattr(probes, fn.__name__ + "_ref")(*args, **fkw)
    at = {"palette_gather": 1, "pal2step": 1}.get(fn.__name__, 0)
    odd = list(args)
    odd[at] = _off_by_one(args[at])          # col (idx)
    odd[at + 1] = _off_by_one(args[at + 1])  # val
    odd[-1] = _off_by_one(args[-1])          # x
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(*odd, **fkw)
    col, val, x = odd[at], odd[at + 1], odd[-1]
    out = _off_by_one(torch.zeros_like(want))
    blk = sub = sel = None
    kind, a, b = {"lane_gather": (0, int(fkw.get("table_rows", 1) == 1), 0),
                  "gather1024": (1, fkw.get("levels", 8), 0),
                  "sublane_gather": (4, x.shape[0], 0)}.get(fn.__name__,
                                                           (None, 0, 0))
    if fn is probes.palette_gather:
        blk, per = args[0], fkw.get("per", 1)
        kind, a, b = 2, 8 * col.shape[1] // 128 // per, per
    elif fn is probes.pal2step:
        blk, sub, sel = args[0], args[3], _off_by_one(args[4])
        kind, a, b = 3, 8 * col.shape[1] // 128, sub.shape[0]
    entry = "probe_gather_bf16" if val.dtype == torch.bfloat16 \
        else "probe_gather_f32"
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = getattr(_build.load(), entry)(
        *map(ptr, (col, val, x, blk, sub, sel, out)), out.numel(),
        col.shape[1], kind, a, b, torch.cuda.current_stream(cuda).cuda_stream)
    assert rc == 0
    _close(out, want, exact=True)


def test_pal2step_three_planes(cuda):
    fn, args, _ = microbench.pal2step_case(w=512, K=3, device=cuda)
    _close(_launched(fn, *args), probes.pal2step_ref(*args), exact=True)


def _slab_step_case(cuda, T, s8, stage):
    n_steps = 3200 // (T // 8)
    arrs = probe_slab.make_inputs(np.random.default_rng(7), n_steps, T, s8,
                                  probe_slab.CB, probe_slab.NU)
    tens = [torch.from_numpy(a).to(cuda) for a in arrs]
    got = _launched(probes.slab_step, *tens, probe_slab.NU, T, stage)
    _close(got, probes.slab_step_ref(*tens, probe_slab.NU, T, stage))


@pytest.mark.parametrize("s8", [2, 8])
@pytest.mark.parametrize("stage", probes.STAGES)
def test_probe_slab_stages(cuda, s8, stage):
    _slab_step_case(cuda, 32, s8, stage)


@pytest.mark.parametrize("T,s8,stage", probe_slab.ROWS)
def test_probe_slab_rows(cuda, T, s8, stage):
    """probe_slab.main's rows: at T 16 a warp holds two rows, at T 64 two
    blocks of one step add into the same unit block."""
    _slab_step_case(cuda, T, s8, stage)


def test_launchers_refuse_bad_ranges(cuda):
    lib = _build.load()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # uids .. out | H T m planes pg p1 n_out R
    assert lib.xch_route_f32(*[None] * 11, 64, 64, 1, 65, 8, 64, 1, 64,
                             stream) != 0               # planes past 64
    assert lib.xch_route_f32(*[None] * 11, 96, 64, 1, 8, 8, 64, 1, 64,
                             stream) != 0               # H % T
    assert lib.xch_route_f32(*[None] * 11, 128, 64, 1, 8, 8, 64, 1, 96,
                             stream) != 0               # R % T
    # uids .. out | H T S8 NU stage R
    assert lib.probe_slab_f32(*[None] * 9, 64, 32, 9, 1, 0, 32,
                              stream) != 0              # S8 past 8
    assert lib.probe_slab_f32(*[None] * 9, 64, 32, 8, 1, 7, 32,
                              stream) != 0              # no such stage
    assert lib.probe_slab_f32(*[None] * 9, 64, 32, 8, 1, 0, 16,
                              stream) != 0              # R below T
    # col .. out | n w kind a b
    assert lib.probe_gather_f32(*[None] * 7, 1024, 100, 0, 1, 0,
                                stream) != 0            # w not 128·k
    assert lib.probe_gather_f32(*[None] * 7, 1024, 128, 4, 0, 0,
                                stream) != 0            # sublane, no rows
    assert lib.probe_dynslice_f32(None, 4, None, 1, 16,
                                  stream) != 0          # v off 16 bytes
    assert lib.probe_onehot_f32(None, None, None, 12, stream) != 0
    assert lib.probe_onehot_f32(4, 16, 32, 8, stream) != 0   # not on 16 B
    assert lib.probe_transpose_f32(None, None, 0, 4, 4, stream) == 0
    assert lib.probe_transpose_f32(None, None, 4, -1, 4, stream) != 0
    assert lib.probe_transpose_f32(None, None, 4, 4, -2, stream) != 0


# ------------------------------------- the lane-owned unit kernels' schedule --
# R, the rows a block takes (rounded up to a multiple of T); None: the
# wrapper's own
SCHEDULES = [None, 8, 32, 64, 96, 512]


def _schedule(monkeypatch, R, T):
    """Forces ``probes.unit_rows`` to R rounded up to a multiple of T."""
    if R is not None:
        R = -(-R // T) * T
        monkeypatch.setattr(probes, "unit_rows", lambda h, t, dev: R)


def _slab_inputs(cuda, T, s8, uids=None, n_steps=None, seed=7):
    n_steps = n_steps or 3200 // (T // 8)
    arrs = list(probe_slab.make_inputs(np.random.default_rng(seed), n_steps,
                                       T, s8, probe_slab.CB, probe_slab.NU))
    if uids is not None:
        arrs[0] = np.asarray(uids, np.int32)
    return [torch.from_numpy(a).to(cuda) for a in arrs]


def _slab_check(tens, T, stage):
    got = _launched(probes.slab_step, *tens, probe_slab.NU, T, stage)
    _close(got, probes.slab_step_ref(*tens, probe_slab.NU, T, stage))


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("stage", ["all", "prefix"])
def test_probe_slab_tail_unit_over_chunks(cuda, monkeypatch, sched, stage):
    """make_inputs gives unit 207 179 of the 800 steps at T 32: it spans
    many chunks, and the chunks of 64 and 32 rows split units of 3 steps
    (96 rows) at a chunk boundary."""
    _schedule(monkeypatch, sched, 32)
    _slab_check(_slab_inputs(cuda, 32, 8), 32, stage)


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("s8", [2, 8])
@pytest.mark.parametrize("stage", probes.STAGES)
def test_probe_slab_stages_gaps_and_dropped_units(cuda, monkeypatch, sched,
                                                  s8, stage):
    """uids with gaps, below 0 and at or above NU (dropped), units of 1 to
    40 steps, T 16."""
    T, n_steps = 16, 480
    rng = np.random.default_rng(s8)
    uids = np.sort(rng.choice(np.arange(-3, probe_slab.NU + 3), n_steps))
    uids[:5], uids[-7:] = -1, probe_slab.NU   # dropped at both ends
    uids[200:240] = uids[200]                  # one long unit
    uids = np.sort(uids)
    assert len(np.unique(uids)) < probe_slab.NU      # gaps
    _schedule(monkeypatch, sched, T)
    _slab_check(_slab_inputs(cuda, T, s8, uids, n_steps), T, stage)


@pytest.mark.parametrize("sched", [None, 64, 256])
def test_probe_slab_one_step_units_and_one_unit(cuda, monkeypatch, sched):
    """T 64: every step its own unit, then every step in unit 5."""
    T, n_steps = 64, 64
    _schedule(monkeypatch, sched, T)
    for uids in (np.arange(n_steps) * 3 % probe_slab.NU,
                 np.full(n_steps, 5)):
        _slab_check(_slab_inputs(cuda, T, 8, np.sort(uids), n_steps), T,
                    "all")


def _route_inputs(cuda, planes, m=1, T=64, H=4096, seed=0, uid0=0,
                  g_grp=16):
    """calibrate's _route_args at ``planes``, uids shifted by ``uid0``,
    gids for ``g_grp``."""
    a, _ = calibrate._route_args(np.random.default_rng(seed), H, planes, m,
                                 T, device=cuda)
    a[0] = a[0] + uid0
    a[1] = (a[0] // g_grp).contiguous()
    return a, int(a[1][-1]) + 1


def _route_check(a, ngb, m, planes, T, g_grp=16, pg=8):
    got = _launched(ops.xch_route, *a, ngb, m, planes, T, g_grp, pg)
    _close(got, ops.xch_route_ref(*a, ngb, m, planes, T, g_grp, pg))


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("planes", [1, 5, 8, 16, 17, 64])
def test_xch_route_planes(cuda, monkeypatch, planes, sched):
    """Every plane count class: the 8-plane accumulators (1, 5, 8), the
    16-plane ones (16) and their groups past 16 (17, 64)."""
    _schedule(monkeypatch, sched, 64)
    a, ngb = _route_inputs(cuda, planes, uid0=3)
    _route_check(a, ngb, 1, planes, 64, pg=4 if planes == 5 else 8)


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("planes,pg", [(16, 4), (64, 8), (8, 3)])
def test_xch_route_planes_change_within_a_unit(cuda, monkeypatch, planes, pg,
                                               sched):
    """sg0/sg1 drawn per step, so the active groups change between the 8
    steps of a unit (empty, sg1 < sg0 and all-plane steps among them)."""
    T = 32
    _schedule(monkeypatch, sched, T)
    a, ngb = _route_inputs(cuda, planes, m=4, T=T, seed=4)
    rng = np.random.default_rng(planes)
    n_steps = a[0].shape[0]
    a[3] = torch.from_numpy(rng.integers(-3, planes + 3, n_steps).astype(
        np.int32)).to(cuda)
    a[4] = torch.from_numpy(rng.integers(-3, planes + 3, n_steps).astype(
        np.int32)).to(cuda)
    _route_check(a, ngb, 4, planes, T, pg=pg)


@pytest.mark.parametrize("sched", [None, 64, 512])
def test_xch_route_ngb_cuts_units(cuda, monkeypatch, sched):
    """An ngb that drops the last units, and, through the C entry, an out
    of n_out rows that cuts a unit's planes."""
    planes, T = 16, 64
    _schedule(monkeypatch, sched, T)
    a, ngb = _route_inputs(cuda, planes, uid0=5, g_grp=2)
    _route_check(a, ngb - 1, 1, planes, T, g_grp=2)
    want = ops.xch_route_ref(*a, ngb, 1, planes, T, 2)
    R = probes.unit_rows(a[6].shape[0], T, cuda)
    for n_out in (want.shape[0] - 3, want.shape[0] - 19):
        out = torch.zeros(n_out, 128, device=cuda)
        rc = _build.load().xch_route_f32(
            *(ops._ptr(t) for t in (a[0], a[2], a[3], a[4], a[5], a[6],
                                    a[7], a[8], a[9], a[10], out)),
            a[6].shape[0], T, 1, planes, 8, a[10].shape[1], n_out, R,
            torch.cuda.current_stream(cuda).cuda_stream)
        assert rc == 0
        _close(out, want[:n_out])


# ---------------------------------------------- the probes' captured chain --

def _chain_body(name, dev):
    """(body, carry, consts, exact) of one probe's chain at a small size:
    the body ``microbench._time_kernel`` or the probe chains."""
    if name == "stream":
        a = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (64, 128)).astype(np.float32)).to(dev)
        return microbench.stream_body, a, (), True
    if name == "hbm_read":
        rng = np.random.default_rng(1)
        a = torch.from_numpy(rng.standard_normal((4096, 128)).astype(
            np.float32)).to(dev)
        return microbench.hbm_read_body, torch.zeros(8, 128, device=dev), \
            (a,), False
    if name == "seg_scan":
        fn, (heads, val), kw = microbench.seg_scan_case(G=256, device=dev)
        return (lambda c, tiny, h: fn(h, c, **kw)), val, (heads,), True
    fn, (offs, v), kw = microbench.dynslice_accum_case(T=512, device=dev)
    return (lambda c, tiny, o: c + fn(o, c)[0, 0] * tiny), v, (offs,), \
        False


@pytest.mark.parametrize("n", [3, 64, 70, 200])
@pytest.mark.parametrize("name", ["stream", "hbm_read", "seg_scan",
                                  "dynslice"])
def test_captured_chain_is_the_eager_chain(cuda, name, n):
    """``microbench.chained`` on the card replays CUDA graphs of chained
    calls (64 and 1): it returns the carry of n eager chained calls, within
    the probe's own check (exact where the body sums in a fixed order, 1e-5
    of max|carry| where a reduction or atomics sum in another)."""
    body, carry, consts, exact = _chain_body(name, cuda)
    run_n = microbench.chained(body)
    got = run_n(carry, n, *consts)
    want = microbench.loop_chain(body)(carry, n, *consts)
    _close(got, want, exact=exact)
    again = run_n(carry, n, *consts)         # replays, no new capture
    _close(again, want, exact=exact)


def test_a_body_that_cannot_be_captured_raises(cuda):
    """A chain whose body syncs with the host cannot be captured: it raises
    ``CaptureError``, and nothing falls back to eager calls."""
    def body(c, tiny):
        return c + float(c.sum()) * tiny

    carry = torch.ones(8, 128, device=cuda)
    with pytest.raises(driver.CaptureError, match="capture"):
        microbench.chained(body)(carry, 10)
