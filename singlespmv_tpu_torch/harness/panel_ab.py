"""A/B of the panel (SpMM) kernels' design choices on the card.

    python -m singlespmv_tpu_torch.harness.panel_ab     # needs a GPU and nvcc

Builds the kernels of ``csrc/`` as they are and the variants of ``VARIANTS``,
each a copy of ``csrc/`` with one change (text substitutions), with the
flags of ``ops/_build.py`` into temporary directories.  Then it times
``slab_spmm`` on g7jac200sc's unit-only plan at B = 8, 16 and 32, and
``xch_mul_panel`` / ``xch_route4_panel`` on the outer states of webbase-1M
and ASIC_680ks at B = 8 and 16 (the structure-matched stand-ins, seed 0),
loading each build in turn in place of the port's library, over two passes
(the variants in order, then reversed).  A time is the device busy µs of
the kernel over one call per chunk (torch.profiler).  Variants that compute
the same function are held to the plain versions within 1e-5·max|out|;
the diagnostic ones (``DIAGNOSTIC``) are not.  It prints the card's name
and power limit, each build's registers per kernel (ptxas) and the count
of shared-memory compare-and-swap instructions (``ATOMS.CAST``, cuobjdump)
in its panel kernels.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from .. import Config
from ..data import synthesize_structured
from ..formats import slab, xch
from ..ops import _build
from ..ops import slab as sops
from ..ops import xch as xops

SINK = "__shared__ float panel_sink[4096];  // the variant's atomics land here\n"
VARIANTS = {
    "as built": {},
    # the walk's run totals go to shared memory with atomicAdd (the same
    # count, on distinct addresses) instead of global memory
    "shared atomics": {
        "// One batch of U slots": SINK + "// One batch of U slots",
        "atomicAdd(oc + (size_t)q[u].dest * B, run);":
            "atomicAdd(&panel_sink[(q[u].dest * 32 + (threadIdx.x & 31)) & "
            "4095], run);",
        "atomicAdd(oc + (size_t)wait * B, wait_sum":
            "atomicAdd(&panel_sink[(wait * 32 + (threadIdx.x & 31)) & "
            "4095], wait_sum"},
    # the walk adds nothing: gathers, run sums and the carry only
    "no atomics": {
        "        atomicAdd(oc + (size_t)q[u].dest * B, run);":
            "        if (run == 1234.5f) oc[0] = run;",
        "    atomicAdd(oc + (size_t)wait * B, wait_sum":
            "    if (wait_sum == 1234.5f) oc[0] = (wait_sum"},
    "walk batch 4": {"constexpr int kWalkBatch = 8;":
                     "constexpr int kWalkBatch = 4;"},
    "walk batch 16": {"constexpr int kWalkBatch = 8;":
                      "constexpr int kWalkBatch = 16;"},
    # read_dests with 8 index-plane loads in flight at once
    "plane loads 8 at a time": {
        """  for (int j = 0; j < n; ++j)
    set_dest(st, lg, load_c4(e0 + j * stride + 4 * k),
             d0 + j * kLanes + 4 * k);""":
        """  for (int j0 = 0; j0 < n; j0 += 8) {
    char4 e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < n) e[u] = load_c4(e0 + (j0 + u) * stride + 4 * k);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (j0 + u < n) set_dest(st, lg, e[u], d0 + (j0 + u) * kLanes + 4 * k);
  }"""},
    "xch_mul_panel lanes of 1 column": {"  if (B % 4)\n": "  if (1)\n"},
}
DIAGNOSTIC = ("shared atomics", "no atomics")
KERNELS = ("slab_spmm_kernel", "xch_mul_panel_kernel",
           "xch_route4_panel_kernel")


def kernel_hit(key, line: str) -> bool:
    """Whether ``line`` names kernel ``key``: a substring of its mangled
    name, or a tuple of substrings that it must all hold (a template's name
    and its arguments)."""
    return all(k in line for k in ((key,) if isinstance(key, str) else key))


def build_variant(name: str, subs: dict, sources=("slab.cu", "xch.cu"),
                  kernels=KERNELS) -> tuple:
    """Compiles the variant's ``sources`` into a shared library; returns
    (library, {kernel: registers}, {kernel: ATOMS.CAST count}) over the
    kernels whose names hold one of ``kernels`` (``kernel_hit``).  The
    library keeps nvcc's output (ptxas) as ``ptxas_log`` and its SASS
    (cuobjdump) as ``sass``."""
    work = tempfile.mkdtemp(prefix="panel_ab_")
    shutil.copytree(_build.CSRC_DIR, work, dirs_exist_ok=True)
    hits = dict.fromkeys(subs, 0)
    for f in os.listdir(work):
        path = os.path.join(work, f)
        with open(path) as fh:
            text = fh.read()
        for old, new in subs.items():
            hits[old] += text.count(old)
            text = text.replace(old, new)
        with open(path, "w") as fh:
            fh.write(text)
    missing = [old for old, n in hits.items() if n == 0]
    if missing:
        raise ValueError(f"{name}: no {missing[0]!r} in csrc/")
    nvcc = _build.nvcc()
    objs = [os.path.join(work, f + ".o") for f in sources]
    procs = [subprocess.Popen([nvcc, *_build.FLAGS, "-c", "-o", o,
                               o[:-2]], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for o in objs]
    log = "".join(p.communicate()[0] for p in procs)
    if any(p.returncode for p in procs):
        raise _build.KernelError(f"{name}: nvcc failed\n{log}")
    lib_path = os.path.join(work, "variant.so")
    subprocess.run([nvcc, *_build.FLAGS[:2], "-shared", "-o", lib_path,
                    *objs], check=True)
    lib = ctypes.CDLL(lib_path)
    lib.ptxas_log = log
    for entry, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    regs, current = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            current = next((k for k in kernels if kernel_hit(k, line)), None)
        elif current and "registers" in line:
            regs[current] = int(re.search(r"(\d+) registers", line).group(1))
            current = None
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", lib_path], capture_output=True,
                          text=True).stdout
    lib.sass = sass
    cas, current = dict.fromkeys(kernels, 0), None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if kernel_hit(k, line)), None)
        elif current and "ATOMS.CAST" in line:
            cas[current] += 1
    return lib, regs, cas


def busy_us(fn, match: str, reps: int = 20) -> float:
    """Device busy µs per call of ``fn`` in kernels named ``match``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if match in e.key) / reps


def cases(dev) -> list:
    """(label, kernel, calls, plain calls) of every timed case."""
    rng = np.random.default_rng(0)
    g7 = synthesize_structured("g7jac200sc")
    plan = slab._estimate_cols(g7.row.astype(np.int64),
                               g7.col.astype(np.int64), g7.nnz,
                               unit_only=True)
    plan.update(hub_cols=None, cols_eff=None, hub_off=0)
    st = slab.convert(g7, Config(format="slab"), plan=plan).to(dev)
    out = []
    for n_cols in (8, 16, 32):
        xp = slab.x_table(st, torch.from_numpy(rng.uniform(
            -1, 1, (g7.n_col, n_cols)).astype(np.float32)).to(dev))
        args = [(*a, xp, nu, st.m, st.t_step) for *a, nu in zip(
            st.uids, st.sg0, st.sg1, st.win, st.lane, st.sub, st.val,
            st.hm1, st.idx, st.chunk_nu)]
        out.append((f"slab_spmm g7jac200sc B{n_cols}", "slab_spmm_kernel",
                    [lambda a=a: sops.slab_spmm(*a) for a in args],
                    [lambda a=a: sops.slab_spmm_ref(*a) for a in args]))
    for name in ("webbase-1M", "ASIC_680ks"):
        coo = synthesize_structured(name)
        xs = xch.convert(coo, Config(format="xch")).to(dev)
        for n_cols in (8, 16):
            xp = xch.x_table(xs, torch.from_numpy(rng.uniform(
                -1, 1, (coo.n_col, n_cols)).astype(np.float32)).to(dev))
            muls = [(*a, xp, xs.m1, xs.t1) for a in zip(
                xs.win1, xs.lane1, xs.sub1, xs.val1)]
            prod = torch.cat([xops.xch_mul_panel_ref(*a) for a in muls])
            prod = prod.view(xs.n_chunks, xs.p1, 128, n_cols)
            routes = [(*a, prod, ng, xs.gb, xs.m2, xs.t2, xs.p_oh)
                      for *a, ng in zip(xs.gids2, xs.off2, xs.cs2, xs.win2,
                                        xs.lane2, xs.sub2, xs.hm2, xs.sig2,
                                        xs.idx2, xs.chunk_ngrp)]
            for kname, args in (("xch_mul_panel", muls),
                                ("xch_route4_panel", routes)):
                fn = getattr(xops, kname)
                ref = getattr(xops, kname + "_ref")
                out.append((f"{kname} {name} B{n_cols}", kname + "_kernel",
                            [lambda a=a, f=fn: f(*a) for a in args],
                            [lambda a=a, f=ref: f(*a) for a in args]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("panel_ab needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    builds = {}
    for name, subs in VARIANTS.items():
        lib, regs, cas = build_variant(name, subs)
        builds[name] = lib
        print(f"build {name!r}: registers {regs}, ATOMS.CAST {cas}",
              flush=True)
    todo = cases(dev)
    wants = {}
    for label, _, _, ref in todo:
        wants[label] = [r() for r in ref]
    times = {}
    saved = _build._lib
    try:
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                _build._lib = builds[name]
                for label, match, calls, _ in todo:
                    if name not in DIAGNOSTIC:
                        for got, want in zip((c() for c in calls),
                                             wants[label]):
                            torch.cuda.synchronize()
                            err = float((got - want).abs().max())
                            if err > 1e-5 * float(want.abs().max()):
                                raise SystemExit(f"{name} {label}: off the "
                                                 f"plain version by {err}")
                    times.setdefault((name, label), []).append(
                        busy_us(lambda: [c() for c in calls], match))
    finally:
        _build._lib = saved
    labels = [label for label, *_ in todo]
    print("variant".ljust(34) + "".join(f"{lb[-22:]:>24}" for lb in labels))
    for name in VARIANTS:
        print(name.ljust(34) + "".join(
            f"{' / '.join(f'{t:.2f}' for t in times[(name, lb)]):>24}"
            for lb in labels), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
