"""Host times of the port's matrix synthesis and format conversion.

    python singlespmv_tpu_torch/harness/convert_times.py webbase-1M:xch PR02R:hyb

Each argument is ``stand-in:format`` (``bkt_g``: bkt at 1024-row buckets).
For each, the script builds the full-size stand-in
(``data.synthesize_structured``, seed 0) and converts it on the host
(``formats.convert``, float32), and prints one JSON line with the seconds
of each step; for bkt and bkt_g also ``route_s``, the seconds that the
convert's derivation of stage B's run-end stream (``bkt.route_rows``)
takes, timed again on the converted state, where the tree has it.  It imports the package through ``PYTHONPATH`` and
only names that every version of the port has had, so one copy of the
script times two trees of the repository side by side:

    env PYTHONPATH=<tree> python singlespmv_tpu_torch/harness/convert_times.py ...

Run one process per tree and turn, as the driver's allocations and caches
stay warm within a process.
"""
from __future__ import annotations

import json
import sys
import time


def main(argv) -> int:
    from singlespmv_tpu_torch import Config
    from singlespmv_tpu_torch import formats
    from singlespmv_tpu_torch.data import synthesize_structured

    for arg in argv:
        name, fmt = arg.split(":")
        cfg = Config(format=fmt, dtype="float32") if fmt != "bkt_g" else \
            Config(format="bkt", dtype="float32", bkt_row_group=1024)
        t0 = time.perf_counter()
        coo = synthesize_structured(name)
        t1 = time.perf_counter()
        state = formats.convert(coo, cfg)
        t2 = time.perf_counter()
        out = {"name": name, "format": fmt, "nnz": coo.nnz,
               "synth_s": t1 - t0, "convert_s": t2 - t1}
        route = getattr(formats.get_format(cfg.format), "route_rows", None)
        if cfg.format == "bkt" and route is not None:
            t3 = time.perf_counter()
            route(state)
            out["route_s"] = time.perf_counter() - t3
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
