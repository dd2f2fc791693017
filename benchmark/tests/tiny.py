"""A copy of the benchmark whose configurations are cut to a size the CPU
runs in a second: the same files, generators and traffic kinds, found by
name as the real ones are."""
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SIZES = {"graph500-s20.csr5.f32": {"scale": 10},
         "graph500-s20.slab.f32": {"scale": 10},
         "hpcg-104.f64": {"grid": [10, 9, 8]}}


def bench_copy(dst, dtypes=None) -> tuple:
    """(bench_dir, spec_path) of a tiny copy under ``dst``; ``dtypes``
    maps a configuration to another value type."""
    bench = os.path.join(str(dst), "benchmark")
    shutil.copytree(BENCH, bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, size in SIZES.items():
        path = os.path.join(bench, "configs", name + ".json")
        with open(path) as f:
            conf = json.load(f)
        conf.update(size)
        conf["dtype"] = (dtypes or {}).get(name, conf["dtype"])
        with open(path, "w") as f:
            json.dump(conf, f)
    spec = os.path.join(str(dst), "BENCHMARK.json")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), spec)
    return bench, spec


def workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
