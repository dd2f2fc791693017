"""Natural (SuiteSparse) suite tooling: ``extract_mtx`` and ``synthesize``
of ``singlespmv_tpu/data/suitesparse.py``.

The reference's suite is 26 SuiteSparse matrices (singleSpMV's
``matrix/natural/download.sh``).  The reference's ``ensure_suite``
downloads their tarballs; it is not ported, since the port runs where no
download is possible: a tarball staged by hand unpacks with
``extract_mtx``, and ``synthesize`` builds each matrix's structure-matched
stand-in (``data/structgen.py``), the one the benchmarks run.
"""
from __future__ import annotations

import os
import tarfile
from typing import Dict, Optional

from .structgen import RECIPES as _RECIPES

# group/name pairs of the reference's download.sh
NATURAL_SUITE = [
    ("Sandia", "ASIC_680ks"), ("Muite", "Chebyshev4"),
    ("Freescale", "Freescale1"), ("Freescale", "FullChip"),
    ("Janna", "ML_Geer"), ("Fluorem", "PR02R"), ("Fluorem", "RM07R"),
    ("TSOPF", "TSOPF_RS_b2383_c1"), ("vanHeukelum", "cage15"),
    ("Freescale", "circuit5M"), ("Williams", "mac_econ_fwd500"),
    ("Schenk_ISEI", "ohne2"), ("Simon", "raefsky3"), ("Rajat", "rajat31"),
    ("Norris", "stomach"), ("Botonakis", "thermomech_dK"),
    ("Norris", "torso1"), ("FEMLAB", "sme3Dc"), ("Hamrle", "Hamrle3"),
    ("Ronis", "xenon2"), ("Raju", "laminar_duct3D"),
    ("Schenk_ISEI", "para-4"), ("Williams", "webbase-1M"),
    ("ATandT", "twotone"), ("Mallya", "lhr34"), ("Hollinger", "g7jac200sc"),
]

# (n_row, n_col, nnz) from the SuiteSparse collection, used by synthesize()
PUBLISHED_SHAPES: Dict[str, tuple] = {
    name: (n, n, nnz) for name, (n, nnz, _) in _RECIPES.items()
}


def extract_mtx(tar_path: str, dest_dir: str) -> Optional[str]:
    """Extracts <name>/<name>.mtx from a SuiteSparse tarball into
    ``dest_dir``, flattened; returns its path, or None when the tarball
    holds no such member."""
    name = os.path.basename(tar_path).replace(".tar.gz", "")
    out = os.path.join(dest_dir, f"{name}.mtx")
    with tarfile.open(tar_path, "r:gz") as tf:
        for m in tf.getmembers():
            if m.name.endswith(f"{name}.mtx"):
                src = tf.extractfile(m)
                with open(out, "wb") as f:
                    while True:
                        chunk = src.read(1 << 20)
                        if not chunk:
                            break
                        f.write(chunk)
                return out
    return None


def synthesize(name: str, *, seed: int = 0, structured: bool = True):
    """The stand-in of suite matrix ``name``: the structure-matched one of
    ``data/structgen.py`` (default), or with ``structured=False`` a
    power-law matrix of the published shape and nnz."""
    import zlib

    from .generators import powerlaw

    if structured:
        from .structgen import synthesize_structured

        return synthesize_structured(name, seed=seed)
    if name not in PUBLISHED_SHAPES:
        raise KeyError(f"no published shape for {name!r}")
    n_row, n_col, nnz = PUBLISHED_SHAPES[name]
    # crc32, not hash(): str hash is salted per process (PYTHONHASHSEED)
    return powerlaw(n_row, nnz, seed=seed + zlib.crc32(name.encode()) % 1000)
