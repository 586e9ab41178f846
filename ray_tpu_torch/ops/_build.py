"""One ``nvcc`` build path for every kernel source in ``ops/csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use, by ``nvcc`` for ``sm_90a``, into
``build/kernels/<name>-<hash>.so`` at the checkout root (git-ignored),
then loaded with ``ctypes`` by its wrapper module. The hash covers the
source, every ``csrc/*.cuh`` header (any source may include one) and the
flags, so a library is reused only for exactly the code and flags it was
built from; a fresh checkout builds everything anew. :func:`build_all` starts one ``nvcc`` per source at once,
so a caller that needs every kernel waits for the slowest build only.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's "
                           "kernels are built from source")
    return found


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc/`` header."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to under the current sources and
    flags."""
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source
    and flag set exists. Returns ``(library path, compiler output)``; the
    output is empty when the library was already built."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({res.returncode}):"
                           f"\n{res.stdout}")
    os.replace(tmp, out)
    return out, res.stdout


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
    """:func:`build` for several sources, one thread each, so their
    ``nvcc`` runs go together; raises the first failure."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))
