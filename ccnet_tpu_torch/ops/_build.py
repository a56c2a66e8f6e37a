"""Build the package's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each library is compiled from ``ccnet_tpu_torch/csrc/<name>.cu`` (and the
``.cuh`` headers beside it) and nothing else, for ``sm_90a``, into
``build/ccnet_tpu_torch/`` at the checkout root. The file name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is loaded as it is. The sources expose a plain C interface
(pointers as ``void*``, ints, the stream as ``void*``), so no PyTorch header
is compiled: a build takes seconds.

A failed build raises. Nothing here falls back to a plain-torch version.
:func:`build_libraries` starts one ``nvcc`` per source together. Ranks that
start at once on one machine share the build directory: each build holds a
file lock (:func:`build_lock`), so one rank compiles a library and the
others wait for it and load what it wrote.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ccnet_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
BUILD_SECONDS: dict = {}  # name -> wall seconds of the nvcc run (0.0 when reused)
PTXAS_REPORT: dict = {}  # name -> what ``-Xptxas -v`` printed (registers, spills)


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _source_hash(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


@contextmanager
def build_lock(so: Path):
    """Hold an exclusive lock on ``<so>.lock`` (``flock``, released when the
    holder exits, so a killed build leaves none behind): the processes that
    build ``so`` at once compile it once."""
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{so}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"CUDA source {src} is missing")
    so = BUILD_DIR / f"lib{name}_{_source_hash(name)}.so"
    with build_lock(so):
        if so.is_file():
            BUILD_SECONDS[name] = 0.0
        else:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_SECONDS[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {src} (exit {proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
            PTXAS_REPORT[name] = (proc.stdout + proc.stderr).strip()
            os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    return lib


def build_libraries(names) -> None:
    """Build (or load) several libraries, one ``nvcc`` per source, all at once."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=len(names)) as ex:
        for fut in [ex.submit(load_library, n) for n in names]:
            fut.result()
