"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is one kernel source with a plain C interface.  It is
compiled by ``nvcc`` for sm_90a at first use into a shared library in the
gitignored ``kernels/build/`` (one library per source, named by a hash of
the source, the shared ``csrc/*.cuh`` headers and the flags, so an edited
source is rebuilt and an unchanged one is not), then loaded with ctypes.
A failed build raises with nvcc's stderr; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# ``-Xptxas -v`` reports (registers, shared memory, spills) of the sources
# built with ``verbose=True``, by source stem
reports: dict[str, str] = {}
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], object] = {}
_lock = threading.Lock()


def sources() -> list[Path]:
    """Every kernel source, sorted by name."""
    return sorted(CSRC.glob("*.cu"))


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives for its current content."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built with the CUDA toolkit at first use")
    return nvcc


def build_all(names=None, *, verbose: bool = False) -> dict[str, Path]:
    """Compile the named sources (all of ``csrc/*.cu`` when None) that are
    not built yet, one nvcc process each, all started together.  Returns
    {source stem: library path}.  ``verbose`` adds ``-Xptxas -v`` and
    prints its report (registers, shared memory, spills)."""
    srcs = [s for s in sources() if names is None or s.stem in names]
    missing = set(names or ()) - {s.stem for s in srcs}
    if missing:
        raise ValueError(f"no kernel source for {sorted(missing)} in {CSRC}")
    libs = {s.stem: library_path(s) for s in srcs}
    todo = [s for s in srcs if not libs[s.stem].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        tmp = libs[src.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):"
                          f"\n{err}")
            continue
        if verbose:
            reports[src.stem] = err
            print(f"[nvcc] {src.name}\n{err}", end="")
        os.replace(tmp, libs[src.stem])
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(name: str, symbol: str, argtypes):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` (built at first
    use), with its argument types set and an int (cudaError_t) result."""
    fn = _fns.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _libs[name] = lib
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[(name, symbol)] = fn
        return fn
