"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
into its own shared library, loaded with ``ctypes`` (no PyTorch headers:
a build takes seconds, not minutes). Libraries land in ``build/repro_torch/``
at the repository root, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused.

Nothing here runs at import: the CPU tests import every module, and a
machine without a card may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -lcuda: the driver API's cuTensorMapEncodeTiled (TMA descriptors)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lcuda")

_LOCK = threading.Lock()
_LIBS: dict = {}


def loaded() -> int:
    """Kernel libraries this process has built or loaded: the port's only
    first-use compilation (the flight recorder's ``compile_delta``)."""
    return len(_LIBS)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str, csrc: pathlib.Path) -> pathlib.Path:
    # the shared headers are part of every source's build key
    src = b"".join(p.read_bytes() for p in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / digest[:16] / f"lib{name}.so"


def build(names, csrc: pathlib.Path = CSRC) -> dict:
    """Compile the named sources of ``csrc`` (the package's own by default;
    another directory builds, for instance, an earlier version to time
    beside this one), all ``nvcc`` processes started together; returns
    {name: library path}. Raises with the compiler's output if any build
    fails."""
    names = list(names)
    procs = {}
    for name in names:
        out = _target(name, csrc)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            out.with_suffix(".ptxas").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: _target(name, csrc) for name in names}


def ptxas(library: pathlib.Path) -> str:
    """The compiler's resource report (-Xptxas -v) of a built library."""
    return library.with_suffix(".ptxas").read_text()


def load(name: str, csrc: pathlib.Path = CSRC) -> ctypes.CDLL:
    """The loaded library for ``<csrc>/<name>.cu``, built on first use."""
    key = (name, str(csrc))   # every launch comes here: no file system access
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(str(build([name], pathlib.Path(csrc))[name]))
        return _LIBS[key]


def sources() -> list:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))
