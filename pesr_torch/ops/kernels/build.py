"""Build and load the port's CUDA kernels (``pesr_torch/csrc``).

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``.  Nothing here includes PyTorch's headers, so a build takes
seconds, not minutes.  Libraries go to ``pesr_torch/_build/<hash>/``,
where ``<hash>`` covers every source and header: the first use builds,
an edited source rebuilds, and an unchanged tree reuses what is there.
All sources compile at once, one ``nvcc`` process each.

There is no fallback: without ``nvcc``, or when a build fails, this
raises.  Importing this module does nothing; building happens on the
first kernel launch (or an explicit :func:`build_all`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
KERNELS = ("resblock", "upsampler")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _sources_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the pesr_torch CUDA kernels cannot be built")


def build_all(verbose: bool = False) -> Dict[str, Path]:
    """Build every kernel library that is missing for the current sources,
    one ``nvcc`` per source, all started together.  Returns
    ``{name: path}``.  With ``verbose``, prints what ``-Xptxas -v`` reports
    (registers, shared memory, spills) for each build it ran."""
    out = BUILD_ROOT / _sources_hash()
    libs = {k: out / f"lib{k}.so" for k in KERNELS}
    todo = [k for k in KERNELS if not libs[k].exists()]
    if not todo:
        return libs
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for k in todo:
        tmp = out / f"lib{k}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{k}.cu")]
        procs[k] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for k, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {k}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, libs[k])
        if verbose:
            print(f"--- built {libs[k]} ---\n{log.strip()}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built at first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            _libs[name] = lib
        return lib


def c_function(name: str, symbol: str, argtypes):
    """``symbol`` of kernel library ``name`` with its ``argtypes`` set
    (``c_void_p`` for every pointer and the stream, so no pointer is cut
    to 32 bits) and an int return: the launch's CUDA error code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn
