"""ctypes binding and build at first use of the native data core
(``sampler.cpp``, a copy of the JAX package's): libpng decode and encode
of RGB8 PNGs and the multithreaded sampler of aligned HR crops.

The library is built with ``g++ ... -lpng -pthread`` into
``pesr_torch/_build/native-<hash>/`` (``<hash>`` covers the source and
the flags, so an edited source rebuilds), under an ``flock`` and with an
atomic rename, so processes that build at once never load a half-written
file.  When it cannot be built (no ``g++``, no libpng), :func:`get_lib`
returns None and :func:`unavailable_reason` says why; the callers
(``pesr_torch.data.datasets``) then decode with Pillow and sample with
``PatchIterator``, as the JAX package does, and say so.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().with_name("sampler.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"
CXX_CMD = ("g++", "-O3", "-shared", "-fPIC", "-std=c++17")
LINK = ("-lpng", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None
_U8P = ctypes.POINTER(ctypes.c_ubyte)
_M64 = (1 << 64) - 1


def lib_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_CMD + LINK).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libpesr_data.so"


def _build(so: Path, stale: bool = False) -> None:
    """Compile ``sampler.cpp`` to ``so`` unless another process did
    (``stale``: ``so`` exists but does not load here, e.g. a copy from a
    machine with another libpng; it is rebuilt)."""
    import fcntl
    import tempfile
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.parent / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists() and not stale:
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            proc = subprocess.run([*CXX_CMD, str(SRC), *LINK, "-o", tmp],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode:
                raise OSError(f"g++ exit {proc.returncode}: "
                              f"{proc.stderr.strip()[-800:]}")
            os.rename(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built at first use), or None when it cannot be
    built or loaded; the reason is kept for :func:`unavailable_reason`."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            so = lib_path()
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                _build(so, stale=True)
                lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        c_int, c_char_p, c_u64 = ctypes.c_int, ctypes.c_char_p, ctypes.c_uint64
        int_p = ctypes.POINTER(c_int)
        for name, args, res in (
                ("pesr_png_probe", [c_char_p, int_p, int_p], c_int),
                ("pesr_png_decode", [c_char_p, _U8P, c_int, c_int], c_int),
                ("pesr_png_encode", [c_char_p, _U8P, c_int, c_int, c_int],
                 c_int),
                ("pesr_sample_patches",
                 [ctypes.POINTER(_U8P), int_p, int_p, c_int, c_int, c_int,
                  c_u64, c_u64, _U8P, c_int], None)):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        _lib = lib
        return lib


def available() -> bool:
    return get_lib() is not None


def unavailable_reason() -> Optional[str]:
    """Why the library is not there (None when it is)."""
    get_lib()
    return _error


def _need_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise ImportError(f"native data library unavailable ({_error})")
    return lib


def decode_png(path: str) -> np.ndarray:
    """PNG -> HWC uint8 RGB through libpng (gray, palette, 16-bit and
    alpha converted as the JAX package's core does); raises IOError on a
    file it cannot read."""
    lib = _need_lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    p = os.fsencode(path)
    if lib.pesr_png_probe(p, ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"cannot read PNG header: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.pesr_png_decode(p, out.ctypes.data_as(_U8P), h.value, w.value)
    if rc:
        raise IOError(f"PNG decode failed ({rc}): {path}")
    return out


def encode_png(path: str, img: np.ndarray, level: int = 4) -> None:
    """HWC uint8 RGB -> an RGB8 PNG file through libpng; ``level`` is
    zlib's 0-9."""
    lib = _need_lib()
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("expected HWC uint8 RGB")
    rc = lib.pesr_png_encode(os.fsencode(path), img.ctypes.data_as(_U8P),
                             img.shape[0], img.shape[1], level)
    if rc:
        raise IOError(f"PNG encode failed ({rc}): {path}")


class NativePatchSampler:
    """Batches of random aligned HR crops [batch, patch_hr, patch_hr, 3]
    from a list of decoded images, assembled by ``threads`` C++ threads.
    Crop ``b`` of step ``s`` is drawn from a splitmix64 stream of (seed,
    s, b), so a batch depends on (seed, step) only and equals the JAX
    package's sampler's bit for bit.  Iterating yields ``(None, hr)``:
    LR is synthesized from the HR crop on the device."""

    def __init__(self, images: List[np.ndarray], patch_hr: int,
                 batch: int, seed: int, threads: int = 0) -> None:
        self._lib = _need_lib()
        self._imgs = [np.ascontiguousarray(im) for im in images]
        for im in self._imgs:
            if im.dtype != np.uint8 or im.ndim != 3 or im.shape[2] != 3:
                raise ValueError("images must be HWC uint8 RGB")
            if im.shape[0] < patch_hr or im.shape[1] < patch_hr:
                raise ValueError(f"image {im.shape[:2]} smaller than the "
                                 f"{patch_hr}-px patch")
        n = len(self._imgs)
        if n == 0:
            raise ValueError("no images to sample from")
        self._ptrs = (_U8P * n)(*[im.ctypes.data_as(_U8P)
                                  for im in self._imgs])
        self._hs = (ctypes.c_int * n)(*[im.shape[0] for im in self._imgs])
        self._ws = (ctypes.c_int * n)(*[im.shape[1] for im in self._imgs])
        self.patch, self.batch, self.seed = patch_hr, batch, seed
        self.threads = threads or min(8, os.cpu_count() or 1)
        self._step = 0

    def __len__(self) -> int:
        return len(self._imgs)

    def sample(self, step: Optional[int] = None) -> np.ndarray:
        """The batch of ``step`` (the next one when None)."""
        if step is None:
            step = self._step
            self._step += 1
        out = np.empty((self.batch, self.patch, self.patch, 3), np.uint8)
        self._lib.pesr_sample_patches(
            self._ptrs, self._hs, self._ws, len(self._imgs), self.batch,
            self.patch, self.seed & _M64, step & _M64,
            out.ctypes.data_as(_U8P), self.threads)
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[None, np.ndarray]:
        return None, self.sample()
