"""Host-heap hygiene for long runs (the port's copy of
``pesr_tpu/utils/memory.py``).

:func:`trim_host_heap` asks glibc to hand freed arena memory back to the
OS (``malloc_trim(0)``), so a long run's resident set does not keep the
high-water mark of its per-step batch buffers.  It is cheap (about a
millisecond) and the training loop calls it once per epoch with
``--trim_host_heap``.  Off glibc it does nothing.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_libc = None
_checked = False


def trim_host_heap() -> bool:
    """Return free heap arenas to the OS; True if a trim call ran."""
    global _libc, _checked
    if not _checked:
        _checked = True
        try:
            path = ctypes.util.find_library("c")
            lib = ctypes.CDLL(path) if path else ctypes.CDLL(None)
            if hasattr(lib, "malloc_trim"):
                _libc = lib
        except OSError:
            _libc = None
    if _libc is None:
        return False
    _libc.malloc_trim(0)
    return True
