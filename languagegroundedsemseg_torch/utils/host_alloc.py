"""Host allocator tuning for the data/graph-build path.

Counterpart of ``languagegroundedsemseg_tpu/utils/host_alloc.py``.

The loader's per-batch graph build allocates tens of MB of numpy scratch
per step. glibc serves allocations above M_MMAP_THRESHOLD (128 KB default)
with fresh ``mmap``s and returns them with ``munmap`` on free, so every
batch re-faults its large temporaries from scratch. On bare metal that is
a minor cost; under lazily-backed VM memory (first-touch page faults go
through the hypervisor) it dominates the build — measured on the bench
host of the JAX package: the same 4-scene graph build swings 2 s -> 22 s
between iterations without tuning and holds a stable ~1.7 s with it.

``tune()`` raises the mmap threshold so large blocks come from the sbrk
heap and disables trimming so the heap's faulted pages are never given
back. Idempotent; no-op on non-glibc platforms or when the
``LGS_NO_MALLOC_TUNING`` env var is set. Call it in every process that
builds batches: loader workers (data/loader.py) and the benchmarks.

Reference analog: the reference leans on torch DataLoader worker processes
(reference main.py) whose allocator churn is hidden by multi-core hosts;
here the loader runs in threads of the training process, so allocator
behavior is part of the perf contract.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

_M_TRIM_THRESHOLD = -1
_M_TOP_PAD = -2
_M_MMAP_THRESHOLD = -3
_M_MMAP_MAX = -4

_done = False


def tune(mmap_threshold: int = 1 << 30) -> bool:
    """Apply glibc malloc tuning for large-array churn. Returns True when
    the tuning was applied (or already had been)."""
    global _done
    if _done:
        return True
    if os.environ.get("LGS_NO_MALLOC_TUNING"):
        return False
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    ok = True
    # order matters: setting M_MMAP_THRESHOLD disables glibc's dynamic
    # threshold adjustment, which is exactly what we want
    ok &= bool(mallopt(_M_MMAP_THRESHOLD, int(mmap_threshold)))
    ok &= bool(mallopt(_M_TRIM_THRESHOLD, 2**31 - 1))
    # keep a generous top pad so sbrk growth happens in large steps
    ok &= bool(mallopt(_M_TOP_PAD, 16 << 20))
    _done = bool(ok)
    return _done
