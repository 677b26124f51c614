"""Build and load the port's hand-written Hopper kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ctypes. The build runs
at first use (or through ``build()``), one nvcc process per source, all
started together, into the package's git-ignored ``_build/`` directory; each
library is written to a private temporary file and renamed into place, so a
concurrent first use never loads a half-written file. Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from typing import Dict

import torch

from languagegroundedsemseg_torch import BUILD_DIR
from languagegroundedsemseg_torch.utils.observability import span

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_vp = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
# name -> (source file, exported C function, argtypes)
KERNELS = {
    "sel_fwd": ("sel_fwd.cu", "lgs_sel_fwd", [_vp] * 5 + [_i] * 9 + [_vp]),
    "csum": ("csum.cu", "lgs_csum", [_vp] * 4 + [_i] * 8 + [_vp]),
    "dw": ("dw.cu", "lgs_dw", [_vp] * 6 + [_i] * 8 + [_vp]),
    "onehot_gemm": ("onehot_gemm.cu", "lgs_onehot_gemm",
                    [_vp] * 6 + [_i] * 6 + [_vp]),
    "onehot_variants": ("onehot_variants.cu", "lgs_onehot_variants",
                        [_vp] * 5 + [_i] * 9 + [_vp]),
    "bn": ("bn.cu", "lgs_bn_stats", [_vp] * 3 + [_i] * 7 + [_vp]),
    "contrast": ("contrast.cu", "lgs_contrast_fwd",
                 [_vp] * 8 + [_i] * 6 + [_f] * 2 + [_vp]),
}

_lock = threading.Lock()
_funcs: Dict[str, object] = {}
# name -> compiler output of the last build (ptxas register / smem report)
build_log: Dict[str, str] = {}


def _paths(name):
    src = os.path.join(CSRC_DIR, KERNELS[name][0])
    return src, os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def build() -> None:
    """Compile every stale kernel library now, in parallel. Raises with the
    compiler output if any source fails."""
    with _lock:
        _build_locked(list(KERNELS))


def _build_locked(names) -> None:
    stale = []
    for name in names:
        src, so = _paths(name)
        if not os.path.isfile(so) or os.path.getmtime(so) < os.path.getmtime(src):
            stale.append(name)
    if not stale:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode == 0:
            with open(f"{tmp}.log", "w") as f:
                f.write(out)
            os.replace(f"{tmp}.log", f"{so}.log")
            os.replace(tmp, so)
        else:
            failed.append(f"{name}:\n{out}")
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def function(name: str, symbol: str = None, argtypes=None):
    """The C entry point of kernel ``name`` (or another exported
    ``symbol`` of its library, taking ``argtypes``), built and loaded on
    first use, with its argtypes declared (every pointer and the stream as
    ``c_void_p``, so ctypes never cuts a 64-bit address). Returns an int
    CUDA error code."""
    _, sym, types = KERNELS[name]
    if symbol is not None:
        sym, types = symbol, argtypes
    fn = _funcs.get(sym)
    if fn is not None:
        return fn
    with _lock:
        fn = _funcs.get(sym)
        if fn is None:
            _build_locked([name])
            lib = ctypes.CDLL(_paths(name)[1])
            fn = getattr(lib, sym)
            fn.argtypes = types
            fn.restype = ctypes.c_int
            _funcs[sym] = fn
    return fn


def ptxas_usage(name: str, entry: str) -> dict:
    """Registers a thread, static shared memory and spill bytes that ptxas
    reported for the kernel whose (mangled) entry name contains ``entry``,
    from the build of ``name`` that made its library (this process's, or
    the log kept beside the library); empty when there is none."""
    log = build_log.get(name)
    if log is None:
        try:
            with open(_paths(name)[1] + ".log") as f:
                log = f.read()
        except OSError:
            log = ""
    usage, inside = {}, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = entry in line
        elif inside and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill (stores|loads)", line)
            usage.update({f"spill_{kind}_bytes": int(n) for n, kind in nums})
        elif inside and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            usage["registers"] = int(regs.group(1)) if regs else None
            usage["static_smem_bytes"] = int(smem.group(1)) if smem else 0
            inside = False
    return usage


def launch(counts: Dict[str, int], kernel: str, fn, dev, args) -> None:
    """One launch of the hand-written ``kernel`` (a key of ``counts``, the
    calling module's launch counter): ``fn(*args, stream)`` on ``dev``'s
    current stream, under the span ``lgs.kernel.<kernel>``, counted once it
    is queued. The span's image on the device's timeline covers the kernel,
    whatever it is named."""
    with span(f"lgs.kernel.{kernel}"):
        # the raw stream handle: torch.cuda.current_stream() builds a
        # Stream object, which costs more host time than a small launch; so
        # does entering the device's context, needed only when it is not
        # current
        if dev.index == torch.cuda.current_device():
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        else:
            with torch.cuda.device(dev):
                rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    counts[kernel] += 1
