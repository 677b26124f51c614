"""The selector convs' bf16 masked-shift table in one hand-written kernel
(``csrc/t3.cu``).

``ops/onehot_conv.py`` projects each selector conv's input through

    T3 = [x_prev * mp | x * mc | x_next * mn]    (cap rows, 3C, bf16)

(``ops/msconv.py`` ``_t3`` without its guard row) in the forward, the dX and
the dW. ``masked_shift_table_bf16`` launches the kernel for every CUDA
tensor, as the batch norm's and the contrastive loss's ops take theirs, and
runs the eager expression ``_t3(x.to(torch.bfloat16), mp, mn, mc)[:-1]`` on
the CPU; that expression is also the plain version
(``masked_shift_table_reference``): the kernel is bit-equal to it, NaNs
aside (NaN where it has NaN). Python refuses on every device what the C
entry cannot see (x's dtype and layout, the masks); the C entry refuses a
width or a row count its launch plan does not cover, which ``launch``
raises.
"""

from __future__ import annotations

import ctypes

import torch

from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.ops.msconv import _t3

# Launches of the kernel: the wrapper adds one where it launches it on the
# card and nowhere else. A selector conv's forward makes one, its dX one
# and its dW one.
launch_counts = {"t3": 0}

# x's dtype as lgs_t3 takes it (the launch plan is the C source's own,
# ``t3_geometry`` reads it on the card)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def check_operands(x, mp, mn, mc) -> None:
    """Raises TypeError for an x that is not f32 or bf16 or masks that are
    not uint8, ValueError for an x that is not a contiguous (rows, c) table
    or masks that are not contiguous (rows,) on x's device: what the kernel
    does not take and its C entry cannot see."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"masked-shift table: x is {x.dtype}, not f32 or bf16")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"masked-shift table: x {tuple(x.shape)} is not a "
                         "contiguous (rows, c) table")
    rows = x.shape[0]
    for name, m in (("mp", mp), ("mn", mn), ("mc", mc)):
        if m.dtype != torch.uint8:
            raise TypeError(f"masked-shift table: {name} is {m.dtype}, not uint8")
        if tuple(m.shape) != (rows,) or not m.is_contiguous():
            raise ValueError(f"masked-shift table: {name} {tuple(m.shape)} is "
                             f"not a contiguous ({rows},) mask")
        if m.device != x.device:
            raise ValueError(f"masked-shift table: {name} is on {m.device}, "
                             f"x on {x.device}")


def masked_shift_table_reference(x, mp, mn, mc):
    """Plain version of the kernel: the eager expression it replaces."""
    return _t3(x.to(torch.bfloat16), mp, mn, mc)[:-1]


def masked_shift_table_bf16(x, mp, mn, mc):
    """(rows, 3c) bf16 T3 of x (rows, c), f32 or bf16, and the (rows,)
    uint8 masks: row r is [bf16(x[r-1]) * mp[r] | bf16(x[r]) * mc[r] |
    bf16(x[r+1]) * mn[r]], the neighbours wrapping around as
    ``torch.roll``'s. One kernel launch for a CUDA tensor, the plain
    version on the CPU; raises as ``check_operands``, and on the card
    RuntimeError for a shape the kernel's launch plan does not cover."""
    check_operands(x, mp, mn, mc)
    if not x.is_cuda:
        return masked_shift_table_reference(x, mp, mn, mc)
    rows, c = x.shape
    if rows >= 2 ** 31:  # the C entry takes an int
        raise ValueError(f"masked-shift table: {rows} rows, above 2**31 - 1")
    if x.data_ptr() % 16:
        x = x.clone()  # an offset view: the vector loads want 16 bytes
    out = torch.empty((rows, 3 * c), dtype=torch.bfloat16, device=x.device)
    cuda_kernels.launch(
        launch_counts, "t3", cuda_kernels.function("t3"), x.device,
        (x.data_ptr(), mp.data_ptr(), mn.data_ptr(), mc.data_ptr(),
         out.data_ptr(), rows, c, _DTYPES[x.dtype]))
    return out


_PLAN_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p]


def t3_geometry(rows: int, c: int, dtype=torch.float32) -> dict:
    """The launch the kernel makes at these shapes, from csrc/t3.cu:
    channels a thread, vectors a row, rows a thread, blocks, threads a
    block, and the blocks an SM holds of the kernel on this card. Builds
    and loads the kernel; needs a CUDA device."""
    if dtype not in _DTYPES:
        raise TypeError(f"masked-shift table: {dtype} is not f32 or bf16")
    plan = (ctypes.c_int * 6)()
    rc = cuda_kernels.function("t3", "lgs_t3_plan", _PLAN_ARGS)(
        rows, c, _DTYPES[dtype], ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"t3 plan query failed: CUDA error {rc}")
    return dict(zip(("vec", "vecs", "rows_per_thread", "blocks", "threads",
                     "blocks_per_sm"), plan))
