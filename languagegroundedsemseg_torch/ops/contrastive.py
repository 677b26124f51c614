"""The language-grounded contrastive loss with cosine distance as one
autograd node on hand-written kernels (``csrc/contrast.cu``).

``losses.contrastive.contrastive_language_loss`` takes this node for CUDA
features, ``distance == "cos"`` and one anchor a class; the CPU, the ``l2``
and ``l1`` distances and the attributed anchors of the ``latent``
augmentation keep its eager arithmetic. With n = ||f||, r = 1 / max(n, eps),
the label's unit anchor a_p and the S negatives' unit anchors a_s:

* forward (``contrast_fwd``): c_p = r f.a_p, c_n = r f.(sum_s a_s) / S;
  pos = relu(1 - c_p - pos_thresh), negl = relu(neg_thresh - (1 - c_n)),
  both 0 where the label is ignored or the row is padding; and the row's
  [c_p, c_n, n] for the backward.
* backward (``contrast_bwd``): with wp = gp where pos > 0 and wn = gn where
  negl > 0 (0 elsewhere), df = r (-wp a_p + wn / S sum_s a_s)
  + [n >= eps] r^2 (wp c_p - wn c_n) f. The anchors get no gradient.

The node saves f, the labels, the negatives, the unit anchor table, the
per-row [c_p, c_n, n] and its two outputs: nothing of size (N, S, D). f is
f32 or bf16 and read as f32; df is written in f's type. The negatives are
the (N, S) class ids ``sample_negatives`` returns, drawn by the caller, so
the draw is the eager loss's bit for bit. Each wrapper launches its kernel
for a CUDA tensor and runs its plain PyTorch version for a CPU one
(``*_reference``, the closed forms above in f32, or f64 for f64 features);
there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from languagegroundedsemseg_torch.ops import cuda_kernels

# Launches of each kernel: a wrapper adds one where it launches its kernel
# on the card and nowhere else. A representation step makes one of each.
launch_counts = {"contrast_fwd": 0, "contrast_bwd": 0}

# The shapes the kernels take (csrc/contrast.cu refuses S and C again and
# makes its own launch plan, which ``contrast_geometry`` reads).
CONTRAST_MAX_SAMPLES = 8
CONTRAST_MAX_DIM = 4096
CONTRAST_MAX_CLASSES = 65536
EPS = 1e-12  # the eager loss's normalisation clamp
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def check_shape(rows: int, dim: int, samples: int, classes: int) -> None:
    """Raises ValueError for rows outside 1..2**31 - 1, a width outside
    1..CONTRAST_MAX_DIM, negatives outside 1..CONTRAST_MAX_SAMPLES or
    classes outside 2..CONTRAST_MAX_CLASSES: what the kernels do not take."""
    if not 1 <= rows < 2 ** 31:
        raise ValueError(f"contrastive kernels: {rows} rows, not 1 to 2**31 - 1")
    if not 1 <= dim <= CONTRAST_MAX_DIM:
        raise ValueError(f"contrastive kernels: width {dim}, not 1 to "
                         f"{CONTRAST_MAX_DIM}")
    if not 1 <= samples <= CONTRAST_MAX_SAMPLES:
        raise ValueError(f"contrastive kernels: {samples} negatives a row, not "
                         f"1 to {CONTRAST_MAX_SAMPLES}")
    if not 2 <= classes <= CONTRAST_MAX_CLASSES:
        raise ValueError(f"contrastive kernels: {classes} classes, not 2 to "
                         f"{CONTRAST_MAX_CLASSES}")


_PLAN_ARGS = [ctypes.c_int, ctypes.c_void_p]


def contrast_geometry(rows: int, dim: int, samples: int, classes: int) -> dict:
    """The launch both kernels make at these shapes, from csrc/contrast.cu:
    blocks, threads, rows a warp, and the blocks an SM holds of each f32
    kernel on this card. Raises ValueError as ``check_shape``. Builds and
    loads the kernels; needs a CUDA device."""
    check_shape(rows, dim, samples, classes)
    plan = (ctypes.c_int * 5)()
    rc = cuda_kernels.function("contrast", "lgs_contrast_plan", _PLAN_ARGS)(
        rows, ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"contrast plan query failed: CUDA error {rc}")
    return dict(zip(("blocks", "threads", "rows_per_warp", "fwd_blocks_per_sm",
                     "bwd_blocks_per_sm"), plan))


# ---- plain versions ------------------------------------------------------


def _acc(f: torch.Tensor) -> torch.dtype:
    return torch.float64 if f.dtype == torch.float64 else torch.float32


def _rows(f, labels, negatives, unit):
    """f in its accumulation type, the label's anchor and the negatives'
    anchor sum of each row."""
    acc = _acc(f)
    c = unit.shape[0]
    a = unit.to(acc)
    a_p = a[labels.long().clamp(0, c - 1)]
    a_n = a[negatives.long().clamp(0, c - 1)].sum(1)
    return f.to(acc), a_p, a_n


def contrast_fwd_reference(f, labels, row_mask, negatives, unit, ignore_index,
                           pos_thresh, neg_thresh):
    """Plain version of the forward kernel: (pos, negl, stat (N, 3))."""
    ff, a_p, a_n = _rows(f, labels, negatives, unit)
    n = torch.linalg.vector_norm(ff, dim=1)
    r = 1.0 / torch.clamp(n, min=EPS)
    cp = (ff * a_p).sum(1) * r
    cn = (ff * a_n).sum(1) * r / negatives.shape[1]
    valid = labels != ignore_index
    if row_mask is not None:
        valid = valid & (row_mask > 0)
    zero = torch.zeros((), dtype=ff.dtype, device=ff.device)
    pos = torch.where(valid, torch.relu(1.0 - cp - pos_thresh), zero)
    negl = torch.where(valid, torch.relu(neg_thresh - (1.0 - cn)), zero)
    return pos, negl, torch.stack([cp, cn, n], dim=1)


def contrast_bwd_reference(f, labels, negatives, unit, stat, pos, negl, gp, gn):
    """Plain version of the backward kernel: df in f's type."""
    ff, a_p, a_n = _rows(f, labels, negatives, unit)
    stat = stat.to(ff.dtype)
    cp, cn, n = stat[:, 0], stat[:, 1], stat[:, 2]
    zero = torch.zeros((), dtype=ff.dtype, device=ff.device)
    wp = torch.where(pos > 0, gp.to(ff.dtype), zero)
    wn = torch.where(negl > 0, gn.to(ff.dtype), zero)
    r = 1.0 / torch.clamp(n, min=EPS)
    gamma = torch.where(n >= EPS, (wp * cp - wn * cn) * r * r, zero)
    df = ((-wp * r)[:, None] * a_p + (wn * r / negatives.shape[1])[:, None] * a_n
          + gamma[:, None] * ff)
    return df.to(f.dtype)


# ---- kernel wrappers -----------------------------------------------------


# the forward's argtypes are cuda_kernels.KERNELS["contrast"]'s
_BWD_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _operand(t: torch.Tensor, name: str, dev, dtype=None) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"contrastive kernels: {name} is on {t.device}, "
                         f"expected {dev}")
    t = t.contiguous() if dtype is None else t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        t = t.clone()  # an offset view: the vector loads want 16 bytes
    return t


def _checked(f, labels, negatives, unit):
    """(rows, dim, samples, classes, dev) of a call, or ValueError."""
    if f.device.type not in ("cpu", "cuda"):
        raise ValueError(f"contrastive kernels: unsupported device {f.device}")
    if f.dim() != 2 or labels.shape != f.shape[:1]:
        raise ValueError(f"contrastive kernels: features {tuple(f.shape)}, labels "
                         f"{tuple(labels.shape)}: (N, D) and (N,)")
    rows, dim = f.shape
    if negatives.dim() != 2 or negatives.shape[0] != rows:
        raise ValueError(f"contrastive kernels: negatives {tuple(negatives.shape)} "
                         f"for {rows} rows")
    if unit.dim() != 2 or unit.shape[1] != dim:
        raise ValueError(f"contrastive kernels: anchors {tuple(unit.shape)} for "
                         f"width {dim}")
    return rows, dim, negatives.shape[1], unit.shape[0], f.device


def contrast_fwd(f, labels, row_mask, negatives, unit, ignore_index: int,
                 pos_thresh: float, neg_thresh: float):
    """(pos, negl, stat): the per-row hinge losses (f32, 0 on ignored and
    padding rows) and [c_p, c_n, ||f||] of f (N, D) against the unit
    anchors ``unit`` (C, D). A CUDA input launches the forward kernel (or
    raises, see ``check_shape``); a CPU input runs the plain version."""
    rows, dim, samples, classes, dev = _checked(f, labels, negatives, unit)
    if dev.type == "cpu":
        return contrast_fwd_reference(f, labels, row_mask, negatives, unit,
                                      ignore_index, pos_thresh, neg_thresh)
    check_shape(rows, dim, samples, classes)
    if f.dtype not in _DTYPES:
        raise ValueError(f"contrast_fwd: features {f.dtype} are not f32 or bf16")
    f = _operand(f, "features", dev)
    labels = _operand(labels, "labels", dev, torch.int32)
    negatives = _operand(negatives, "negatives", dev, torch.int64)
    unit = _operand(unit, "anchors", dev, torch.float32)
    mask = None if row_mask is None else _operand(row_mask, "row_mask", dev,
                                                  torch.float32)
    pos = torch.empty(rows, dtype=torch.float32, device=dev)
    negl = torch.empty(rows, dtype=torch.float32, device=dev)
    stat = torch.empty((rows, 3), dtype=torch.float32, device=dev)
    cuda_kernels.launch(
        launch_counts, "contrast_fwd", cuda_kernels.function("contrast"), dev,
        (f.data_ptr(), labels.data_ptr(), 0 if mask is None else mask.data_ptr(),
         negatives.data_ptr(), unit.data_ptr(), pos.data_ptr(), negl.data_ptr(),
         stat.data_ptr(), rows, dim, samples, classes, _DTYPES[f.dtype],
         int(ignore_index), float(pos_thresh), float(neg_thresh)))
    return pos, negl, stat


def contrast_bwd(f, labels, negatives, unit, stat, pos, negl, gp, gn):
    """df (N, D) in f's type from the cotangents ``gp``, ``gn`` of the
    forward's pos and negl. A CUDA input launches the backward kernel; a CPU
    input runs the plain version."""
    rows, dim, samples, classes, dev = _checked(f, labels, negatives, unit)
    if dev.type == "cpu":
        return contrast_bwd_reference(f, labels, negatives, unit, stat, pos,
                                      negl, gp, gn)
    check_shape(rows, dim, samples, classes)
    if f.dtype not in _DTYPES:
        raise ValueError(f"contrast_bwd: features {f.dtype} are not f32 or bf16")
    f = _operand(f, "features", dev)
    labels = _operand(labels, "labels", dev, torch.int32)
    negatives = _operand(negatives, "negatives", dev, torch.int64)
    unit = _operand(unit, "anchors", dev, torch.float32)
    per_row = [_operand(t, name, dev, torch.float32) for t, name in
               ((stat, "stat"), (pos, "pos"), (negl, "negl"), (gp, "gp"),
                (gn, "gn"))]
    df = torch.empty_like(f)
    cuda_kernels.launch(
        launch_counts, "contrast_bwd",
        cuda_kernels.function("contrast", "lgs_contrast_bwd", _BWD_ARGS), dev,
        (f.data_ptr(), labels.data_ptr(), negatives.data_ptr(), unit.data_ptr(),
         *(t.data_ptr() for t in per_row), df.data_ptr(), rows, dim, samples,
         classes, _DTYPES[f.dtype]))
    return df


# ---- the autograd node ---------------------------------------------------


class _ContrastiveCos(torch.autograd.Function):

    @staticmethod
    def forward(ctx, f, labels, row_mask, negatives, unit, ignore_index,
                pos_thresh, neg_thresh):
        pos, negl, stat = contrast_fwd(f, labels, row_mask, negatives, unit,
                                       ignore_index, pos_thresh, neg_thresh)
        ctx.save_for_backward(f, labels, negatives, unit, stat, pos, negl)
        return pos, negl

    @staticmethod
    def backward(ctx, gp, gn):
        f, labels, negatives, unit, stat, pos, negl = ctx.saved_tensors
        df = None
        if ctx.needs_input_grad[0]:
            df = contrast_bwd(f, labels, negatives, unit, stat, pos, negl, gp, gn)
        return df, None, None, None, None, None, None, None


def contrastive_cos(features, labels, anchors, negatives, *, row_mask=None,
                    ignore_index: int = 255, pos_thresh: float = 0.0,
                    neg_thresh: float = 0.6):
    """(pos_loss, neg_loss) per row of the cosine-distance contrastive loss
    of ``features`` (N, D) against ``anchors`` (C, D), the (N, S) class ids
    ``negatives`` and ``labels`` (N,), as one autograd node: kernels on a
    CUDA input, the plain versions on a CPU one. The anchors are made unit
    here (as the eager loss normalises each gathered copy) and get no
    gradient."""
    a = anchors.detach().to(torch.float32)
    unit = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                           min=EPS)
    return _ContrastiveCos.apply(features, labels, row_mask, negatives, unit,
                                 ignore_index, pos_thresh, neg_thresh)
