"""The contrastive loss's node (``ops/contrastive.py``, ``csrc/contrast.cu``)
on the CPU: its plain versions against autograd of the eager loss, the
negatives it consumes, its launch plan, and the C interface the wrappers
declare against the source.

The plain versions are the kernels' closed forms: per row n = ||f||,
c_p = f.a_p / max(n, eps), c_n = f.(sum_s a_s) / (S max(n, eps)), the two
hinges, and df = r (-wp a_p + wn / S sum_s a_s) + r^2 (wp c_p - wn c_n) f.
In float64 they are held to autograd through ``contrastive_language_loss``'s
eager arithmetic (its ``_pair_dist``, ``where`` and ``relu``) at 1e-12; in
float32 and bf16 to the eager loss itself, which computes in f32, at a few
units of f32 rounding. The kernels run on the card only
(tests/test_torch_cuda.py).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.losses import contrastive as lc
from languagegroundedsemseg_torch.ops import contrastive as oc
from languagegroundedsemseg_torch.ops import cuda_kernels

SRC = Path(cuda_kernels.CSRC_DIR) / "contrast.cu"
F64_TOL = 1e-12
F32_TOL = 1e-5
IGNORE = 255


def _case(rows=400, dim=24, classes=9, samples=3, seed=0, dtype=torch.float64):
    """Features mixed from the label's anchor, a negative's and noise, so
    that both hinges fall on both sides of their margins; ignored labels
    and padding rows (row_mask 0); the negatives of ``sample_negatives``,
    which draws the label's neighbour class too."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(classes, dim))
    unit = a / np.linalg.norm(a, axis=1, keepdims=True)
    labels = rng.integers(0, classes, rows)
    gen = torch.Generator().manual_seed(seed)
    negatives = lc.sample_negatives(gen, torch.as_tensor(labels), classes, samples)
    neg_dir = unit[negatives.numpy()].mean(1)
    neg_dir /= np.linalg.norm(neg_dir, axis=1, keepdims=True)
    mix = rng.uniform(0, 1.2, (rows, 1))
    toward = rng.uniform(-1.5, 2.0, (rows, 1))
    f = (mix * unit[labels] + toward * neg_dir
         + 0.3 * rng.normal(size=(rows, dim))) * rng.uniform(0.2, 3.0, (rows, 1))
    f[7] = 0.0  # a zero row: the normalisation's clamp
    labels[rng.random(rows) < 0.1] = IGNORE
    row_mask = (rng.random(rows) < 0.85).astype(np.float32)
    return (torch.tensor(f, dtype=dtype), torch.as_tensor(labels, dtype=torch.int32),
            torch.as_tensor(row_mask), negatives, torch.tensor(unit, dtype=dtype))


def _eager(f, labels, row_mask, negatives, unit, pos_thresh, neg_thresh):
    """``contrastive_language_loss``'s eager hinges, in f's own dtype."""
    valid = (labels != IGNORE) & (row_mask > 0)
    safe = labels.long().clamp(0, unit.shape[0] - 1)
    zero = torch.zeros((), dtype=f.dtype)
    d_pos = torch.where(valid, lc._pair_dist(f, unit[safe][:, None, :], "cos"), zero)
    d_neg = torch.where(valid, lc._pair_dist(f, unit[negatives], "cos"), zero)
    return (torch.where(valid, torch.relu(d_pos - pos_thresh), zero),
            torch.where(valid, torch.relu(neg_thresh - d_neg), zero))


@pytest.mark.parametrize("pos_thresh,neg_thresh", [(0.0, 0.6), (0.6, 0.9)])
@pytest.mark.parametrize("samples", [1, 3, 8])
def test_plain_versions_match_eager_autograd_in_float64(pos_thresh, neg_thresh,
                                                         samples):
    f, labels, row_mask, negatives, unit = _case(samples=samples)
    pos, negl, stat = oc.contrast_fwd_reference(f, labels, row_mask, negatives,
                                                unit, IGNORE, pos_thresh,
                                                neg_thresh)
    fe = f.clone().requires_grad_(True)
    want_pos, want_neg = _eager(fe, labels, row_mask, negatives, unit, pos_thresh,
                                neg_thresh)
    valid = (labels != IGNORE) & (row_mask > 0)
    # every kind of row is there: each hinge on both sides of its margin
    # (a positive margin of 0 leaves only rows on the anchor inside it),
    # ignored labels, padding
    assert int(((negl > 0) & valid).sum()) > 20 and int(((negl == 0) & valid).sum()) > 20
    assert int(((pos > 0) & valid).sum()) > 20
    assert pos_thresh == 0 or int(((pos == 0) & valid).sum()) > 20
    assert int((labels == IGNORE).sum()) and int((row_mask == 0).sum())
    assert float((pos - want_pos.detach()).abs().max()) <= F64_TOL
    assert float((negl - want_neg.detach()).abs().max()) <= F64_TOL
    assert torch.equal(stat[:, 2], torch.linalg.vector_norm(f, dim=1))

    g = torch.Generator().manual_seed(1)
    gp = torch.randn(f.shape[0], generator=g, dtype=f.dtype)
    gn = torch.randn(f.shape[0], generator=g, dtype=f.dtype)
    want, = torch.autograd.grad((want_pos * gp).sum() + (want_neg * gn).sum(), fe)
    got = oc.contrast_bwd_reference(f, labels, negatives, unit, stat, pos, negl,
                                    gp, gn)
    assert float((got - want).abs().max() / want.abs().max()) <= F64_TOL
    # rows whose hinges are both off (ignored, padding, inside both
    # margins) get no gradient
    off = (pos == 0) & (negl == 0)
    assert int(off.sum()) > 0 and float(got[off].abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_node_matches_the_eager_loss(dtype, monkeypatch):
    """``contrastive_language_loss`` through the node (its plain versions on
    the CPU) against the same call through the eager arithmetic: the loss,
    both per-row hinges and the features' gradient, with the negatives the
    loss draws from the generator."""
    f, labels, row_mask, _, unit = _case(dtype=torch.float32)
    f = f.to(dtype)

    def run(node):
        monkeypatch.setattr(lc, "_takes_node", lambda *a: node)
        x = f.clone().requires_grad_(True)
        loss, pos, negl = lc.contrastive_language_loss(
            torch.Generator().manual_seed(5), x, labels, unit[:, None, :],
            row_mask=row_mask, neg_thresh=0.6)
        (loss + 0.5 * pos.sum()).backward()
        return loss.detach(), pos.detach(), negl.detach(), x.grad

    got, want = run(True), run(False)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype == torch.float32
        assert float((g - w).abs().max()) <= F32_TOL * max(float(w.abs().max()), 1.0)
    assert got[3].dtype == dtype
    unit_err = 2.0 ** -8 if dtype == torch.bfloat16 else F32_TOL
    assert float((got[3].float() - want[3].float()).abs().max()
                 / want[3].float().abs().max()) <= unit_err


def test_node_consumes_sample_negatives_draw(monkeypatch):
    """Through the node the loss draws its negatives with
    ``sample_negatives`` from the generator, once, over every row: the same
    (N, S) ids, bit for bit, as the eager loss and the benchmark's judge
    redraw."""
    f, labels, row_mask, _, unit = _case(dtype=torch.float32)
    seen = []
    node = lc.contrastive_cos

    def recording(*args, **kwargs):
        seen.append(args[3].clone())
        return node(*args, **kwargs)

    monkeypatch.setattr(lc, "_takes_node", lambda *a: True)
    monkeypatch.setattr(lc, "contrastive_cos", recording)
    lc.contrastive_language_loss(torch.Generator().manual_seed(11), f, labels, unit,
                                 num_negatives=3, row_mask=row_mask)
    want = lc.sample_negatives(torch.Generator().manual_seed(11),
                               labels.long().clamp(0, unit.shape[0] - 1),
                               unit.shape[0], 3)
    assert len(seen) == 1 and torch.equal(seen[0], want)
    r = torch.randint(0, unit.shape[0] - 1, (f.shape[0], 3),
                      generator=torch.Generator().manual_seed(11))
    lab = labels.long().clamp(0, unit.shape[0] - 1)[:, None]
    assert torch.equal(seen[0], r + (r >= lab).long())
    assert not bool((seen[0] == lab).any())


def test_the_card_takes_the_node_only_for_cos_and_one_anchor_a_class():
    cpu = torch.zeros(2, 4)
    assert not lc._takes_node(cpu, "cos", None)

    class Card:
        is_cuda = True

    assert lc._takes_node(Card(), "cos", None)
    assert not lc._takes_node(Card(), "l2", None)
    assert not lc._takes_node(Card(), "l1", None)
    assert not lc._takes_node(Card(), "cos", torch.zeros(3, 2, 4))


@pytest.mark.parametrize("dim", [96, 100, 128, 512])
@pytest.mark.parametrize("rows", [1, 63, 64, 65, 13312, 800_000, 2_359_296, 2_400_000])
def test_plan_covers_the_step_shapes(rows, dim):
    """The wrappers take every step shape (the blocks that cover the rows
    are the kernels' own: tests/test_torch_cuda.py on the card)."""
    for samples in range(1, 9):
        oc.check_shape(rows, dim, samples, 200)


@pytest.mark.parametrize("rows,dim,samples,classes", [
    (0, 512, 3, 200), (2 ** 31, 512, 3, 200), (100, 0, 3, 200),
    (100, oc.CONTRAST_MAX_DIM + 1, 3, 200), (100, 512, 0, 200),
    (100, 512, 9, 200), (100, 512, 3, 1), (100, 512, 3, oc.CONTRAST_MAX_CLASSES + 1)])
def test_plan_raises_on_shapes_it_does_not_take(rows, dim, samples, classes):
    with pytest.raises(ValueError):
        oc.check_shape(rows, dim, samples, classes)
    with pytest.raises(ValueError):
        oc.contrast_geometry(rows, dim, samples, classes)


def test_wrappers_refuse_mismatched_operands():
    f, labels, row_mask, negatives, unit = _case(dtype=torch.float32)
    with pytest.raises(ValueError):
        oc.contrast_fwd(f, labels, row_mask, negatives[:-1], unit, IGNORE, 0.0, 0.6)
    with pytest.raises(ValueError):
        oc.contrast_fwd(f, labels, row_mask, negatives, unit[:, :-1], IGNORE, 0.0, 0.6)
    with pytest.raises(ValueError):
        oc.contrast_fwd(f, labels[:-1], row_mask, negatives, unit, IGNORE, 0.0, 0.6)


# ---- the C interface against the source -------------------------------------


_CTYPE = {"void*": "c_void_p", "int": "c_int", "float": "c_float"}


def _c_params(symbol):
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", SRC.read_text())
    assert m, symbol
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("void*" if "*" in p else p.rsplit(" ", 1)[0])
    return [_CTYPE[k] for k in kinds]


@pytest.mark.parametrize("symbol,argtypes", [
    ("lgs_contrast_fwd", cuda_kernels.KERNELS["contrast"][2]),
    ("lgs_contrast_bwd", oc._BWD_ARGS), ("lgs_contrast_plan", oc._PLAN_ARGS)])
def test_declared_argtypes_match_the_c_entry_points(symbol, argtypes):
    assert [t.__name__ for t in argtypes] == _c_params(symbol)


def test_plan_constants_match_the_source():
    text = SRC.read_text()
    m = re.search(r"constexpr int MAX_S = (\d+);", text)
    assert m and int(m.group(1)) == oc.CONTRAST_MAX_SAMPLES
    m = re.search(r"constexpr float EPS = ([0-9e.+-]+)f;", text)
    assert m and float(m.group(1)) == oc.EPS
