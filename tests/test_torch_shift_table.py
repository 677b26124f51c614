"""The selector convs' masked-shift table (``ops/shift_table.py``,
``csrc/t3.cu``) on the CPU: the op against the eager expression it replaces,
what it refuses, and the C interface the wrapper declares against the
source. The kernel runs on the card only
(tests/test_torch_cuda.py, where it is held bit for bit to the same
expression).
"""

import re
from pathlib import Path

import pytest
import torch

from languagegroundedsemseg_torch.ops import cuda_kernels
from languagegroundedsemseg_torch.ops import onehot_conv as oc
from languagegroundedsemseg_torch.ops import shift_table as st
from languagegroundedsemseg_torch.ops.msconv import _t3

SRC = Path(cuda_kernels.CSRC_DIR) / "t3.cu"


def _case(rows=37, c=8, dtype=torch.float32, seed=0):
    """x with signed zeros, infinities and a NaN among normal values; masks
    of all eight (mp, mn, mc) patterns, rows 0 and rows - 1 unmasked."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((rows, c), generator=gen)
    x[1, 0], x[2, -1], x[3, 0], x[-1, -1] = -0.0, float("inf"), float("nan"), 0.0
    x[4, 0] = float("-inf")
    pattern = torch.arange(rows) % 8
    pattern[0] = pattern[-1] = 7
    masks = [((pattern >> k) & 1).to(torch.uint8) for k in range(3)]
    return (x.to(dtype), *masks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [3, 8, 12, 8193])
def test_cpu_op_is_the_eager_table(c, dtype):
    x, mp, mn, mc = _case(c=c, dtype=dtype)
    before = dict(st.launch_counts)
    got = st.masked_shift_table_bf16(x, mp, mn, mc)
    want = _t3(x.to(torch.bfloat16), mp, mn, mc)[:-1]
    assert got.dtype == torch.bfloat16 and got.shape == (x.shape[0], 3 * c)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert torch.equal(st.masked_shift_table_reference(x, mp, mn, mc).view(torch.int16),
                       want.view(torch.int16))
    assert st.launch_counts == before  # the CPU launches nothing


def test_rows_follow_the_contract():
    """Row r: [x[r-1] * mp[r] | x[r] * mc[r] | x[r+1] * mn[r]] in bf16, the
    neighbours wrapping around at rows 0 and rows - 1."""
    x, mp, mn, mc = _case(rows=9, c=4)
    x = torch.nan_to_num(x, nan=1.0, posinf=2.0, neginf=-2.0)
    got = st.masked_shift_table_bf16(x, mp, mn, mc).float()
    xb = x.to(torch.bfloat16).float()
    rows = x.shape[0]
    for r in range(rows):
        want = torch.cat([xb[(r - 1) % rows] * mp[r], xb[r] * mc[r],
                          xb[(r + 1) % rows] * mn[r]])
        assert torch.equal(got[r], want), r


def _refused(exc, x, mp, mn, mc):
    with pytest.raises(exc):
        st.check_operands(x, mp, mn, mc)
    with pytest.raises(exc):
        st.masked_shift_table_bf16(x, mp, mn, mc)


@pytest.mark.parametrize("what", ["f64", "f16", "int"])
def test_refuses_dtypes_the_kernel_does_not_take(what):
    x, mp, mn, mc = _case()
    dtype = {"f64": torch.float64, "f16": torch.float16, "int": torch.int32}[what]
    _refused(TypeError, x.to(dtype), mp, mn, mc)


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32, torch.int64])
def test_refuses_masks_that_are_not_uint8(which, dtype):
    x, *masks = _case()
    masks[which] = masks[which].to(dtype)
    _refused(TypeError, x, *masks)


@pytest.mark.parametrize("what", ["strided", "short_mask", "long_mask",
                                  "mask_2d", "strided_mask", "vector"])
def test_refuses_shapes_the_kernel_does_not_take(what):
    x, mp, mn, mc = _case()
    if what == "strided":
        x = torch.zeros((x.shape[0], 2 * x.shape[1]))[:, ::2]
    elif what == "short_mask":
        mn = mn[:-1]
    elif what == "long_mask":
        mc = torch.cat([mc, mc[:1]])
    elif what == "mask_2d":
        mp = mp[:, None]
    elif what == "strided_mask":
        mp = torch.stack([mp, mp], 1)[:, 0]
    elif what == "vector":
        x = x[:, 0].contiguous()
    _refused(ValueError, x, mp, mn, mc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_op_takes_an_empty_table(dtype):
    """The CPU keeps the eager expression's reach: no rows in, none out
    (on the card the C entry refuses a plan for no rows)."""
    x = torch.zeros((0, 5), dtype=dtype)
    m = torch.zeros(0, dtype=torch.uint8)
    got = st.masked_shift_table_bf16(x, m, m, m)
    assert got.dtype == torch.bfloat16 and got.shape == (0, 15)


def test_selector_conv_launch_counts_keep_their_keys():
    assert set(st.launch_counts) == {"t3"}
    assert set(oc.launch_counts) == {"sel_fwd", "csum", "dw"}


# ---- the C interface against the source -------------------------------------


_CTYPE = {"void*": "c_void_p", "int": "c_int"}


def _c_params(symbol):
    m = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", SRC.read_text())
    assert m, symbol
    kinds = []
    for p in m.group(1).split(","):
        p = " ".join(p.split())
        kinds.append("void*" if "*" in p else p.rsplit(" ", 1)[0])
    return [_CTYPE[k] for k in kinds]


@pytest.mark.parametrize("symbol,argtypes", [
    ("lgs_t3", cuda_kernels.KERNELS["t3"][2]), ("lgs_t3_plan", st._PLAN_ARGS)])
def test_declared_argtypes_match_the_c_entry_points(symbol, argtypes):
    assert [t.__name__ for t in argtypes] == _c_params(symbol)

