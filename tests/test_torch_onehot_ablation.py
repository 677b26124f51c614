"""The one-hot ablation kernels: the port's plain versions against the JAX
package's Pallas kernels in interpret mode, on the scripts' own inputs.

``onehot_gemm_reference`` against ``build_fn(interpret=True)`` of
scripts/bench_onehot_pallas.py, and ``onehot_variants_reference`` against
the kernel of scripts/bench_onehot_variants.py, both at small sizes (the
scripts' module constants patched). The variants kernel is a closure inside
that script's ``main()``: the test runs ``main()`` with ``pallas_call``
replaced by a recorder (and ``jax.jit`` by the identity, so the recorder
sees the script's concrete inputs), then runs the recorded kernel through
the real ``pallas_call`` in interpret mode. Neither script is edited.

Tolerances: ``onehot_gemm``, ``no_sel`` and ``no_proj`` sum the same values
in f32 in another order: 1e-5 of max |ref|. ``full`` rounds each column's
f32 product to bf16, which another sum order can flip by one bf16 unit:
1e-2 of max |ref|. ``-rP`` prints the measured errors. The JAX ``no_dma``
mode reads uninitialised VMEM (interpret mode gives NaN); the port's
zero-fills, so its output is zeros.
The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py's ``ablation`` phase.
"""

import importlib.util
import os
import sys

import jax
import jax.experimental.pallas as jpl
import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.ops import onehot_ablation as oa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
FULL_RTOL = 1e-2

# (N, B, W, CW, COUT, M) of bench_onehot_pallas.py, cut to CPU size
GEMM_SIZES = [(4096, 256, 512, 128, 32, 192), (2048, 128, 384, 64, 16, 96)]
# (CAP, TILE, WIN, CWP, COUT) of bench_onehot_variants.py, cut to CPU size
VARIANT_SIZES = [(2048, 256, 384, 128, 32), (1024, 128, 256, 64, 16)]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _max_rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _f32(a):
    return np.asarray(a).astype(np.float32)


def _gemm_script(monkeypatch, size):
    """bench_onehot_pallas.py with its constants set to ``size`` and its
    global JAX settings left alone."""
    mod = _load_script("bench_onehot_pallas")
    for k, v in zip(("N", "B", "W", "CW", "COUT", "M"), size):
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    return mod


@pytest.mark.parametrize("size", GEMM_SIZES)
def test_gemm_script_inputs_and_kernel_match_port(monkeypatch, size):
    """The script's main() in interpret mode: its inputs equal
    gemm_inputs at the same seed, and its kernel's output equals
    onehot_gemm_reference on them."""
    n, b, w, cw, c_out, m = size
    mod = _gemm_script(monkeypatch, size)
    seen = {}
    real_build = mod.build_fn

    def recording_build_fn(interpret=False):
        f = real_build(interpret)

        def run(*arrays):
            seen["inputs"] = [np.asarray(x) for x in arrays]
            seen["out"] = np.asarray(f(*arrays))
            return seen["out"]
        return run

    monkeypatch.setattr(mod, "build_fn", recording_build_fn)
    monkeypatch.setattr(sys, "argv", ["bench_onehot_pallas.py", "--interpret"])
    mod.main()
    port = oa.gemm_inputs(n, b, w, cw, c_out, m, seed=0, device="cpu")
    for name, arr in zip(("wstart", "anchors", "t3", "w"), seen["inputs"]):
        assert port[name].dtype == {np.int32: torch.int32,
                                    np.float32: torch.float32}[arr.dtype.type]
        np.testing.assert_array_equal(port[name].numpy(), arr, err_msg=name)
    got = oa.onehot_gemm_reference(port["wstart"], port["anchors"],
                                   port["t3"], port["w"], b, w)
    assert got.dtype == torch.float32 and got.shape == (n, c_out)
    rel = _max_rel(got.numpy(), seen["out"])
    print(f"onehot_gemm {size}: max rel err vs Pallas {rel:.3e}")
    assert rel <= RTOL


@pytest.mark.parametrize("size", GEMM_SIZES)
def test_onehot_gemm_reference_matches_pallas_out_of_window(monkeypatch,
                                                            size):
    """20% of the anchors moved anywhere in the table: those outside their
    tile's window give zero rows, as the iota compare does."""
    n, b, w, cw, c_out, m = size
    mod = _gemm_script(monkeypatch, size)
    port = oa.gemm_inputs(n, b, w, cw, c_out, m, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    anchors = port["anchors"].numpy().copy()
    pick = rng.random(n) < 0.2
    anchors[pick] = rng.integers(0, n, int(pick.sum()))
    hit, _ = oa._gemm_hits(port["wstart"], torch.from_numpy(anchors), n, b, w)
    assert 0 < int((~hit).sum()) < n
    want = np.asarray(mod.build_fn(interpret=True)(
        port["wstart"].numpy(), anchors, port["t3"].numpy(),
        port["w"].numpy()))
    got = oa.onehot_gemm_reference(port["wstart"], torch.from_numpy(anchors),
                                   port["t3"], port["w"], b, w)
    assert _max_rel(got.numpy(), want) <= RTOL
    assert not got[~hit].any() and not want[~hit.numpy()].any()


def _capture_variants(monkeypatch, size):
    """Run bench_onehot_variants.py's main() at ``size`` with pallas_call
    recording, per mode, the kernel, its pallas_call keywords and the
    concrete inputs, then raising (main() reports FAIL and goes on)."""
    cap, tile, win, cwp, c_out = size
    mod = _load_script("bench_onehot_variants")
    for k, v in zip(("CAP", "TILE", "WIN", "CWP", "COUT"), size):
        monkeypatch.setattr(mod, k, v)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jax, "jit", lambda f, **k: f)
    seen = {}

    def recording_pallas_call(kernel, **kwargs):
        def run(*arrays):
            seen[kernel.args[0]] = (kernel, kwargs, arrays)
            raise RuntimeError("recorded")
        return run

    real = jpl.pallas_call
    monkeypatch.setattr(jpl, "pallas_call", recording_pallas_call)
    mod.main()
    monkeypatch.setattr(jpl, "pallas_call", real)
    assert set(seen) == set(oa.MODES)
    return mod, seen


def _port_variants(size, seed=0):
    cap, tile, win, cwp, c_out = size
    return oa.variants_inputs(cap, tile, win, 3, cwp, c_out, seed=seed,
                              device="cpu")


@pytest.mark.parametrize("size", VARIANT_SIZES)
def test_variants_inputs_match_script(monkeypatch, size):
    _, seen = _capture_variants(monkeypatch, size)
    port = _port_variants(size)
    for mode in oa.MODES:
        arrays = seen[mode][2]
        for name, arr in zip(("wstart", "anchors", "t3", "w"), arrays):
            want = np.asarray(arr)
            got = port[name]
            if name in ("t3", "w"):
                assert got.dtype == torch.bfloat16
                got, want = got.to(torch.float32), _f32(want)
            else:
                assert got.dtype == torch.int32 and want.dtype == np.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{mode} {name}")


@pytest.mark.parametrize("mode", ["full", "no_sel", "no_proj"])
@pytest.mark.parametrize("size", VARIANT_SIZES)
def test_onehot_variants_reference_matches_pallas(monkeypatch, size, mode):
    cap, tile, win, cwp, c_out = size
    _, seen = _capture_variants(monkeypatch, size)
    kernel, kwargs, arrays = seen[mode]
    kwargs = {k: v for k, v in kwargs.items() if k != "compiler_params"}
    want = np.asarray(jpl.pallas_call(kernel, interpret=True, **kwargs)(
        *arrays))
    port = _port_variants(size)
    got = oa.onehot_variants_reference(mode, port["wstart"], port["anchors"],
                                       port["t3"], port["w"], tile, win, 3)
    assert got.dtype == torch.float32 and got.shape == (cap, c_out)
    assert np.isfinite(want).all()
    rel = _max_rel(got.numpy(), want)
    print(f"onehot_variants {mode} {size}: max rel err vs Pallas {rel:.3e}")
    assert rel <= (FULL_RTOL if mode == "full" else RTOL)


@pytest.mark.parametrize("size", VARIANT_SIZES)
def test_no_dma_gives_zeros(size):
    """The JAX mode computes on uninitialised VMEM; the port's computes on
    a zero fill, so its output is defined: zeros of the output's shape."""
    cap, tile, win, cwp, c_out = size
    p = _port_variants(size)
    args = (p["wstart"], p["anchors"], p["t3"], p["w"], tile, win, 3)
    for fn in (oa.onehot_variants_reference, oa.onehot_variants):
        out = fn("no_dma", *args)
        assert out.dtype == torch.float32 and out.shape == (cap, c_out)
        assert not out.any()


@pytest.mark.parametrize("kernel", ["onehot_gemm", *oa.MODES])
def test_cpu_wrappers_run_plain_versions_and_count_nothing(kernel):
    """On CPU tensors the wrappers return the plain versions' results and
    leave the launch counts alone: a count is a launch on the card."""
    before = dict(oa.launch_counts)
    if kernel == "onehot_gemm":
        n, b, w, cw, c_out, m = GEMM_SIZES[0]
        p = oa.gemm_inputs(n, b, w, cw, c_out, m, seed=2, device="cpu")
        args = (p["wstart"], p["anchors"], p["t3"], p["w"], b, w)
        got, want = oa.onehot_gemm(*args), oa.onehot_gemm_reference(*args)
    else:
        size = VARIANT_SIZES[0]
        p = _port_variants(size, seed=2)
        args = (kernel, p["wstart"], p["anchors"], p["t3"], p["w"], size[1],
                size[2], 3)
        got = oa.onehot_variants(*args)
        want = oa.onehot_variants_reference(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert oa.launch_counts == before


def test_unknown_mode_raises():
    p = _port_variants(VARIANT_SIZES[1])
    args = (p["wstart"], p["anchors"], p["t3"], p["w"], 128, 256, 3)
    for fn in (oa.onehot_variants, oa.onehot_variants_reference):
        with pytest.raises(ValueError, match="mode"):
            fn("no_such_mode", *args)


def test_input_builders_default_to_the_card():
    """Like the port's other entry points, the builders default to
    device="cuda" and raise without a card instead of running on the
    CPU."""
    if torch.cuda.is_available():
        assert oa.gemm_inputs(*GEMM_SIZES[1])["t3"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        oa.gemm_inputs(*GEMM_SIZES[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        oa.variants_inputs(1024, 128, 256, 3, 64, 16)
