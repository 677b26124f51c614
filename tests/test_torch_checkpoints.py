"""The port's checkpoints and reference-weight import against the JAX
package's ``train/checkpoints.py``.

- ``me_kernel_permutation`` is array-equal to JAX's (cubes of 27, 125 and
  81 slots; None for a cross region).
- A reference-format state dict, written by JAX's
  ``flax_to_torch_state_dict`` from a random Res16UNet14A tree and saved
  with ``torch.save``, loads through the port's importer into exactly the
  tensors JAX's ``torch_to_flax_params`` + ``convert.state_dict_from_jax``
  give, with the same skipped names; the port's export is array-equal to
  JAX's.
- Save and restore round-trip the train state bit for bit and load with
  ``weights_only=True``; ``CheckpointManager`` leaves the same file names.
"""

import os

import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.models.res16unet import (
    Res16UNet14A as JaxRes16UNet14A,
    res16unet_graph_spec as jax_graph_spec,
)
from languagegroundedsemseg_tpu.train import checkpoints as jck
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.models.res16unet import Res16UNet14A
from languagegroundedsemseg_torch.train import checkpoints as pck
from languagegroundedsemseg_torch.train.solvers import sgd_torch
from languagegroundedsemseg_torch.train.state import TrainState
from test_torch_res16unet import _random_variables, _shapes


@pytest.mark.parametrize("num_slots,d", [(27, 3), (125, 3), (8, 3), (81, 4),
                                         (7, 3), (9, 4), (1, 3)])
def test_me_kernel_permutation_equal(num_slots, d):
    want = jck.me_kernel_permutation(num_slots, d)
    got = pck.me_kernel_permutation(num_slots, d)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
    if (num_slots, d) in ((7, 3), (9, 4)):  # cross regions
        assert got is None


@pytest.fixture(scope="module")
def jax_tree():
    """A random Res16UNet14A flax tree (20 classes) and its port state
    dict through ``state_dict_from_jax``."""
    scene = voxelize_scene(np.random.default_rng(0), 300)
    jbatch = JaxBatchBuilder(spec=jax_graph_spec(), fixed_capacity=512).build([scene])
    variables = _random_variables(_shapes(JaxRes16UNet14A(out_channels=20), jbatch), 1)
    params, stats = variables["params"], variables["batch_stats"]
    return params, stats, state_dict_from_jax(params, stats)


def _reference_template(port_sd):
    """Reference (MinkowskiEngine) names and shapes: the port's names, with
    the pointwise head stored kernel-volume-1, (1, Cin, Cout)."""
    tmpl = {k: np.zeros(tuple(v.shape), np.float32) for k, v in port_sd.items()}
    tmpl["final.kernel"] = tmpl["final.kernel"][None]
    return tmpl


def test_me_import_equals_jax_import(jax_tree, tmp_path):
    params, stats, port_sd = jax_tree
    exported, missing = jck.flax_to_torch_state_dict(params, stats,
                                                     _reference_template(port_sd))
    assert not missing
    blob = {"module." + k: torch.from_numpy(v) for k, v in exported.items()}
    # tensors the import must skip, as JAX's does
    blob["module.bn0.bn.num_batches_tracked"] = torch.tensor(5)
    blob["module.block1.0.norm1.bn.weight_extra"] = torch.ones(3)
    blob["module.conv0p1s1.kernel_t"] = torch.ones(2)
    blob["module.final.bias"] = torch.ones(7)  # wrong shape
    path = str(tmp_path / "ref.pth")
    torch.save({"state_dict": blob, "epoch": 3}, path)

    sd_j = jck.load_torch_state_dict(path)
    sd_p = pck.load_torch_state_dict(path)
    assert sd_j.keys() == sd_p.keys()
    jp, js, skipped_j = jck.torch_to_flax_params(sd_j, params, stats)
    want = state_dict_from_jax(jp, js)

    template = Res16UNet14A(out_channels=20, device="cpu").state_dict()
    got, skipped_p = pck.torch_to_port_state_dict(sd_p, template)
    assert skipped_p == skipped_j
    assert len(skipped_p) == 4
    assert got.keys() == want.keys()
    for k in want:
        if k == "final.bias":  # skipped: each keeps its template's own
            assert torch.equal(got[k], template[k])
            assert torch.equal(want[k], port_sd[k])
            continue
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


def test_me_import_without_permutation_equal(jax_tree):
    params, stats, port_sd = jax_tree
    sd = {k: v.numpy() for k, v in port_sd.items()}
    jp, js, skipped_j = jck.torch_to_flax_params(sd, params, stats, kernel_perm=None)
    got, skipped_p = pck.torch_to_port_state_dict(sd, port_sd, kernel_perm=None)
    want = state_dict_from_jax(jp, js)
    assert skipped_p == skipped_j == []
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_export_equals_jax_export(jax_tree):
    params, stats, port_sd = jax_tree
    tmpl = _reference_template(port_sd)
    tmpl["extra.running_mean"] = np.zeros(3, np.float32)  # missing in both
    want, missing_j = jck.flax_to_torch_state_dict(params, stats, tmpl)
    got, missing_p = pck.port_to_torch_state_dict(port_sd, tmpl)
    assert missing_p == missing_j == ["extra.running_mean"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == np.float32


def _state(seed):
    model = Res16UNet14A(out_channels=20, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    opt = sgd_torch(model.parameters(), lambda s: 0.1 / (1 + s), momentum=0.9)
    return TrainState(model, opt)


def test_save_restore_round_trips_bit_for_bit(tmp_path):
    state = _state(0)
    for _ in range(3):  # momentum buffers, updates, BN statistics
        state.optimizer.zero_grad()
        sum((p * p).sum() for p in state.model.parameters()).backward()
        state.optimizer.step(lr_scale=0.5)
    for b in state.model.buffers():
        b.add_(torch.rand(b.shape))
    state.step, state.lr_scale = 7, 0.3
    path = str(tmp_path / "x" / "last_step=7.ckpt")
    pck.save_checkpoint(path, state, {"step": 7, "epoch": 1})

    blob = torch.load(path, weights_only=True)
    assert set(blob) >= {"model", "optimizer", "updates", "step", "lr_scale"}
    assert pck.load_checkpoint_metadata(path) == {"step": 7, "epoch": 1}

    fresh = _state(1)
    assert not torch.equal(fresh.model.conv0p1s1.kernel, state.model.conv0p1s1.kernel)
    out = pck.restore_checkpoint(path, fresh)
    assert out.step == 7 and out.lr_scale == 0.3
    assert out.optimizer.updates == 3
    for (n, a), b in zip(state.model.state_dict().items(), out.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa = state.optimizer.inner.state_dict()["state"]
    sb = out.optimizer.inner.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for k in sa:
        assert torch.equal(sa[k]["momentum_buffer"], sb[k]["momentum_buffer"])
    # the restored optimizer goes on as the saved one would
    for s in (state, out):
        s.optimizer.zero_grad()
        sum((p * p).sum() for p in s.model.parameters()).backward()
        s.optimizer.step(lr_scale=s.lr_scale)
    for a, b in zip(state.model.parameters(), out.model.parameters()):
        assert torch.equal(a, b)


class _Tiny:
    """A minimal port train state for the manager's file names."""

    def __init__(self):
        self.model = torch.nn.Linear(2, 2)
        self.optimizer = sgd_torch(self.model.parameters(), 0.1)
        self.step, self.lr_scale = 0, 1.0


def test_checkpoint_manager_leaves_the_same_files(tmp_path):
    monitors = {"val_miou": "max", "val_loss": "min"}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jm, pm = jck.CheckpointManager(jdir, monitors), pck.CheckpointManager(pdir, monitors)
    seq = [(2, {"val_miou": 0.10, "val_loss": 3.0}),
           (4, {"val_miou": 0.08, "val_loss": 2.5}),
           (6, {}),
           (8, {"val_miou": 0.20, "val_loss": 2.7}),
           (10, {"val_miou": 0.20, "val_loss": None})]
    tiny = _Tiny()
    for step, metrics in seq:
        jm.save({"w": np.zeros(2, np.float32)}, metrics, step, {"epoch": step // 2})
        pm.save(tiny, metrics, step, {"epoch": step // 2})
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    assert sorted(os.listdir(pdir)) == [
        "best_val_loss=2.5000_step=4.ckpt", "best_val_loss=2.5000_step=4.ckpt.json",
        "best_val_miou=0.2000_step=8.ckpt", "best_val_miou=0.2000_step=8.ckpt.json",
        "last_step=10.ckpt", "last_step=10.ckpt.json"]
    assert pck.find_resume_checkpoint(pdir) == os.path.join(pdir, "last_step=10.ckpt")
    assert (os.path.basename(jck.find_resume_checkpoint(jdir))
            == os.path.basename(pck.find_resume_checkpoint(pdir)))
