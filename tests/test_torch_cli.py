"""The port's command line and model registry.

- The README quick-start through ``cli.main.main(argv, device="cpu")`` on
  tiny synthetic shapes: one epoch, then the test pass.
- ``cli/convert.py`` on a reference-format state dict written here.
- The registry lists the JAX package's names; ``load_model`` returns each
  BasicBlock Res16UNet variant, and each variant's eval
  forward matches the JAX model's on the f32 gather paths (the port's
  window routes declined, as tests/test_torch_data_loader.py does), with
  tests/test_torch_res16unet.py's tolerance: 1e-4 relative max error.
"""

import functools
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from languagegroundedsemseg_tpu.data.batching import BatchBuilder as JaxBatchBuilder
from languagegroundedsemseg_tpu.models import available_models as jax_available_models
from languagegroundedsemseg_tpu.models import load_model as jax_load_model
from languagegroundedsemseg_tpu.models.res16unet import res16unet_graph_spec as jax_graph_spec
from languagegroundedsemseg_torch.cli import convert as cli_convert
from languagegroundedsemseg_torch.cli.main import main
from languagegroundedsemseg_torch.convert import state_dict_from_jax
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.models import available_models, load_model, load_wrapper
from languagegroundedsemseg_torch.models.res16unet import Res16UNet14A, res16unet_graph_spec
from languagegroundedsemseg_torch.train.checkpoints import port_to_torch_state_dict
from languagegroundedsemseg_torch.train.step import make_eval_step
from test_torch_res16unet import _random_variables
from test_torch_trainer import gather_paths, one_torch_thread  # noqa: F401 (autouse)

QUICK_START = ["--dataset", "SyntheticTiny20Dataset", "--model", "Res16UNet14A",
               "--batch_size", "2", "--val_batch_size", "2", "--max_epoch", "1",
               "--num_workers", "1", "--num_val_workers", "1",
               "--fixed_capacity", "2048", "--ignore_label", "255",
               "--tensorboard", "False", "--stat_freq", "1"]

FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}

VARIANTS = ["Res16UNet14", "Res16UNet14A", "Res16UNet14A2", "Res16UNet14B",
            "Res16UNet14B2", "Res16UNet14B3", "Res16UNet14C", "Res16UNet14D",
            "Res16UNet18", "Res16UNet18A", "Res16UNet18B", "Res16UNet18D",
            "Res16UNet34", "Res16UNet34A", "Res16UNet34B", "Res16UNet34C",
            "Res16UNet34C100", "Res16UNet34C200", "Res16UNet34CR", "Res16UNet34D"]


def test_quick_start_trains_and_tests(tmp_path):
    log_dir = str(tmp_path / "run")
    metrics = main(QUICK_START + ["--log_dir", log_dir], device="cpu")
    assert 0.0 <= metrics["val_miou"] <= 1.0 and np.isfinite(metrics["val_loss"])
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["phase"] for r in recs] == ["train", "train", "epoch"]
    assert all(np.isfinite(r["loss"]) for r in recs[:2])
    assert glob.glob(os.path.join(log_dir, "last_step=2.ckpt"))
    with open(os.path.join(log_dir, "config.json")) as f:
        assert json.load(f)["model"] == "Res16UNet14A"


def test_test_only_run_and_resume(tmp_path):
    """``--is_train False`` runs the test pass alone; ``--resume`` picks the
    last checkpoint of a log dir and trains on from its epoch."""
    first = str(tmp_path / "a")
    main(QUICK_START + ["--log_dir", first], device="cpu")
    m = main(QUICK_START + ["--log_dir", str(tmp_path / "b"), "--is_train", "False"],
             device="cpu")
    assert 0.0 <= m["val_miou"] <= 1.0
    assert not glob.glob(str(tmp_path / "b" / "*.ckpt"))
    main(QUICK_START + ["--log_dir", str(tmp_path / "c"), "--resume", first,
                        "--max_epoch", "2"], device="cpu")
    assert glob.glob(str(tmp_path / "c" / "last_step=4.ckpt"))


def test_main_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(QUICK_START + ["--log_dir", str(tmp_path / "run")])


def test_convert_writes_a_checkpoint_the_trainer_loads(tmp_path):
    src = Res16UNet14A(out_channels=20, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    template = {k: np.zeros(tuple(v.shape), np.float32)
                for k, v in src.state_dict().items()}
    template["final.kernel"] = template["final.kernel"][None]
    ref, missing = port_to_torch_state_dict(src.state_dict(), template)
    assert not missing
    sd = {"module." + k: torch.from_numpy(v) for k, v in ref.items()}
    sd["module.bn0.bn.num_batches_tracked"] = torch.tensor(1)
    ckpt, out = str(tmp_path / "ref.pth"), str(tmp_path / "conv.ckpt")
    torch.save({"state_dict": sd}, ckpt)

    merged, skipped = cli_convert.main(
        ["--ckpt", ckpt, "--model", "Res16UNet14A", "--out-channels", "20",
         "--out", out], device="cpu")
    assert skipped == ["bn0.bn.num_batches_tracked"]
    blob = torch.load(out, weights_only=True)
    for k, v in src.state_dict().items():
        assert torch.equal(blob["model"][k], v), k  # ME permutation undone

    main(QUICK_START + ["--log_dir", str(tmp_path / "run"), "--weights", out,
                        "--is_train", "False"], device="cpu")


def test_registry_lists_every_variant():
    assert set(VARIANTS) <= set(available_models())
    assert available_models() == sorted(jax_available_models())
    for name in VARIANTS:
        cls = load_model(name)
        assert cls.__name__ == name
        jcls = jax_load_model(name)
        assert cls.PLANES == jcls.PLANES and cls.LAYERS == jcls.LAYERS
        assert cls.STRIP_FINAL_RELU == jcls.strip_final_relu
    with pytest.raises(KeyError):
        load_model("Res16UNet42")
    assert load_wrapper("BilateralCRF").__name__ == "BilateralCRF"
    with pytest.raises(KeyError):
        load_wrapper("GaussianCRF")


@pytest.fixture(scope="module")
def scene_batches():
    scenes = [voxelize_scene(np.random.default_rng(0), 3000)]
    jbatch = JaxBatchBuilder(spec=jax_graph_spec(), fixed_capacity=4096).build(scenes)
    batch = BatchBuilder(spec=res16unet_graph_spec(),
                         fixed_capacity=4096).build(scenes, device="cpu")
    return jbatch, batch


def _flax_shapes(model):
    """The flax trees' shapes, named from the port's state dict (the
    inverse of ``convert.state_dict_from_jax``'s naming): saves tracing
    the JAX init once per variant."""
    tree = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        parts = name.split(".")
        path = []
        i = 0
        while i < len(parts) - 1:
            p = parts[i]
            if p.startswith("block") and parts[i + 1].isdigit():
                path.append(f"{p}_{parts[i + 1]}")
                i += 2
            elif p == "downsample":
                path.append({"0": "downsample_conv", "1": "downsample_norm"}[parts[i + 1]])
                i += 2
            else:
                path.append("SparseBatchNorm_0" if p == "bn" else p)
                i += 1
        leaf = parts[-1]
        coll = "batch_stats" if leaf.startswith("running_") else "params"
        leaf = {"weight": "scale", "running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.ShapeDtypeStruct(tuple(t.shape), np.float32)
    return tree


@pytest.mark.parametrize("name", VARIANTS)
def test_variant_forward_matches_jax(scene_batches, name):
    jbatch, batch = scene_batches
    jmodel = jax_load_model(name)(out_channels=20)
    model = load_model(name)(out_channels=20, device="cpu")
    variables = _random_variables(_flax_shapes(model), 0)
    args = (variables, jbatch.feats, jbatch.graph)
    # one XLA compile per variant; LLVM's expensive passes buy nothing for
    # a single call
    want, _ = jax.jit(functools.partial(jmodel.apply, train=False)).lower(
        *args).compile(compiler_options=FAST_COMPILE)(*args)

    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    with gather_paths():
        got, _ = make_eval_step(model, device="cpu")(batch)
    valid = np.asarray(jbatch.graph.levels[0].valid) > 0
    got, want = got.numpy()[valid], np.asarray(want)[valid]
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-4, f"{name}: relative max error {err}"
