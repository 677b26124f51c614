"""Res16UNet50's validation loss over a short run: the port's trainer
against the JAX package's.

At full size (chip_smoke.py's zoo_path (a), Res16UNet50 at lr 0.05) the
validation loss jumps while the training loss falls: eval mode normalizes
by the running statistics, which after a few steps at momentum 0.02 still
sit near their init, so a deep residual net's activations grow through the
unnormalized blocks. Here both trainers fit a Res16UNet50 at half width
(PLANES (16, 32, 64, 128, 128, 128, 128, 128), two blocks a stage, where
the jump shows) with zoo_path (a)'s flags (SGD lr 0.05, MultiStepLR,
balanced sampling, seed 42) on ``SyntheticTiny20Dataset`` at capacity
2048, from the same flax init, for two epochs of two steps with a
validation after each. Held: the first step's loss (the same weights, the
same batch), the jump in both packages, and JAX's validation of the port's
final weights against the port's own: the jump is the weights', and JAX's
eval forward gives it too. After the first step the two runs drift apart
(the gradients are not a continuous function of the rounding, PERF.md
§6), and eval mode without normalization amplifies the drift, so the two
series are not held value for value.
"""

import functools
import json
import os
from typing import Tuple
from unittest import mock

import jax

from languagegroundedsemseg_tpu.config import Config as JaxConfig
from languagegroundedsemseg_tpu.models.res16unet import Res16UNet50 as JaxRes16UNet50
from languagegroundedsemseg_tpu.train import trainer as jax_trainer
from languagegroundedsemseg_tpu.train.checkpoints import torch_to_flax_params
from languagegroundedsemseg_torch.config import Config
from languagegroundedsemseg_torch.models.res16unet import Res16UNet50
from languagegroundedsemseg_torch.train import trainer as port_trainer
from test_torch_trainer import _copy_weights, gather_paths, one_torch_thread  # noqa: F401

PLANES = (16, 32, 64, 128, 128, 128, 128, 128)
LAYERS = (2,) * 8
# zoo_path (a)'s flags (chip_smoke.LEARNING_CURVE_ARGV with
# --model Res16UNet50), at the CPU's size
FLAGS = dict(model="Res16UNet50", dataset="SyntheticTiny20Dataset", lr=0.05,
             optimizer="SGD", scheduler="MultiStepLR", seed=42, stat_freq=1,
             batch_size=2, val_batch_size=2, num_workers=1, num_val_workers=1,
             fixed_capacity=2048, ignore_label=255, num_devices=1,
             tensorboard=False)
# the first step: the same f32 sums in another order
STEP_RTOL = 1e-5
# JAX's eval forward of the port's weights against the port's: the gather
# paths' f32 sums in another order, through unnormalized blocks
VAL_RTOL = 1e-3
# "jumps": the second validation's loss over the first's. How far it
# jumps is chaotic (3x-6x in these runs: a change of the init's last bits
# moved JAX's own second value from 14.6 to 9.8), that it jumps is not
JUMP = 2.0


class _JaxNarrow50(JaxRes16UNet50):
    PLANES: Tuple[int, ...] = PLANES
    LAYERS: Tuple[int, ...] = LAYERS


class _PortNarrow50(Res16UNet50):
    PLANES = PLANES
    LAYERS = LAYERS


def _records(log_dir, phase):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["phase"] == phase]


def test_res16unet50_val_loss_jump_is_shared_with_jax(tmp_path):
    def jitted_init(init_fn, *args, **kwargs):  # the flax init, compiled
        return jax.jit(functools.partial(init_fn, **kwargs))(*args)

    with mock.patch.object(jax_trainer, "load_model", lambda name: _JaxNarrow50), \
            mock.patch.object(jax_trainer, "init_on_cpu", jitted_init):
        tr_j = jax_trainer.Trainer(JaxConfig(log_dir=str(tmp_path / "jax"), **FLAGS))
    with mock.patch.object(port_trainer, "load_model", lambda name: _PortNarrow50):
        tr_p = port_trainer.Trainer(Config(log_dir=str(tmp_path / "port"), **FLAGS),
                                    device="cpu")
    _copy_weights(tr_j, tr_p)
    tr_j.fit(max_epochs=2)
    with gather_paths():
        tr_p.fit(max_epochs=2)
    val_j = [r["val_loss"] for r in _records(tr_j.log_dir, "epoch")]
    val_p = [r["val_loss"] for r in _records(tr_p.log_dir, "epoch")]
    step_j = [r["loss"] for r in _records(tr_j.log_dir, "train")]
    step_p = [r["loss"] for r in _records(tr_p.log_dir, "train")]
    # JAX's validation of the port's final weights
    params, stats, skipped = torch_to_flax_params(
        {k: v.numpy() for k, v in tr_p.model.state_dict().items()},
        tr_j.state.params, tr_j.state.batch_stats, kernel_perm=None)
    assert not skipped
    tr_j.state = tr_j.state.replace(params=params, batch_stats=stats)
    jax_of_port = tr_j.validate()["val_loss"]
    print(f"val_loss jax {val_j} port {val_p}, jax's eval of the port's weights "
          f"{jax_of_port}\nstep losses jax {step_j} port {step_p}")
    assert len(val_p) == len(val_j) == 2 and len(step_p) == len(step_j) == 4
    assert abs(step_p[0] - step_j[0]) <= STEP_RTOL * abs(step_j[0])
    assert val_p[1] > JUMP * val_p[0] and val_j[1] > JUMP * val_j[0]
    assert abs(jax_of_port - val_p[1]) <= VAL_RTOL * abs(val_p[1])
