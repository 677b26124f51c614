"""The port's spans (``utils/observability.span``) and the loader's time
counters, on the CPU.

- Span tree: one Res16UNet14A train step under ``torch.profiler`` (CPU
  activity, recording the calling thread or every thread) shows
  ``lgs.step`` on the calling thread holding its phases in order, disjoint
  and covering at least 95% of it, and the model's stage spans in order
  inside ``lgs.step.forward``.
- Profiler off: a train step and a loader epoch enter no profiler range
  (counted on the patched entry point); with a profiler recording, the
  same calls enter one range per span.
- Loader: the workers' ``lgs.loader.get_item`` / ``.build`` / ``.h2d``
  spans carry the batch counter (and ``get_item`` the scene index) as
  their arguments, ``lgs.loader.wait`` is on the consumer, and the new
  ``LoaderCounters`` sums count each scene, build, wait and copy once
  (timed by a clock that advances one second a call on each thread).
"""

import threading

import numpy as np
import pytest
import torch

from languagegroundedsemseg_torch.data import loader as loader_mod
from languagegroundedsemseg_torch.data.batching import BatchBuilder
from languagegroundedsemseg_torch.data.synthetic import voxelize_scene
from languagegroundedsemseg_torch.losses.classification import cross_entropy_loss
from languagegroundedsemseg_torch.models.res16unet import (
    Res16UNet14A,
    res16unet_graph_spec,
)
from languagegroundedsemseg_torch.train.solvers import sgd_torch
from languagegroundedsemseg_torch.train.state import TrainState
from languagegroundedsemseg_torch.train.step import make_train_step

PHASES = ["lgs.step.prep", "lgs.step.forward", "lgs.step.loss",
          "lgs.step.backward", "lgs.step.update"]
STAGES = (["lgs.model.stem"] + [f"lgs.model.enc{i}" for i in range(1, 5)]
          + [f"lgs.model.dec{i}" for i in range(1, 5)] + ["lgs.model.head"])
N_CLASSES = 20


def _profile(fn, all_threads=False):
    """``fn()`` under a CPU profiler; (its result, the ``lgs.*`` ranges as
    (name, start ns, end ns, thread, arguments) by start)."""
    kw = {}
    if all_threads:
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                record_shapes=True, **kw) as prof:
        out = fn()
    ranges = sorted(
        ((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
          e.start_thread_id(), list(e.concrete_inputs()))
         for e in prof.profiler.kineto_results.events()
         if e.name().startswith("lgs.")), key=lambda r: r[1])
    return out, ranges


def _step_and_batch():
    rng = np.random.default_rng(0)
    scenes = []
    for _ in range(2):
        c, f, lab = voxelize_scene(rng, 1500)
        scenes.append((c, f, np.where(lab == 255, 255, lab % N_CLASSES).astype(np.int32)))
    batch = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=2048).build(
        scenes, device="cpu")
    model = Res16UNet14A(out_channels=N_CLASSES, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    opt = sgd_torch(model.parameters(), 1e-2)

    def objective(logits, _features, b, _generator, row_mask):
        return cross_entropy_loss(logits, b.labels, 255, row_mask=row_mask), {}

    step = make_train_step(model, opt, objective, device="cpu")
    return step, TrainState(model, opt), batch


def _inside(r, outer):
    return outer[1] <= r[1] and r[2] <= outer[2]


def _in_order_and_disjoint(ranges, names):
    assert [r[0] for r in ranges] == names
    for a, b in zip(ranges, ranges[1:]):
        assert a[2] <= b[1], (a[0], b[0])


@pytest.mark.parametrize("all_threads", [False, True])
def test_step_span_tree(all_threads):
    step, state, batch = _step_and_batch()
    (_, metrics), ranges = _profile(lambda: step(state, batch), all_threads)
    assert np.isfinite(float(metrics["loss"]))
    (top,) = [r for r in ranges if r[0] == "lgs.step"]
    caller = [r for r in ranges if r[3] == top[3]]
    phases = [r for r in caller if r[0].startswith("lgs.step.")]
    _in_order_and_disjoint(phases, PHASES)
    assert all(_inside(r, top) for r in phases)
    covered = sum(r[2] - r[1] for r in phases)
    assert covered >= 0.95 * (top[2] - top[1]), covered / (top[2] - top[1])
    (fwd,) = [r for r in phases if r[0] == "lgs.step.forward"]
    stages = [r for r in caller if r[0].startswith("lgs.model.")]
    _in_order_and_disjoint(stages, STAGES)
    assert all(_inside(r, fwd) for r in stages)


class _Scenes:
    """Six small scenes, 64 voxels each."""

    class config:
        normalize_color = False

    def __len__(self):
        return 6

    def get_item(self, idx, rng):
        return {"coords": rng.integers(0, 20, size=(64, 3)).astype(np.int32),
                "feats": rng.random((64, 3)).astype(np.float32),
                "labels": np.zeros(64, np.int32)}


def _loader(num_workers=2):
    builder = BatchBuilder(spec=res16unet_graph_spec(), fixed_capacity=256,
                           limit_numpoints=10_000_000)
    return loader_mod.DataLoader(_Scenes(), builder, batch_size=2, shuffle=False,
                                 num_workers=num_workers, device="cpu")


def _host_bytes(obj):
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if hasattr(obj, "__dataclass_fields__"):
        return sum(_host_bytes(getattr(obj, f)) for f in obj.__dataclass_fields__)
    if isinstance(obj, dict):
        return sum(_host_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_host_bytes(v) for v in obj)
    return 0


@pytest.mark.parametrize("recording", [False, True])
def test_spans_enter_no_range_with_the_profiler_off(monkeypatch, recording):
    entered = []
    enter = torch.autograd._record_function_with_args_enter

    def counted(name, *args):
        entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", counted)
    step, state, batch = _step_and_batch()

    def run():
        step(state, batch)
        return len(list(_loader()))

    if recording:
        n_batches, _ = _profile(run, all_threads=True)
    else:
        n_batches = run()
    assert n_batches == 3
    if not recording:
        assert entered == []
    else:
        # the step, its phases and stages; per batch a build, a copy, two
        # scenes and a wait, and the wait that finds the end
        assert entered.count("lgs.step") == 1
        assert sorted(set(entered) & set(PHASES + STAGES)) == sorted(PHASES + STAGES)
        assert entered.count("lgs.loader.get_item") == 6
        assert entered.count("lgs.loader.build") == entered.count("lgs.loader.h2d") == 3
        assert entered.count("lgs.loader.wait") == 4


@pytest.mark.parametrize("num_workers", [1, 2])
def test_loader_spans_and_counters(monkeypatch, num_workers):
    local = threading.local()

    def clock():
        # one second a call on each thread: every timed stretch reads 1 s
        local.t = getattr(local, "t", 0.0) + 1.0
        return local.t

    monkeypatch.setattr(loader_mod, "perf_counter", clock)
    loader = _loader(num_workers)
    host_bytes = []
    to_device = loader._to_device

    def recorded(b):
        host_bytes.append(_host_bytes(b))
        return to_device(b)

    loader._to_device = recorded
    batches, ranges = _profile(lambda: list(loader), all_threads=True)
    assert len(batches) == 3
    (consumer,) = {r[3] for r in ranges if r[0] == "lgs.loader.wait"}
    assert sum(r[0] == "lgs.loader.wait" for r in ranges) == 4
    worker = [r for r in ranges if r[0] != "lgs.loader.wait"]
    assert worker and all(r[3] != consumer for r in worker)
    by = {}
    for name, _, _, _, args in worker:
        by.setdefault(name, []).append(tuple(args))
    # batch k holds scenes 2k and 2k + 1 (no shuffle)
    assert sorted(by["lgs.loader.get_item"]) == [(k, 2 * k + j) for k in range(3)
                                                 for j in range(2)]
    assert sorted(by["lgs.loader.build"]) == sorted(by["lgs.loader.h2d"]) == [
        (0,), (1,), (2,)]

    c = loader.counters
    assert (c.get_item_s, c.build_s, c.wait_s) == (6.0, 3.0, 3.0)
    assert (c.batches, c.waits, c.copies) == (3, 3, 3)
    assert c.h2d_bytes == sum(host_bytes) > 0
    snap = c.snapshot()
    assert snap["loader_get_item_ms"] == 2000.0
    assert snap["loader_build_ms"] == snap["loader_wait_ms"] == 1000.0
    assert snap["loader_h2d_mb"] == round(sum(host_bytes) / 3 / 1e6, 3)
    # the keys that were there before, as before
    assert snap["loader_batches"] == 3
    assert snap["loader_scenes_dropped"] == snap["loader_voxels_dropped"] == 0
    old = {k for k in snap if k.startswith(("loader_overflow_l", "loader_fill_l"))}
    assert {f"loader_fill_l{l}" for l in range(5)} <= old
    assert set(snap) == old | {"loader_batches", "loader_scenes_dropped",
                               "loader_voxels_dropped", "loader_get_item_ms",
                               "loader_build_ms", "loader_wait_ms", "loader_h2d_mb"}
