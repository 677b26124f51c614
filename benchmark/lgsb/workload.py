"""One run of one cell: set-up, the proof steps, the measured window, the
traced steps, and the judgment against the plain reference.

The traffic file says how batches reach the step:

* ``"feed": "resident"``: the port's loader builds a ring of
  ``ring_batches`` batches in set-up (a pool of exactly that many batches
  of scenes, in order), and the window cycles through the ring: no host
  data work is timed.
* ``"feed": "loader"``: the port's loader feeds the step as in training
  (repeating, ``num_workers`` workers over a pool of ``pool_scenes``
  scenes, each epoch augmented afresh); an iteration is ``next(it)`` +
  step + sync.

Everything the step reads comes from ``--seed``: the rooms of the scenes,
the loader's order and augmentation, the weights, the text anchors and the
step's generator (the contrastive objective's negatives). What stays the
same from seed to seed is the amount of work: the pool's scene sizes are
the stratified quantiles of the traffic's size law, laid out so that every
batch takes one size from each stratum, and the capacity envelope
(``envelope`` in the traffic file: the largest size of each stratum times
``points_scale``, its rooms and augmentation from its own fixed ``seed``)
is built first, so that the builder pads each batch to the envelope's
capacities rather than to the seed's own. Without the envelope the seed's
voxel counts crossed one of the builder's capacity steps (~9% at a million
rows) on some seeds and not others, and 34C's rate read 23.2 or 25.3
scenes/s by the seed alone.

Set-up builds one train step (model, SGD, objective) and drives it through
its first three steps on three different batches (the proof steps), then
warms up to ``warmup_steps`` steps; the window then times that same step
for ``seconds``. The reference follows the three proof steps after the
window has closed and the program's state is freed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from lgsb import reference, scenes
from lgsb.reference import Arch

PROOF_STEPS = 3
TRACE_RANGE = "lgsb.traced"


def arch_of(cfg: dict) -> Arch:
    return Arch(planes=tuple(cfg["planes"]), layers=tuple(cfg["layers"]),
                out_channels=cfg["num_classes"],
                strip_final_relu=bool(cfg.get("strip_final_relu", False)))


def sub_seed(seed: int, *keys: int) -> int:
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def make_weights(a: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's parameters and batch-norm buffers, made on ``device``
    from the seed in three calls, well conditioned (activations stay O(1)
    through the depth): kernels N(0, 0.36 / fan_in), norm scales and
    running variances U(0.6, 1.4), biases and running means 0.1 N(0, 1)."""
    shapes = reference.param_shapes(a)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 3))
    groups = {"kernel": [], "scale": [], "shift": []}
    for name, shp in shapes.items():
        if name.endswith("kernel"):
            groups["kernel"].append(name)
        elif name.endswith(("bn.weight", "running_var")):
            groups["scale"].append(name)
        else:
            groups["shift"].append(name)
    out = {}
    for g, names in groups.items():
        sizes = [int(np.prod(shapes[n])) for n in names]
        if g == "kernel":
            flat = torch.randn(sum(sizes), generator=gen, device=device)
        elif g == "scale":
            flat = torch.rand(sum(sizes), generator=gen, device=device) * 0.8 + 0.6
        else:
            flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.1
        for n, part in zip(names, torch.split(flat, sizes)):
            t = part.view(shapes[n])
            if g == "kernel":
                t = t * (0.36 / float(np.prod(shapes[n][:-1]))) ** 0.5
            out[n] = t.contiguous()
    return out


def make_anchors(num_classes: int, dim: int, seed: int) -> np.ndarray:
    """Unit text anchors, one a class (the stand-in for CLIP's)."""
    a = np.random.default_rng((seed, 2)).normal(size=(num_classes, dim))
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def make_raw_pool(n: int, batch: int, seed: int, law: dict, num_classes: int,
                  workers: int = 8):
    """The pool's raw scenes (xyz, rgb, labels) by dataset index, their
    sizes laid out so that each run of ``batch`` indices is one batch of
    equal expected work."""
    sizes = scenes.pool_sizes(n, law)
    arrangement = scenes.stratified_order(n, batch, np.random.default_rng((seed, 0)))

    def one(i):
        return scenes.synthetic_scene(np.random.default_rng((seed, 1, i)),
                                      int(sizes[arrangement[i]]),
                                      num_classes=num_classes)

    with ThreadPoolExecutor(workers) as ex:
        return dict(enumerate(ex.map(one, range(n))))


def make_envelope(n: int, batch: int, law: dict, env: dict, num_classes: int,
                  workers: int = 8) -> Dict[int, tuple]:
    """The capacity envelope's raw scenes, by dataset index past the pool's
    ``n``; the same in every run (from the envelope's own seed)."""
    sizes = scenes.envelope_sizes(n, batch, law, float(env["points_scale"]))
    seed = int(env["seed"])

    def one(i):
        return scenes.synthetic_scene(np.random.default_rng((seed, 6, i)),
                                      int(sizes[i]), num_classes=num_classes)

    with ThreadPoolExecutor(workers) as ex:
        return {n + i: sc for i, sc in enumerate(ex.map(one, range(batch)))}


def _halve(objective):
    """The objective over the first half of the batch's real rows: the
    other half left out, the mean taken over the rest (a planted fault)."""

    def halved(*args):
        *outs, batch, gen, row_mask = args
        rm = row_mask.clone()
        rows = torch.nonzero(rm > 0)[:, 0]
        rm[rows[rows.numel() // 2:]] = 0
        return objective(*outs, batch, gen, rm)

    return halved


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Proof:
    """What the program's three proof steps produced."""
    losses: List[float] = field(default_factory=list)
    output: Optional[torch.Tensor] = None      # step 1, rows in concatenated order
    grad_norms: Dict[str, float] = field(default_factory=dict)
    stage_gap: float = float("nan")
    change_norms: Dict[str, float] = field(default_factory=dict)
    batches: List[dict] = field(default_factory=list)  # per proof batch


class Cell:
    """The port's objects of one run and what they record."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 variant: Optional[str] = None):
        from lgsb import program

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.loader_seed = sub_seed(seed, 5)
        self.dev = torch.device(device)
        self.variant = variant
        self.arch = arch_of(cfg)
        self.representation = cfg["objective"] == "contrastive"
        resident = traffic["feed"] == "resident"
        b = cfg["batch_size"]
        n_pool = traffic["ring_batches"] * b if resident else traffic["pool_scenes"]
        self.n_pool, self.resident = n_pool, resident
        self.raw = make_raw_pool(n_pool, b, seed, traffic["scene_points"],
                                 cfg["num_classes"])
        env = traffic.get("envelope")
        self.envelope = [] if env is None else list(range(n_pool, n_pool + b))
        if env is not None:
            self.raw.update(make_envelope(n_pool, b, traffic["scene_points"], env,
                                          cfg["num_classes"]))
        self.anchors = (make_anchors(cfg["num_classes"], cfg["anchor_dim"], seed)
                        if self.representation else None)
        dtype = "bfloat16" if variant == "bf16" else cfg["dtype"]
        self.port_cfg = program.port_config(cfg, traffic, self.loader_seed, dtype)
        ds_cls = program.dataset_class(self.raw, n_pool, cfg["num_classes"],
                                       cfg.get("anchor_dim", 512))
        keep = n_pool // b if resident else PROOF_STEPS
        self.loader, self.rec, self.get_item = program.make_loader(
            cfg, traffic, self.port_cfg, ds_cls, self.anchors, self.dev, keep)
        self.weights = make_weights(self.arch, seed, self.dev)
        self.step, self.state, self.model, self.optimizer = program.make_step(
            cfg, self.port_cfg, self.loader.dataset, self.weights, self.dev,
            wrap_objective=_halve if variant == "half_batch" else None)
        self.generator = torch.Generator(device=self.dev).manual_seed(sub_seed(seed, 4))
        self._plant(variant)
        self.program = program
        self.batches_seen = 0
        self.envelope_caps: List[int] = []
        self.ring: List = []
        self.it = None

    def _plant(self, variant):
        """Faults a test or the calibration plants in the timed path."""
        if variant == "frozen":
            self.optimizer.step = lambda lr_scale=1.0: True
        elif variant == "altered":
            def alter(_m, _inp, out):
                first = out[0].clone()
                row = int(torch.nonzero(self._valid > 0)[0, 0])
                first[row] = -first[row]
                return (first,) + tuple(out[1:])
            self.model.register_forward_hook(alter)
        elif variant not in (None, "bf16", "half_batch"):
            raise ValueError(f"unknown variant {variant!r}")

    # -- feeding -------------------------------------------------------------

    def fill(self) -> None:
        if self.envelope:
            env_seed = int(self.traffic["envelope"]["seed"])
            self.envelope_caps = self.program.prime_capacities(
                self.loader, self.rec, self.envelope,
                [np.random.default_rng((env_seed, 7, i))
                 for i in range(len(self.envelope))])
        if self.resident:
            self.ring = list(self.loader)
            self.ring_scenes = [self.rec.scenes_per_batch[k]
                                for k in range(len(self.ring))]
        else:
            self.it = iter(self.loader)

    def over_envelope(self) -> int:
        """How many of the batches built so far were padded past the
        envelope's capacities at some level."""
        if not self.envelope_caps:
            return 0
        return sum(any(c > e for c, e in zip(caps, self.envelope_caps))
                   for caps in list(self.rec.caps.values()))

    def counter(self, k: int) -> int:
        """The loader's batch counter of the k-th step."""
        return k % len(self.ring) if self.resident else k

    def next_batch(self):
        k = self.batches_seen
        self.batches_seen += 1
        if self.resident:
            j = self.counter(k)
            return self.ring[j], self.ring_scenes[j]
        b = next(self.it)
        return b, self.rec.scenes_per_batch[k]

    def run_step(self, batch):
        self._valid = batch.graph.levels[0].valid
        self.state, metrics = self.step(self.state, batch, self.generator)
        return metrics

    # -- proof ---------------------------------------------------------------

    def proof(self) -> Proof:
        pf = Proof()
        captured = {}

        def grab(_m, _inp, out):
            captured["out"] = out[0].detach()

        p0 = {k: v.detach().clone() for k, v in self.weights.items()}
        gaps: List[float] = []
        for k in range(PROOF_STEPS):
            batch, _ = self.next_batch()
            hook = self.model.register_forward_hook(grab) if k == 0 else None
            stages = self._stage_hooks(p0, gaps) if k == 0 else []
            metrics = self.run_step(batch)
            for h in stages:
                h.remove()
            pf.losses.append(float(metrics["loss"]))
            lay = self.rec.layouts[self.counter(k)]
            pos0 = torch.as_tensor(lay["pos0"], device=self.dev).long()
            pf.batches.append({
                "wire": batch.feats[pos0].cpu().numpy(),
                "labels": batch.labels[pos0].to(torch.int64).cpu().numpy(),
                "cap": int(batch.feats.shape[0]), "layout": lay,
                "counter": self.counter(k)})
            if hook is not None:
                hook.remove()
                pf.output = captured["out"][pos0].float().cpu()
                wd = self.cfg["weight_decay"]
                bufs = self.program.momentum_buffers(self.model, self.optimizer)
                pf.grad_norms = {n: float(torch.linalg.vector_norm(b - wd * p0[n]))
                                 for n, b in bufs.items()}
                pf.stage_gap = max(gaps) if gaps else float("nan")
        sd = self.model.state_dict()
        pf.change_norms = {n: float(torch.linalg.vector_norm(sd[n].float() - p0[n]))
                           for n in p0}
        return pf

    def _stage_hooks(self, p0, gaps: List[float]):
        """Hooks on the first step's batch norms and head: each stage's
        output against the reference's arithmetic (float32) from the
        stage's own input, the widest gap over the largest magnitude, on
        the real rows."""

        @torch.no_grad()
        def gap(got, want):
            return float((got.float() - want).abs().max()
                         / want.abs().max().clamp(min=1e-30))

        def norm_hook(name):
            @torch.no_grad()
            def hook(_m, inp, out):
                x, mask = inp[0], inp[1]
                rows = mask > 0
                want = reference.batch_norm(
                    x[rows].float(), {f"{name}.{s}": p0[f"{name}.{s}"].clone()
                                      for s in ("weight", "bias", "running_mean",
                                                "running_var")}, name)
                gaps.append(gap(out[rows], want))
            return hook

        @torch.no_grad()
        def head_hook(_m, inp, out):
            rows = self._valid > 0
            x = inp[0][rows].float()
            want = x @ p0["final.kernel"] + p0["final.bias"]
            gaps.append(gap(out[rows], want))

        hooks = []
        for name, mod in self.model.named_modules():
            if name.endswith(".bn") and f"{name}.running_mean" in p0:
                hooks.append(mod.register_forward_hook(norm_hook(name)))
            elif name == "final" and not self.representation:
                hooks.append(mod.register_forward_hook(head_hook))
        return hooks

    def close(self) -> None:
        if self.it is not None:
            self.it.close()
            self.it = None
        for t in self.program.loader_threads():
            t.join(timeout=120)
        self.ring = []
        for name in ("step", "state", "model", "optimizer", "loader", "weights"):
            setattr(self, name, None)
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
