"""One run of one cell, from set-up to the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name:

* ``benchmark/configs/<config>.json`` (the ``file`` of the configuration
  in ``BENCHMARK.json``): model, widths, batch, limits, objective;
* ``benchmark/traffic/<traffic>.json``: how batches reach the step;
* ``benchmark/metrics/<metric>.py``: ``read(ctx) -> float | None`` for one
  metric of ``BENCHMARK.json``; ``benchmark/metrics/<list>.txt``: kernel
  names a reader matches.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional

import torch

from lgsb import judge, pipeline_ref, trace as trace_mod, work
from lgsb.reference import Geometry
from lgsb.workload import TRACE_RANGE, Cell

PATH = "benchmark"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Spec:
    """A cell as ``BENCHMARK.json`` and its files define it."""
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: List[str]
    per_layer: List[str]
    units: dict


def cell_spec(root: str, name: str, bench: Optional[dict] = None) -> Spec:
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(root, PATH, "traffic", f"{w['traffic']}.json"))

    def applies(m):
        return name in m.get("workloads", [name])

    e2e = [m["name"] for m in bench["end_to_end"] if applies(m)]
    per = [m["name"] for m in bench["per_layer"]
           if applies(m) and m["moves"] in e2e]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    return Spec(name, int(w["chips"]), cfg, traffic, e2e, per, units)


def reader(root: str, name: str):
    path = os.path.join(root, PATH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"lgsb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def names_file(root: str, name: str) -> List[str]:
    with open(os.path.join(root, PATH, "metrics", f"{name}.txt")) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


@dataclass
class Window:
    """What the measured window did, on the host clock."""
    steps: int = 0
    scenes: int = 0
    seconds: float = 0.0
    wait_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)
    ends: List[float] = field(default_factory=list)  # each step's end - t0
    scenes_each: List[int] = field(default_factory=list)
    t0: float = 0.0
    t1: float = 0.0
    losses: List[torch.Tensor] = field(default_factory=list)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(cell: Cell, seconds: float, trace_steps: int):
    """The window: whole iterations until ``seconds`` have passed; the
    first ``trace_steps`` of them under the profiler when asked. Returns
    (Window, Trace or None, ring positions of the traced steps)."""
    dev = cell.dev
    rf = torch.profiler.record_function
    win = Window()
    prof, traced, tr = None, [], None
    if trace_steps:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    win.t0 = time.perf_counter()
    t_prev = win.t0
    span = rf(TRACE_RANGE).__enter__() if prof is not None else None
    while True:
        pos = cell.batches_seen
        with rf("lgsb.next_batch"):
            batch, n_scenes = cell.next_batch()
        t_batch = time.perf_counter()
        with rf("lgsb.step"):
            metrics = cell.run_step(batch)
        with rf("lgsb.sync"):
            _sync(dev)
        t_end = time.perf_counter()
        win.wait_s.append(t_batch - t_prev)
        win.step_s.append(t_end - t_batch)
        win.ends.append(t_end - win.t0)
        win.losses.append(metrics["loss"].detach())
        win.steps += 1
        win.scenes += n_scenes
        win.scenes_each.append(n_scenes)
        t_prev = t_end
        if prof is not None:
            traced.append(pos)
            if len(traced) == trace_steps:
                span.__exit__(None, None, None)
                prof.__exit__(None, None, None)
                tr = trace_mod.read_profile(prof, TRACE_RANGE)
                prof = None
                t_prev = time.perf_counter()
        if t_end - win.t0 >= seconds and prof is None:
            break
    win.t1 = t_end
    win.seconds = win.t1 - win.t0
    return win, tr, traced


def traced_work(cell: Cell, traced: List[int]):
    """Per traced step: the kernels' map work and the model FLOPs, read
    from the ring's batches (None where the batch is not held)."""
    if not cell.resident:
        return None, None
    works, flops = [], []
    cache = {}
    for pos in traced:
        j = cell.counter(pos)
        if j not in cache:
            lay = cell.rec.layouts[j]
            coords = pipeline_ref.batched(lay["coords"])[lay["order"]]
            geo = Geometry(torch.as_tensor(coords, device=cell.dev))
            cache[j] = (work.graph_works(cell.ring[j].graph),
                        work.step_flops(cell.arch, geo, cell.representation))
            del geo
        works.append(cache[j][0])
        flops.append(cache[j][1])
    return works, flops


def log(t_start: float, what: str) -> None:
    print(f"lgsb {time.perf_counter() - t_start:9.3f} s  {what}",
          file=sys.stderr, flush=True)


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", variant: Optional[str] = None,
             bench: Optional[dict] = None, warmup: bool = True) -> dict:
    """One run of the cell ``name``; ``variant`` and ``warmup=False`` are
    for the calibration and the tests (see ``workload.Cell``)."""
    spec = cell_spec(root, name, bench)
    dev = torch.device(device)
    log(t_start, f"{name} seed {seed} on {dev}: building")
    cell = Cell(spec.cfg, spec.traffic, seed, dev, variant)
    log(t_start, "scenes, loader, model and weights made")
    cell.fill()
    log(t_start, "ring filled" if cell.resident else "loader started")
    proof = cell.proof()
    log(t_start, f"proof steps done, losses {proof.losses}")
    while warmup and cell.batches_seen < spec.traffic["warmup_steps"]:
        batch, _ = cell.next_batch()
        cell.run_step(batch)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    trace_steps = spec.traffic["trace_steps"] if trace else 0
    log(t_start, "warm; window opens")
    win, tr, traced = measure(cell, seconds, trace_steps)
    log(t_start, f"window closed: {win.steps} steps, {win.scenes} scenes "
                 f"in {win.seconds:.3f} s")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    losses = torch.stack(win.losses).float().cpu()
    failed = int((~torch.isfinite(losses)).sum())

    bw, bf16, f32 = work.peaks(torch.cuda.get_device_name(dev)) \
        if dev.type == "cuda" else work.peaks("H100")
    works, flops = traced_work(cell, traced) if tr is not None else (None, None)
    get_item = cell.get_item.between(win.t0, win.t1)
    builds = cell.rec.timed.between(win.t0, win.t1)
    ctx = SimpleNamespace(
        window=win, setup_s=setup_s, peak_bytes=peak, trace=tr,
        traced_steps=len(traced), traced_works=works, traced_flops=flops,
        arch=cell.arch, representation=cell.representation, bw=bw,
        bf16_peak=bf16, f32_peak=f32, names=lambda n: names_file(root, n),
        get_item_s=get_item, build_s=builds,
        counters=cell.loader.counters.snapshot(), resident=cell.resident)
    wanted = spec.per_layer if trace else spec.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(root, m)(ctx)
        if v is not None:
            metrics[m] = {"value": float(v), "unit": spec.units[m]}

    raw, n_pool, weights, loader_seed = cell.raw, cell.n_pool, cell.weights, cell.loader_seed
    run_detail = {"envelope_caps": cell.envelope_caps,
                  "batches_over_envelope": cell.over_envelope(),
                  "batches_built": len(cell.rec.caps),
                  "window_steps": [[t, n] for t, n in zip(win.ends, win.scenes_each)]}
    weights = {k: v.detach().clone() for k, v in weights.items()}
    anchors, gen_seed = cell.anchors, cell.generator.initial_seed()
    cell.close()
    del cell
    log(t_start, "metrics read, program freed; reference follows")
    numbers = judge.follow(spec.cfg, spec.traffic, loader_seed, raw, n_pool, weights,
                           anchors, proof, gen_seed, dev)
    log(t_start, f"reference done, losses {numbers['_losses_ref']}")
    limits = spec.cfg.get("limits", {})
    result = {
        "correct": judge.verdict(numbers, limits),
        "attempted": win.steps,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else "cpu"),
                   "count": spec.chips, "memory_peak_bytes": int(peak)},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["detail"] = {**{k.lstrip("_"): v for k, v in numbers.items()
                           if k.startswith("_") or k not in limits}, **run_detail}
    result["compared"] = {n: {"value": numbers[n], "limit": limits[n]}
                          for n in judge.NUMBERS if n in limits}
    return result

