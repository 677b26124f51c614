"""The readers of device idle by step phase on hand-built traces: known
answers, the idle outside ``lgs.step`` left to none of them, and nothing
read from a trace without the program's spans or without device
operations."""

from types import SimpleNamespace

import pytest

from lgsb import harness, spans
from lgsb.trace import Trace

from conftest import REPO

MS = 1_000_000  # ns
READERS = ("prep_idle_ms_per_step", "fwd_idle_ms_per_step",
           "bwd_idle_ms_per_step", "update_idle_ms_per_step")
# device busy over [100, 200], [300, 400], [650, 900] ms of a [0, 1000] ms
# window: idle 100 + 100 + 250 + 100 = 550 ms
DEVICE = [("k1", 100, 200), ("k2", 300, 400), ("k3", 650, 800), ("k4", 700, 900)]
# the step thread's ranges: one lgs.step over [50, 950] with its phases
# back to back up to 940, and an op inside the forward
STEP = [("lgs.step", 50, 950), ("lgs.step.prep", 50, 150),
        ("lgs.step.forward", 150, 350), ("aten::mm", 160, 340),
        ("lgs.step.loss", 350, 450), ("lgs.step.backward", 450, 600),
        ("lgs.step.allreduce", 600, 700), ("lgs.step.update", 700, 940)]
# idle under each phase, over 2 traced steps: prep [50, 100] = 50 ms,
# forward [200, 300] + loss [400, 450] = 150, backward [450, 600] +
# allreduce [600, 650] = 200, update [900, 940] = 40
WANT = {"prep_idle_ms_per_step": 25.0, "fwd_idle_ms_per_step": 75.0,
        "bwd_idle_ms_per_step": 100.0, "update_idle_ms_per_step": 20.0}


def _ctx(device, host, steps=2, t0=0, t1=1000):
    tr = Trace(t0 * MS, t1 * MS, [(n, s * MS, e * MS) for n, s, e in device],
               [(n, s * MS, e * MS) for n, s, e in host])
    return SimpleNamespace(trace=tr, traced_steps=steps)


def _read(name, ctx):
    return harness.reader(REPO, name)(ctx)


@pytest.mark.parametrize("name", READERS)
def test_idle_by_phase_known_answers(name):
    assert _read(name, _ctx(DEVICE, STEP)) == pytest.approx(WANT[name])


def test_idle_outside_the_step_counts_in_no_phase():
    """550 ms idle: 440 under the phases, 10 inside lgs.step between the
    update and its end, 100 outside lgs.step (the loop's)."""
    ctx = _ctx(DEVICE, STEP)
    tr = ctx.trace
    total = tr.window_s - tr.busy_s()
    assert total == pytest.approx(0.550)
    phases = sum(_read(n, ctx) for n in READERS) * ctx.traced_steps / 1e3
    assert phases == pytest.approx(0.440)
    assert spans.idle_under_s(tr, {"lgs.step"}) == pytest.approx(0.450)
    assert total - spans.idle_under_s(tr, {"lgs.step"}) == pytest.approx(0.100)


def test_ranges_are_clipped_to_the_window():
    """A step that began before the traced window counts only inside it."""
    ctx = _ctx(DEVICE, STEP, t0=120)
    # prep [50, 150] meets idle only before 100, outside the window
    assert _read("prep_idle_ms_per_step", ctx) == 0.0
    assert _read("fwd_idle_ms_per_step", ctx) == pytest.approx(75.0)


@pytest.mark.parametrize("case", ["no_spans", "no_device", "no_trace", "no_steps"])
def test_nothing_to_read(case):
    ctx = {"no_spans": _ctx(DEVICE, [("aten::mm", 160, 340), ("lgsb.step", 40, 960)]),
           "no_device": _ctx([], STEP),
           "no_trace": SimpleNamespace(trace=None, traced_steps=2),
           "no_steps": _ctx(DEVICE, STEP, steps=0)}[case]
    for name in READERS:
        assert _read(name, ctx) is None


def test_the_resident_cell_reports_them():
    spec = harness.cell_spec(REPO, "res16unet34c.resident")
    assert set(READERS) <= set(spec.per_layer)
    assert all(spec.units[n] == "ms" for n in READERS)
