"""The command itself: no card means no result and a non-zero exit (no
fall back to the CPU); a directory holding only BENCHMARK.json and the
benchmark gives none either; and nothing a run loads is JAX or the JAX
package, by whole top-level module name."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, REPO

RUN = [sys.executable, "benchmark/run.py", "--workload", "res16unet34c.resident",
       "--seed", "3", "--seconds", "1", "--trace", "0"]


def _no_result(proc):
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(RUN, cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    _no_result(p)


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    _no_result(p)


def test_forbidden_names_are_whole_names():
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    import run

    sys.modules["languagegroundedsemseg_tpu_not"] = object()
    sys.modules["benchmark_like"] = object()
    try:
        assert "languagegroundedsemseg_tpu" not in run.forbidden_loaded()
        assert "bench" not in run.forbidden_loaded()
    finally:
        del sys.modules["languagegroundedsemseg_tpu_not"], sys.modules["benchmark_like"]


def test_a_run_loads_no_jax(tiny_root):
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from lgsb import harness\n"
        "harness.run_cell(%r, 'tiny.loader', 11, 0.2, True, time.perf_counter(),"
        " device='cpu', warmup=False)\n"
        "import run\n"
        "print('LOADED', run.forbidden_loaded())\n"
    ) % (os.path.join(REPO, "benchmark"), REPO, tiny_root)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "LOADED []" in p.stdout
