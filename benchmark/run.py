"""Run one cell of the benchmark of languagegroundedsemseg_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Builds the cell's train step as
``BENCHMARK.json`` and its files define it, proves its first three steps
against the plain reference, times ``--seconds`` of training, and prints
one JSON line last on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` the per-layer
metrics and ``breakdown``, and last the numbers compared with their
limits), and those numbers as the last lines of standard error. Needs
CUDA and as many cards as the cell asks for; exits non-zero without a
result otherwise, and if JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level module names that may not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "languagegroundedsemseg_tpu",
             "bench", "__graft_entry__", "chip_smoke")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fail(msg: str, code: int) -> int:
    print(f"benchmark/run.py: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel and compiler caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

    if not os.path.isdir(os.path.join(ROOT, "languagegroundedsemseg_torch")):
        return fail("the program (languagegroundedsemseg_torch) is not in "
                    "this checkout", 2)
    from lgsb import harness

    try:
        spec = harness.cell_spec(ROOT, args.workload)
    except (KeyError, FileNotFoundError) as e:
        return fail(f"no such cell: {e}", 2)
    import torch

    if not torch.cuda.is_available():
        return fail("CUDA is not available; the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < spec.chips:
        return fail(f"the cell asks for {spec.chips} cards, "
                    f"{torch.cuda.device_count()} found", 3)
    if spec.chips != 1:
        return fail("cells on more than one card are not implemented", 2)

    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T_START)
    loaded = forbidden_loaded()
    if loaded:
        return fail(f"loaded in this process: {', '.join(loaded)}", 4)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
