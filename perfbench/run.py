"""The benchmark of probunet_torch on one NVIDIA H100.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json: set-up (kernel library, inputs and weights
from the seed, warm-up), then either the measured window (``--trace 0``:
the cell's end-to-end metrics) or a few profiled segments (``--trace 1``:
its per-layer metrics), then the check against the plain reference. The
last line of standard output is one JSON object; the numbers compared,
each with its limit, are the last lines of standard error and the result's
last key. Exits with another code than 0, printing no result, without a
CUDA card, or if JAX or the JAX package was loaded. The benchmark's own CPU
tests: ``python -m pytest perfbench/tests``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench_cache"
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"this benchmark needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(2)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"the run loaded {', '.join(bad)}; the benchmark must not import them")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
