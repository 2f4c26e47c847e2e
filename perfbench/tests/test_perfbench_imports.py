"""Import and device guards (CPU only).

What a run loads is checked in a child process that imports every module a
run imports (the harness, each family with the program modules its job
builds, each metric reader), by top-level module names compared whole: the
port's name begins with the JAX package's. The reference loads no part of
the program. Without a card a run exits with another code than 0 and
prints no result.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "probunet_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    code = """
import glob, os
import perfbench.run, perfbench.harness as h, perfbench.control, perfbench.ranks
from perfbench.families import probunet, edm
from probunet_torch.train import loop, state, steps
from probunet_torch.ops import _build, attention, gn_silu
for p in glob.glob('perfbench/metrics/*.py'):
    h.reader(os.path.basename(p)[:-3])
"""
    mods = _top_level_after(code)
    assert "probunet_torch" in mods and "perfbench" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_reference_loads_no_program():
    code = """
import perfbench.reference.unet, perfbench.reference.probunet, perfbench.reference.edm
import perfbench.counts, perfbench.compare, perfbench.inputs
"""
    mods = _top_level_after(code)
    assert not mods & (FORBIDDEN | {"probunet_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    from perfbench import harness

    monkeypatch.setitem(sys.modules, "probunet_tpu_like", sys)
    assert "probunet_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()


def test_no_card_means_no_result():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure, not refuse")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "probunet_mc128.train_strict_b8", "--seed", str(2 ** 31 + 5),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
