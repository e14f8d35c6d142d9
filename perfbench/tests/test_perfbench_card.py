"""The import check on the card: a run that finds JAX or the JAX package
loaded once its window has closed prints no result and exits non-zero;
the same run without it prints its line.

    python -m pytest --noconftest -m gpu perfbench/tests/test_perfbench_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "pgan128.serve", "--seed", "3000000023",
        "--seconds", "1"]
# a module named ``jax`` planted in the run's process before it starts
PLANTED = ("import sys, types, runpy; sys.modules['jax'] = "
           "types.ModuleType('jax'); sys.argv = ['run.py'] + sys.argv[1:]; "
           "runpy.run_path('perfbench/run.py', run_name='__main__')")


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_run_without_jax_prints_its_line():
    _card()
    r = subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["device"]["platform"] == "gpu"


@pytest.mark.gpu
def test_a_run_with_jax_loaded_prints_nothing():
    _card()
    r = subprocess.run([sys.executable, "-c", PLANTED, *ARGS], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "jax" in r.stderr
