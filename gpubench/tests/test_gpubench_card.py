"""Each cell on the card, a short window: run on the chip with
``python -m pytest gpubench/tests -m card``; skips where there is no card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.Registry().bench["workloads"]])
def test_a_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the cells run only on the card")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", cell, "--seed",
                          "3000000019", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu", result
