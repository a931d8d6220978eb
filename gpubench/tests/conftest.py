"""Fixtures of the benchmark's CPU tests: a copy of the benchmark's files
at a size the CPU runs in seconds."""

import json
import shutil
from pathlib import Path

import pytest

from gpubench import harness

FILES = Path(harness.__file__).resolve().parent
TINY_DATA = {"n_rows": 5000, "n_features": 3000}
TINY_ARGS = {"rcv1-svm-local": {"check_every": 160}}  # the second check at round 11


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_tree(dest: Path) -> Path:
    """A copy of BENCHMARK.json and the benchmark's files under `dest`,
    each configuration's rows cut to TINY_DATA; returns `dest`."""
    for kind in ("configs", "traffic", "workloads", "drivers", "metrics"):
        shutil.copytree(FILES / kind, dest / "gpubench" / kind)
    shutil.copy(harness.BENCHMARK, dest / "BENCHMARK.json")
    for path in (dest / "gpubench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["data"].update(TINY_DATA)
        cfg["engine_args"].update(TINY_ARGS.get(cfg["name"], {}))
        path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny(tmp_path) -> harness.Registry:
    root = tiny_tree(tmp_path)
    return harness.Registry(root / "BENCHMARK.json", root / "gpubench")
