"""Nothing of JAX or of the JAX package, compared by whole top-level names;
a host without a card gets no result."""

import subprocess
import sys
from pathlib import Path

from gpubench import isolation

ROOT = Path(__file__).resolve().parents[2]


def test_top_level_names_are_compared_whole():
    names = ["distributed_sgd_tpu_torch", "distributed_sgd_tpu_torch.ops.sync_epoch",
             "jaxtyping", "flaxen", "distributed_sgd_tpu", "distributed_sgd_tpu.core.trainer",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert isolation.forbidden_modules(names) == sorted(names[4:])


def test_a_cpu_run_loads_nothing_forbidden(tiny):
    import time

    from gpubench import harness

    harness.run_cell(tiny, "local-b256-h16-sgd", 3, 0.1, False, time.perf_counter(),
                     device="cpu", log=lambda m: None)
    assert isolation.forbidden_modules() == [] or "jax" in sys.modules  # JAX tests share a process
    code = ("import sys, time; sys.path.insert(0, 'gpubench/tests'); import conftest, tempfile;"
            "from pathlib import Path; from gpubench import harness, isolation;"
            "root = conftest.tiny_tree(Path(tempfile.mkdtemp()));"
            "reg = harness.Registry(root / 'BENCHMARK.json', root / 'gpubench');"
            "harness.run_cell(reg, 'sync3-b100-sgd', 3, 0.1, False, time.perf_counter(),"
            " device='cpu', log=lambda m: None);"
            "print(isolation.forbidden_modules()); sys.exit(bool(isolation.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "sync3-b100-sgd",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT)})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "card" in out.stderr


def test_a_checkout_without_the_program_gets_no_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    # past the look for a card, the run stops where it first needs the program
    code = ("import sys, time; sys.path.insert(0, '.'); from gpubench import harness;"
            "harness.run_cell(harness.Registry(), 'sync3-b100-sgd', 1, 0.1, False,"
            " time.perf_counter(), device='cpu', log=lambda m: None); print('{}')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'distributed_sgd_tpu_torch'" in out.stderr
