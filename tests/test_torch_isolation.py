"""The port (distributed_sgd_tpu_torch/) and chip_smoke.py stand alone:
they import no jax, no orbax and nothing of the JAX package, its entry points refuse
to run without a device choice when there is no CUDA, and chip_smoke.py
fails without a card or without the rest of the repo."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_sgd_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue  # running it starts a training run
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _is_jax_package(name: str) -> bool:
    return name == "distributed_sgd_tpu" or name.startswith("distributed_sgd_tpu.")


def test_every_port_module_imports_with_jax_blocked():
    mods = _port_modules() + ["chip_smoke"]
    assert {"distributed_sgd_tpu_torch.ops.worker_grads", "distributed_sgd_tpu_torch.parallel.hogwild",
            "distributed_sgd_tpu_torch.parallel.local_sgd",
            "distributed_sgd_tpu_torch.core.loss_check", "distributed_sgd_tpu_torch.checkpoint",
            "distributed_sgd_tpu_torch.utils.measure",
            "distributed_sgd_tpu_torch.utils.fsio", "distributed_sgd_tpu_torch.utils.metrics",
            "distributed_sgd_tpu_torch.trace", "distributed_sgd_tpu_torch.trace.flight",
            "distributed_sgd_tpu_torch.trace.merge", "distributed_sgd_tpu_torch.rpc",
            "distributed_sgd_tpu_torch.rpc.codec", "distributed_sgd_tpu_torch.rpc.service",
            "distributed_sgd_tpu_torch.rpc.dsgd_pb2", "distributed_sgd_tpu_torch.rpc.stream",
            "distributed_sgd_tpu_torch.core.worker",
            "distributed_sgd_tpu_torch.core.master", "distributed_sgd_tpu_torch.core.cluster",
            "distributed_sgd_tpu_torch.core.split",
            "distributed_sgd_tpu_torch.tools.sync_epoch_routes",
            "distributed_sgd_tpu_torch.utils.pool", "distributed_sgd_tpu_torch.data.host_shard",
            "distributed_sgd_tpu_torch.data.row_store"} <= set(mods)
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['orbax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (\n"
        "    m == 'distributed_sgd_tpu' or m.startswith('distributed_sgd_tpu.')\n"
        "    or m == 'jax' or m.startswith('jax.') or m.split('.')[0] == 'orbax'))\n"
        "print('BAD', bad)\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_line_imports_jax_or_the_jax_package(path):
    # catches imports inside functions too, which the import test misses
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "orbax") and not _is_jax_package(name), (
                f"{path}: imports {name}")


def test_entry_points_without_a_device_refuse_to_run_on_a_host_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: entry points run on it by default")
    from distributed_sgd_tpu_torch import convert
    from distributed_sgd_tpu_torch.main import main
    from distributed_sgd_tpu_torch.models.linear import make_model
    from distributed_sgd_tpu_torch.parallel.sync import SyncEngine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_model("hinge", 1e-4, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.weights_from_jax([0.0] * 10, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main()
    model = make_model("hinge", 1e-4, 10, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyncEngine(model, batch_size=4, learning_rate=0.5)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
