"""The port's provisioned dashboards and alerts (telemetry/provision.py)
against the files committed under kube/observability/, and its
instrument names against its own sources.

The four checks of tests/test_observability.py's provisioning section,
pointed at the port's package: the generation equals the committed files
byte for byte (they came from the JAX generator, whose header they keep);
every instrument either file references is recorded by a port module;
the curated core set is on them; and every instrument constant of the
port's utils/metrics.py and trace/ is recorded somewhere in the port,
bar the ones only modules still to be ported record, each listed with
its ROADMAP item.  The CLI writes the two files into the directory it is
given, never into kube/."""

import signal
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_sgd_tpu.telemetry import provision as jprovision
from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.telemetry import provision
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod


LIMIT_S = 120  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "distributed_sgd_tpu_torch"
KUBE_OBS = ROOT / "kube" / "observability"

# constants whose only recorders are modules not ported yet, each with
# its ROADMAP.md item: none since autopilot/ and compile_cache.py were
# ported (they record EVENT_AUTOPILOT_TRANSITION and
# PROC_PRESSURE_COMPILE_CACHE)
NOT_RECORDED_YET = {}


def _port_sources():
    out = {}
    for path in PORT.rglob("*.py"):
        if "__pycache__" not in path.parts:
            out[str(path)] = path.read_text()
    return out


def _constant_is_recorded(symbol: str, value: str, sources) -> bool:
    """Recorded when its SYMBOL is referenced beyond its definition, its
    literal value appears at a second site, or an f-string builds its
    family (prefix + '{'): tests/test_observability.py's rule."""
    sym_re = re.compile(rf"\b{re.escape(symbol)}\b")
    if sum(len(sym_re.findall(src)) for src in sources.values()) >= 2:
        return True
    lit_re = re.compile(rf"[\"']{re.escape(value)}[\"']")
    if sum(len(lit_re.findall(src)) for src in sources.values()) >= 2:
        return True
    prefix = value.rsplit(".", 1)[0] + ".{"
    return any(prefix in src for src in sources.values())


def _provisioned_prom_identifiers():
    text = ((KUBE_OBS / provision.DASHBOARD_FILE).read_text()
            + (KUBE_OBS / provision.ALERTS_FILE).read_text())
    return set(re.findall(r"\b(?:master|slave|health|rpc|comms|serve|proc)_[a-z0-9_]+", text))


def test_the_generation_equals_the_committed_files():
    assert (KUBE_OBS / provision.DASHBOARD_FILE).read_text() == provision.render_dashboard()
    assert (KUBE_OBS / provision.ALERTS_FILE).read_text() == provision.alert_rules()
    # and the generator is the JAX one's, instrument for instrument
    assert provision.REFERENCED_INSTRUMENTS == jprovision.REFERENCED_INSTRUMENTS
    assert provision.CORE_INSTRUMENTS == jprovision.CORE_INSTRUMENTS
    assert provision.dashboard() == jprovision.dashboard()


def test_every_dashboard_and_alert_metric_is_recorded_by_a_port_module():
    known = {provision._prom(name): name for name in provision.REFERENCED_INSTRUMENTS}
    sources = {p: s for p, s in _port_sources().items()
               if not p.endswith(os.path.join("telemetry", "provision.py"))}
    suffixes = ("_total", "_hist_bucket", "_hist_sum", "_hist_count",
                "_bucket", "_count", "_sum", "_min", "_max", "_last", "")
    constants = {v: k for k, v in vars(metrics_mod).items()
                 if k.isupper() and isinstance(v, str)}
    stray, unrecorded = [], []
    for ident in sorted(_provisioned_prom_identifiers()):
        base = next((ident[: len(ident) - len(s)] for s in suffixes
                     if s and ident.endswith(s)), ident)
        name = known.get(base) or known.get(ident)
        if name is None:
            stray.append(ident)
            continue
        # recorded: the literal at a recording site, or its constant used
        # outside utils/metrics.py
        lit = re.compile(rf"[\"']{re.escape(name)}[\"']")
        sym = constants.get(name)
        used = any(lit.search(src) for p, src in sources.items()
                   if not p.endswith(os.path.join("utils", "metrics.py")))
        if not used and sym is not None:
            sym_re = re.compile(rf"\b{sym}\b")
            used = any(sym_re.search(src) for p, src in sources.items()
                       if not p.endswith(os.path.join("utils", "metrics.py")))
        if not used:
            unrecorded.append(f"{ident} -> {name}")
    assert not stray, f"metrics with no REFERENCED_INSTRUMENTS entry: {stray}"
    assert not unrecorded, f"metrics no port module records: {unrecorded}"


def test_the_core_instruments_are_dashboarded():
    idents = _provisioned_prom_identifiers()
    missing = [name for name in provision.CORE_INSTRUMENTS
               if not any(i.startswith(provision._prom(name)) for i in idents)]
    assert not missing, f"core instruments absent from the dashboard and alerts: {missing}"


def test_every_instrument_constant_is_recorded_somewhere_in_the_port():
    sources = _port_sources()
    missing, listed = [], []
    for mod in (metrics_mod, trace_mod):
        for name, value in vars(mod).items():
            if (name.isupper() and not name.startswith("_")
                    and isinstance(value, str) and "." in value):
                recorded = _constant_is_recorded(name, value, sources)
                if name in NOT_RECORDED_YET:
                    listed.append((name, recorded))
                elif not recorded:
                    missing.append(f"{mod.__name__}.{name} = {value!r}")
    assert not missing, f"constants the port never records: {missing}"
    # a listed one that the port records now leaves the list
    assert dict(listed) == dict.fromkeys(NOT_RECORDED_YET, False), listed


def test_the_cli_writes_into_the_directory_it_is_given(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-m", "distributed_sgd_tpu_torch.telemetry.provision",
                          str(tmp_path / "obs")], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    for name in (provision.DASHBOARD_FILE, provision.ALERTS_FILE):
        assert (tmp_path / "obs" / name).read_bytes() == (KUBE_OBS / name).read_bytes()
    usage = subprocess.run([sys.executable, "-m", "distributed_sgd_tpu_torch.telemetry.provision"],
                           cwd=tmp_path, env=env, capture_output=True, text=True, timeout=60)
    assert usage.returncode != 0 and "out_dir" in usage.stderr


@pytest.mark.parametrize("name", ["health.loss.ewma", "health.tripped",
                                  "health.ef.residual.norm"])
def test_the_three_instruments_missing_before_are_recorded_by_their_modules(name):
    """Before the health monitor and the compressors were ported, no port
    module recorded these: each is set by the module that owns it now."""
    owner = {"health.loss.ewma": "telemetry/health.py", "health.tripped": "telemetry/health.py",
             "health.ef.residual.norm": "core/worker.py"}[name]
    sym = next(k for k, v in vars(metrics_mod).items() if v == name and k.isupper())
    assert re.search(rf"metrics_mod\.{sym}\b", (PORT / owner).read_text())
