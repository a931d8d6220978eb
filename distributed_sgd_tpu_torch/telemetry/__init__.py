"""The long-horizon resource plane (the JAX package's telemetry/, first part).

- ``resources``: the per-process ``ResourceProbe`` sampling /proc and the
  internal-pressure gauges every ``DSGD_RESOURCE_PROBE_S`` seconds, and
  the pressure registry the master's drain inbox and the serving batcher
  publish to;
- ``slope``: the ``LeakSentinel``, Theil–Sen slope detection over those
  series;
- ``blackbox``: the crash-surviving on-disk snapshot ring under
  ``DSGD_BLACKBOX_DIR``, with its post-mortem CLI
  (``python -m distributed_sgd_tpu_torch.telemetry.blackbox``);
- ``aggregate``: the cluster telemetry scrape (DSGD_TELEMETRY), a node's
  ``Metrics`` snapshot and the merged exposition of a master or router;
- ``health``: the training-health monitor (DSGD_HEALTH_ACTION) that rides
  the rpc sync fit, and to which the leak sentinel routes its trips;
- ``provision``: the cluster dashboard and the alert rules, generated from
  the instrument names (``python -m
  distributed_sgd_tpu_torch.telemetry.provision <dir>``).

Everything is default-off: with ``DSGD_RESOURCE_PROBE_S`` unset no probe
thread starts and no file is written, with DSGD_TELEMETRY unset no node is
scraped (the ``Metrics`` RPC is served, pull-only), and with
DSGD_HEALTH_ACTION unset no fit is watched.
"""

# NOTE: blackbox is deliberately NOT imported here — it is a `-m`-runnable
# post-mortem CLI, and a package-level import would put the submodule in
# sys.modules before runpy executes it (RuntimeWarning on every CLI use).
from distributed_sgd_tpu_torch.telemetry.health import HealthMonitor  # noqa: F401
from distributed_sgd_tpu_torch.telemetry.resources import (  # noqa: F401
    ResourceProbe,
    register_pressure,
    sample_resources,
    unregister_pressure,
)
from distributed_sgd_tpu_torch.telemetry.slope import LeakSentinel  # noqa: F401
