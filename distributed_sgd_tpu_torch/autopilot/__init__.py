"""Continual-learning autopilot.

The port's copy of the JAX package's autopilot/ (its docs/CONTINUAL.md):
the train/serve flywheel as a subsystem -- an online drifting stream
plane (:mod:`stream`), live canary-probe sourcing from serving traffic
(:mod:`probe_source`), and the controller state machine that closes the
loop: drift detected at the serving edge triggers a warm-start retrain
whose checkpoint flows through the existing ``CheckpointDistributor`` ->
canary -> promote path with zero operator actions (:mod:`controller`,
:mod:`flywheel`).

Default-off behind ``DSGD_AUTOPILOT``: with the knob unset nothing here
is imported on any hot path, no thread starts, and no instrument
registers.
"""

from distributed_sgd_tpu_torch.autopilot.controller import (  # noqa: F401
    AutopilotController,
    DriftDetector,
    STATES,
)
from distributed_sgd_tpu_torch.autopilot.flywheel import Flywheel  # noqa: F401
from distributed_sgd_tpu_torch.autopilot.probe_source import ProbeReservoir  # noqa: F401
from distributed_sgd_tpu_torch.autopilot.stream import (  # noqa: F401
    DriftingStream,
    SCHEDULES,
    continual_criterion,
    window_split,
)
