"""Online serving on the card (the port of the JAX package's serving/).

Answers single-row prediction requests at serving latency from the same
sparse forward pass the trainers use, with the weights on the card:

- `batcher.MicroBatcher`: concurrent single-row requests coalesce into
  one padded device batch under a max-latency deadline, with a bounded
  admission queue (backpressure instead of unbounded latency);
- `bucketing`: powers-of-two (batch, nnz) shape buckets, the JAX
  server's padded arrays byte for byte;
- `model_store.ModelStore`: loads the port's ``<step>.npz`` checkpoints
  onto the device and hot-swaps them atomically when the trainer saves a
  new one, or applies pushed weights and deltas (`PushWeights`);
- `server.ServingServer`: the gRPC `dsgd.Serving` front end
  (Predict/ServeHealth/PushWeights), the `DSGD_ROLE=serve` role;
- `health_probe`: exec-style readiness probe;
- `router.ServingRouter`: the fleet front (`DSGD_ROLE=route`) — N
  shared-nothing replicas behind power-of-two-choices health-aware load
  balancing, hedged failover, and a canary gate on pushed versions; it
  computes on the host;
- `push.WeightPusher` / `push.CheckpointDistributor`: the trainer side of
  delta checkpoint distribution (`DSGD_SERVE_PUSH`);
- `ha`: dual live routers with a leased decider, client failover and the
  replica autoscaler (`DSGD_SERVE_HA`, `DSGD_SERVE_SLO_MS`);
- `fleet.ServingFleet`: in-process N-replica fleet + router harness.

Every class keeps the JAX module's name, metrics and wire behaviour, so
JAX and port routers, replicas, pushers and HA peers mix in one fleet.
"""

from distributed_sgd_tpu_torch.serving.batcher import MicroBatcher, QueueFull
from distributed_sgd_tpu_torch.serving.fleet import ServingFleet
from distributed_sgd_tpu_torch.serving.model_store import ModelStore
from distributed_sgd_tpu_torch.serving.push import CheckpointDistributor, WeightPusher
from distributed_sgd_tpu_torch.serving.router import ServingRouter
from distributed_sgd_tpu_torch.serving.server import PredictEngine, ServingServer

__all__ = [
    "CheckpointDistributor",
    "MicroBatcher",
    "ModelStore",
    "PredictEngine",
    "QueueFull",
    "ServingFleet",
    "ServingRouter",
    "ServingServer",
    "WeightPusher",
]
