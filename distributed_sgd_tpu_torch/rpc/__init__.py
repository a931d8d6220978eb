"""gRPC plane of the port: the JAX package's wire, byte for byte."""

from distributed_sgd_tpu_torch.rpc import codec  # noqa: F401
from distributed_sgd_tpu_torch.rpc.service import (  # noqa: F401
    MasterStub,
    WorkerStub,
    add_master_servicer,
    add_worker_servicer,
    new_channel,
    new_server,
)
