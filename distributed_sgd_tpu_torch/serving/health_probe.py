"""Exec-style readiness probe for the serving role (the port's copy of
the JAX package's serving/health_probe.py).

k8s's built-in gRPC probe speaks only the standard grpc.health.v1 protocol,
which the hand-written stub layer doesn't register (rpc/service.py), so
a pod probes readiness by exec'ing this module instead: dial
localhost, call `dsgd.Serving/ServeHealth`, exit 0 iff a model snapshot is
loaded (`ok=true`).  The pod therefore receives no traffic until the first
checkpoint has been hot-loaded.

    python -m distributed_sgd_tpu_torch.serving.health_probe [port]

Port defaults to $DSGD_SERVE_PORT, then 4100 (config.py).
"""

from __future__ import annotations

import os
import sys


def probe(port: int, host: str = "127.0.0.1", timeout_s: float = 2.0) -> bool:
    from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
    from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel

    channel = new_channel(host, port)
    try:
        reply = ServeStub(channel).ServeHealth(pb.Empty(), timeout=timeout_s)
        return bool(reply.ok)
    except Exception:  # noqa: BLE001 - any failure is "not ready"
        return False
    finally:
        channel.close()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    port = int(argv[0]) if argv else int(os.environ.get("DSGD_SERVE_PORT", "4100"))
    return 0 if probe(port) else 1


if __name__ == "__main__":
    sys.exit(main())
