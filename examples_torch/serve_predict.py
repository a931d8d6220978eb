"""Train -> checkpoint -> serve -> predict, end to end in one process.

Trains a hinge SVM briefly on synthetic RCV1-shaped data, checkpoints it,
starts the gRPC serving front end (serving/ServingServer) over that
checkpoint directory, and issues concurrent single-row Predicts -- which
the server coalesces into micro-batches (watch `serve.batch.size`).
Every served answer is checked against `model.predict` on the same
checkpointed weights, and a second checkpoint demonstrates hot-reload
without restarting the server.

    python examples_torch/serve_predict.py [n_samples] [--device cpu]

Fleet mode: set DSGD_SERVE_ROUTER to a router's host:port and the demo
drives THAT endpoint instead of starting a local server -- the same
Predict checks, with the second checkpoint reaching the fleet through its
PushWeights distribution path (the router and its replicas must share
this process's checkpoint directory, or be fed by a CheckpointDistributor
watching it).
"""

import argparse
import os
import shutil
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_sgd_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from distributed_sgd_tpu_torch.core.early_stopping import no_improvement  # noqa: E402
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer  # noqa: E402
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split  # noqa: E402
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import make_model  # noqa: E402
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb  # noqa: E402
from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel  # noqa: E402
from distributed_sgd_tpu_torch.serving.server import ServingServer  # noqa: E402
from distributed_sgd_tpu_torch.utils.metrics import Metrics  # noqa: E402

RELOAD_WAIT_S = 15.0  # the hot reload must be served within this
REQUEST_TIMEOUT_S = 30.0


def main(n: int = 5_000, max_epochs: int = 2, n_requests: int = 32, device=None) -> float:
    ckpt_dir = tempfile.mkdtemp(prefix="dsgd-serve-demo-")

    # -- train briefly and checkpoint ---------------------------------------
    data = rcv1_like(n, seed=0, idf_values=True)
    train, test = train_test_split(data)
    model = make_model("hinge", 1e-5, data.n_features, dim_sparsity=dim_sparsity(train),
                       device=device)
    ckpt = Checkpointer(ckpt_dir)
    trainer = SyncTrainer(model, batch_size=100, learning_rate=0.5, checkpointer=ckpt,
                          checkpoint_every=1, device=device)
    res = trainer.fit(train, test, max_epochs,
                      criterion=no_improvement(patience=3, min_delta=0.01))
    ckpt.close()
    w = torch.as_tensor(res.state.weights).detach().cpu()
    print(f"trained {res.epochs_run} epochs, test_loss={res.test_losses[-1]:.4f}")

    # -- serve it -----------------------------------------------------------
    # DSGD_SERVE_ROUTER=host:port -> drive an already-running fleet router
    # instead of a local single-node server (the wire surface is the same)
    router = os.environ.get("DSGD_SERVE_ROUTER")
    metrics = Metrics()
    server = None
    if router:
        from distributed_sgd_tpu_torch.serving.push import parse_targets

        channel = new_channel(*parse_targets(router)[0])
    else:
        server = ServingServer(
            ckpt_dir, model="hinge", port=0, host="127.0.0.1",
            max_batch=16, max_delay_ms=5.0, queue_depth=128,
            ckpt_poll_s=0.2, metrics=metrics, device=device,
        ).start()
        channel = new_channel("127.0.0.1", server.bound_port)
    try:
        stub = ServeStub(channel)
        health = stub.ServeHealth(pb.Empty(), timeout=5)
        where = router or f":{server.bound_port}"
        print(f"serving on {where}, model step {health.model_step}")

        # -- concurrent Predicts, checked against model.predict -------------
        rows = [(train.indices[i], train.values[i]) for i in range(n_requests)]
        mismatches, answered, rpc_errors = [], [], []

        def one(i):
            try:
                idx, val = rows[i]
                nz = val != 0
                reply = stub.Predict(pb.PredictRequest(indices=idx[nz], values=val[nz]),
                                     timeout=REQUEST_TIMEOUT_S)
                margin = (w[torch.from_numpy(idx[nz]).long()]
                          * torch.from_numpy(val[nz])).sum()
                direct = float(model.predict(margin.to(model.device)))
                if abs(reply.margin - float(margin)) > 1e-4 or reply.prediction != direct:
                    mismatches.append((i, reply.margin, float(margin)))
                answered.append(i)
            except Exception as e:  # noqa: BLE001 - surfaced by the asserts below
                rpc_errors.append((i, e))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=REQUEST_TIMEOUT_S + 5)
        assert not any(t.is_alive() for t in threads), "a Predict outlived its timeout"
        assert not rpc_errors, f"predict RPCs failed: {rpc_errors[:3]}"
        assert len(answered) == n_requests
        assert not mismatches, f"served answers diverged: {mismatches[:3]}"
        if server is not None:
            batch_hist = metrics.histogram("serve.batch.size")
            print(f"{n_requests} predicts over {batch_hist.count} micro-batches "
                  f"(max batch {batch_hist.max:.0f}, p50 latency "
                  f"{metrics.histogram('serve.predict.duration').quantile(0.5) * 1e3:.2f} ms)")

        # -- hot-reload: save new weights, the server picks them up ---------
        step0 = int(health.model_step)
        ckpt2 = Checkpointer(ckpt_dir)
        ckpt2.save(step0 + 1, np.asarray(w) * 2.0)
        ckpt2.close()
        deadline = time.time() + RELOAD_WAIT_S

        def serving_step():
            # local mode watches the store directly; router mode asks the
            # fleet's aggregate ServeHealth over the wire
            if server is not None:
                return server.store.step
            return stub.ServeHealth(pb.Empty(), timeout=5).model_step

        while time.time() < deadline and serving_step() != step0 + 1:
            time.sleep(0.05)
        reply = stub.Predict(pb.PredictRequest(indices=rows[0][0][:1], values=rows[0][1][:1]),
                             timeout=REQUEST_TIMEOUT_S)
        print(f"hot-reloaded: now serving model step {reply.model_step}")
        assert reply.model_step == step0 + 1
    finally:
        channel.close()
        if server is not None:
            server.stop()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return float(metrics.histogram("serve.batch.size").max) if server is not None else 1.0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=5_000)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    main(args.n, device=args.device)
