"""In-process development cluster over real loopback gRPC.

The port of the JAX package's DevCluster (distributed_sgd_tpu/core/
cluster.py, after the reference's dev mode, Main.scala:143-158): one
master and `n_workers` workers in one process, on OS-assigned loopback
ports, with real sockets, real proto marshalling and real registration
and peer introduction.  Every node runs on the caller's device: the
workers' sync gradients are ``worker_grads`` launches on the card and
their async dispatches ``sync_epoch`` launches in the mean mode, or the
plain versions with ``device="cpu"``.

The master's heartbeat (`heartbeat_s`, `heartbeat_max_misses`) and the
workers' master watch (`master_watch_s`) are the JAX cluster's; so are
`add_worker` (a new worker joins the running cluster) and `leave_worker`
(a worker leaves it gracefully), the churn of an elastic fit, and
`host_local` (each worker holds only its contiguous slice of the train
rows, widened by `host_overprovision`, with an in-memory row reader over
the corpus, so an elastic resplit reloads only the delta).  With
`telemetry_port` (DSGD_TELEMETRY) every node gets a registry of its own,
the workers publish their health gauges and the master scrapes them and
serves the merged view on that port (0: OS-assigned), as the JAX
cluster does.  With `host_devices` = D > 1 each worker is a hierarchical
host over a contiguous group of D of `devices` (parallel/mesh.py
``local_device_groups``; parallel/hier.py).  `compress`, `compress_k`
and `compress_ef` (DSGD_COMPRESS) give every worker its compressor
(compress/): the sync replies and the async gossip are encoded by it.
`chaos` (DSGD_CHAOS, a plan or ``scenario:NAME``) installs the fault plan
(chaos/) before any node opens a channel, un-armed, so the cluster forms
in clear weather; the nodes are named ``master`` and ``w0``..``wN`` for
partition specs and for the per-edge streams, the plan is armed at the
``await_ready`` barrier and uninstalled by ``stop``, as in the JAX
cluster.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data import host_shard
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.parallel.mesh import local_device_groups
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.cluster")


class DevCluster:
    def __init__(
        self,
        model: LinearModel,
        train: Dataset,
        test: Dataset,
        n_workers: int,
        host: str = "127.0.0.1",
        base_port: int = 0,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        steps_per_dispatch: int = 1,
        compress: str = "none",
        compress_k: float = 0.01,
        compress_ef: bool = True,
        gossip_topology: str = "all",
        heartbeat_s: Optional[float] = None,
        heartbeat_max_misses: int = 3,
        master_watch_s: Optional[float] = None,
        host_local: bool = False,
        host_overprovision: float = 0.0,
        telemetry_port: Optional[int] = None,
        host_devices: int = 1,
        devices=None,
        chaos: Optional[str] = None,
    ):
        """The nodes run on the model's device (`make_model(...,
        device=...)`; the card unless the caller asks for the CPU).  All
        share `metrics` (the process's registry when None).  The workers'
        async dispatches run `steps_per_dispatch` local steps each and
        gossip along `gossip_topology`.  `heartbeat_s` starts the master's
        heartbeat; `master_watch_s` the workers' watch of the master.
        `host_local` gives worker i only rows ``overprovisioned_slice(len(
        train), i, n_workers, host_overprovision)`` of the vanilla split,
        with a row reader over `train` (data/host_shard.py).  With
        `telemetry_port` each node has a fresh registry instead of
        `metrics`: in one process a shared one would make every worker's
        Metrics reply the same and the cluster sum count it N times.
        `host_devices` > 1 makes every worker a host of that many devices,
        worker i the i-th contiguous group of `devices` (the model's
        device `n_workers * host_devices` times when None: groups on one
        card); each group's first device must be the model's.  `chaos`
        puts a fault plan on every channel of the cluster (see above)."""
        telemetry = telemetry_port is not None
        node_metrics = metrics_mod.Metrics if telemetry else (lambda: metrics)
        self._host, self._seed, self._train, self._model = host, seed, train, model
        self._host_local = bool(host_local)
        self._overprovision = max(0.0, float(host_overprovision))
        self._node_metrics = node_metrics
        host_devices = max(1, int(host_devices))
        groups = None
        if host_devices > 1:
            devs = (list(devices) if devices is not None
                    else [model.device] * (n_workers * host_devices))
            groups = local_device_groups(devs, n_workers, host_devices)
        self._worker_kwargs = dict(steps_per_dispatch=steps_per_dispatch,
                                   compress=compress, compress_k=compress_k,
                                   compress_ef=compress_ef,
                                   gossip_topology=gossip_topology,
                                   master_watch_s=master_watch_s, telemetry=telemetry)
        # the plan wraps every channel opened from here on, but injects
        # nothing until the await_ready barrier arms it
        self._chaos_installed = False
        if chaos:
            from distributed_sgd_tpu_torch import chaos as chaos_mod

            chaos_mod.install(chaos, metrics=metrics_mod.global_metrics(), armed=False)
            self._chaos_installed = True
        self.workers: List[WorkerNode] = []
        self.master = None
        try:
            self.master = MasterNode(host, base_port, train, test, model,
                                     expected_workers=n_workers, seed=seed,
                                     metrics=node_metrics()).start(
                heartbeat_s=heartbeat_s, heartbeat_max_misses=heartbeat_max_misses)
            if telemetry:
                self.master.enable_telemetry(telemetry_port)
            self._name(self.master.port, "master")
            for i in range(n_workers):
                port = 0 if base_port == 0 else base_port + 1 + i
                wdata, extra = train, {}
                if host_local:
                    lo, hi, _, _ = host_shard.overprovisioned_slice(
                        len(train), i, n_workers, overprovision=self._overprovision)
                    wdata = train.slice(slice(lo, hi))
                    # a hierarchical host binds its slice once: no reader
                    extra = (self._local_kwargs(lo) if groups is None
                             else dict(data_offset=lo))
                if groups is not None:
                    extra.update(host_devices=host_devices, devices=groups[i])
                self.workers.append(WorkerNode(host, port, host, self.master.port, wdata,
                                               model, seed=seed + i, metrics=node_metrics(),
                                               **self._worker_kwargs, **extra))
                self._name(self.workers[-1].port, f"w{i}")
            for w in self.workers:
                w.start(wait_registered=True)
            self.master.await_ready()
        except BaseException:
            self.stop()
            raise
        if self._chaos_installed:
            from distributed_sgd_tpu_torch import chaos as chaos_mod

            chaos_mod.arm()
            log.warning("chaos plan armed: %s", chaos)
        log.info("dev cluster ready: master :%d + %d workers", self.master.port, n_workers)

    def _name(self, port: int, name: str) -> None:
        """Name a node's endpoint in the installed plan (partition specs,
        and the per-edge streams' keys: OS-assigned ports differ every
        run)."""
        if self._chaos_installed:
            from distributed_sgd_tpu_torch import chaos as chaos_mod

            chaos_mod.name_endpoint(self._host, port, name)

    def _local_kwargs(self, offset: int) -> dict:
        return dict(data_offset=offset, row_reader=host_shard.dataset_reader(self._train),
                    total_rows=len(self._train), host_overprovision=self._overprovision)

    def add_worker(self, seed: Optional[int] = None) -> WorkerNode:
        """A new worker joins the running cluster: the same data and model,
        an OS-assigned port, registered through the control plane.  The
        master needs a free slot (an eviction or a leave frees one); an
        elastic fit takes it in at its next tick, a sync fit at its next
        window.  In a host-local cluster it joins with no rows, and its
        first assignment loads its slice through the reader."""
        i = len(self.workers)
        wdata, extra = self._train, {}
        if self._host_local:
            wdata, extra = self._train.slice(slice(0, 0)), self._local_kwargs(0)
        w = WorkerNode(self._host, 0, self._host, self.master.port, wdata, self._model,
                       seed=self._seed + i if seed is None else seed,
                       metrics=self._node_metrics(), **self._worker_kwargs, **extra)
        self.workers.append(w)
        self._name(w.port, f"w{i}")
        w.start(wait_registered=True)
        return w

    def leave_worker(self, i: int) -> WorkerNode:
        """Worker `i` leaves gracefully: it unregisters through the control
        plane, its async loop ends and its server and channels close (a
        scale-down, not a crash).  It is taken out of `workers`, so the
        cluster's stop does not stop it twice."""
        w = self.workers.pop(i)
        w.stop()
        return w

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        if self.master is not None:
            self.master.stop()
        if self._chaos_installed:
            from distributed_sgd_tpu_torch import chaos as chaos_mod

            chaos_mod.uninstall()
            self._chaos_installed = False

    def __enter__(self) -> "DevCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
