"""In-host device group for hierarchical RPC workers.

The port of the JAX package's parallel/hier.py.  A `WorkerNode` started
with ``host_devices=D`` (DSGD_HOST_DEVICES) is one host of D devices: its
Gradient and local-window bodies split the request's batch over the
devices and sum the partials on the first one, so the master sees one
reply a host instead of one a device.

The reply is the flat worker's (core/worker.py ``compute_gradient`` /
``compute_local_window``): the per-sample backward SUM over the whole
request batch, regularized ONCE (a host is one reference worker,
Slave.scala:142-157).  Each device's partial is unregularized, and the
regularizer is applied to the summed total, so the ``g != 0`` support
mask of the dim-sparsity term is the full batch's.  It equals the flat
worker's up to the order of the float sums.

Each device's partial is one ``worker_grads`` launch at K = 1 on a CUDA
device (ops/worker_grads.py), its plain version on the CPU; a dense-layout
slice takes ``grad_dense``.  The host's slice is REPLICATED on every
device of the group: each device gathers arbitrary rows of it (the master
draws uniformly from the host's partition).  The devices are an explicit
list, which may name one device twice (a group on one card).

The batch buckets are the JAX engine's: a power of two a device, the pad
ids pointing at row 0 with a zero validity weight.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.ops.coeff import check_launchable
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike


def _indexed(device: DeviceLike) -> torch.device:
    """`device` with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class HostMeshEngine:
    """One RPC worker's device group: batch-split gradient sums."""

    def __init__(self, model: LinearModel, devices: Sequence[DeviceLike], data: Dataset):
        if len(devices) < 2:
            raise ValueError(
                f"a host mesh needs >= 2 devices, got {len(devices)} "
                f"(host_devices=1 is the flat single-device worker)")
        self.model = model
        self.devices = [_indexed(d) for d in devices]
        if self.devices[0] != _indexed(model.device):
            raise ValueError(f"the group's first device {self.devices[0]} differs from the "
                             f"model's {model.device}: the sum is regularized there")
        self.n_devices = len(self.devices)
        self.n_rows = len(data)
        self.dense = data.is_dense
        if not self.dense:  # a model's own rule needs its CUDA form on a card
            for dev in self.devices:
                check_launchable(model.coeff, dev)
        # the host's slice on every device of the group (one copy a
        # distinct device)
        copies = {}
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = (
                    torch.as_tensor(np.ascontiguousarray(data.indices), dtype=torch.int32).to(dev),
                    torch.as_tensor(np.ascontiguousarray(data.values), dtype=torch.float32).to(dev),
                    torch.as_tensor(np.asarray(data.labels, np.float32)).to(dev))
        self._rows = [copies[dev] for dev in self.devices]

    # -- padding -----------------------------------------------------------

    def pad_capacity(self, n: int) -> int:
        """Power-of-two batch bucket a device, rounded up to a device
        multiple so the split is exact."""
        d = self.n_devices
        per_dev = 1 if n <= d else 1 << (-(-n // d) - 1).bit_length()
        return d * per_dev

    def _check_ids(self, ids: np.ndarray) -> None:
        """Ids outside the slice raise here: a gather on the card would
        not."""
        if len(ids) and (np.min(ids) < 0 or np.max(ids) >= self.n_rows):
            raise ValueError(f"sample ids outside this host's {self.n_rows} rows")

    def pad_ids(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(ids padded to their bucket with row 0, validity weights)."""
        self._check_ids(ids)
        cap = self.pad_capacity(len(ids))
        padded = np.zeros(cap, dtype=np.int32)
        padded[: len(ids)] = ids
        valid = np.zeros(cap, dtype=np.float32)
        valid[: len(ids)] = 1.0
        return padded, valid

    # -- the bodies ----------------------------------------------------------

    def _partial_grad(self, i: int, w: torch.Tensor, ids: np.ndarray,
                      valid: np.ndarray) -> torch.Tensor:
        """Device i's UNregularized backward sum over its part of the batch
        (pad rows weighted 0 contribute 0 in every model)."""
        dev = self.devices[i]
        idx, val, y = self._rows[i]
        t = torch.from_numpy(ids.astype(np.int64)).to(dev)
        v = torch.from_numpy(valid).to(dev)
        rows_v = val.index_select(0, t) * v[:, None]
        by = y.index_select(0, t) * v
        wd = w.to(dev)
        if self.dense:
            return self.model.grad_dense(wd, rows_v, by)
        rows_i = idx.index_select(0, t)
        return wg.worker_grads(wd, rows_i[None].contiguous(), rows_v[None].contiguous(),
                               by[None].contiguous(), self.model.coeff)[0]

    def _reduced_grad(self, w: torch.Tensor, ids: np.ndarray,
                      valid: np.ndarray) -> torch.Tensor:
        """The partials of every device, summed on the first in device
        order, then regularized once: the whole batch's support mask."""
        per = len(ids) // self.n_devices
        parts: List[torch.Tensor] = [
            self._partial_grad(i, w, ids[i * per:(i + 1) * per], valid[i * per:(i + 1) * per])
            for i in range(self.n_devices)]
        g = parts[0]
        for p in parts[1:]:
            g = g + p.to(self.devices[0])
        return self.model.regularize(g, w)

    def _weights(self, w: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(w, dtype=np.float32)).to(self.devices[0])

    # -- host API ----------------------------------------------------------

    def grad(self, w: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Sync Gradient reply body: the sum of backwards over the whole
        request batch, regularized once, f32[D] on the host."""
        padded, valid = self.pad_ids(ids)
        return self._reduced_grad(self._weights(w), padded, valid).cpu().numpy()

    def local_window(self, w: np.ndarray, ids: np.ndarray, steps: int,
                     batch_size: int, learning_rate: float) -> np.ndarray:
        """K local SGD steps over `ids` split into `batch_size` batches, each
        step's batch padded to a device multiple, the plain update
        ``w - lr*g``.  Returns the decrement w_start - w_end."""
        d = self.n_devices
        bs = -(-max(1, int(batch_size)) // d) * d  # device-multiple batch
        n = min(len(ids), steps * batch_size)
        self._check_ids(ids[:n])
        w0 = self._weights(w)
        wt = w0
        for t in range(steps):
            row = np.asarray(ids[t * batch_size: min(n, (t + 1) * batch_size)], dtype=np.int32)
            padded = np.zeros(bs, dtype=np.int32)
            valid = np.zeros(bs, dtype=np.float32)
            padded[: len(row)] = row
            valid[: len(row)] = 1.0
            wt = wt - learning_rate * self._reduced_grad(wt, padded, valid)
        return (w0 - wt).cpu().numpy()
