"""Checkpoint and resume, in the port's own file format.

The JAX package checkpoints through orbax (distributed_sgd_tpu/
checkpoint.py).  orbax imports jax and is absent on the GPU host, so the
port keeps the JAX package's snapshot *contract* (the keys, the leaf
order, the cadence) in a format of its own:

- a checkpoint directory holds one ``<step>.npz`` file per step (numpy's
  ``np.savez``: the snapshot's arrays under their keys, ``weights`` among
  them), each written atomically (utils/fsio.py), the newest `keep` kept;
- `Checkpointer` has the JAX class's methods and orbax's observable
  behaviour: a save to a step that exists writes nothing and returns
  False with a warning, and `restore_latest` returns ``(step, state)``
  with numpy arrays.  The JAX trainer and loss checker take any object
  with ``save``/``restore_latest``, so a directory written through this
  class by either package resumes in the other;
- a directory that holds orbax step directories (the JAX package's own
  format) raises ValueError: the port cannot read it, and does not start
  a fresh fit beside it.

Wiring (``Config.checkpoint_dir``, built in main.py), as in the JAX
package:

- `SyncTrainer` saves the weights, the newest-first test-loss history and
  the optimizer's kind and state leaves every `checkpoint_every` epochs,
  and once at an off-cadence end, and resumes from the latest snapshot,
  continuing the sampling stream, the optimizer state and the
  early-stopping window;
- the async engines hand their Checkpointer to `LossChecker`, which saves
  the best weights and the smoothing history on each improvement and
  every `save_every`-th plateau check; main.py feeds the latest snapshot
  back as the initial weights.  The async optimizer state is not saved.

`FitState` and `save_fit_state`/`restore_fit_state` are the JAX package's
crash-safe ``fit_state.npz``, the same keys in the same numpy file.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.convert import LANES, n_blocks
from distributed_sgd_tpu_torch.utils.fsio import atomic_write
from distributed_sgd_tpu_torch.utils.measure import span

log = logging.getLogger("dsgd.checkpoint")

_STEP_FILE = re.compile(r"^(\d+)\.npz$")
_ORBAX_STEP_DIR = re.compile(r"^\d+(\.orbax-checkpoint-tmp-.*)?$")  # orbax's step directories


def _host(x) -> np.ndarray:
    """A numpy array of `x`: a torch tensor (on any device), a JAX or
    numpy array, or a Python scalar."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Checkpointer:
    """Step-numbered snapshots in a directory, one ``<step>.npz`` each."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.keep = int(keep)
        os.makedirs(self.directory, exist_ok=True)
        self._steps()  # an orbax directory fails here, before any fit

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.npz")

    def _steps(self) -> List[int]:
        """The saved steps, ascending, read from the directory."""
        steps = []
        with os.scandir(self.directory) as entries:
            for e in entries:
                m = _STEP_FILE.match(e.name)
                if m and e.is_file():
                    steps.append(int(m.group(1)))
                elif _ORBAX_STEP_DIR.match(e.name) and e.is_dir():
                    raise ValueError(
                        f"{self.directory} holds orbax step directories ({e.name!r}): the "
                        f"JAX package's checkpoint format, which the port cannot read.  "
                        f"Re-save it in the port's format from a process that has orbax: "
                        f"step, state = distributed_sgd_tpu.checkpoint.Checkpointer(src)"
                        f".restore_latest(); distributed_sgd_tpu_torch.checkpoint."
                        f"Checkpointer(dst).save(step, state.pop('weights'), extra=state); "
                        f"then point the port at dst")
        return sorted(steps)

    def save(self, step: int, weights, extra: Optional[Dict[str, Any]] = None) -> bool:
        """Write ``{"weights": weights, **extra}`` as step `step`; False (and
        nothing written) when that step exists.  Values may be numpy or JAX
        arrays, torch tensors on any device, or Python scalars."""
        path = self._path(step)
        with span("ckpt.save"):
            saved = not os.path.exists(path)
            if saved:
                state = {"weights": _host(weights)}
                if extra:
                    state.update({k: _host(v) for k, v in extra.items()})
                atomic_write(path, lambda f: np.savez(f, **state))
                for old in self._steps()[:-self.keep]:
                    try:
                        os.remove(self._path(old))
                    except FileNotFoundError:  # another writer pruned it
                        pass
        if saved:
            log.info("checkpoint saved at step %d -> %s", step, self.directory)
        else:  # as orbax declines a write to an existing step
            log.warning("checkpoint at step %d NOT saved (step exists?)", step)
        return saved

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def reload(self) -> None:
        """Re-read the step list from disk.  The list is read at every call
        (orbax caches it), so this only checks the directory again."""
        self._steps()

    def poll_newer(self, than: Optional[int]) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The latest snapshot iff its step is newer than `than` (None: any
        step is newer), else None: a directory watcher's poll."""
        self.reload()
        step = self.latest_step()
        if step is None or (than is not None and step <= than):
            return None
        return self.restore_latest()

    def restore_latest(self) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        """(step, state) of the newest snapshot, every value a numpy array;
        None when the directory holds none."""
        step = self.latest_step()
        if step is None:
            return None
        with span("ckpt.restore"):
            try:
                with np.load(self._path(step), allow_pickle=False) as z:
                    state = {k: z[k] for k in z.files}
            except FileNotFoundError:  # a writer pruned it after the listing: list again
                return self.restore_latest()
        return step, state

    def close(self) -> None:
        """Nothing to release: no file or thread outlives a call."""


class RestoreOnly:
    """A checkpointer as a rank other than 0 sees it: it restores the
    snapshots, and its `save` writes nothing, so a fit over N ranks leaves
    one snapshot a step, rank 0's."""

    def __init__(self, checkpointer):
        self.checkpointer = checkpointer

    def save(self, step: int, weights, extra: Optional[Dict[str, Any]] = None) -> bool:
        return False

    def latest_step(self) -> Optional[int]:
        return self.checkpointer.latest_step()

    def restore_latest(self):
        return self.checkpointer.restore_latest()

    def close(self) -> None:
        """Nothing to release."""


def for_rank(checkpointer, rank: int):
    """`checkpointer` itself at rank 0 (or None), else its `RestoreOnly`
    view: every rank restores, rank 0 alone writes."""
    if checkpointer is None or rank == 0:
        return checkpointer
    return RestoreOnly(checkpointer)


# -- the shared sync-fit snapshot contract ------------------------------------
#
# The JAX package's keys: the weights, the newest-first test-loss history,
# the optimizer kind tag and its state leaves in optax's order.  The port
# writes its leaves flat [D]; it also accepts a JAX engine's lane-blocked
# [R, 128] leaves, which parallel/sync.py load_opt_state_leaves converts.


def opt_kind_tag(optimizer) -> str:
    """The snapshot's optimizer tag: the configured name, 'sgd' for None,
    'custom' for anything else (as the JAX package tags optax objects)."""
    if isinstance(optimizer, str):
        return optimizer
    return "sgd" if optimizer is None else "custom"


def sync_fit_extra(test_losses_newest_first, opt_kind: str, opt_leaves) -> Dict[str, Any]:
    """The `extra` dict saved beside the weights."""
    extra: Dict[str, Any] = {}
    if test_losses_newest_first:
        extra["test_losses_nf"] = np.asarray(test_losses_newest_first, np.float32)
    extra["opt_kind"] = np.frombuffer(opt_kind.encode(), dtype=np.uint8)
    for i, leaf in enumerate(opt_leaves):
        extra[f"opt_{i}"] = _host(leaf)
    return extra


def _leaf_fits(got, want) -> bool:
    """`got` has `want`'s shape, or is the lane-blocked view of a flat one."""
    got, want = tuple(np.shape(got)), tuple(np.shape(want))
    return got == want or (len(want) == 1 and got == (n_blocks(want[0]), LANES))


def decode_sync_fit_state(state: Dict[str, Any], opt_kind: str, expected_leaves):
    """(test_losses_newest_first, opt_leaves) of a sync-fit snapshot,
    checked against the configured optimizer: a snapshot written under
    another optimizer kind, leaf count or leaf shape raises ValueError."""
    test_nf = ([float(x) for x in np.asarray(state["test_losses_nf"])]
               if "test_losses_nf" in state else [])
    saved_kind = (bytes(np.asarray(state["opt_kind"], np.uint8)).decode()
                  if "opt_kind" in state else "sgd")
    if saved_kind != opt_kind:
        raise ValueError(
            f"checkpoint was written with optimizer {saved_kind!r} but this "
            f"run is configured with {opt_kind!r}; resume with the original "
            f"optimizer or point at a fresh checkpoint_dir")
    opt_leaves = []
    while f"opt_{len(opt_leaves)}" in state:
        opt_leaves.append(state[f"opt_{len(opt_leaves)}"])
    expected = list(expected_leaves)
    if len(opt_leaves) != len(expected) or not all(map(_leaf_fits, opt_leaves, expected)):
        raise ValueError(
            f"checkpointed optimizer-state leaves "
            f"{[tuple(np.shape(x)) for x in opt_leaves]} do not match the configured "
            f"optimizer/kernel layout {[tuple(np.shape(x)) for x in expected]}; "
            f"resume with the original optimizer and kernel, or use a fresh "
            f"checkpoint_dir")
    return test_nf, opt_leaves


def restore_sync_fit(checkpointer, opt_kind: str, expected_leaves):
    """(start_epoch, weights_np, test_losses_newest_first, opt_leaves) of
    the latest sync-fit snapshot, checked against the configured
    optimizer; None without a checkpointer or a snapshot."""
    if checkpointer is None:
        return None
    restored = checkpointer.restore_latest()
    if restored is None:
        return None
    start_epoch, state = restored
    test_nf, opt_leaves = decode_sync_fit_state(state, opt_kind, expected_leaves)
    return start_epoch, np.asarray(state["weights"]), test_nf, opt_leaves


def save_sync_fit(checkpointer, epoch: int, weights, test_losses_newest_first,
                  opt_kind: str = "sgd", opt_leaves=()) -> None:
    checkpointer.save(epoch, weights, extra=sync_fit_extra(
        test_losses_newest_first, opt_kind, list(opt_leaves)))


def save_sync_fit_final(checkpointer, epochs_run: int, start_epoch: int,
                        checkpoint_every: int, weights, test_losses_newest_first,
                        opt_kind: str = "sgd", opt_leaves=()) -> None:
    """An off-cadence end (an early stop, or max_epochs not a multiple of
    `checkpoint_every`) saves the final state, so no fit with a
    checkpointer ends unsaved.  `weights` may be a zero-argument callable,
    called only when the save happens."""
    if (checkpointer is not None and epochs_run > start_epoch
            and epochs_run % checkpoint_every != 0):
        if callable(weights):
            weights = weights()
        save_sync_fit(checkpointer, epochs_run, weights, test_losses_newest_first,
                      opt_kind, opt_leaves)


# -- the crash-safe full fit state (the JAX package's fit_state.npz) ----------
#
# Everything the RPC master's fit_sync loop needs to resume from its last
# completed window: weights, optimizer leaves, the epoch and window cursor,
# the np.random.Generator bit-generator state, the early-stopping history,
# the broadcast version and the fit-token lineage.  Written atomically.

FIT_STATE_FILE = "fit_state.npz"


def fit_state_path(directory: str) -> str:
    """Where a checkpoint directory keeps its fit-state snapshot."""
    return os.path.join(directory, FIT_STATE_FILE)


@dataclasses.dataclass
class FitState:
    """A decoded fit-state snapshot."""

    epoch: int
    batch: int                    # window cursor within `epoch`
    weights: np.ndarray
    rng_state: Dict[str, Any]     # np.random.Generator.bit_generator.state
    test_losses_nf: List[float]   # newest-first early-stopping history
    opt_leaves: List[np.ndarray]
    bcast_version: int
    fit_tokens: List[int]         # lineage: the tokens that have driven this fit
    # the convergence criterion ended the fit before max_epochs: a restart
    # takes the nothing-to-run path (budget exhaustion is not marked: the
    # epoch cursor carries it, and a raised max_epochs resumes training)
    finished: bool = False


def save_fit_state(path: str, *, weights, epoch: int, batch: int,
                   rng_state: Dict[str, Any], test_losses_nf, opt_kind: str,
                   opt_leaves, bcast_version: int = 0, fit_tokens=(),
                   finished: bool = False) -> None:
    """Write a fit-state snapshot atomically, with the JAX package's keys
    and dtypes."""
    with span("ckpt.save"):
        state: Dict[str, Any] = {
            "weights": _host(weights).astype(np.float32),
            "epoch": np.int64(epoch),
            "batch": np.int64(batch),
            "rng_state": np.frombuffer(json.dumps(rng_state).encode(), dtype=np.uint8),
            "opt_kind": np.frombuffer(opt_kind.encode(), dtype=np.uint8),
            "bcast_version": np.int64(bcast_version),
            "fit_tokens": np.asarray(list(fit_tokens), dtype=np.int64),
            "finished": np.int64(1 if finished else 0),
        }
        if test_losses_nf:
            state["test_losses_nf"] = np.asarray(test_losses_nf, np.float32)
        for i, leaf in enumerate(opt_leaves):
            state[f"opt_{i}"] = _host(leaf)
        atomic_write(path, lambda f: np.savez(f, **state))


def restore_fit_state(path: Optional[str], opt_kind: str,
                      expected_leaves) -> Optional[FitState]:
    """The fit-state snapshot at `path`, its optimizer checked as
    `decode_sync_fit_state` checks it; None when there is none."""
    if not path or not os.path.exists(path):
        return None
    with span("ckpt.restore"):
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files}
    test_nf, opt_leaves = decode_sync_fit_state(state, opt_kind, expected_leaves)
    return FitState(
        epoch=int(state["epoch"]),
        batch=int(state["batch"]),
        weights=np.asarray(state["weights"], np.float32),
        rng_state=json.loads(bytes(np.asarray(state["rng_state"], np.uint8)).decode()),
        test_losses_nf=test_nf,
        opt_leaves=opt_leaves,
        bcast_version=int(state.get("bcast_version", 0)),
        fit_tokens=[int(t) for t in state.get("fit_tokens", [])],
        finished=bool(int(state.get("finished", 0))),
    )
