"""Typed configuration with ``DSGD_*`` environment overrides.

The fields of the JAX package's Config (distributed_sgd_tpu/config.py)
that the port's sync path reads, under the same ``DSGD_*`` names and with
the same defaults.  The port runs the in-process sync engine only:
``engine`` must be 'mesh' and ``use_async`` false.  ``optimizer`` is read
and handed to the trainer, which refuses 'momentum' and 'adam' until they
are ported.  ``DSGD_KERNEL`` is not read: in the JAX package it picks
among XLA formulations of the same function, so ignoring it changes no
result.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional


def _env(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


@dataclass
class Config:
    batch_size: int = 100
    learning_rate: float = 0.5
    lam: float = 1e-5  # `lambda` in the reference; keyword in Python
    node_count: int = 3
    full: bool = False
    use_async: bool = False  # `async` in the reference; keyword in Python
    data_path: str = "data"
    max_epochs: int = 10
    conv_delta: float = 0.01
    patience: int = 5
    model: str = "hinge"  # hinge | svm | logistic | least_squares
    seed: int = 0
    pad_width: Optional[int] = None  # sparse-batch nnz padding (None = auto)
    virtual_workers: int = 1  # reference workers emulated per card
    exact_topology: bool = False  # insist on exactly node_count workers
    engine: str = "mesh"
    optimizer: str = "sgd"  # sgd (reference) | momentum | adam
    momentum: float = 0.9  # used by optimizer='momentum'

    def __post_init__(self):
        if self.engine != "mesh":
            raise ValueError(
                f"DSGD_ENGINE={self.engine!r}: the port runs the in-process "
                f"sync engine only ('mesh'); the rpc topology is not ported yet")
        if self.use_async:
            raise ValueError(
                "DSGD_ASYNC=1: the port runs the sync engine only; the async "
                "engines are not ported yet")
        if self.model not in ("hinge", "svm", "logistic", "least_squares"):
            raise ValueError(f"config field model={self.model!r} is not a known model")
        if self.optimizer not in ("sgd", "momentum", "adam"):
            raise ValueError(
                f"config field optimizer={self.optimizer!r} must be 'sgd', "
                f"'momentum' or 'adam'")
        if self.virtual_workers < 1:
            raise ValueError("virtual_workers must be >= 1")
        if self.seed < 0:
            raise ValueError("seed must be >= 0")

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build from DSGD_* env vars."""
        cfg = cls(
            batch_size=_env("DSGD_BATCH_SIZE", cls.batch_size, int),
            learning_rate=_env("DSGD_LEARNING_RATE", cls.learning_rate, float),
            lam=_env("DSGD_LAMBDA", cls.lam, float),
            node_count=_env("DSGD_NODE_COUNT", cls.node_count, int),
            full=_env("DSGD_FULL", cls.full, bool),
            use_async=_env("DSGD_ASYNC", cls.use_async, bool),
            data_path=_env("DSGD_DATA_PATH", cls.data_path, str),
            max_epochs=_env("DSGD_MAX_EPOCHS", cls.max_epochs, int),
            conv_delta=_env("DSGD_CONV_DELTA", cls.conv_delta, float),
            patience=_env("DSGD_PATIENCE", cls.patience, int),
            model=_env("DSGD_MODEL", cls.model, str),
            seed=_env("DSGD_SEED", cls.seed, int),
            pad_width=_env("DSGD_PAD_WIDTH", None, int),
            virtual_workers=_env("DSGD_VIRTUAL_WORKERS", cls.virtual_workers, int),
            exact_topology=_env("DSGD_EXACT_TOPOLOGY", cls.exact_topology, bool),
            engine=_env("DSGD_ENGINE", cls.engine, str),
            optimizer=_env("DSGD_OPTIMIZER", cls.optimizer, str),
            momentum=_env("DSGD_MOMENTUM", cls.momentum, float),
        )
        return dataclasses.replace(cfg, **overrides)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)
