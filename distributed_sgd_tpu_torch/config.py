"""Typed configuration with ``DSGD_*`` environment overrides.

The fields of the JAX package's Config (distributed_sgd_tpu/config.py)
that the port's in-process engines read, under the same ``DSGD_*`` names
and with the same defaults: the sync trainer, and with ``use_async`` the
Hogwild gossip (``async_mode='gossip'``) or local SGD
(``async_mode='local_sgd'``).  ``engine`` must be 'mesh'.  ``optimizer``
('sgd', 'momentum' or 'adam') and ``momentum`` are handed to every engine,
``checkpoint_dir`` (with ``checkpoint_every``) to every engine and
``profile_dir`` to the sync trainer.  Settings that change what the JAX
CLI does but are not ported (the dp x tp engine, gossip compression) are
read and refused here, before any data is loaded.
``DSGD_KERNEL`` is not read: in the JAX package it picks among XLA
formulations of the same function, so ignoring it changes no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

from distributed_sgd_tpu_torch.parallel.topology import parse_topology


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
    # async (use_async): the loss checker, the local SGD period, the gossip
    check_every: int = 100
    leaky_loss: float = 0.9
    async_mode: str = "gossip"  # gossip | local_sgd
    sync_period: int = 16  # local-SGD averaging period (steps)
    steps_per_dispatch: int = 1  # gossip: k local steps per dispatch
    gossip_topology: str = "all"  # all | ring | random:k
    checkpoint_dir: Optional[str] = None  # snapshots: checkpoint.Checkpointer
    checkpoint_every: int = 1  # sync: epochs between snapshots
    profile_dir: Optional[str] = None  # sync: the trace of one epoch
    # read so that none is ignored without a word; each raises when set
    compress: str = "none"  # none | topk | qint8
    feature_shards: int = 1

    def __post_init__(self):
        if self.engine != "mesh":
            raise ValueError(
                f"DSGD_ENGINE={self.engine!r}: the port runs the in-process "
                f"engines only ('mesh'); the rpc topology is not ported yet")
        if self.async_mode not in ("gossip", "local_sgd"):
            raise ValueError(
                f"config field async_mode={self.async_mode!r} must be 'gossip' or 'local_sgd'")
        if self.model not in ("hinge", "svm", "logistic", "least_squares"):
            raise ValueError(f"config field model={self.model!r} is not a known model")
        if self.compress not in ("none", "topk", "qint8"):
            raise ValueError(
                f"config field compress={self.compress!r} must be 'none', 'topk' or 'qint8'")
        if self.compress != "none":
            raise NotImplementedError(
                f"DSGD_COMPRESS={self.compress}: gossip compression is not ported yet "
                f"(ROADMAP.md Queue A 13: compress/)")
        if self.feature_shards < 1:
            raise ValueError("feature_shards must be >= 1")
        if self.feature_shards > 1:
            raise NotImplementedError(
                f"DSGD_FEATURE_SHARDS={self.feature_shards}: the dp x tp engine is not "
                f"ported yet (ROADMAP.md Queue A 11: parallel/feature_sharded.py)")
        parse_topology(self.gossip_topology)
        for name in ("checkpoint_every", "steps_per_dispatch", "sync_period"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if not 0.0 <= self.leaky_loss <= 1.0:
            raise ValueError("leaky_loss must be between 0 and 1")
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
            check_every=_env("DSGD_CHECK_EVERY", cls.check_every, int),
            leaky_loss=_env("DSGD_LEAKY_LOSS", cls.leaky_loss, float),
            async_mode=_env("DSGD_ASYNC_MODE", cls.async_mode, str),
            sync_period=_env("DSGD_SYNC_PERIOD", cls.sync_period, int),
            steps_per_dispatch=_env("DSGD_STEPS_PER_DISPATCH", cls.steps_per_dispatch, int),
            gossip_topology=_env("DSGD_GOSSIP_TOPOLOGY", cls.gossip_topology, str),
            compress=_env("DSGD_COMPRESS", cls.compress, str),
            checkpoint_dir=_env("DSGD_CHECKPOINT_DIR", None, str),
            checkpoint_every=_env("DSGD_CHECKPOINT_EVERY", cls.checkpoint_every, int),
            profile_dir=_env("DSGD_PROFILE_DIR", None, str),
            feature_shards=_env("DSGD_FEATURE_SHARDS", cls.feature_shards, int),
        )
        return dataclasses.replace(cfg, **overrides)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)
