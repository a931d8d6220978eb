"""Logging setup: the reference's logback pattern (ISO timestamps to
stdout), as in the JAX package's utils/log.py."""

from __future__ import annotations

import logging
import sys


def setup(level: int = logging.INFO) -> None:
    root = logging.getLogger()
    if root.handlers:  # idempotent
        return
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(
        logging.Formatter(
            fmt="%(asctime)s.%(msecs)03d [%(threadName)s] %(levelname)-5s %(name)s - %(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S",
        )
    )
    root.addHandler(handler)
    root.setLevel(level)

