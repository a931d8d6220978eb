"""Logging setup: the reference's logback pattern (ISO timestamps to
stdout), and its node tags (``mastr-<host:port>``, ``slave-<host:port>``,
core/package.scala:23-27), as in the JAX package's utils/log.py."""

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



def pretty(host: str, port: int, master: bool) -> str:
    """Node log tag, core/package.scala:23-27."""
    kind = "mastr" if master else "slave"
    return f"{kind}-{host}:{port}"


def node_logger(host: str, port: int, master: bool) -> logging.Logger:
    return logging.getLogger(pretty(host, port, master))
