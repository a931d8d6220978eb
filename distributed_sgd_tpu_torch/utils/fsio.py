"""Crash-safe small-file writes.

The port's own copy of the JAX package's utils/fsio.py: one copy of the
pid-unique temporary file + fsync + ``os.replace`` idiom, which the
checkpointer (checkpoint.py) and every JSON sidecar use.  A reader sees
the old complete file or the new complete file, never a torn one;
concurrent writers each install a complete file, and the last one wins.
"""

from __future__ import annotations

import json
import os
from typing import Callable, IO


def atomic_write(path: str, write: Callable[[IO[bytes]], None]) -> None:
    """Install the bytes `write(f)` puts into a binary file at `path`
    atomically: a pid-unique temporary file beside it, fsync, then
    os.replace.  Raises on I/O failure and leaves no temporary file."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def atomic_write_json(path: str, obj) -> None:
    """Serialize `obj` to `path` atomically, as the JAX package's
    ``atomic_write_json`` (indent 1, sorted keys, a final newline)."""
    text = json.dumps(obj, indent=1, sort_keys=True) + "\n"
    atomic_write(path, lambda f: f.write(text.encode()))
