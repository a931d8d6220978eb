"""Crash-safe small-file writes.

The port's own copy of the JAX package's utils/fsio.py: one copy of the
pid-unique temporary file + ``os.replace`` idiom, which the checkpointer
(checkpoint.py), every JSON sidecar and the two library builds
(ops/_build.py, data/_native) use.  A reader sees
the old complete file or the new complete file, never a torn one;
concurrent writers each install a complete file, and the last one wins.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Callable, IO, Iterator


@contextlib.contextmanager
def replacing(path) -> Iterator[str]:
    """A pid-unique temporary path beside `path` for a writer or a
    compiler to fill; on a clean exit it replaces `path` atomically (a
    reader never sees half a file), and on any exit no temporary file is
    left."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        yield tmp
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def atomic_write(path: str, write: Callable[[IO[bytes]], None]) -> None:
    """Install the bytes `write(f)` puts into a binary file at `path`
    atomically: a pid-unique temporary file beside it, fsync, then
    os.replace.  Raises on I/O failure and leaves no temporary file."""
    with replacing(path) as tmp, open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def atomic_write_json(path: str, obj) -> None:
    """Serialize `obj` to `path` atomically, as the JAX package's
    ``atomic_write_json`` (indent 1, sorted keys, a final newline)."""
    text = json.dumps(obj, indent=1, sort_keys=True) + "\n"
    atomic_write(path, lambda f: f.write(text.encode()))
