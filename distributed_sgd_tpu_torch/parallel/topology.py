"""Sparse gossip topologies for the Hogwild delta gossip
(DSGD_GOSSIP_TOPOLOGY).

The port's own copy of the JAX package's parallel/topology.py.  The
reference gossips all to all (Slave.scala:103-105).  Per dispatch, this
picks which peers receive a worker's summed delta:

- ``all``       (default) every peer, in canonical sorted order;
- ``ring``      the worker's successor on the ring of sorted member ids;
- ``random:k``  k peers drawn without replacement from a deterministic
                per-(round, worker) random stream.

Selection is a pure function of (mode, sorted peer ids, self id, round,
seed).  A peer for which ``suppressed`` is true (an open circuit breaker
on a wire) is walked past, and the substitution is counted.  The
coordinator is not part of the selection: it receives every delta.
"""

from __future__ import annotations

import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

def parse_topology(spec: str) -> Tuple[str, int]:
    """'all' | 'ring' | 'random:k' -> (mode, k).  Raises ValueError on a
    typo, so the configuration fails when it is built."""
    spec = (spec or "all").strip().lower()
    if spec in ("all", "ring"):
        return spec, 0
    mode, _, karg = spec.partition(":")
    if mode == "random":
        try:
            k = int(karg)
        except ValueError:
            raise ValueError(
                f"DSGD_GOSSIP_TOPOLOGY={spec!r}: random needs an integer "
                f"fan-out, e.g. random:2") from None
        if k < 1:
            raise ValueError(
                f"DSGD_GOSSIP_TOPOLOGY={spec!r}: random fan-out must be >= 1")
        return "random", k
    raise ValueError(
        f"DSGD_GOSSIP_TOPOLOGY={spec!r} must be all | ring | random:k")


def node_id(key) -> int:
    """Stable integer identity of an endpoint key: integers (worker ids)
    pass through, (host, port) tuples and strings go through crc32."""
    if isinstance(key, int):
        return key
    if isinstance(key, tuple):
        key = f"{key[0]}:{key[1]}"
    return zlib.crc32(str(key).encode())


def select_gossip_peers(
    mode: str,
    k: int,
    peers: Sequence,
    self_key,
    round_idx: int,
    seed: int = 0,
    suppressed: Optional[Callable[[object], bool]] = None,
) -> Tuple[List, int]:
    """This dispatch's gossip destinations from `peers`.

    Returns (selected, reselects): `selected` in the canonical sorted
    order, `reselects` the edges re-routed past a suppressed peer.  With
    ``mode='all'`` the sorted peer list comes back and `suppressed` is
    never consulted.
    """
    ordered = sorted(peers, key=lambda p: (node_id(p), str(p)))
    if mode == "all" or not ordered:
        return list(ordered), 0
    if mode == "ring":
        # successor on the ring of (peers + self) sorted by id
        ring = sorted(ordered + [self_key], key=lambda p: (node_id(p), str(p)))
        start = ring.index(self_key)
        candidates = [ring[(start + i) % len(ring)] for i in range(1, len(ring))]
        candidates = [c for c in candidates if c != self_key]
    elif mode == "random":
        rng = np.random.default_rng(
            (int(seed) & 0xFFFFFFFF, int(round_idx) & 0xFFFFFFFFFFFF,
             node_id(self_key)))
        candidates = [ordered[i] for i in rng.permutation(len(ordered))]
    else:
        raise ValueError(f"unknown gossip topology mode {mode!r}")
    want = 1 if mode == "ring" else min(k, len(candidates))
    selected: List = []
    reselects = 0
    for cand in candidates:
        if len(selected) >= want:
            break
        if suppressed is not None and suppressed(cand):
            reselects += 1
            continue
        selected.append(cand)
    # every candidate suppressed: keep the head of the candidate order, so
    # the suppressed send is still made and counted rather than lost
    if not selected and candidates:
        selected = candidates[:want]
        reselects = 0
    order = {node_id(p): i for i, p in enumerate(ordered)}
    selected.sort(key=lambda p: (order.get(node_id(p), len(order)), str(p)))
    return selected, reselects
