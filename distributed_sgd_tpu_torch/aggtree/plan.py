"""Deterministic reduce-tree builder; the port's copy of the JAX package's
aggtree/plan.py.

``build_plan`` is a PURE function of (registration-ordered membership,
fanout, seed): every process that sees the same member list computes the
same tree, and ``TreePlan.digest`` is byte-identical to the JAX plan's, so
a JAX master and a port master stamp the same roles on the same workers.

Shape: the master is the root.  The member list is grouped by host in
first-appearance order (a host's workers reduce their own rows before the
sum crosses hosts), each group rotated by the seed so that election does
not always tax the first-registered worker, and the concatenated order is
carved into contiguous chunks: the first element of each chunk is the
aggregator of the rest, recursively, giving O(log_F N) depth with at most
F children a node.  N <= F is the flat topology: no worker has children,
and the master stamps nothing.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

Key = Tuple[str, int]


def parse_agg_tree(spec: Optional[str]) -> int:
    """DSGD_AGG_TREE -> fanout (0 = off): None/"" or "fanout:F", F >= 2."""
    if not spec:
        return 0
    parts = str(spec).split(":")
    if len(parts) != 2 or parts[0] != "fanout":
        raise ValueError(f"DSGD_AGG_TREE must be 'fanout:F' (F >= 2), got {spec!r}")
    try:
        fanout = int(parts[1])
    except ValueError:
        raise ValueError(f"DSGD_AGG_TREE fanout must be an integer, got {parts[1]!r}")
    if fanout < 2:
        raise ValueError(f"DSGD_AGG_TREE fanout must be >= 2, got {fanout}")
    return fanout


class TreePlan:
    """One immutable reduce tree over a membership snapshot.

    ``parent[k]`` is None for root children (they reply their subtree sum
    to the master); ``children[k]`` is the CANONICAL add order of k's
    reduce (f32 addition is order-sensitive: two fits over one plan chain
    the same order and land on the same bits).  ``height[k]`` is the edge
    count to k's deepest leaf (0 = leaf); the master scales each node's
    child-wait budget by it."""

    def __init__(self, fanout: int, keys: Sequence[Key],
                 parent: Dict[Key, Optional[Key]],
                 children: Dict[Key, Tuple[Key, ...]]):
        self.fanout = int(fanout)
        self.keys = tuple(keys)
        self.parent = dict(parent)
        self.children = dict(children)
        self.root_children = tuple(k for k in self.keys if self.parent[k] is None)
        self.height: Dict[Key, int] = {}
        for k in reversed(self.keys):  # children always come later in the order
            kids = self.children.get(k, ())
            self.height[k] = 1 + max(self.height[c] for c in kids) if kids else 0
        # master -> root child is one edge (the flat topology has depth 1)
        self.depth = 1 + max((self.height[k] for k in self.root_children), default=0)
        self.n_edges = sum(len(c) for c in self.children.values())

    @property
    def trivial(self) -> bool:
        """No elected aggregators: the plan is the flat topology."""
        return self.n_edges == 0

    def aggregators(self) -> List[Key]:
        return [k for k in self.keys if self.children.get(k)]

    def digest(self) -> str:
        """sha256 over the canonical (fanout, edge list) JSON, the JAX
        plan's exactly."""
        edges = [[f"{k[0]}:{k[1]}",
                  "master" if self.parent[k] is None
                  else f"{self.parent[k][0]}:{self.parent[k][1]}"]
                 for k in self.keys]
        blob = json.dumps({"fanout": self.fanout, "edges": edges},
                          separators=(",", ":"), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def __repr__(self):
        return (f"TreePlan(fanout={self.fanout}, n={len(self.keys)}, depth={self.depth}, "
                f"edges={self.n_edges}, aggregators={len(self.aggregators())})")


def _chunks(n: int, k: int) -> List[Tuple[int, int]]:
    """[lo, hi) bounds of min(k, n) near-even contiguous chunks of
    range(n), larger chunks first (core/split.py's carve rule)."""
    k = max(1, min(k, n))
    base, rem = divmod(n, k)
    out, lo = [], 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def build_plan(keys: Sequence[Key], fanout: int, seed: int = 0,
               hosts: Optional[Dict[Key, str]] = None) -> TreePlan:
    """Membership snapshot -> reduce tree.  `keys` is the registration-
    ordered member list; `hosts` optionally overrides each key's locality
    label (default key[0]).  No RNG and no clock: the seed enters only as
    a rotation of each host group."""
    fanout = int(fanout)
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    keys = list(keys)
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate member keys in tree membership")

    label = hosts or {}
    by_host: Dict[str, List[Key]] = {}
    host_order: List[str] = []
    for k in keys:
        h = label.get(k, k[0])
        if h not in by_host:
            by_host[h] = []
            host_order.append(h)
        by_host[h].append(k)
    ordered: List[Key] = []
    for h in host_order:
        group = by_host[h]
        rot = seed % len(group)
        ordered.extend(group[rot:] + group[:rot])

    parent: Dict[Key, Optional[Key]] = {}
    children: Dict[Key, Tuple[Key, ...]] = {}

    def carve(lo: int, hi: int, up: Optional[Key]) -> None:
        """Split ordered[lo:hi) into <= fanout contiguous chunks; each
        chunk's first element attaches to `up` and aggregates the rest of
        its chunk.  Leaves get no `children` entry."""
        if lo >= hi:
            return
        heads = []
        for clo, chi in _chunks(hi - lo, fanout):
            head = ordered[lo + clo]
            parent[head] = up
            heads.append(head)
            carve(lo + clo + 1, lo + chi, head)
        if up is not None:
            children[up] = tuple(heads)

    if ordered:
        carve(0, len(ordered), None)
    return TreePlan(fanout, ordered, parent, children)
