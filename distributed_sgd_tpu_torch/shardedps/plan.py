"""Feature-range shard plan of the sharded master plane; the port's copy
of the JAX package's shardedps/plan.py.

``build_shard_plan`` is a PURE function of (dim, shards): the weight
vector's coordinates are carved into `shards` contiguous near-even
[lo, hi) ranges by the reduce tree's carve rule (sizes differ by at most
one, larger ranges first), so every process, JAX or port, computes the
same ranges and ``ShardPlan.digest``.  A slice of a dense f32 vector is a
memcpy, and a WeightDelta in shard frame is the master's delta restricted
to [lo, hi) and shifted.
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Optional, Tuple

from distributed_sgd_tpu_torch.aggtree.plan import _chunks


def parse_master_shards(value: Optional[object]) -> int:
    """DSGD_MASTER_SHARDS -> shard count (0 = off): None, "" or 0, or an
    integer M >= 1 (M=1 runs the whole sharded wire with one lane)."""
    if value is None or value == "":
        return 0
    try:
        shards = int(value)
    except (TypeError, ValueError):
        raise ValueError(f"DSGD_MASTER_SHARDS must be an integer >= 0, got {value!r}")
    if shards < 0:
        raise ValueError(f"DSGD_MASTER_SHARDS must be >= 0 (0 = off), got {shards}")
    return shards


class ShardPlan:
    """One immutable range partition of a `dim`-long weight vector:
    ``ranges[i]`` is shard i's [lo, hi), ascending, disjoint, covering
    [0, dim).  More shards than coordinates clamps to one a coordinate."""

    def __init__(self, dim: int, shards: int):
        dim = int(dim)
        shards = int(shards)
        if dim < 1:
            raise ValueError(f"shard plan needs dim >= 1, got {dim}")
        if shards < 1:
            raise ValueError(f"shard plan needs shards >= 1, got {shards}")
        self.dim = dim
        self.shards = min(shards, dim)
        self.ranges: Tuple[Tuple[int, int], ...] = tuple(_chunks(dim, self.shards))

    def range_of(self, index: int) -> Tuple[int, int]:
        return self.ranges[index]

    def digest(self) -> str:
        """sha256 over the canonical (dim, ranges) JSON, the JAX plan's
        exactly."""
        blob = json.dumps({"dim": self.dim, "ranges": [list(r) for r in self.ranges]},
                          separators=(",", ":"), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()

    def __repr__(self):
        sizes = [hi - lo for lo, hi in self.ranges]
        return (f"ShardPlan(dim={self.dim}, shards={self.shards}, "
                f"range_sizes={min(sizes)}..{max(sizes)})")


def build_shard_plan(dim: int, shards: int) -> ShardPlan:
    """(model dimension, shard count) -> range partition.  No RNG, clock
    or membership."""
    return ShardPlan(dim, shards)


def slice_ranges(plan: ShardPlan) -> List[Tuple[int, int, int]]:
    """[(index, lo, hi)] of each shard."""
    return [(i, lo, hi) for i, (lo, hi) in enumerate(plan.ranges)]
