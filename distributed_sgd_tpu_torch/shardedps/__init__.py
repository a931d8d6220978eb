"""The sharded master plane (DSGD_MASTER_SHARDS): the port of the JAX
package's shardedps/.

The weight vector is range-partitioned across M master shard lanes, so a
round's broadcast and fan-in bytes scale as dim/M a lane:

- ``plan``: the pure (dim, M) -> contiguous range partition, its digest
  the JAX plan's;
- ``coordinator``: the master's lanes, each with its own versioned
  broadcast state, byte ledger and (with DSGD_AGG_TREE) shard-colored
  reduce tree, and the flat single-master round and plan rebuild that a
  lost shard costs;
- ``assemble``: the worker's rendezvous: M range-tagged requests assemble
  one weight vector on the host, the gradient is computed ONCE, and each
  lane's reply carries its slice.

Default off: with the knob unset no plan, lane or assembler is built, no
shard instrument registered, and the wire is the flat fit's.
"""

from distributed_sgd_tpu_torch.shardedps.plan import (  # noqa: F401
    ShardPlan,
    build_shard_plan,
    parse_master_shards,
)
