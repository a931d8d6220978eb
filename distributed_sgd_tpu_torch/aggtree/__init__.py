"""The aggregation tree (DSGD_AGG_TREE): the port of the JAX package's
aggtree/.

Workers elected as reduce nodes add their subtree's gradient replies
onto their own before ONE upstream send, so the master takes O(fanout)
replies a round instead of O(N).  Two modules, with the JAX names and
wire behaviour, so that JAX and port nodes mix in either direction:

- ``plan``: the deterministic tree builder, a pure function of the
  registration-ordered membership, the fanout and the seed (the JAX
  ``TreePlan.digest`` of the same membership is the port's).  The master
  rebuilds it on any membership change;
- ``reduce``: the worker's reduce-node role: buffered child pushes
  (``AggregateGrad``), the canonical-order f32 add chain on the worker's
  device, and the upstream push with a flat (direct-to-master) fallback.

Default off: with the knob unset no plan is built, no ``Reducer`` made,
no tree instrument registered, and the wire is the flat fit's.
"""

from distributed_sgd_tpu_torch.aggtree.plan import (  # noqa: F401
    TreePlan,
    build_plan,
    parse_agg_tree,
)
