"""Live canary-probe sourcing.

The port's copy of the JAX package's autopilot/probe_source.py (its
docs/CONTINUAL.md): the same admissions for the same seed and traffic,
and the same sidecar state, so a router of either package restores the
other's reservoir.

The router's canary gate is only as honest as its probe set, and an
operator-rotated ``.npz`` (the DSGD_SERVE_PROBE_REFRESH_S cadence) goes stale the moment the
traffic drifts.  :class:`ProbeReservoir` replaces the file: the router
feeds every live ``Predict`` request through :meth:`observe`, and the
reservoir keeps a BOUNDED sample of the traffic — classic Algorithm R
(uniform over history, or uniform over a trailing ``recency`` horizon
so the sample tracks a drifting stream), with every replace decision
drawn from a
COUNTER-DERIVED RNG (``default_rng((seed, t))``), so the sample is a
pure function of (seed, arrival order).  A router restart that restores
the counters from the ``DSGD_SERVE_STATE`` sidecar resumes the exact
sampling sequence — no RNG state blob to persist, no post-restart
divergence (asserted in tests/test_probe_source.py).

Ground truth is NOT on the Predict wire (``PredictRequest`` carries
features only), and in production it would not exist yet at request
time.  The label-delay model makes that explicit: an observed row sits
in a pending lane for ``label_delay`` further requests — the stand-in
for the hours a click/log join takes — and only then is the ``labeler``
(the ground-truth join: a stream oracle in the benches, a feedback log
in production) asked for its label.  Rows whose truth never arrives
(labeler returns None) are dropped, never guessed.  Consequence worth
stating: the probe set always trails live traffic by the label delay,
so a drift detector reading probe loss fires at least that late — the
caveat documented in docs/CONTINUAL.md.

``rows()`` emits the router's probe-row format (``(indices, values,
label)`` triples), so a reservoir snapshot drops straight into the
existing ``ServingRouter.refresh_probe`` -> ``LossChecker.refresh``
re-anchor path: rejected versions stay rejected, the baseline re-anchors
on the sampled set.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, List, Optional, Tuple

import numpy as np

# a row as the router's probe path consumes it
ProbeRow = Tuple[np.ndarray, np.ndarray, float]
Labeler = Callable[[np.ndarray, np.ndarray], Optional[float]]


class ProbeReservoir:
    def __init__(
        self,
        labeler: Labeler,
        capacity: int = 64,
        seed: int = 0,
        label_delay: int = 0,
        min_fill: Optional[int] = None,
        recency: Optional[int] = None,
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if label_delay < 0:
            raise ValueError("label_delay must be >= 0")
        if recency is not None and recency < capacity:
            raise ValueError("recency must be >= capacity")
        self.labeler = labeler
        self.capacity = int(capacity)
        self.seed = int(seed)
        self.label_delay = int(label_delay)
        self.recency = None if recency is None else int(recency)
        self.min_fill = int(min_fill) if min_fill is not None else int(capacity)
        if not 1 <= self.min_fill <= self.capacity:
            raise ValueError("min_fill must be in [1, capacity]")
        self._lock = threading.Lock()
        self._rows: List[ProbeRow] = []
        # rows awaiting ground truth: (arrival ordinal, indices, values);
        # bounded by construction — every observe drains all aged entries,
        # so at most label_delay + 1 are ever pending
        self._pending: deque = deque()
        self._seen = 0     # requests observed (pending-lane clock)
        self._labeled = 0  # labeled rows admitted to the Algorithm-R draw

    # -- the hot path -------------------------------------------------------

    def observe(self, indices: np.ndarray, values: np.ndarray) -> None:
        """Feed one live request.  Called from the router's Predict
        handler (concurrent); one short critical section, no labeler
        call unless a pending row just aged past the label delay."""
        idx = np.asarray(indices, dtype=np.int32).copy()
        val = np.asarray(values, dtype=np.float32).copy()
        with self._lock:
            self._seen += 1
            self._pending.append((self._seen, idx, val))
            aged = []
            while self._pending and self._pending[0][0] <= self._seen - self.label_delay:
                aged.append(self._pending.popleft())
        for _, a_idx, a_val in aged:
            y = self.labeler(a_idx, a_val)
            if y is None:
                continue  # truth never arrived: drop, never guess
            self._admit(a_idx, a_val, float(y))

    def _admit(self, idx: np.ndarray, val: np.ndarray, y: float) -> None:
        with self._lock:
            self._labeled += 1
            t = self._labeled
            if len(self._rows) < self.capacity:
                self._rows.append((idx, val, y))
                return
            # Algorithm R, decision t: keep with probability capacity/t —
            # or capacity/recency once t passes the recency horizon, the
            # biased-reservoir variant that lets old rows decay
            # geometrically so the sample TRACKS the traffic instead of
            # averaging over all history (a uniform-over-history sample
            # would dilute a distribution shift forever).  Counter-derived
            # draw — a function of (seed, t) alone — so a restart that
            # restores `labeled` resumes the same sequence.
            horizon = t if self.recency is None else min(t, self.recency)
            j = int(np.random.default_rng((self.seed, t)).integers(0, horizon))
            if j < self.capacity:
                self._rows[j] = (idx, val, y)

    # -- the probe-refresh side --------------------------------------------

    def ready(self) -> bool:
        with self._lock:
            return len(self._rows) >= self.min_fill

    @property
    def fill(self) -> int:
        with self._lock:
            return len(self._rows)

    @property
    def seen(self) -> int:
        with self._lock:
            return self._seen

    def rows(self) -> List[ProbeRow]:
        """Snapshot of the sampled probe set, router probe-row format."""
        with self._lock:
            return list(self._rows)

    # -- DSGD_SERVE_STATE persistence --------------------------------------

    def state_dict(self) -> dict:
        """JSON-serializable state for the router's sidecar: counters +
        rows + pending lane.  Bounded by construction (capacity +
        label_delay rows), so the sidecar stays small."""
        with self._lock:
            return {
                "seen": self._seen,
                "labeled": self._labeled,
                "rows": [[r[0].tolist(), r[1].tolist(), r[2]]
                         for r in self._rows],
                "pending": [[t, i.tolist(), v.tolist()]
                            for t, i, v in self._pending],
            }

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._seen = int(state["seen"])
            self._labeled = int(state["labeled"])
            self._rows = [
                (np.asarray(i, np.int32), np.asarray(v, np.float32), float(y))
                for i, v, y in state["rows"]]
            self._pending = deque(
                (int(t), np.asarray(i, np.int32), np.asarray(v, np.float32))
                for t, i, v in state["pending"])
