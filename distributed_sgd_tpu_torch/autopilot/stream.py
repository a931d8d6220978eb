"""Online drifting stream plane.

The port's copy of the JAX package's autopilot/stream.py (its
docs/CONTINUAL.md), in numpy on the port's Dataset and criterion types:
the same seed and row range give byte-equal rows, labels and eval sets.

:class:`DriftingStream` generalizes ``data/synthetic.rcv1_like`` from a
fixed corpus into an unbounded, seeded stream whose ROW AXIS IS THE TIME
AXIS: row ``r`` is drawn from the distribution at stream-time ``r``, and
the planted separator drifts along it under a named shift schedule —

- ``step``:      w jumps from w0 toward w1 at ``shift_at`` (concept
                 shift, the flywheel bench's injected fault);
- ``ramp``:      w slides linearly over ``ramp_rows`` starting at
                 ``shift_at`` (slow drift — the regime where a
                 persistence window matters);
- ``recurring``: w alternates every ``period_rows`` (seasonality — a
                 promoted model goes stale on a clock).

Rows are generated in fixed ``BLOCK``-row chunks, each from its own
counter-derived RNG (``default_rng((seed, block))`` — the master's
``(seed, epoch)`` idiom), so any row range is RANDOM-ACCESS
deterministic: two readers at different cursors, or a reader restarted
mid-stream, see byte-identical rows.  Feature statistics (Zipf
popularity, frozen IDF weights) are stationary; only the labeling
concept moves.  That separation is deliberate — the canary probe loss
measures the CONCEPT gap, not a vocabulary artifact.

Training consumes the stream as a sliding window instead of a fixed
epoch partition: :func:`window_split` restricts the existing
``SplitFn`` contract to ``[lo, hi)``, so a warm-start retrain is just
``fit_sync(split=window_split(...), initial_weights=...)`` over the rows
the current distribution produced.  Continual eval rides the existing
early-stopping machinery: :func:`continual_criterion` truncates the
newest-first loss history to an eval horizon so "converged" is judged
against the CURRENT distribution, and ``DriftingStream.eval_set`` draws
a held-out set (a disjoint block lane) pinned to the distribution at a
chosen stream-time for ``master.test`` re-anchoring.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.data.rcv1 import Dataset

SCHEDULES = ("step", "ramp", "recurring")

BLOCK = 256  # row-generation granularity: the random-access unit
# eval sets draw from a disjoint block lane so held-out rows can never
# collide with training rows at any cursor
_EVAL_LANE = 1 << 30


class DriftingStream:
    def __init__(
        self,
        n_features: int = 16384,
        nnz: int = 8,
        noise: float = 0.05,
        seed: int = 0,
        schedule: str = "step",
        shift_at: int = 4096,
        shift_magnitude: float = 1.0,
        ramp_rows: int = 4096,
        period_rows: int = 8192,
        idf_rows: int = 2048,
    ):
        if schedule not in SCHEDULES:
            raise ValueError(
                f"shift schedule {schedule!r} must be one of {SCHEDULES}")
        if not 0.0 <= shift_magnitude <= 1.0:
            raise ValueError("shift_magnitude must be in [0, 1]")
        if ramp_rows < 1 or period_rows < 1:
            raise ValueError("ramp_rows and period_rows must be >= 1")
        self.n_features = int(n_features)
        self.nnz = int(nnz)
        self.noise = float(noise)
        self.seed = int(seed)
        self.schedule = schedule
        self.shift_at = int(shift_at)
        self.shift_magnitude = float(shift_magnitude)
        self.ramp_rows = int(ramp_rows)
        self.period_rows = int(period_rows)
        self.cursor = 0

        # stationary feature statistics: Zipf popularity like term
        # frequencies (matches rcv1_like) and IDF weights frozen from a
        # one-time reference draw, so value magnitudes cannot drift and
        # masquerade as concept shift
        pop = 1.0 / np.arange(1, self.n_features + 1, dtype=np.float64)
        self._pop = pop / pop.sum()
        rng = np.random.default_rng((self.seed, _EVAL_LANE - 1))
        ref = rng.choice(self.n_features, size=(int(idf_rows), self.nnz),
                         p=self._pop).astype(np.int32)
        ref.sort(axis=1)
        dup = np.zeros_like(ref, dtype=bool)
        dup[:, 1:] = ref[:, 1:] == ref[:, :-1]
        df = np.bincount(ref[~dup], minlength=self.n_features)
        self._idf = np.log(
            int(idf_rows) / np.maximum(df, 1.0)).astype(np.float32)
        # the two endpoint separators: w0 is the pre-shift concept, the
        # drifted concept is the (magnitude-scaled) blend toward w1
        self._w0 = rng.normal(size=self.n_features).astype(np.float32)
        self._w1 = rng.normal(size=self.n_features).astype(np.float32)

    # -- schedule -----------------------------------------------------------

    def phase(self, row: int) -> float:
        """Shift phase in [0, 1] at stream-time `row` (0 = pre-shift
        concept, 1 = fully shifted)."""
        if self.schedule == "step":
            return 1.0 if row >= self.shift_at else 0.0
        if self.schedule == "ramp":
            return float(np.clip((row - self.shift_at) / self.ramp_rows,
                                 0.0, 1.0))
        return float((row // self.period_rows) % 2)  # recurring

    def separator(self, row: int) -> np.ndarray:
        """The planted separator in force at stream-time `row` (the blend
        whose sign labels that row, before noise)."""
        a = self.phase(row) * self.shift_magnitude
        return ((1.0 - a) * self._w0 + a * self._w1).astype(np.float32)

    # -- generation ---------------------------------------------------------

    def _gen_block(self, block: int, phases: np.ndarray):
        """One BLOCK-row chunk from its counter-derived RNG; `phases` is
        the per-row shift phase (len BLOCK)."""
        rng = np.random.default_rng((self.seed, block))
        idx = rng.choice(self.n_features, size=(BLOCK, self.nnz),
                         p=self._pop).astype(np.int32)
        idx.sort(axis=1)
        val = np.abs(rng.normal(size=(BLOCK, self.nnz))).astype(np.float32)
        dup = np.zeros_like(idx, dtype=bool)
        dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
        val *= self._idf[idx]
        val[dup] = 0.0
        val /= np.maximum(np.linalg.norm(val, axis=1, keepdims=True), 1e-12)
        # blended margin per row: sign is invariant to normalizing the
        # blended separator, so labels are exactly the blend's labels
        m0 = np.einsum("np,np->n", val, self._w0[idx])
        m1 = np.einsum("np,np->n", val, self._w1[idx])
        a = phases.astype(np.float64) * self.shift_magnitude
        margins = (1.0 - a) * m0 + a * m1
        # threshold at 0 (not the batch median): E[margin] = 0 under the
        # symmetric planted draw, and a per-batch median would couple a
        # row's label to which batch read it — breaking random access
        y = np.where(margins > 0.0, 1, -1).astype(np.int32)
        flip = rng.random(BLOCK) < self.noise
        y[flip] = -y[flip]
        return idx, val, y

    def rows(self, start: int, n: int) -> Dataset:
        """Rows [start, start+n) — deterministic regardless of call
        history or chunking."""
        if n <= 0:
            raise ValueError("n must be positive")
        lo_b, hi_b = start // BLOCK, (start + n - 1) // BLOCK + 1
        parts = []
        for b in range(lo_b, hi_b):
            t0 = b * BLOCK
            phases = np.array([self.phase(t0 + i) for i in range(BLOCK)])
            parts.append(self._gen_block(b, phases))
        idx = np.concatenate([p[0] for p in parts])
        val = np.concatenate([p[1] for p in parts])
        y = np.concatenate([p[2] for p in parts])
        off = start - lo_b * BLOCK
        return Dataset(indices=idx[off:off + n], values=val[off:off + n],
                       labels=y[off:off + n], n_features=self.n_features)

    def take(self, n: int) -> Dataset:
        """Next `n` rows at the cursor; advances stream-time."""
        out = self.rows(self.cursor, n)
        self.cursor += n
        return out

    def eval_set(self, n: int, at: Optional[int] = None) -> Dataset:
        """Held-out eval rows pinned to the distribution at stream-time
        `at` (default: the cursor).  Drawn from a disjoint block lane —
        never overlaps training rows — and does not advance the cursor."""
        at = self.cursor if at is None else int(at)
        phase = np.full(BLOCK, self.phase(at))
        n_blocks = (n - 1) // BLOCK + 1
        # lane blocks keyed by (eval draw position, pinned time) so two
        # eval sets at different times share no rows either
        base = _EVAL_LANE + (at // BLOCK) * 4096
        parts = [self._gen_block(base + b, phase) for b in range(n_blocks)]
        idx = np.concatenate([p[0] for p in parts])[:n]
        val = np.concatenate([p[1] for p in parts])[:n]
        y = np.concatenate([p[2] for p in parts])[:n]
        return Dataset(indices=idx, values=val, labels=y,
                       n_features=self.n_features)

    def oracle_labeler(
        self, start: int = 0,
    ) -> Callable[[np.ndarray, np.ndarray], Optional[float]]:
        """The ground-truth join for :class:`~distributed_sgd_tpu_torch.autopilot
        .probe_source.ProbeReservoir`: labels the t-th row it is asked
        about with the sign of the planted separator IN FORCE at
        stream-time ``start + t`` — truth as the world holds it when the
        delayed label finally arrives, which is exactly what a click/log
        join would return.  Noise-free (the join returns truth, not the
        stream's noisy training label), and order-robust: the counter
        only selects the phase, which moves on a thousands-of-rows
        clock, so modest request reordering under concurrent clients
        cannot mislabel."""
        lock = threading.Lock()
        clock = [int(start)]

        def labeler(indices: np.ndarray,
                    values: np.ndarray) -> Optional[float]:
            with lock:
                t = clock[0]
                clock[0] += 1
            w = self.separator(t)
            margin = float(np.dot(np.asarray(values, np.float64),
                                  w[np.asarray(indices, np.int64)]))
            return 1.0 if margin > 0.0 else -1.0

        return labeler


# -- training over a stream window -----------------------------------------


def window_split(lo: int, hi: int):
    """A ``SplitFn`` that trains only rows [lo, hi) of the resident
    corpus: the sliding-window view of an unbounded stream.  The window
    is vanilla-split (contiguous, reference semantics) across workers;
    rows outside it simply never enter a dispatch — the fixed-partition
    contract (ids index the resident corpus) is unchanged, which is what
    lets the incremental re-sharding slide the resident slice along
    with the window."""
    if not 0 <= lo < hi:
        raise ValueError(f"bad stream window [{lo}, {hi})")

    def split(n_samples: int, n_workers: int) -> List[np.ndarray]:
        from distributed_sgd_tpu_torch.core.split import vanilla_split

        hi_eff = min(hi, n_samples)
        if hi_eff <= lo:
            raise ValueError(
                f"stream window [{lo}, {hi}) is past the resident corpus "
                f"({n_samples} rows)")
        return [p + lo for p in vanilla_split(hi_eff - lo, n_workers)]

    return split


def continual_criterion(inner: Criterion, horizon: int) -> Criterion:
    """Early stopping judged on the CURRENT distribution only: truncate
    the newest-first loss history to the last `horizon` evals before
    applying `inner` (core/early_stopping.py).  Without this, a
    no-improvement scan keeps comparing against minima earned on a
    distribution that no longer exists — a retrain after a shift would
    stop instantly because the pre-shift best looks unbeatable."""
    if horizon < 1:
        raise ValueError("horizon must be >= 1")

    def criterion(losses: Sequence[float]) -> bool:
        return inner(list(losses)[:horizon])

    return criterion
