"""Schedule + retry policies for the battery pool (transcribed from
``repro/core/policies.py``; pure numpy, no device work).

  roundrobin      the paper's batch model: ceil(K/W) batches
  lpt             longest-processing-time first
  over_decompose  the heaviest tests split into sub-jobs on fresh
                  sub-streams, LPT-packed; the stitcher folds each group's
                  sub-p-values back into one (Stouffer/Fisher)
  adaptive        rounds filled in descending discrimination/cost, so a
                  bad generator meets the tests that fail it first

Policies are host-side and pure: ``plan`` maps (costs, workers) to a
``Plan``; ``decompose`` (optional) maps the job table to an expanded one;
``plan_entries`` (adaptive only) ranks by the entries' kernel family.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Protocol, Sequence, Union, runtime_checkable

import numpy as np


# ---------------------------------------------------------------------------
# plan


@dataclasses.dataclass(frozen=True)
class Plan:
    """A placement: (rounds, workers) job-index grid plus the makespan
    estimates the policies compete on."""
    assignment: np.ndarray          # (rounds, workers) int32 job index, -1 idle
    mode: str
    est_makespan: float             # sum over rounds of max worker cost
    est_ideal: float                # sum(costs)/W lower bound

    @property
    def rounds(self) -> int:
        """Batches the plan dispatches (the paper's ceil(K/W))."""
        return self.assignment.shape[0]


def _ordered_assignment(order, n_workers: int) -> np.ndarray:
    """Fill rounds of W slots in the given job order (round-robin is the
    identity order)."""
    order = list(order)
    rounds = -(-len(order) // n_workers)
    a = np.full((rounds, n_workers), -1, np.int32)
    for pos, i in enumerate(order):
        a[pos // n_workers, pos % n_workers] = i
    return a


def _roundrobin_plan(costs: np.ndarray, n_workers: int) -> np.ndarray:
    return _ordered_assignment(range(len(costs)), n_workers)


def _lpt_plan(costs: np.ndarray, n_workers: int) -> np.ndarray:
    order = np.argsort(-costs)
    loads = np.zeros(n_workers)
    lists: List[List[int]] = [[] for _ in range(n_workers)]
    for i in order:
        w = int(np.argmin(loads))
        loads[w] += costs[i]
        lists[w].append(int(i))
    rounds = max(len(l) for l in lists)
    a = np.full((rounds, n_workers), -1, np.int32)
    for w, l in enumerate(lists):
        for r, i in enumerate(l):
            a[r, w] = i
    return a


def _finish_plan(a: np.ndarray, costs: np.ndarray, n_workers: int,
                 mode: str) -> Plan:
    per_round = np.where(a >= 0, costs[np.clip(a, 0, None)], 0.0)
    est = float(per_round.max(axis=1).sum())
    return Plan(a, mode, est, float(costs.sum() / n_workers))


# ---------------------------------------------------------------------------
# policy protocol + registry


@runtime_checkable
class SchedulePolicy(Protocol):
    """Placement strategy. ``decompose`` returning None means the job
    table is the battery's entry list unchanged.

    ``decompose`` must be a pure function of the battery: the session
    invokes it with ``n_workers=None`` (the argument survives for
    signature compatibility only), because one job table serves every
    pool width — job ids, sub-stream assignments and checkpoints all
    have to survive elastic re-meshing (DESIGN.md §6). Width-aware
    placement belongs in ``plan``, which does get ``n_workers``."""
    name: str

    def plan(self, costs: Sequence[float], n_workers: int) -> Plan:
        """Place jobs with the given costs onto ``n_workers`` slots."""
        ...

    def decompose(self, entries, n_workers: Optional[int] = None
                  ) -> Optional[list]:
        """Optionally expand the battery into sub-jobs (None = as-is)."""
        ...

    def signature(self) -> Optional[tuple]:
        """Compile-cache key component: None unless decomposition changes
        the compiled job table."""
        ...


@dataclasses.dataclass(frozen=True)
class RoundRobinPolicy:
    """The paper's placement: fill rounds in battery order (§11's
    ceil(K/W) batch model, reproduced exactly)."""
    name: str = "roundrobin"

    def plan(self, costs, n_workers):
        """Identity-order round fill."""
        costs = np.asarray(costs, np.float64)
        return _finish_plan(_roundrobin_plan(costs, n_workers), costs,
                            n_workers, self.name)

    def decompose(self, entries, n_workers):
        """Never decomposes."""
        return None

    def signature(self):
        """No decomposition -> no compile-cache component."""
        return None


@dataclasses.dataclass(frozen=True)
class LPTPolicy:
    """Longest-processing-time-first: strictly better makespan than
    round-robin whenever test costs are skewed (TestU01's are)."""
    name: str = "lpt"

    def plan(self, costs, n_workers):
        """Greedy LPT onto the least-loaded worker."""
        costs = np.asarray(costs, np.float64)
        return _finish_plan(_lpt_plan(costs, n_workers), costs, n_workers,
                            self.name)

    def decompose(self, entries, n_workers):
        """Never decomposes."""
        return None

    def signature(self):
        """No decomposition -> no compile-cache component."""
        return None


@dataclasses.dataclass(frozen=True)
class OverDecomposePolicy:
    """Split any test whose cost exceeds ``threshold`` x the battery's mean
    test cost into up to ``max_parts`` sub-jobs, then LPT-pack the expanded
    table. The cut is deliberately a function of the battery alone (NOT of
    ``n_workers``): the job table — and with it checkpoint job indices and
    sub-stream ids — stays identical across mesh widths, so a checkpointed
    run resumes correctly after elastic re-meshing. Sub-jobs draw fresh,
    disjoint generator sub-streams and are re-parameterized
    lambda-invariantly (see battery.split_entry), so each sub-result is a
    valid p-value; the stitcher combines a group's sub-p-values with
    ``combine`` ('stouffer' keeps both tails, 'fisher' is small-p
    sensitive)."""
    name: str = "over_decompose"
    max_parts: int = 8
    threshold: float = 1.0
    combine: str = "stouffer"

    def plan(self, costs, n_workers):
        """LPT over the (already expanded) job table."""
        costs = np.asarray(costs, np.float64)
        return _finish_plan(_lpt_plan(costs, n_workers), costs, n_workers,
                            self.name)

    def decompose(self, entries, n_workers=None):
        """Split over-threshold tests into lambda-invariant sub-jobs
        (see the class docstring; None when nothing splits)."""
        from repro_torch.core.battery import split_entry
        if not entries:                         # replan of nothing: no table
            return None
        costs = np.asarray([e.cost for e in entries], np.float64)
        cut = self.threshold * max(float(costs.mean()), 1e-12)
        jobs = []
        for e in entries:
            parts = 1
            if e.cost > cut:
                parts = min(self.max_parts, max(int(np.ceil(e.cost / cut)), 2))
            subs = split_entry(e, parts, start_index=len(jobs))
            jobs.extend(subs)
        if len(jobs) == len(entries):           # nothing split
            return None
        return jobs

    def signature(self):
        """The decomposition parameters ARE the compiled-table identity."""
        return (self.name, self.max_parts, self.threshold)


def _ordered_plan(order: Sequence[int], costs: np.ndarray,
                  n_workers: int, mode: str) -> Plan:
    """Priority-ordered plan. Round r IS the r-th interim look of the
    sequential verdict engine, so order here is execution order, not
    just placement."""
    return _finish_plan(_ordered_assignment(order, n_workers), costs,
                        n_workers, mode)


@dataclasses.dataclass(frozen=True)
class AdaptivePolicy:
    """Early-stopping schedule order: jobs are ranked by
    ``discrimination / cost`` (battery.DISCRIMINATION — the static table
    seeded from the known-bad generators) and rounds are filled in that
    order, so the cheapest historically-discriminating tests execute in
    the earliest rounds. Ties and unknown kernels fall back to
    cheapest-first, which still front-loads verdict information: an
    interim look after round r has seen the most tests per unit of wall
    clock. Placement is deliberately NOT makespan-optimal — the point is
    to minimise expected rounds-to-verdict for a bad generator, and the
    driver cancels the tail of the plan once the verdict lands."""
    name: str = "adaptive"

    def plan(self, costs, n_workers):
        """Cost-only fallback order (cheapest first)."""
        costs = np.asarray(costs, np.float64)
        order = np.argsort(costs, kind="stable")        # cheap first
        return _ordered_plan([int(i) for i in order], costs, n_workers,
                             self.name)

    def plan_entries(self, entries, n_workers):
        """Priority plan over real battery entries (discrimination/cost)."""
        from repro_torch.core.battery import discrimination
        costs = np.asarray([e.cost for e in entries], np.float64)
        score = np.asarray([discrimination(e) for e in entries], np.float64)
        # primary: discrimination per unit cost, descending; tie-break on
        # cheapness so zero-discrimination tails still run cheap-first
        priority = score / np.maximum(costs, 1e-12)
        order = sorted(range(len(entries)),
                       key=lambda i: (-priority[i], costs[i], i))
        return _ordered_plan(order, costs, n_workers, self.name)

    def decompose(self, entries, n_workers):
        """Never decomposes."""
        return None

    def signature(self):
        """No decomposition -> no compile-cache component."""
        return None


POLICIES: Dict[str, SchedulePolicy] = {}


def register_policy(policy: SchedulePolicy) -> SchedulePolicy:
    """Add a policy to the registry under ``policy.name`` (last wins)."""
    POLICIES[policy.name] = policy
    return policy


register_policy(RoundRobinPolicy())
register_policy(LPTPolicy())
register_policy(OverDecomposePolicy())
register_policy(AdaptivePolicy())


def get_policy(policy: Union[str, SchedulePolicy]) -> SchedulePolicy:
    """Resolve a mode string (or pass a policy object through)."""
    if isinstance(policy, str):
        try:
            return POLICIES[policy]
        except KeyError:
            raise ValueError(
                f"unknown schedule policy {policy!r}; "
                f"registered: {sorted(POLICIES)}") from None
    if isinstance(policy, SchedulePolicy):
        return policy
    raise TypeError(f"not a SchedulePolicy: {policy!r}")


# ---------------------------------------------------------------------------
# retry


class RetryBudgetExhausted(RuntimeError):
    """The driver's release budget ran out with jobs still HELD.

    Raised by ``BatteryRun.drive``/``stream`` (and re-raised by
    ``serve.Ticket.result`` for failed tickets) instead of silently
    finalising with missing results.  Carries the final HELD job-id
    list so callers can report or replan; catch it and call
    ``_finalize`` explicitly if a partial report is genuinely wanted.
    """

    def __init__(self, held: Sequence[int], retries: int):
        """Record the unrecoverable job ids and the budget that was spent."""
        self.held = [int(j) for j in held]
        self.retries = int(retries)
        super().__init__(
            f"retry budget exhausted after {self.retries} release "
            f"pass(es) with {len(self.held)} job(s) still HELD: "
            f"{self.held}")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """hold/release discipline: how many release passes the driver grants
    before exhaustion is reported as :class:`RetryBudgetExhausted`
    (paper: condor_release), and the fault domain's knobs (DESIGN.md
    §12): exponential backoff between the drive loop's release passes, a
    straggler ``deadline`` per round, and ``quarantine_after``, the
    consecutive faults after which a worker slot leaves the pool."""
    max_retries: int = 2
    backoff_base: float = 0.0      # seconds before the first release; 0 = off
    backoff_mult: float = 2.0      # exponential growth per release pass
    backoff_max: float = 60.0      # hard cap, jitter included
    deadline: Optional[float] = None      # per-round seconds before HELD
    quarantine_after: Optional[int] = None  # consecutive faults per slot

    def __post_init__(self):
        """Reject nonsense budgets up front instead of failing silently."""
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_base < 0:
            raise ValueError(
                f"backoff_base must be >= 0, got {self.backoff_base}")
        if self.backoff_mult < 1.0:
            raise ValueError(
                f"backoff_mult must be >= 1, got {self.backoff_mult}")
        if self.backoff_max < 0:
            raise ValueError(
                f"backoff_max must be >= 0, got {self.backoff_max}")
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(
                f"deadline must be > 0 seconds, got {self.deadline}")
        if self.quarantine_after is not None and self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {self.quarantine_after}")

    def backoff_for(self, attempt: int) -> float:
        """Seconds to wait before the drive loop's release pass ``attempt``
        (0-based): ``base * mult**attempt`` with up to 10 % jitter that
        is a sha256 of the attempt index, not a random draw (so a replay
        waits the same), capped at ``backoff_max``; 0.0 when backoff is
        off (the default)."""
        if self.backoff_base <= 0:
            return 0.0
        raw = self.backoff_base * self.backoff_mult ** max(int(attempt), 0)
        h = hashlib.sha256(f"backoff:{int(attempt)}".encode()).digest()
        jitter = 1.0 + 0.1 * (int.from_bytes(h[:4], "big") / 2.0 ** 32)
        return min(self.backoff_max, raw * jitter)
