"""Deterministic fault injection for the battery pool (transcribed from
``repro/core/faults.py``; DESIGN.md §12).

The paper's pool is opportunistic: lab workstations join it and are
reclaimed without warning, so jobs are evicted, held and straggled as a
matter of course. ``FaultPlan`` is a declarative, seeded schedule of such
faults; ``FaultInjector`` replays it bit for bit from ``(plan, seed)``
at the host boundary in ``pool.py`` (``inject_round_faults``), after a
round's results are on the host as numpy arrays and before they are
folded, so no kernel and no runner ever sees a fault.

Fault kinds (``FAULT_KINDS``):

  evict        the slot's result is nulled to NaN, so the job is HELD and
               the retry machinery replans it (condor_vacate);
  corrupt      the slot's (stat, p) float64 bits are flipped: a silent
               corruption that the sanity gate of ``api.BatteryRun`` must
               catch (p outside [0, 1] or not finite) and turn into HELD;
  straggle     the slot's simulated latency grows by ``delay_s``; past
               ``RetryPolicy.deadline`` the job is HELD, otherwise the
               event is only recorded;
  lose_worker  the pool's width drops through ``PoolSession.resize`` at
               the next round boundary (a machine reclaimed).

Host-side numpy and the standard library only. Every probabilistic draw
is the sha256 of ``f"{seed}:{rule}:{round}:{slot}"``, the reference's
own, so a plan fires at the same (rule, round, slot) in both packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("evict", "corrupt", "straggle", "lose_worker")


class CorruptResultError(ValueError):
    """A runner returned a result that fails the sanity gate: a non-idle
    slot with a non-finite stat or p, or a p outside [0, 1]. The drive
    loop never lets it become a verdict: the job is nulled to NaN,
    folded as missing and replanned on the next release pass."""


def _bit_flip(x: float) -> float:
    """Flip bit 62 (the top exponent bit) of a float64: every p in
    [0, 1] maps to a value above 1 or to a non-finite one, so the
    corruption is detectable by construction. Involutive, no
    randomness."""
    u = np.array([x], dtype=np.float64).view(np.uint64)
    u ^= np.uint64(1) << np.uint64(62)
    return float(u.view(np.float64)[0])


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule. ``kind`` is one of ``FAULT_KINDS``;
    ``round``/``slot``/``job`` select where it fires (``None`` = any);
    ``p`` is the Bernoulli probability per match, drawn from the plan's
    seed; ``delay_s`` is a ``straggle``'s latency; ``width`` is the pool
    width after a ``lose_worker`` (default: the current width - 1,
    floored at 1)."""

    kind: str
    round: Optional[int] = None
    slot: Optional[int] = None
    job: Optional[int] = None
    p: float = 1.0
    delay_s: float = 0.0
    width: Optional[int] = None

    def __post_init__(self):
        """Reject malformed rules when they are made, not when they fire."""
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if not (0.0 < self.p <= 1.0):
            raise ValueError(f"fault probability must be in (0, 1], "
                             f"got {self.p}")
        if self.round is not None and self.round < 0:
            raise ValueError(f"round must be >= 0, got {self.round}")
        if self.slot is not None and self.slot < 0:
            raise ValueError(f"slot must be >= 0, got {self.slot}")
        if self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")
        if self.width is not None and self.width < 1:
            raise ValueError(f"width must be >= 1, got {self.width}")

    def to_dict(self) -> Dict:
        """JSON-safe dict with ``None`` fields and default ``p``/``delay_s``
        left out (the wire format)."""
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items()
                if v is not None and not (k == "p" and v == 1.0)
                and not (k == "delay_s" and v == 0.0)}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A declarative, seeded fault schedule (the ``--inject`` payload).
    Frozen and hashable, so it rides on a ``RunSpec``; the seed and a
    rule's index determine every draw, so a plan replays bit for bit
    across runs, resumes and machines."""

    rules: Tuple[FaultRule, ...] = ()
    seed: int = 0

    def __post_init__(self):
        """Normalise ``rules`` to a tuple of ``FaultRule``."""
        object.__setattr__(self, "rules", tuple(self.rules))
        for r in self.rules:
            if not isinstance(r, FaultRule):
                raise TypeError(f"rules must be FaultRule, got {type(r)}")

    def to_dict(self) -> Dict:
        """JSON-safe dict: ``{"seed": ..., "rules": [...]}``."""
        return {"seed": self.seed,
                "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: Dict) -> "FaultPlan":
        """Inverse of :meth:`to_dict` (an unknown key is an error)."""
        rules = tuple(FaultRule(**r) for r in d.get("rules", ()))
        return cls(rules=rules, seed=int(d.get("seed", 0)))

    def save(self, path: str) -> None:
        """Write the plan as JSON (the ``--inject PLAN.json`` format)."""
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        """Read a plan written by :meth:`save` (or by hand)."""
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One ledger entry: what fired, where and why. ``rule`` indexes
    ``plan.rules`` (-1 for events the injector did not cause: sanity-gate
    detections and quarantines)."""

    round: int
    kind: str
    slot: int
    job: int
    rule: int = -1
    detail: str = ""

    def to_dict(self) -> Dict:
        """JSON-safe dict for the ``--json`` fault ledger."""
        return dataclasses.asdict(self)


class WorkerHealth:
    """Per-slot consecutive-fault streaks (the quarantine's input). A
    slot's streak grows on every round it faulted and resets on a clean
    one; slots whose streak reaches ``RetryPolicy.quarantine_after`` are
    flaky. A resize renumbers the slots, so the caller resets every
    streak then (:meth:`reset`)."""

    def __init__(self):
        """No history and no flaky slot."""
        self._consecutive: Dict[int, int] = {}
        self.total_faults = 0

    def record(self, slot: int, faulted: bool) -> None:
        """Grow ``slot``'s streak if it faulted this round, else reset it."""
        if faulted:
            self._consecutive[slot] = self._consecutive.get(slot, 0) + 1
            self.total_faults += 1
        else:
            self._consecutive[slot] = 0

    def consecutive(self, slot: int) -> int:
        """``slot``'s current streak."""
        return self._consecutive.get(slot, 0)

    def flaky(self, threshold: int) -> List[int]:
        """Slots whose streak has reached ``threshold``, sorted."""
        return sorted(s for s, c in self._consecutive.items()
                      if c >= threshold)

    def reset(self) -> None:
        """Forget every streak (after a resize renumbers the slots)."""
        self._consecutive.clear()


class FaultInjector:
    """Replays a :class:`FaultPlan` against dispatch rounds. Stateless but
    for its event ledger: every draw is a hash of (seed, rule, round,
    slot), so the same plan against the same schedule gives the same
    faults, across a checkpoint resume too (earlier rounds are simply not
    dispatched again)."""

    def __init__(self, plan: FaultPlan):
        """Bind the injector to one plan; the ledger starts empty."""
        if not isinstance(plan, FaultPlan):
            raise TypeError(f"expected FaultPlan, got {type(plan)}")
        self.plan = plan
        self.events: List[FaultEvent] = []

    def _draw(self, rule_idx: int, round_idx: int, slot: int) -> bool:
        """The deterministic Bernoulli(p) draw of one (rule, round, slot):
        the first 8 bytes of a sha256, big-endian, over 2^64."""
        rule = self.plan.rules[rule_idx]
        if rule.p >= 1.0:
            return True
        key = f"{self.plan.seed}:{rule_idx}:{round_idx}:{slot}".encode()
        h = hashlib.sha256(key).digest()
        return int.from_bytes(h[:8], "big") / 2.0 ** 64 < rule.p

    def matches(self, round_idx: int,
                row: np.ndarray) -> List[Tuple[int, FaultRule, int]]:
        """The (rule index, rule, slot) triples that fire for this round's
        ``row`` (job id per slot, -1 = idle). An idle slot never faults;
        a ``lose_worker`` rule does not depend on the slot and fires at
        most once a round (slot -1)."""
        out: List[Tuple[int, FaultRule, int]] = []
        for idx, rule in enumerate(self.plan.rules):
            if rule.round is not None and rule.round != round_idx:
                continue
            if rule.kind == "lose_worker":
                if self._draw(idx, round_idx, -1):
                    out.append((idx, rule, -1))
                continue
            if rule.slot is not None:
                slots = [rule.slot] if rule.slot < row.shape[0] else []
            else:
                slots = list(range(row.shape[0]))
            for s in slots:
                if int(row[s]) < 0:
                    continue                      # idle slot: no job
                if rule.job is not None and int(row[s]) != rule.job:
                    continue
                if self._draw(idx, round_idx, s):
                    out.append((idx, rule, s))
        return out

    def apply_round(self, round_idx: int, row: np.ndarray,
                    arrays: Sequence[Tuple[np.ndarray, np.ndarray]],
                    deadline: Optional[float] = None,
                    ) -> Tuple[List[FaultEvent], Optional[int]]:
        """Apply the plan to one round's host results, in place.
        ``arrays`` holds each generator's ``(stats, ps)``, shaped (W,).
        Returns ``(events, resize_to)``: ``resize_to`` is the width a
        ``lose_worker`` asks for after this round (``None`` if none
        fired). The events are also appended to ``self.events``."""
        events: List[FaultEvent] = []
        resize_to: Optional[int] = None
        delays: Dict[int, float] = {}
        for idx, rule, slot in self.matches(round_idx, row):
            if rule.kind == "lose_worker":
                want = rule.width if rule.width is not None \
                    else row.shape[0] - 1
                resize_to = max(1, int(want))
                events.append(FaultEvent(
                    round_idx, "lose_worker", -1, -1, idx,
                    f"pool width drops to {resize_to} after this round"))
                continue
            job = int(row[slot])
            if rule.kind == "evict":
                for st, pv in arrays:
                    st[slot] = np.nan
                    pv[slot] = np.nan
                events.append(FaultEvent(
                    round_idx, "evict", slot, job, idx,
                    "result nulled; job goes HELD (condor_vacate)"))
            elif rule.kind == "corrupt":
                for st, pv in arrays:
                    st[slot] = _bit_flip(float(st[slot]))
                    pv[slot] = _bit_flip(float(pv[slot]))
                events.append(FaultEvent(
                    round_idx, "corrupt", slot, job, idx,
                    "stat/p bits perturbed (silent corruption)"))
            elif rule.kind == "straggle":
                delays[slot] = delays.get(slot, 0.0) + rule.delay_s
                held = deadline is not None and delays[slot] > deadline
                if held:
                    for st, pv in arrays:
                        st[slot] = np.nan
                        pv[slot] = np.nan
                events.append(FaultEvent(
                    round_idx, "straggle", slot, job, idx,
                    f"latency +{rule.delay_s:g}s"
                    + (f" > deadline {deadline:g}s; job HELD" if held
                       else " (within deadline)" if deadline is not None
                       else " (no deadline set)")))
        self.events.extend(events)
        return events, resize_to
