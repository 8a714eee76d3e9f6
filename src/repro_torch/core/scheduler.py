"""Pool scheduler: the classic ``make_plan``/``replan`` surface over the
policy registry, and a campaign's wave order and makespan model
(``repro/core/scheduler.py``)."""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from repro_torch.core.policies import Plan, SchedulePolicy, get_policy


def make_plan(costs: Sequence[float], n_workers: int,
              mode: Union[str, SchedulePolicy] = "roundrobin",
              entries: Sequence = None) -> Plan:
    """Plan via the registered policy; a policy with ``plan_entries``
    (adaptive) gets the job table when it is given."""
    policy = get_policy(mode)
    plan_entries = getattr(policy, "plan_entries", None)
    if entries is not None and plan_entries is not None:
        return plan_entries(entries, n_workers)
    return policy.plan(costs, n_workers)


def wave_schedule(scales: Sequence[float]) -> list:
    """Campaign wave order (DESIGN.md §8): the battery scales sorted
    ascending, duplicates kept, so every cell a cheap wave knocks out
    never pays for the expensive ones."""
    out = sorted(float(s) for s in scales)
    if not out:
        raise ValueError("a campaign needs at least one wave scale")
    if any(s <= 0 for s in out):
        raise ValueError(f"wave scales must be positive, got {out}")
    return out


def wave_makespan(costs: Sequence[float], n_workers: int, n_cells: int,
                  mode: Union[str, SchedulePolicy] = "lpt") -> tuple:
    """``(batched, per_cell)`` estimated makespans of one wave over
    ``n_cells`` grid cells: one plan whose rounds carry every cell, and
    the same plan run once per cell."""
    plan = make_plan(costs, n_workers, mode)
    return plan.est_makespan, plan.est_makespan * max(int(n_cells), 1)


def replan(missing: Sequence[int], costs: Sequence[float],
           n_workers: int, mode: Union[str, SchedulePolicy] = "lpt",
           entries: Sequence = None) -> Plan:
    """Plan covering only the ``missing`` job indices (hold/release
    retries); an empty set yields a zero-round plan."""
    missing = list(missing)
    if not missing:
        return Plan(np.zeros((0, n_workers), np.int32),
                    get_policy(mode).name, 0.0, 0.0)
    sub_entries = ([entries[i] for i in missing]
                   if entries is not None else None)
    sub = make_plan([costs[i] for i in missing], n_workers, mode,
                    entries=sub_entries)
    remap = np.asarray(list(missing) + [-1], np.int32)
    a = remap[np.where(sub.assignment >= 0, sub.assignment, len(missing))]
    return Plan(a.astype(np.int32), sub.mode, sub.est_makespan,
                sub.est_ideal)
