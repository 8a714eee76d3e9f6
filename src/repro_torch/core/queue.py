"""The classic one-call battery driver (``repro/core/queue.py``).

``run_battery(battery, gen, seed, device, ...)`` builds the ``RunSpec`` its
arguments describe, submits it to a new ``PoolSession`` on ``device``
(``cuda`` unless the caller names another) and drives it to its end.
``core/api.py`` is the fuller surface: a session kept across runs,
several generators in one run, results streamed per round.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.core.api import (  # noqa: F401  (RunResult re-exported)
    BatteryResult,
    PoolSession,
    RunResult,
    RunSpec,
)
from repro_torch.core.policies import RetryPolicy, SchedulePolicy


def run_battery(battery: str, gen: str, seed: int, device=None,
                scale: float = 1.0,
                mode: Union[str, SchedulePolicy] = "lpt",
                checkpoint_path: Optional[str] = None,
                max_retries: int = 2, progress: bool = False,
                n_workers: Optional[int] = None) -> RunResult:
    """Run one battery for one generator on a pool of ``n_workers``
    slots on ``device`` and return its ``RunResult``."""
    spec = RunSpec(battery, generators=(gen,), seeds=(seed,), scale=scale,
                   policy=mode, retry=RetryPolicy(max_retries=max_retries),
                   checkpoint_path=checkpoint_path, progress=progress)
    return PoolSession(n_workers=n_workers,
                       device=device).submit(spec).result()
