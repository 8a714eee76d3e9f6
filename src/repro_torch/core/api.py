"""Public API, classic path: declarative ``RunSpec`` -> ``PoolSession``
-> streaming ``BatteryRun`` (``repro/core/api.py``).

  ``RunSpec``      a frozen description of one run: battery, scale,
                   generator(s), seed(s), schedule and retry policy,
                   verdict alpha, kernel backend.
  ``PoolSession``  owns the pool (W worker slots on one device) and a
                   cache of job tables and round runners keyed as in the
                   reference, so repeated submits reuse them.
  ``BatteryRun``   the submit handle with HTCondor-shaped verbs:
                   ``poll()`` runs one round, ``held()``/``release()``
                   handle missing results, ``drive()``/``result()`` run to
                   completion, ``verdict()`` gives the sequential
                   PASS/FAIL/UNDECIDED decision after any round,
                   ``cancel()`` drops pending rounds.

Checkpoints, campaigns, captured sources, elastic resize, fault
injection, the e-value verdict engine and serving are not ported yet;
the fields that select them do not exist here, and the CLI refuses
their flags. The verdict is always the Bonferroni-sequential one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import stitch
from repro_torch.core.battery import TestEntry, build_battery
from repro_torch.core.policies import (RetryBudgetExhausted, RetryPolicy,
                                       SchedulePolicy, get_policy)
from repro_torch.core.pool import (make_fanout_runner, make_round_runner,
                                   word_bucket)
from repro_torch.core.scheduler import make_plan, replan
from repro_torch.rng.sources import GeneratorSource
from repro_torch.stats import backends as kernel_backends

BATTERY_SIZES = {"smallcrush": 10, "crush": 96, "bigcrush": 106,
                 "pairstream": 4}


def emit_progress(progress: Union[bool, Callable], msg: str) -> None:
    """``False`` drops the line, ``True`` prints it, a callable gets it."""
    if not progress:
        return
    if callable(progress):
        progress(msg)
    else:
        print(msg, flush=True)


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Declarative description of one battery run.

    ``generators`` is a name or a tuple of names; ``seeds`` broadcasts
    (one seed for every generator) or pairs element-wise. ``alpha`` is
    the family-wise error rate of the Bonferroni-sequential verdict;
    ``stop_on_verdict`` cancels a generator's pending work once its
    verdict is decided. ``backend`` is ``reference``, ``accelerated``
    (the hand-written CUDA kernels) or ``auto`` (accelerated on cuda)."""
    battery: str
    generators: Union[str, Tuple[str, ...]] = ()
    seeds: Union[int, Tuple[int, ...]] = (0,)
    scale: float = 1.0
    policy: Union[str, SchedulePolicy] = "lpt"
    retry: RetryPolicy = RetryPolicy()
    progress: Union[bool, Callable] = False
    alpha: float = 0.01
    stop_on_verdict: bool = False
    backend: str = "auto"

    def __post_init__(self):
        if self.battery not in BATTERY_SIZES:
            raise KeyError(f"unknown battery {self.battery!r}; "
                           f"known: {sorted(BATTERY_SIZES)}")
        gens = ((self.generators,) if isinstance(self.generators, str)
                else tuple(self.generators)) or ("splitmix64",)
        for g in gens:
            GeneratorSource(g)                   # KeyError for unknown
        seeds = ((self.seeds,) if isinstance(self.seeds, int)
                 else tuple(int(s) for s in self.seeds))
        if len(seeds) == 1:
            seeds = seeds * len(gens)
        if len(seeds) != len(gens):
            raise ValueError(
                f"{len(seeds)} seeds for {len(gens)} generators "
                "(give one seed, or one per generator)")
        object.__setattr__(self, "generators", gens)
        object.__setattr__(self, "seeds", seeds)
        get_policy(self.policy)                  # validate early
        if not (0.0 < self.alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")
        if self.backend not in kernel_backends.BACKENDS:
            raise KeyError(f"unknown backend {self.backend!r}; "
                           f"known: {kernel_backends.BACKENDS}")

    @property
    def n_generators(self) -> int:
        """Width of the fan-out axis (generator positions)."""
        return len(self.generators)


@dataclasses.dataclass
class RunResult:
    """Per-generator outcome."""
    results: Dict[int, tuple]       # test index -> (stat, p), combined
    report: str
    rounds_run: int
    retries: int
    wall_s: float
    plan_rounds: int
    verdict: Optional[stitch.Verdict] = None

    @property
    def n_suspect(self) -> int:
        """Tests flagged by the two-sided suspect rule."""
        return self.report.count("SUSPECT")


@dataclasses.dataclass
class BatteryResult:
    """Outcome of a multi-generator submit."""
    spec: RunSpec
    runs: Dict[str, RunResult]      # generator name -> result
    rounds_run: int
    retries: int
    wall_s: float


@dataclasses.dataclass
class _Compiled:
    """One job-table slot: the battery and job tables plus the round
    runners built for it, keyed ``(n_workers, G)``. The reference also
    keys the switch width it traced; here the generator registry is read
    at each call, so a runner serves every registered generator."""
    entries: List[TestEntry]        # original battery (test space)
    jobs: List[TestEntry]           # possibly decomposed (job space)
    costs: List[float]
    combine: str
    runners: dict


class PoolSession:
    """Owns the pool and the runner cache. ``device`` defaults to
    ``cuda``; the CPU runs only when asked for."""

    def __init__(self, mesh=None, n_workers: Optional[int] = None,
                 device=None):
        if mesh is None:
            from repro_torch.launch.mesh import make_pool_mesh
            mesh = make_pool_mesh(n_workers, device)
        self.mesh = mesh
        self._cache: Dict[tuple, _Compiled] = {}
        self.trace_counts: Dict[tuple, int] = {}

    @property
    def device(self):
        """The device every slot's jobs run on."""
        return self.mesh.device

    @property
    def n_workers(self) -> int:
        """Pool width (logical worker slots)."""
        return self.mesh.n_workers

    @property
    def total_traces(self) -> int:
        """Round runners built so far (cache accounting)."""
        return sum(self.trace_counts.values())

    def _backend(self, spec: RunSpec) -> str:
        return kernel_backends.resolve(spec.backend, self.device)

    def cache_key(self, spec: RunSpec) -> tuple:
        """Runner accounting key: battery, scale, width, decomposition
        and the resolved backend."""
        policy = get_policy(spec.policy)
        return (spec.battery, float(spec.scale), self.n_workers,
                policy.signature(), self._backend(spec))

    def _table_key(self, spec: RunSpec) -> tuple:
        """Job-table key, without the pool width."""
        policy = get_policy(spec.policy)
        return (spec.battery, float(spec.scale), policy.signature(),
                self._backend(spec))

    def _compiled(self, spec: RunSpec) -> _Compiled:
        key = self._table_key(spec)
        hit = self._cache.get(key)
        if hit is None:
            entries = build_battery(spec.battery, spec.scale,
                                    backend=self._backend(spec))
            policy = get_policy(spec.policy)
            jobs = policy.decompose(entries, None) or entries
            combine = getattr(policy, "combine", "stouffer")
            hit = _Compiled(entries, jobs, [j.cost for j in jobs],
                            combine, {})
            self._cache[key] = hit
        return hit

    def _runner(self, spec: RunSpec, n_gens: Optional[int] = None):
        """The round runner for this spec's shape: pool width x G
        generators, reused by any later spec of the same shape."""
        key = self.cache_key(spec)
        compiled = self._compiled(spec)
        g = spec.n_generators if n_gens is None else n_gens
        runner = compiled.runners.get((self.n_workers, g))
        if runner is None:
            def on_trace():
                self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
            make = make_round_runner if g == 1 else make_fanout_runner
            runner = make(compiled.jobs, self.mesh, on_trace=on_trace)
            compiled.runners[(self.n_workers, g)] = runner
        return runner

    def entries(self, spec: RunSpec) -> List[TestEntry]:
        """The spec's battery test table (test space)."""
        return self._compiled(spec).entries

    def submit(self, spec: RunSpec) -> "BatteryRun":
        """condor_submit: plan the spec and hand back the run handle."""
        return BatteryRun(self, spec)


class BatteryRun:
    """Streaming handle for one submitted spec (HTCondor verbs)."""

    def __init__(self, session: PoolSession, spec: RunSpec):
        self.session = session
        self.spec = spec
        self._compiled = session._compiled(spec)
        self._t0 = time.time()
        self.rounds_run = 0
        self.retries = 0
        self.driver_retries = 0
        self.plan_rounds = 0
        self.words_generated = 0
        self.cancelled = False
        G = spec.n_generators
        self._results: List[Dict[int, tuple]] = [dict() for _ in range(G)]
        self._verdicts: List[stitch.Verdict] = [
            stitch.sequential_verdict({}, len(self._compiled.entries),
                                      spec.alpha)
            for _ in range(G)]
        self._queue: List[np.ndarray] = []
        todo = self._missing()
        if todo:
            self._enqueue(todo, initial=True)

    # -- planning ----------------------------------------------------------

    def _active(self) -> List[int]:
        """Generator positions still driven (undecided ones only, under
        ``stop_on_verdict``)."""
        if not self.spec.stop_on_verdict:
            return list(range(self.spec.n_generators))
        return [g for g in range(self.spec.n_generators)
                if not self._verdicts[g].decided]

    def _missing(self) -> List[int]:
        """Job-space HELD/missing set across the active generators."""
        n = len(self._compiled.jobs)
        held = set()
        for g in self._active():
            held.update(stitch.missing(self._results[g], n))
        return sorted(held)

    def _enqueue(self, todo: List[int], initial: bool = False) -> None:
        costs = self._compiled.costs
        jobs = self._compiled.jobs
        w = self.session.n_workers
        if initial and len(todo) == len(costs):
            plan = make_plan(costs, w, self.spec.policy, entries=jobs)
        else:
            plan = replan(todo, costs, w, self.spec.policy, entries=jobs)
        self.plan_rounds = self.plan_rounds or plan.rounds
        self._queue.extend(np.asarray(row, np.int32)
                           for row in plan.assignment)

    # -- HTCondor verbs ----------------------------------------------------

    @property
    def pending_rounds(self) -> int:
        """Rounds still queued for dispatch."""
        return len(self._queue)

    @property
    def done(self) -> bool:
        """True when nothing is queued and no job is missing/held."""
        return not self._queue and not self._missing()

    def poll(self) -> dict:
        """Run one round for every active generator and report status;
        under ``stop_on_verdict`` each poll is also an interim look."""
        self._auto_cancel()
        if self._queue:
            row = self._queue.pop(0)
            self._dispatch(row)
            self.rounds_run += 1
            self._update_verdicts()
            self._auto_cancel()
            if self.spec.progress:
                emit_progress(self.spec.progress,
                              f"  round {self.rounds_run}: "
                              f"{self._jobs_done()}/"
                              f"{len(self._compiled.jobs)} files generated")
        return self.status()

    def held(self) -> List[int]:
        """Job ids with missing/invalid results once the plan is spent."""
        return [] if (self._queue or self.cancelled) else self._missing()

    def verdict(self) -> Union[stitch.Verdict, Dict[str, stitch.Verdict]]:
        """The current sequential verdict (one per generator name for a
        multi-generator spec)."""
        self._update_verdicts()
        if self.spec.n_generators == 1:
            return self._verdicts[0]
        return {gen: self._verdicts[g]
                for g, gen in enumerate(self.spec.generators)}

    def results_by_position(self) -> List[Dict[int, tuple]]:
        """Combined test-space results per generator position."""
        return [stitch.fold_groups(self._results[g], self._compiled.jobs,
                                   self._compiled.combine)
                for g in range(self.spec.n_generators)]

    def cancel(self) -> int:
        """condor_rm: drop every pending round; returns how many."""
        n = len(self._queue)
        self._queue.clear()
        self.cancelled = True
        return n

    def _update_verdicts(self) -> None:
        """Recompute undecided verdicts (Bonferroni decisions stick)."""
        for g in range(self.spec.n_generators):
            if self._verdicts[g].decided:
                continue
            combined = stitch.fold_groups(self._results[g],
                                          self._compiled.jobs,
                                          self._compiled.combine)
            self._verdicts[g] = stitch.sequential_verdict(
                combined, len(self._compiled.entries), self.spec.alpha)

    def _auto_cancel(self) -> None:
        """stop_on_verdict: once every generator is decided, pending
        rounds are never dispatched."""
        if (self.spec.stop_on_verdict and self._queue
                and not self._active()):
            dropped = len(self._queue)
            self._queue.clear()
            self.cancelled = True
            emit_progress(self.spec.progress,
                          f"  verdict decided for all generators — "
                          f"{dropped} pending round(s) cancelled")

    def release(self) -> int:
        """condor_release: replan the HELD set; returns #jobs released."""
        h = self.held()
        if not h:
            return 0
        self.retries += 1
        self._enqueue(h)
        emit_progress(self.spec.progress,
                      f"  {len(h)} held tests released for retry")
        return len(h)

    def _driver_release(self) -> int:
        """A release by the drive loop itself, the only kind that spends
        the ``RetryPolicy`` budget."""
        self.driver_retries += 1
        return self.release()

    def drive(self, stop_when=None,
              raise_on_exhausted: bool = True) -> "BatteryRun":
        """Dispatch every queued round, then release and retry the HELD
        set until it clears or the retry budget is spent
        (``RetryBudgetExhausted``). ``stop_when(handle)`` is checked
        after every round and cancels the rest when it fires."""
        while True:
            while self._queue:
                self.poll()
                if stop_when is not None and stop_when(self):
                    self.cancel()
                    break
            if self.done or self.cancelled:
                break
            held = self.held()
            if not held:
                break
            if self.driver_retries >= self.spec.retry.max_retries:
                if raise_on_exhausted:
                    raise RetryBudgetExhausted(held, self.driver_retries)
                break
            self._driver_release()
        return self

    def result(self) -> Union[RunResult, BatteryResult]:
        """Drive to completion and stitch: ``RunResult`` for one
        generator, ``BatteryResult`` otherwise."""
        return self.drive()._finalize()

    def status(self) -> dict:
        """A condor_q-shaped snapshot (cancellation is sticky)."""
        state = ("cancelled" if self.cancelled
                 else "done" if self.done
                 else "running" if self._queue else "held")
        return {"state": state, "jobs_done": self._jobs_done(),
                "jobs_total": len(self._compiled.jobs),
                "pending_rounds": len(self._queue),
                "rounds_run": self.rounds_run, "retries": self.retries,
                "held": self.held(),
                "verdicts": {gen: self._verdicts[g].decision
                             for g, gen in enumerate(self.spec.generators)}}

    # -- execution ---------------------------------------------------------

    def _jobs_done(self) -> int:
        n = len(self._compiled.jobs)
        undone = set()
        for res in self._results:
            undone.update(stitch.missing(res, n))
        return n - len(undone)

    def _dispatch(self, row: np.ndarray) -> None:
        """One round for the active generators: one runner call, the
        undecided generators on its fan-out axis."""
        active = self._active()
        if not active:
            return
        runner = self.session._runner(self.spec, n_gens=len(active))
        gids = [GeneratorSource(self.spec.generators[g]).gen_id
                for g in active]
        seeds = [self.spec.seeds[g] for g in active]
        if len(active) == 1:
            stats, ps = runner(row, seeds[0], gids[0])
            per_gen = [(active[0], stats, ps)]
        else:
            stats, ps = runner(row, seeds, gids)
            per_gen = [(g, stats[a], ps[a]) for a, g in enumerate(active)]
        jobs = self._compiled.jobs
        self.words_generated += len(active) * sum(
            word_bucket(jobs[int(j)].n_words) for j in row if j >= 0)
        for g, st, pv in per_gen:
            self._results[g] = stitch.fold(row[None, :], st[None, :],
                                           pv[None, :], self._results[g])

    def _finalize(self) -> Union[RunResult, BatteryResult]:
        wall = time.time() - self._t0
        self._update_verdicts()
        per_pos = self.results_by_position()
        runs: Dict[str, RunResult] = {}
        for g, gen in enumerate(self.spec.generators):
            combined = per_pos[g]
            rep = stitch.report(self._compiled.entries, combined, gen,
                                self.spec.seeds[g])
            runs[gen] = RunResult(combined, rep, self.rounds_run,
                                  self.retries, wall, self.plan_rounds,
                                  verdict=self._verdicts[g])
        if self.spec.n_generators == 1:
            return runs[self.spec.generators[0]]
        return BatteryResult(self.spec, runs, self.rounds_run, self.retries,
                             wall)
