"""Public API, classic path: declarative ``RunSpec`` -> ``PoolSession``
-> streaming ``BatteryRun`` (``repro/core/api.py``).

  ``RunSpec``      a frozen description of one run: battery, scale,
                   generator(s), seed(s), schedule and retry policy,
                   checkpoint path, verdict engine and alpha, kernel
                   backend.
  ``PoolSession``  owns the pool (W worker slots on one device) and a
                   cache of job tables and round runners keyed as in the
                   reference, so repeated submits reuse them.
  ``BatteryRun``   the submit handle with HTCondor-shaped verbs:
                   ``poll()`` runs one round, ``held()``/``release()``
                   handle missing results, ``drive()``/``result()`` run to
                   completion, ``stream()`` yields a status per round,
                   ``verdict()`` gives the PASS/FAIL/UNDECIDED decision
                   after any round, ``cancel()`` drops pending rounds.

With ``checkpoint_path`` a run saves its results after every round in
the reference's checkpoint v5 (``Checkpoint``: results keyed by job id,
verdict state tagged with its engine, the sources' uids), which either
package can resume; a run submitted again with the same path dispatches
only the missing jobs (the paper's restart after an HTCondor eviction).
``verdict_engine`` is ``bonferroni`` (sequential spending) or
``evalue`` (anytime-valid e-value wealth, ``core/evidence.py``).

Campaigns, captured sources, elastic resize, fault injection and
serving are not ported yet; the fields that select them do not exist
here, and the CLI refuses their flags.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from repro_torch.ckpt import io as ckpt_io
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

    ``generators`` is a name or a tuple of names; ``sources`` is the
    same positions as ``GeneratorSource``s (or names), and after
    construction both are set (``generators`` holds the names).
    ``seeds`` broadcasts (one seed for every generator) or pairs
    element-wise. ``checkpoint_path`` saves progress after every round
    and resumes from the file when it exists. ``alpha`` is the
    family-wise error rate of the verdict, judged by ``verdict_engine``
    (``stitch.VERDICT_ENGINES``: ``bonferroni`` or ``evalue``);
    ``stop_on_verdict`` cancels a generator's pending work once its
    verdict is decided. ``backend`` is ``reference``, ``accelerated``
    (the hand-written CUDA kernels) or ``auto`` (accelerated on cuda)."""
    battery: str
    generators: Union[str, Tuple[str, ...]] = ()
    seeds: Union[int, Tuple[int, ...]] = (0,)
    scale: float = 1.0
    policy: Union[str, SchedulePolicy] = "lpt"
    retry: RetryPolicy = RetryPolicy()
    checkpoint_path: Optional[str] = None
    progress: Union[bool, Callable] = False
    alpha: float = 0.01
    stop_on_verdict: bool = False
    verdict_engine: str = "bonferroni"
    backend: str = "auto"
    sources: Optional[Tuple] = None

    def __post_init__(self):
        if self.battery not in BATTERY_SIZES:
            raise KeyError(f"unknown battery {self.battery!r}; "
                           f"known: {sorted(BATTERY_SIZES)}")
        if self.sources is not None:
            given = (self.sources if isinstance(self.sources, (tuple, list))
                     else (self.sources,))
            srcs = tuple(_generator_source(s) for s in given)
            if not srcs:
                raise ValueError("sources must name at least one source")
            gens = tuple(s.name for s in srcs)
        else:
            gens = ((self.generators,) if isinstance(self.generators, str)
                    else tuple(self.generators)) or ("splitmix64",)
            srcs = tuple(GeneratorSource(g) for g in gens)   # KeyError
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
        object.__setattr__(self, "sources", srcs)
        get_policy(self.policy)                  # validate early
        if not (0.0 < self.alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")
        stitch.verdict_for(self.verdict_engine)  # validate early
        if self.backend not in kernel_backends.BACKENDS:
            raise KeyError(f"unknown backend {self.backend!r}; "
                           f"known: {kernel_backends.BACKENDS}")

    @property
    def n_generators(self) -> int:
        """Width of the fan-out axis (generator positions)."""
        return len(self.generators)


def _generator_source(src) -> GeneratorSource:
    """A ``sources`` entry as a ``GeneratorSource``: a registered
    generator's name or the source itself. Captured bitstreams are not
    ported."""
    if isinstance(src, GeneratorSource):
        return src
    if isinstance(src, str) and not src.startswith("file:"):
        return GeneratorSource(src)
    raise TypeError(f"source {src!r} is not a registered generator; "
                    f"captured sources are not ported to repro_torch yet")


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


# ---------------------------------------------------------------------------
# checkpoint layout (v5: job-id keyed, worker-count independent,
# source-identity pinned, verdict-engine aware)

CKPT_VERSION = 5


@dataclasses.dataclass
class Checkpoint:
    """On-disk battery progress — v5, keyed by JOB ID, never by
    (round, worker) position. The layout is a pure function of the job
    table, so a checkpoint written on a W=8 mesh resumes bitwise on W=4
    (or any width) after elastic re-meshing (DESIGN.md §6). The file is
    the reference's, leaf for leaf and byte for byte (``ckpt/io.py``),
    so either package resumes the other's.

    Wire layouts (``ckpt/io`` leaves)::

      v5 (written): [version, job_idx (K,), stats (G, K), ps (G, K),
                     decisions (G,) int8 — empty when absent, rounds_run,
                     alpha — nan when absent, source_uids (G,) bytes —
                     empty when absent, engine (1,) bytes,
                     log_wealth (G,) float64 — empty when absent]
      v4 (read):    v5 without the trailing engine + log_wealth leaves
      v3 (read):    v4 without the trailing source_uids leaf
      v2 (read):    [job_idx, stats, ps, decisions, rounds_run]
      v1 (read):    [job_idx, stats, ps]    (stats flat for one generator)

    Loading a v1..v4 file works transparently; the next save upgrades
    it to v5. ``decisions`` carries the verdict codes (see
    ``BatteryRun._DECISION_CODE``); ``None`` means no verdict state.
    ``alpha`` records which error rate the decisions were computed
    under — a resuming run adopts them only when its own alpha matches
    (they are a pure function of (results, alpha)). ``engine`` names the
    verdict engine that produced the decisions (v1..v4 files imply
    ``"bonferroni"``); resuming verdict state under a DIFFERENT engine
    raises ``VerdictEngineMismatch`` — the engines' decisions are not
    comparable. ``log_wealth`` snapshots each generator's accumulated
    e-process wealth under the ``evalue`` engine (DESIGN.md §13); it is
    advisory (wealth is recomputed from results on load) but makes the
    trajectory inspectable on disk. ``source_uids`` pins each generator
    position's source identity (``GeneratorSource.uid()``,
    ``gen:<name>``; the reference's captured sources embed the file's
    content digest), so a run of other sources refuses to resume."""
    job_idx: np.ndarray                         # (K,) int32 job ids
    stats: np.ndarray                           # (G, K) float64
    ps: np.ndarray                              # (G, K) float64
    decisions: Optional[np.ndarray] = None      # (G,) int8 verdict codes
    rounds_run: int = 0
    alpha: Optional[float] = None               # decisions' error rate
    source_uids: Optional[np.ndarray] = None    # (G,) bytes BitSource.uid
    engine: str = "bonferroni"                  # decisions' verdict engine
    log_wealth: Optional[np.ndarray] = None     # (G,) float64 e-wealth
    version: int = CKPT_VERSION

    @property
    def n_generators(self) -> int:
        """Rows of the stacked (G, K) result arrays."""
        return int(self.stats.shape[0])

    @classmethod
    def load(cls, path: str) -> "Checkpoint":
        """Read any supported layout (v1..v5) into the v5 shape."""
        leaves = ckpt_io.load_flat(path)
        if len(leaves) == 10:                   # v5: verdict engine
            (ver, idx, st, pv, dec, rounds, alpha, uids, eng, lw) = leaves
            if int(ver) != CKPT_VERSION:
                raise ValueError(
                    f"checkpoint {path} declares version {int(ver)}; "
                    f"this build reads v1..v{CKPT_VERSION}")
            dec = np.asarray(dec, np.int8)
            alpha = float(alpha)
            uids = np.asarray(uids)
            eng = np.asarray(eng)
            lw = np.asarray(lw, np.float64)
            return cls(np.asarray(idx, np.int32), np.atleast_2d(st),
                       np.atleast_2d(pv), dec if dec.size else None,
                       int(rounds),
                       None if np.isnan(alpha) else alpha,
                       uids if uids.size else None,
                       engine=(bytes(eng.reshape(-1)[0]).decode()
                               if eng.size else "bonferroni"),
                       log_wealth=lw if lw.size else None,
                       version=CKPT_VERSION)
        if len(leaves) == 8:                    # v4: source identity
            ver, idx, st, pv, dec, rounds, alpha, uids = leaves
            if int(ver) != 4:
                raise ValueError(
                    f"checkpoint {path} declares version {int(ver)} in an "
                    f"8-leaf (v4) layout; this build reads "
                    f"v1..v{CKPT_VERSION}")
            dec = np.asarray(dec, np.int8)
            alpha = float(alpha)
            uids = np.asarray(uids)
            return cls(np.asarray(idx, np.int32), np.atleast_2d(st),
                       np.atleast_2d(pv), dec if dec.size else None,
                       int(rounds),
                       None if np.isnan(alpha) else alpha,
                       uids if uids.size else None, version=4)
        if len(leaves) == 7:                    # v3: no source identity
            ver, idx, st, pv, dec, rounds, alpha = leaves
            if int(ver) != 3:
                raise ValueError(
                    f"checkpoint {path} declares version {int(ver)} in a "
                    f"7-leaf (v3) layout; this build reads "
                    f"v1..v{CKPT_VERSION}")
            dec = np.asarray(dec, np.int8)
            alpha = float(alpha)
            return cls(np.asarray(idx, np.int32), np.atleast_2d(st),
                       np.atleast_2d(pv), dec if dec.size else None,
                       int(rounds),
                       None if np.isnan(alpha) else alpha, None, version=3)
        if len(leaves) == 5:                    # v2: verdict state present
            idx, st, pv, dec, rounds = leaves
            return cls(np.asarray(idx, np.int32), np.atleast_2d(st),
                       np.atleast_2d(pv),
                       np.atleast_1d(np.asarray(dec, np.int8)),
                       int(rounds), None, None, version=2)
        if len(leaves) == 3:                    # v1: classic results-only
            idx, st, pv = leaves
            return cls(np.asarray(idx, np.int32), np.atleast_2d(st),
                       np.atleast_2d(pv), None, 0, None, None, version=1)
        raise ValueError(
            f"checkpoint {path} has {len(leaves)} leaves; expected 3 (v1), "
            f"5 (v2), 7 (v3), 8 (v4) or 10 (v{CKPT_VERSION})")

    def save(self, path: str) -> None:
        """Write the v5 layout (whatever version was loaded)."""
        dec = (np.zeros((0,), np.int8) if self.decisions is None
               else np.asarray(self.decisions, np.int8))
        uids = (np.zeros((0,), "S1") if self.source_uids is None
                else np.asarray(self.source_uids))
        lw = (np.zeros((0,), np.float64) if self.log_wealth is None
              else np.asarray(self.log_wealth, np.float64))
        ckpt_io.save(path, [
            np.int64(CKPT_VERSION), np.asarray(self.job_idx, np.int32),
            np.atleast_2d(np.asarray(self.stats, np.float64)),
            np.atleast_2d(np.asarray(self.ps, np.float64)),
            dec, np.int64(self.rounds_run),
            np.float64(np.nan if self.alpha is None else self.alpha),
            uids, np.asarray([self.engine.encode()]), lw])

    def drop(self, job_ids) -> "Checkpoint":
        """A copy with the given jobs knocked out (simulated node loss /
        checkpoint surgery). Verdict state is discarded — decisions are a
        function of the full result set, and a resumed run recomputes
        them from what survives."""
        keep = ~np.isin(self.job_idx, np.asarray(list(job_ids), np.int32))
        return dataclasses.replace(
            self, job_idx=self.job_idx[keep], stats=self.stats[:, keep],
            ps=self.ps[:, keep], decisions=None, log_wealth=None,
            version=CKPT_VERSION)

    def results(self) -> List[Dict[int, tuple]]:
        """Per-generator {job_id: (stat, p)} — the in-memory form."""
        return [{int(i): (float(s), float(p))
                 for i, s, p in zip(self.job_idx, self.stats[g], self.ps[g])}
                for g in range(self.n_generators)]


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
        # verdict state under the spec's engine: sticky per-generator
        # decisions; a decided generator leaves dispatch under
        # stop_on_verdict
        self._engine_fn = stitch.verdict_for(spec.verdict_engine)
        self._verdicts: List[stitch.Verdict] = [
            self._engine_fn({}, len(self._compiled.entries), spec.alpha)
            for _ in range(G)]
        # per-generator wealth after each dispatched round (evalue only)
        self.wealth_history: List[List[float]] = [[] for _ in range(G)]
        self._restored_decisions: Optional[List[int]] = None
        self._restored_alpha: Optional[float] = None
        self._restored_engine: Optional[str] = None
        self._load_checkpoint()
        self._update_verdicts()
        if self._restored_decisions is not None:
            self._check_restored_verdicts()
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
            if self.spec.verdict_engine == "evalue":
                for g, v in enumerate(self._verdicts):
                    self.wealth_history[g].append(v.wealth)
            self._auto_cancel()
            self._save_checkpoint()
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
        """condor_rm: drop every pending round; returns how many. The
        results so far (and the verdicts made from them) are kept and
        saved."""
        n = len(self._queue)
        self._queue.clear()
        self.cancelled = True
        self._save_checkpoint()
        return n

    def _check_restored_verdicts(self) -> None:
        """Saved decisions must agree with the verdicts recomputed from
        the saved p-values: decisions are a pure function of the results,
        so a disagreement means the checkpoint was edited or written
        under another alpha, engine or battery."""
        if len(self._restored_decisions) != self.spec.n_generators:
            raise ValueError(
                f"checkpoint {self.spec.checkpoint_path} holds verdict "
                f"state for {len(self._restored_decisions)} generator(s), "
                f"spec has {self.spec.n_generators}")
        code = self._DECISION_CODE
        saved_alpha = self._restored_alpha
        for g, saved in enumerate(self._restored_decisions):
            if saved != code[self._verdicts[g].decision]:
                raise ValueError(
                    f"checkpoint {self.spec.checkpoint_path}: generator "
                    f"{self.spec.generators[g]!r} was saved as decision "
                    f"code {saved} (engine "
                    f"{self._restored_engine or self.spec.verdict_engine!r}, "
                    f"checkpoint alpha="
                    f"{'unrecorded' if saved_alpha is None else saved_alpha}"
                    f") but its saved results recompute to "
                    f"{self._verdicts[g].decision} under the spec's "
                    f"{self.spec.verdict_engine!r} engine at alpha="
                    f"{self.spec.alpha} — resumed with a different spec?")

    def _update_verdicts(self) -> None:
        """Recompute the verdicts (test space, after sub-jobs are
        combined) under the spec's engine. Bonferroni decisions stick (a
        crossed boundary never un-crosses); evalue decisions stick only
        under ``stop_on_verdict``, where a decided generator's results
        stop changing. Without it wealth moves as results land (e-values
        below 1 shrink it), and the final verdict must be the pure
        function of the complete result set that a resume recomputes."""
        sticky = (self.spec.verdict_engine == "bonferroni"
                  or self.spec.stop_on_verdict)
        for g in range(self.spec.n_generators):
            if sticky and self._verdicts[g].decided:
                continue
            combined = stitch.fold_groups(self._results[g],
                                          self._compiled.jobs,
                                          self._compiled.combine)
            self._verdicts[g] = self._engine_fn(
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

    def stream(self) -> Iterator[dict]:
        """Yield one status per round until the run completes, the
        hold/release retry rounds included, as ``drive()`` runs them;
        budget exhaustion with jobs still HELD raises
        ``RetryBudgetExhausted``."""
        while True:
            while self._queue:
                yield self.poll()
            if self.done or self.cancelled:
                return
            held = self.held()
            if not held:
                return
            if self.driver_retries >= self.spec.retry.max_retries:
                raise RetryBudgetExhausted(held, self.driver_retries)
            self._driver_release()

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
        gids = [self.spec.sources[g].gen_id for g in active]
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

    # -- checkpointing -----------------------------------------------------

    _DECISION_CODE = {stitch.UNDECIDED: 0, stitch.PASS: 1, stitch.FAIL: 2}

    def _save_checkpoint(self) -> None:
        """Write the v5 layout: results keyed by job id (never by the
        round or slot that produced them), so the file is a pure function
        of the job table and resumes on any pool width. Verdict state
        rides along, tagged with its engine, and under ``evalue`` each
        generator's log-wealth; ``rounds_run`` is adopted on resume only
        by ``stop_on_verdict`` runs."""
        path = self.spec.checkpoint_path
        if not path:
            return
        idx = np.array(sorted(set().union(*[set(r) for r in self._results])),
                       np.int32)
        st = np.array([[r.get(int(i), (np.nan, np.nan))[0] for i in idx]
                       for r in self._results], np.float64)
        pv = np.array([[r.get(int(i), (np.nan, np.nan))[1] for i in idx]
                       for r in self._results], np.float64)
        decisions = np.array([self._DECISION_CODE[v.decision]
                              for v in self._verdicts], np.int8)
        uids = np.asarray([s.uid().encode() for s in self.spec.sources])
        lw = None
        if self.spec.verdict_engine == "evalue":
            lw = np.array([v.log_wealth for v in self._verdicts], np.float64)
        Checkpoint(idx, st, pv, decisions, self.rounds_run,
                   alpha=self.spec.alpha, source_uids=uids,
                   engine=self.spec.verdict_engine,
                   log_wealth=lw).save(path)

    def _load_checkpoint(self) -> None:
        """Adopt a checkpoint's results, refusing one that belongs to
        another run: verdict state of another engine
        (``VerdictEngineMismatch``), another generator count, other
        source uids, or a job beyond this spec's job table. Saved
        decisions (and ``rounds_run``) bind only a ``stop_on_verdict``
        run at the alpha they were made under (an unrecorded alpha, v2,
        binds too); otherwise the verdicts are recomputed from the
        results."""
        path = self.spec.checkpoint_path
        if not (path and ckpt_io.exists(path)):
            return
        ck = Checkpoint.load(path)          # v1..v4 are upgraded here
        if (ck.decisions is not None and self.spec.stop_on_verdict
                and ck.engine != self.spec.verdict_engine):
            raise stitch.VerdictEngineMismatch(
                f"checkpoint {path} holds verdict state computed by the "
                f"{ck.engine!r} engine (alpha="
                f"{'unrecorded' if ck.alpha is None else ck.alpha}) but "
                f"the spec resumes with verdict_engine="
                f"{self.spec.verdict_engine!r} (alpha={self.spec.alpha}) "
                f"— the engines' decisions are not comparable; re-run "
                f"from scratch or resume with the original engine")
        if (ck.decisions is not None and self.spec.stop_on_verdict
                and (ck.alpha is None or ck.alpha == self.spec.alpha)):
            self._restored_decisions = [int(d) for d in ck.decisions]
            self._restored_alpha = ck.alpha
            self._restored_engine = ck.engine
            self.rounds_run = ck.rounds_run
        if ck.n_generators != self.spec.n_generators:
            raise ValueError(
                f"checkpoint {path} holds {ck.n_generators} generator "
                f"row(s), spec has {self.spec.n_generators}")
        if ck.source_uids is not None:
            saved = [u.decode() for u in np.asarray(ck.source_uids)]
            want = [s.uid() for s in self.spec.sources]
            if saved != want:
                raise ValueError(
                    f"checkpoint {path} was written against sources "
                    f"{saved}, spec names {want} — a run of other "
                    f"sources must re-run, never resume")
        if (len(ck.job_idx)
                and int(np.max(ck.job_idx)) >= len(self._compiled.jobs)):
            raise ValueError(
                f"checkpoint {path} references job "
                f"{int(np.max(ck.job_idx))} but this spec's job table has "
                f"{len(self._compiled.jobs)} entries — it was written by a "
                f"different battery/scale/decomposition")
        self._results = ck.results()

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
