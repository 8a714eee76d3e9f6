"""Public API, classic path: declarative ``RunSpec`` -> ``PoolSession``
-> streaming ``BatteryRun`` (``repro/core/api.py``).

  ``RunSpec``      a frozen description of one run: battery, scale,
                   generator(s), seed(s), schedule and retry policy,
                   checkpoint path, verdict engine and alpha, kernel
                   backend.
  ``PoolSession``  owns the pool (W worker slots on one device) and a
                   cache of job tables and round runners keyed as in the
                   reference, so repeated submits reuse them. Pool width
                   is a runtime property: ``resize(n)`` (``grow()``/
                   ``shrink()``: machines joining or vacating) changes it,
                   and live runs replan their remaining jobs onto the new
                   width at the next round boundary. Runners of other
                   widths stay cached, so a return to a width already
                   built builds nothing (DESIGN.md §6).
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

``RunSpec.sources`` takes captured bitstreams (``CapturedSource``,
``"file:path[:fmt]"``) beside registered generators: their words are read
on the host and copied to the device once per round
(``pool.gather_captured_bits``), and a checkpoint pins each capture's
content digest. ``RunSpec.offsets`` places each position in its own
sub-stream (the campaign grid's runner). ``CampaignSpec`` and
``CampaignLedger`` describe and record a generator-fleet screening
campaign (``core/campaign.py`` drives it): the ledger is the reference's
v3 file, which either package resumes.

``RunSpec.inject`` takes a ``faults.FaultPlan`` (DESIGN.md §12): a seeded
schedule of simulated pool faults (evict, corrupt, straggle, lose_worker)
applied on the host after each round's results are materialised
(``pool.inject_round_faults``), then a sanity gate that turns a p outside
[0, 1] or a non-finite result into HELD, and a per-slot health model that
quarantines a flaky slot by shrinking the pool. Any plan that leaves a
healthy worker stitches the fault-free run's (stat, p) bit for bit.

The screening service over a session (``SubmissionQueue``, the result
cache, the daemon CLI) is ``repro_torch.serve``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import stitch
from repro_torch.core.battery import TestEntry, build_battery
from repro_torch.core.faults import (CorruptResultError, FaultEvent,
                                     FaultInjector, FaultPlan, WorkerHealth)
from repro_torch.core.policies import (RetryBudgetExhausted, RetryPolicy,
                                       SchedulePolicy, get_policy)
from repro_torch.core.pool import (gather_captured_bits, inject_round_faults,
                                   make_external_runner, make_fanout_runner,
                                   make_grid_runner, make_round_runner,
                                   word_bucket)
from repro_torch.core.scheduler import make_plan, replan
from repro_torch.rng.sources import (BitSource, registry_size,
                                     require_offsetable, resolve_source)
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

    ``generators`` is a name or a tuple of names; ``sources`` spells the
    positions as bit sources (``BitSource`` objects or specs: a
    generator's name, ``"file:path[:fmt]"`` for a captured file), and
    after construction both are set (``generators`` holds each source's
    reporting name). ``offsets`` gives each position a word offset into
    its (seed, stream) sequences (one value broadcasts); ``None`` is the
    classic path, and any tuple, zeros included, runs on the grid
    runner. A non-zero offset needs a counter-based source.
    ``seeds`` broadcasts (one seed for every generator) or pairs
    element-wise. ``checkpoint_path`` saves progress after every round
    and resumes from the file when it exists. ``alpha`` is the
    family-wise error rate of the verdict, judged by ``verdict_engine``
    (``stitch.VERDICT_ENGINES``: ``bonferroni`` or ``evalue``);
    ``stop_on_verdict`` cancels a generator's pending work once its
    verdict is decided. ``backend`` is ``reference``, ``accelerated``
    (the hand-written CUDA kernels) or ``auto`` (accelerated on cuda).
    ``inject`` is an optional ``faults.FaultPlan``: simulated pool faults
    applied on the host boundary (``pool.inject_round_faults``), never
    inside a runner, so the run replays bit for bit."""
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
    offsets: Optional[Union[int, Tuple[int, ...]]] = None
    sources: Optional[Tuple] = None
    inject: Optional[FaultPlan] = None

    def __post_init__(self):
        if self.battery not in BATTERY_SIZES:
            raise KeyError(f"unknown battery {self.battery!r}; "
                           f"known: {sorted(BATTERY_SIZES)}")
        if self.sources is not None:
            given = (self.sources if isinstance(self.sources, (tuple, list))
                     else (self.sources,))
            srcs = tuple(resolve_source(s) for s in given)
            if not srcs:
                raise ValueError("sources must name at least one source")
            gens = tuple(s.name for s in srcs)
        else:
            gens = ((self.generators,) if isinstance(self.generators, str)
                    else tuple(self.generators)) or ("splitmix64",)
            srcs = tuple(resolve_source(g) for g in gens)   # KeyError
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
        if self.offsets is not None:
            offs = ((int(self.offsets),) if isinstance(self.offsets, int)
                    else tuple(int(o) for o in self.offsets))
            if len(offs) == 1:
                offs = offs * len(gens)
            if len(offs) != len(gens):
                raise ValueError(
                    f"{len(offs)} offsets for {len(gens)} generators "
                    "(give one offset, or one per generator)")
            for src, o in zip(srcs, offs):
                if o < 0:
                    raise ValueError(f"offsets must be >= 0, got {o}")
                require_offsetable(src, o)
            object.__setattr__(self, "offsets", offs)
        get_policy(self.policy)                  # validate early
        if not (0.0 < self.alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")
        stitch.verdict_for(self.verdict_engine)  # validate early
        if self.backend not in kernel_backends.BACKENDS:
            raise KeyError(f"unknown backend {self.backend!r}; "
                           f"known: {kernel_backends.BACKENDS}")
        if self.inject is not None and not isinstance(self.inject, FaultPlan):
            raise TypeError(f"inject must be a faults.FaultPlan, "
                            f"got {type(self.inject)}")

    @property
    def n_generators(self) -> int:
        """Width of the fan-out axis (generator positions)."""
        return len(self.generators)

    @property
    def switch_lanes(self) -> int:
        """``1 + max(gen_id)`` over the generator positions (0 when every
        position is captured): the registry width the reference's runner
        keys carry."""
        ids = [s.gen_id for s in self.sources if not s.captured]
        return 1 + max(ids) if ids else 0

    @property
    def captured_positions(self) -> Tuple[int, ...]:
        """Positions whose words come from a ``CapturedSource``."""
        return tuple(g for g, s in enumerate(self.sources) if s.captured)


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

    @property
    def n_suspect(self) -> int:
        """Suspect count across every generator's run."""
        return sum(r.n_suspect for r in self.runs.values())

    @property
    def verdicts(self) -> Dict[str, stitch.Verdict]:
        """Per-generator verdicts, keyed by name."""
        return {g: r.verdict for g, r in self.runs.items()}


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
    position's source identity (``BitSource.uid()``: ``gen:<name>``, or
    for a capture ``cap:<stem>:<digest16>`` of the file's content), so a
    run of other sources, or of a re-captured or byte-modified file,
    refuses to resume."""
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


# ---------------------------------------------------------------------------
# campaign spec + ledger (generator-fleet screening, DESIGN.md §8)


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """Declarative screening grid: ``generators`` x ``n_streams``
    sub-streams, screened in ``waves`` (battery scales, run cheapest
    first) with failed cells knocked out of later waves.

    ``stream_check`` prepends the ``pairstream`` seam battery as phase 0
    (grids of more than one stream). ``span`` is the word spacing of
    adjacent sub-streams (``None``: ``campaign.default_span``, the
    smallest power of two that keeps every job's block of the largest
    wave in its own stream). More than one stream needs counter-based
    sources: ``mwc`` is refused here, not at dispatch. ``sources`` spells
    the fleet as ``RunSpec.sources`` does, captured files included.

    ``verdict_engine`` is ``bonferroni`` or ``evalue``; under ``evalue``
    each cell's e-value wealth accumulates across waves in the ledger and
    a cell FAILs once it reaches ``1/alpha``. A cell still UNDECIDED
    after the last wave with wealth in ``[continue_band/alpha,
    1/alpha)`` is re-opened on fresh stream words, up to
    ``max_continuations`` times (0 disables; band 0 decides it at
    once). Both knobs are inert under ``bonferroni``."""
    battery: str
    generators: Tuple[str, ...] = ()
    n_streams: int = 1
    seed: int = 0
    waves: Tuple[float, ...] = (0.25, 1.0)
    alpha: float = 0.01
    policy: Union[str, SchedulePolicy] = "lpt"
    retry: RetryPolicy = RetryPolicy()
    backend: str = "auto"
    stream_check: bool = True
    span: Optional[int] = None
    ledger_path: Optional[str] = None
    progress: Union[bool, Callable] = False
    sources: Optional[Tuple] = None
    verdict_engine: str = "bonferroni"
    continue_band: float = 0.5
    max_continuations: int = 1

    def __post_init__(self):
        if self.battery not in BATTERY_SIZES:
            raise KeyError(f"unknown battery {self.battery!r}; "
                           f"known: {sorted(BATTERY_SIZES)}")
        if self.sources is not None:
            given = (self.sources if isinstance(self.sources, (tuple, list))
                     else (self.sources,))
            srcs = tuple(resolve_source(s) for s in given)
            gens = tuple(s.name for s in srcs)
        else:
            gens = ((self.generators,) if isinstance(self.generators, str)
                    else tuple(self.generators))
            srcs = tuple(resolve_source(g) for g in gens)
        if not gens:
            raise ValueError("a campaign needs at least one generator "
                             "(or source)")
        if len(set(gens)) != len(gens):
            raise ValueError(f"duplicate generators in {gens}")
        object.__setattr__(self, "generators", gens)
        object.__setattr__(self, "sources", srcs)
        if self.n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {self.n_streams}")
        if self.n_streams > 1:
            bad = [s.name for s in srcs if not s.counter_based]
            if bad:
                raise ValueError(
                    f"stream grids need offset-continuable generators; "
                    f"{bad} are not COUNTER_BASED")
        waves = ((self.waves,) if isinstance(self.waves, (int, float))
                 else tuple(float(w) for w in self.waves))
        if not waves or any(w <= 0 for w in waves):
            raise ValueError(f"waves must be positive scales, got {waves}")
        object.__setattr__(self, "waves", waves)
        if not (0.0 < self.alpha < 1.0):
            raise ValueError(f"alpha must be in (0, 1), got {self.alpha}")
        get_policy(self.policy)
        if self.backend not in kernel_backends.BACKENDS:
            raise KeyError(f"unknown backend {self.backend!r}; "
                           f"known: {kernel_backends.BACKENDS}")
        if self.span is not None and self.span < 1:
            raise ValueError(f"span must be >= 1, got {self.span}")
        stitch.verdict_for(self.verdict_engine)  # validate early
        if not (0.0 <= self.continue_band < 1.0):
            raise ValueError(f"continue_band must be in [0, 1), "
                             f"got {self.continue_band}")
        if self.max_continuations < 0:
            raise ValueError(f"max_continuations must be >= 0, "
                             f"got {self.max_continuations}")
        if (self.verdict_engine != "bonferroni" and self.max_continuations
                and self.continue_band > 0.0):
            # a continuation phase reads words past every stream's
            # scheduled block, which needs jump-ahead
            bad = [s.name for s in srcs if not s.counter_based]
            if bad:
                raise ValueError(
                    f"optional continuation needs offset-continuable "
                    f"generators; {bad} are not COUNTER_BASED (set "
                    f"max_continuations=0 or continue_band=0.0)")

    @property
    def cells(self) -> List[Tuple[str, int]]:
        """Grid cells in ledger order: (generator, stream) pairs."""
        return [(g, s) for g in self.generators
                for s in range(self.n_streams)]

    @property
    def cell_sources(self) -> List[Tuple[BitSource, int]]:
        """Grid cells in ledger order as (source, stream) pairs."""
        return [(src, s) for src in self.sources
                for s in range(self.n_streams)]

    @property
    def n_cells(self) -> int:
        """Grid size: generators x streams."""
        return len(self.generators) * self.n_streams

    def digest(self) -> int:
        """uint64 identity of everything the campaign's decisions depend
        on: battery, grid, seed, waves, alpha, policy, stream_check,
        span, each captured source's uid (its file's content), and the
        verdict engine with its continuation knobs when it is not the
        default. It is the sha256 of ``repr`` of the same tuple the
        reference hashes, so either package's ledger matches the other's
        spec. ``backend`` is left out: both backends give the same
        verdicts."""
        import hashlib
        policy = get_policy(self.policy)
        parts = (self.battery, self.generators, self.n_streams,
                 self.seed, self.waves, self.alpha, policy.name,
                 policy.signature(), self.stream_check, self.span)
        captured = tuple(s.uid() for s in self.sources if s.captured)
        if captured:
            parts = parts + (captured,)
        if self.verdict_engine != "bonferroni":
            parts = parts + (("engine", self.verdict_engine,
                              self.continue_band, self.max_continuations),)
        key = repr(parts)
        return int.from_bytes(
            hashlib.sha256(key.encode()).digest()[:8], "big")


CAMPAIGN_LEDGER_VERSION = 3

# cell decision codes of the ledger and the campaign driver (0/1/2 match
# BatteryRun._DECISION_CODE)
CELL_UNDECIDED, CELL_PASS, CELL_FAIL = 0, 1, 2


@dataclasses.dataclass
class CampaignLedger:
    """On-disk campaign progress, keyed by cell identity ``(gen_id,
    stream)``, never by wave order. The file is the reference's, leaf for
    leaf and byte for byte, so either package resumes the other's.

    Wire layouts (``ckpt/io`` leaves)::

      v3 (written): [version, gen_ids (C,) int32, streams (C,) int32,
                     decisions (C,) int8, decided_phase (C,) int8
                     (-1 = undecided), phases_done, alpha,
                     spec_digest uint64, source_uids (C,) bytes,
                     log_wealth (C,) float64 — empty when absent,
                     engine (1,) bytes, continuations int64]
      v2 (read):    v3 without the trailing log_wealth + engine +
                    continuations leaves
      v1 (read):    v2 without the trailing source_uids leaf

    ``source_uids`` pins each cell's source (a captured cell has gen_id
    -1 and a uid that carries its file's digest). ``decided_phase`` is
    the phase that decided a cell (0 is the stream check when there is
    one, then the waves in ascending scale, then continuations).
    ``phases_done`` counts completed phases; a phase cut mid-battery
    resumes from its own run checkpoint ``<ledger>.phaseK``.
    ``log_wealth`` is each cell's e-value wealth across phases (evalue),
    ``engine`` the verdict engine (v1/v2 imply ``bonferroni``),
    ``continuations`` the continuation phases opened, and
    ``spec_digest`` ``CampaignSpec.digest()``: resuming another
    configuration is refused."""
    gen_ids: np.ndarray
    streams: np.ndarray
    decisions: np.ndarray
    decided_phase: np.ndarray
    phases_done: int = 0
    alpha: Optional[float] = None
    spec_digest: int = 0
    source_uids: Optional[np.ndarray] = None    # (C,) bytes BitSource.uid
    log_wealth: Optional[np.ndarray] = None     # (C,) float64 e-wealth
    engine: str = "bonferroni"                  # decisions' verdict engine
    continuations: int = 0                      # continuation phases opened
    version: int = CAMPAIGN_LEDGER_VERSION

    @staticmethod
    def _want_ids(spec: CampaignSpec):
        """The spec's grid as ledger columns: per-cell gen_id (-1 for a
        captured cell) and stream index."""
        gids = [(-1 if src.captured else src.gen_id)
                for src, _ in spec.cell_sources]
        return (np.asarray(gids, np.int32),
                np.asarray([s for _, s in spec.cell_sources], np.int32))

    @classmethod
    def fresh(cls, spec: CampaignSpec) -> "CampaignLedger":
        """An all-undecided ledger for the spec's grid."""
        c = spec.n_cells
        gids, streams = cls._want_ids(spec)
        uids = np.asarray([src.uid().encode()
                           for src, _ in spec.cell_sources])
        return cls(gids, streams,
                   np.zeros((c,), np.int8), np.full((c,), -1, np.int8),
                   0, spec.alpha, spec.digest(), uids,
                   log_wealth=np.zeros((c,), np.float64),
                   engine=spec.verdict_engine)

    @classmethod
    def load(cls, path: str) -> "CampaignLedger":
        """Read (and version-check) a v1, v2 or v3 ledger file."""
        leaves = ckpt_io.load_flat(path)
        if len(leaves) == 12:                   # v3: verdict engine
            (ver, gids, streams, dec, phase, done, alpha, digest, uids,
             lw, eng, cont) = leaves
            if int(ver) != CAMPAIGN_LEDGER_VERSION:
                raise ValueError(
                    f"campaign ledger {path} declares version {int(ver)} "
                    f"in a 12-leaf layout; this build reads "
                    f"v1/v2/v{CAMPAIGN_LEDGER_VERSION}")
            uids = np.asarray(uids)
            alpha = float(alpha)
            lw = np.asarray(lw, np.float64)
            eng = np.asarray(eng)
            return cls(np.asarray(gids, np.int32),
                       np.asarray(streams, np.int32),
                       np.asarray(dec, np.int8), np.asarray(phase, np.int8),
                       int(done), None if np.isnan(alpha) else alpha,
                       int(np.uint64(digest)),
                       uids if uids.size else None,
                       log_wealth=lw if lw.size else None,
                       engine=(bytes(eng.reshape(-1)[0]).decode()
                               if eng.size else "bonferroni"),
                       continuations=int(cont),
                       version=CAMPAIGN_LEDGER_VERSION)
        if len(leaves) == 9:                    # v2: source identity
            ver, gids, streams, dec, phase, done, alpha, digest, uids = leaves
            if int(ver) != 2:
                raise ValueError(
                    f"campaign ledger {path} declares version {int(ver)} "
                    f"in a 9-leaf (v2) layout; this build reads "
                    f"v1/v2/v{CAMPAIGN_LEDGER_VERSION}")
            uids = np.asarray(uids)
            alpha = float(alpha)
            return cls(np.asarray(gids, np.int32),
                       np.asarray(streams, np.int32),
                       np.asarray(dec, np.int8), np.asarray(phase, np.int8),
                       int(done), None if np.isnan(alpha) else alpha,
                       int(np.uint64(digest)),
                       uids if uids.size else None, version=2)
        if len(leaves) == 8:                    # v1: no source identity
            ver, gids, streams, dec, phase, done, alpha, digest = leaves
            if int(ver) != 1:
                raise ValueError(
                    f"campaign ledger {path} declares version {int(ver)} "
                    f"in an 8-leaf (v1) layout; this build reads "
                    f"v1/v2/v{CAMPAIGN_LEDGER_VERSION}")
            alpha = float(alpha)
            return cls(np.asarray(gids, np.int32),
                       np.asarray(streams, np.int32),
                       np.asarray(dec, np.int8), np.asarray(phase, np.int8),
                       int(done), None if np.isnan(alpha) else alpha,
                       int(np.uint64(digest)), None, version=1)
        raise ValueError(f"campaign ledger {path} has {len(leaves)} "
                         "leaves; expected 8 (v1), 9 (v2) or 12 (v3)")

    def save(self, path: str) -> None:
        """Write the 12-leaf v3 layout (atomic)."""
        uids = (np.zeros((0,), "S1") if self.source_uids is None
                else np.asarray(self.source_uids))
        lw = (np.zeros((0,), np.float64) if self.log_wealth is None
              else np.asarray(self.log_wealth, np.float64))
        ckpt_io.save(path, [
            np.int64(CAMPAIGN_LEDGER_VERSION),
            np.asarray(self.gen_ids, np.int32),
            np.asarray(self.streams, np.int32),
            np.asarray(self.decisions, np.int8),
            np.asarray(self.decided_phase, np.int8),
            np.int64(self.phases_done),
            np.float64(np.nan if self.alpha is None else self.alpha),
            np.uint64(self.spec_digest), uids, lw,
            np.asarray([self.engine.encode()]),
            np.int64(self.continuations)])

    def matches(self, spec: CampaignSpec) -> bool:
        """Does this ledger describe exactly this campaign: the same cells
        in the same order, the same sources and the same
        decision-relevant configuration (``CampaignSpec.digest``)? A v1
        ledger (no uids) matches on the other columns alone."""
        want_g, want_s = self._want_ids(spec)
        if self.source_uids is not None:
            want_u = np.asarray([src.uid().encode()
                                 for src, _ in spec.cell_sources])
            uids = np.asarray(self.source_uids)
            if uids.shape != want_u.shape or not bool(np.all(uids == want_u)):
                return False
        return (self.gen_ids.shape == want_g.shape
                and bool(np.all(self.gen_ids == want_g))
                and bool(np.all(self.streams == want_s))
                and (self.alpha is None or self.alpha == spec.alpha)
                and self.engine == spec.verdict_engine
                and self.spec_digest == spec.digest())


@dataclasses.dataclass
class _Compiled:
    """One job-table slot: the battery and job tables plus the round
    runners built for it, keyed as the reference keys them:
    ``(n_workers, G, grid, captured, lanes)``. ``lanes`` is the registry
    width the reference traced its switch at; here the registry is read
    at each call, so a runner of any width serves every generator, and
    the key only keeps the reference's accounting."""
    entries: List[TestEntry]        # original battery (test space)
    jobs: List[TestEntry]           # possibly decomposed (job space)
    costs: List[float]
    combine: str
    runners: dict       # (n_workers, G, grid, captured, lanes) -> runner


class PoolSession:
    """Owns the pool and the runner cache. ``device`` defaults to
    ``cuda``; the CPU runs only when asked for. The width is a runtime
    property (``resize``); each width keeps its own runners, so bouncing
    8 -> 4 -> 8 builds only the 4-wide ones."""

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
        """Pool width (logical worker slots; see ``resize``)."""
        return self.mesh.n_workers

    def resize(self, n_workers: int) -> int:
        """Elastic re-meshing: set the pool width to ``n_workers`` (>= 1)
        and return it. Live ``BatteryRun``s replan their remaining jobs
        onto the new width at their next round boundary; results, verdict
        state and sub-streams do not depend on the width, so nothing is
        lost or run twice. The slots share one device, so unlike the
        reference no width is refused for want of devices."""
        n = int(n_workers)
        if n < 1:
            raise ValueError(f"pool width must be >= 1, got {n}")
        if n != self.n_workers:
            from repro_torch.launch.mesh import make_pool_mesh
            self.mesh = make_pool_mesh(n, self.device)
        return self.n_workers

    def grow(self, n: int = 1) -> int:
        """``n`` machines joined the pool (condor: their owner went idle)."""
        return self.resize(self.n_workers + n)

    def shrink(self, n: int = 1) -> int:
        """``n`` machines vacated the pool (condor: their owner came back)."""
        return self.resize(self.n_workers - n)

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

    def _runner(self, spec: RunSpec, n_gens: Optional[int] = None,
                captured: bool = False):
        """The round runner for this spec's shape, reused by any later
        spec of the same shape: pool width x G lanes, on the grid runner
        when the spec carries ``offsets``, on the external runner for
        captured positions (``captured=True``). A runner built for a
        registry at least ``spec.switch_lanes`` wide serves the spec, as
        in the reference."""
        key = self.cache_key(spec)
        compiled = self._compiled(spec)
        g = spec.n_generators if n_gens is None else n_gens
        grid = spec.offsets is not None and not captured
        need = 0 if captured else spec.switch_lanes
        runner = compiled.runners.get((self.n_workers, g, grid, captured,
                                       need))
        if runner is None:
            for (w, gg, gr, cap, lanes), r in compiled.runners.items():
                if ((w, gg, gr, cap) == (self.n_workers, g, grid, captured)
                        and lanes >= need):
                    runner = r
                    break
        if runner is None:
            def on_trace():
                self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
            if captured:
                runner = make_external_runner(compiled.jobs, self.mesh,
                                              on_trace=on_trace)
                lanes = 0
            else:
                make = (make_grid_runner if grid
                        else make_round_runner if g == 1
                        else make_fanout_runner)
                runner = make(compiled.jobs, self.mesh, on_trace=on_trace)
                lanes = registry_size()
            compiled.runners[(self.n_workers, g, grid, captured, lanes)] \
                = runner
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
        # captured positions: host read time, bytes copied to the device
        # and rounds that read a capture
        self.prefetch_s = 0.0
        self.bytes_to_device = 0
        self.captured_rounds = 0
        self.cancelled = False
        # fault domain (DESIGN.md §12), all on the host: the injector, its
        # event ledger, the per-slot health model and the quarantines;
        # fault_s is the host time of injection, gate and health
        self._injector = (FaultInjector(spec.inject)
                          if spec.inject is not None else None)
        self.fault_events: List[FaultEvent] = []
        self.health = WorkerHealth()
        self.quarantines: List[dict] = []
        self.fault_s = {"inject": 0.0, "gate": 0.0, "health": 0.0}
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

    def _sync_width(self) -> None:
        """If the session was resized since the pending rounds were
        planned, replan the residual jobs onto the new width at this
        round boundary. Completed results stay: job identity does not
        depend on the width (``pool.stream_table``), so a replan moves
        jobs between slots and rounds, never changes which work remains."""
        w = self.session.n_workers
        if not self._queue or self._queue[0].shape[0] == w:
            return
        residual = sorted({int(j) for row in self._queue
                           for j in row if j >= 0})
        self._queue.clear()
        if residual:
            self._enqueue(residual)
            emit_progress(self.spec.progress,
                          f"  pool resized to {w} worker(s): {len(residual)} "
                          f"residual job(s) replanned onto "
                          f"{len(self._queue)} round(s)")

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
        under ``stop_on_verdict`` each poll is also an interim look. A
        session ``resize()`` since the last poll is absorbed first: the
        remaining rounds are replanned onto the new width."""
        self._sync_width()
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

    def verdicts_by_position(self) -> List[stitch.Verdict]:
        """Interim verdicts by generator position (``verdict()`` keys by
        name, which merges positions that repeat a name, as a campaign
        grid's do)."""
        self._update_verdicts()
        return list(self._verdicts)

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
        the ``RetryPolicy`` budget. It first waits the policy's backoff
        (``RetryPolicy.backoff_for``, 0 by default), so a misbehaving
        pool is not hammered."""
        delay = self.spec.retry.backoff_for(self.driver_retries)
        if delay > 0:
            emit_progress(self.spec.progress,
                          f"  backing off {delay:.2f}s before release "
                          f"pass {self.driver_retries + 1}")
            time.sleep(delay)
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
        """One round for the active positions: one runner call for the
        generator positions (the grid runner when the spec has offsets)
        and one for the captured positions, whose words are read on the
        host (``gather_captured_bits``) and copied to the device in one
        piece."""
        active = self._active()
        if not active:
            return
        srcs, spec = self.spec.sources, self.spec
        switched = [g for g in active if not srcs[g].captured]
        captured = [g for g in active if srcs[g].captured]
        per_gen = []
        if switched:
            runner = self.session._runner(spec, n_gens=len(switched))
            gids = [srcs[g].gen_id for g in switched]
            seeds = [spec.seeds[g] for g in switched]
            if spec.offsets is not None:
                stats, ps = runner(row, seeds, gids,
                                   [spec.offsets[g] for g in switched])
                per_gen += [(g, stats[a], ps[a])
                            for a, g in enumerate(switched)]
            elif len(switched) == 1:
                stats, ps = runner(row, seeds[0], gids[0])
                per_gen.append((switched[0], stats, ps))
            else:
                stats, ps = runner(row, seeds, gids)
                per_gen += [(g, stats[a], ps[a])
                            for a, g in enumerate(switched)]
            jobs = self._compiled.jobs
            self.words_generated += len(switched) * sum(
                word_bucket(jobs[int(j)].n_words) for j in row if j >= 0)
        if captured:
            runner = self.session._runner(spec, n_gens=len(captured),
                                          captured=True)
            lanes = [(srcs[g], spec.seeds[g],
                      None if spec.offsets is None else spec.offsets[g])
                     for g in captured]
            bits = gather_captured_bits(
                self._compiled.jobs, row, lanes,
                pin=self.session.device.type == "cuda")
            self.prefetch_s += bits.seconds
            self.bytes_to_device += bits.nbytes
            self.captured_rounds += 1
            stats, ps = runner(row, bits)
            per_gen += [(g, stats[a], ps[a]) for a, g in enumerate(captured)]
        # fault domain (DESIGN.md §12): host-side work on the round's
        # materialised numpy results; the runners above never see a fault,
        # the gate or a quarantine
        t0 = time.perf_counter()
        injected: List[FaultEvent] = []
        resize_to: Optional[int] = None
        if self._injector is not None:
            per_gen = [(g, np.array(st, np.float64), np.array(pv, np.float64))
                       for g, st, pv in per_gen]
            injected, resize_to = inject_round_faults(
                self._injector, self.rounds_run, row,
                [(st, pv) for _, st, pv in per_gen],
                deadline=self.spec.retry.deadline)
            self.fault_events.extend(injected)
            for ev in injected:
                emit_progress(self.spec.progress,
                              f"  fault[{ev.kind}] round {ev.round} "
                              f"slot {ev.slot} job {ev.job}: {ev.detail}")
        t1 = time.perf_counter()
        per_gen, gate_events = self._sanity_gate(row, per_gen, injected)
        t2 = time.perf_counter()
        if resize_to is not None and resize_to != self.session.n_workers:
            emit_progress(self.spec.progress,
                          f"  worker lost: pool resizes to {resize_to}")
            self.session.resize(resize_to)
        self._update_health(row, injected + gate_events)
        t3 = time.perf_counter()
        self.fault_s["inject"] += t1 - t0
        self.fault_s["gate"] += t2 - t1
        self.fault_s["health"] += t3 - t2
        for g, st, pv in per_gen:
            self._results[g] = stitch.fold(row[None, :], st[None, :],
                                           pv[None, :], self._results[g])

    def _sanity_gate(self, row: np.ndarray, per_gen: list,
                     injected: List[FaultEvent]) -> tuple:
        """The result sanity gate: a non-idle slot whose stat or p is not
        finite, or whose p lies outside [0, 1], holds a corrupt result.
        It is nulled to NaN, so ``stitch.missing`` marks the job HELD and
        a release runs it again, and recorded as a ``corrupt_result``
        event carrying the :class:`CorruptResultError` text: a silent
        corruption becomes HELD and a retry, never a verdict. Slots an
        injected ``evict`` or a ``straggle`` past the deadline nulled this
        round are skipped (they are faults already accounted). Returns
        ``(per_gen, gate_events)``."""
        nulled = {ev.slot for ev in injected
                  if ev.kind == "evict"
                  or (ev.kind == "straggle" and "HELD" in ev.detail)}
        row = np.asarray(row)
        events: List[FaultEvent] = []
        out = []
        for g, st, pv in per_gen:
            st, pv = np.asarray(st), np.asarray(pv)
            bad = (row >= 0) & ~(np.isfinite(st) & np.isfinite(pv)
                                 & (pv >= 0.0) & (pv <= 1.0))
            for w in np.nonzero(bad)[0]:
                bad[w] = int(w) not in nulled
            if bad.any():
                st = np.array(st, np.float64)
                pv = np.array(pv, np.float64)
                for w in np.nonzero(bad)[0]:
                    err = CorruptResultError(
                        f"job {int(row[w])} (slot {int(w)}, generator "
                        f"position {g}) returned stat={float(st[w])!r} "
                        f"p={float(pv[w])!r}; p must be finite and in "
                        f"[0, 1] — result quarantined to HELD")
                    events.append(FaultEvent(
                        self.rounds_run, "corrupt_result", int(w),
                        int(row[w]), -1, str(err)))
                    emit_progress(self.spec.progress,
                                  f"  corrupt result gated: {err}")
                st[bad] = np.nan
                pv[bad] = np.nan
            out.append((g, st, pv))
        self.fault_events.extend(events)
        return out, events

    def _update_health(self, row: np.ndarray,
                       events: List[FaultEvent]) -> None:
        """Advance the per-slot health model with this round and
        quarantine flaky slots. Every non-idle slot either faulted (an
        injected evict, corrupt or straggle, or a gated result, landed on
        it) or ran clean; once slots' streaks reach
        ``RetryPolicy.quarantine_after`` the pool shrinks by their number
        through ``resize`` (to one worker at least), their residual jobs
        replan onto the survivors at the next round boundary, and every
        streak resets (a resize renumbers the slots)."""
        faulted = {int(ev.slot) for ev in events if ev.slot >= 0}
        for w in range(row.shape[0]):
            if int(row[w]) >= 0:
                self.health.record(w, w in faulted)
        qa = self.spec.retry.quarantine_after
        if not qa:
            return
        flaky = self.health.flaky(qa)
        cur = self.session.n_workers
        if not flaky or cur <= 1:
            return
        new_w = max(1, cur - len(flaky))
        self.quarantines.append({"round": self.rounds_run,
                                 "slots": flaky, "workers": new_w})
        self.fault_events.append(FaultEvent(
            self.rounds_run, "quarantine", flaky[0], -1, -1,
            f"slot(s) {flaky} quarantined after {qa} consecutive "
            f"fault(s); pool shrinks to {new_w} worker(s)"))
        emit_progress(self.spec.progress,
                      f"  slot(s) {flaky} quarantined — pool shrinks "
                      f"to {new_w} worker(s)")
        self.health.reset()
        self.session.resize(new_w)

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
                    f"{saved}, spec names {want} — for a captured source "
                    f"the uid embeds the file's content digest, so a "
                    f"re-captured (byte-different) file must re-run, "
                    f"never resume")
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
