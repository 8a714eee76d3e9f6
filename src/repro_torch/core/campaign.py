"""Generator-fleet screening campaigns (``repro/core/campaign.py``,
DESIGN.md §8).

The paper turned ONE five-hour battery into a fleet of small jobs on
idle machines. The modern version of that workload is not one generator
but a FAMILY: which of G generators x S parallel sub-streams pass
together (Wartel & Hill 2026; Antunes et al. 2024 — PAPERS.md)? A
``Campaign`` screens that declarative grid in WAVES:

  phase 0   ``pairstream`` seam battery — the inter-stream
            disjointness/correlation check over adjacent sub-streams
            (stats/tests.pairstream at rng.generators.seam_offsets);
            a failed seam knocks out both cells that share it.
  phase 1+  the target battery at each wave scale, cheapest first
            (``scheduler.wave_schedule``); every cell the sequential
            verdict engine FAILs is knocked out of all later waves.

Each phase is ONE ``RunSpec`` whose generators tuple enumerates the
surviving cells and whose ``offsets`` tuple places each cell in its own
sub-stream, so a whole wave is one multi-lane runner call per round, on
the session's cached grid runner. Offsets are call arguments and the
cell axis is padded to power-of-two buckets as in the reference (the
pool computes a repeated lane once), so knockouts reuse the runners of
earlier phases: a campaign builds at most one runner per phase, not one
per cell (``PoolSession.total_traces``).

Progress lives in the cell-keyed ``CampaignLedger`` (api.py, the
job-id-keyed checkpoint discipline) plus one per-phase run checkpoint,
so an interrupted campaign resumes mid-wave with knocked-out cells
still knocked out.

Under ``CampaignSpec(verdict_engine="evalue")`` (DESIGN.md §13) the
knockout currency changes from per-phase Bonferroni boundaries to
cumulative e-process WEALTH: each stream phase's calibrated e-values
multiply into the cell's ledger-persisted wealth, a cell FAILs the
moment cumulative wealth reaches ``1/alpha`` (valid at every look by
Ville's inequality), and a cell that finishes the last scheduled wave
merely *borderline* — wealth inside ``[continue_band/alpha, 1/alpha)``
— is RE-OPENED: a continuation phase at the top wave's scale reads
fresh (previously unread) words of each cell's sub-stream, up to
``max_continuations`` times, before the cell is force-decided. Seam
phases stay knockout-only under either engine: their reads straddle the
same words the stream phases consume, so their evidence must not be
double-counted into cell wealth.

Typical use::

    session = PoolSession()
    spec = CampaignSpec("smallcrush", generators=("splitmix64", "pcg32"),
                        n_streams=4, waves=(0.25, 1.0),
                        ledger_path="campaign.ck")
    result = Campaign(session, spec).run()
    print(result.report)
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import stitch
from repro_torch.core.api import (CELL_FAIL, CELL_PASS, CELL_UNDECIDED,
                                  CampaignLedger, CampaignSpec, PoolSession,
                                  RunSpec, emit_progress)
from repro_torch.core.battery import build_battery, max_words
from repro_torch.core.pool import word_bucket
from repro_torch.core.scheduler import wave_schedule
from repro_torch.rng.generators import seam_offsets, stream_offsets


def default_span(spec: CampaignSpec) -> int:
    """The sub-stream spacing (words) that keeps every cell's reads in
    its own stream: the widest block any job of any wave's battery (or
    the seam check's half-block) consumes, rounded up to a power of two
    (``pool.word_bucket`` — same bucketing discipline as generation).
    A pure function of the spec, so ledgers and resumes agree on it."""
    words = 0
    for scale in sorted(set(spec.waves)):
        words = max(words, max_words(build_battery(spec.battery, scale,
                                                   device="cpu")))
    if spec.stream_check and spec.n_streams > 1:
        pair = build_battery("pairstream", _stream_check_scale(spec),
                             device="cpu")
        words = max(words, max_words(pair) // 2)
    return word_bucket(max(words, 1))


def _stream_check_scale(spec: CampaignSpec) -> float:
    """The seam battery runs at the cheapest wave's scale — it is a
    machinery check (overlap/correlation at stream seams is ~certain to
    trip any mode when the offset arithmetic is wrong), so the small
    screening size is enough and keeps phase 0 cheap."""
    return min(spec.waves)


@dataclasses.dataclass(frozen=True)
class Phase:
    """One screening phase: a battery at a scale, plus the per-cell
    offset rule ("stream" = cells read their own sub-stream; "seam" =
    cells straddle their right-hand seam for the pairstream check).
    ``continuation`` numbers the re-opening passes appended for
    borderline cells under the e-value engine (0 = a scheduled phase);
    continuation k advances every cell's offset past the whole grid's
    first k blocks, so each pass reads fresh words."""
    name: str
    battery: str
    scale: float
    offset_rule: str            # "stream" | "seam"
    continuation: int = 0


@dataclasses.dataclass
class CampaignResult:
    """Outcome of a campaign: the per-cell decision matrix and the
    knockout history, plus the aggregate execution counters."""
    spec: CampaignSpec
    cells: List[Tuple[str, int]]
    decisions: np.ndarray           # (C,) CELL_* codes, cell order
    decided_phase: np.ndarray       # (C,) phase index, -1 undecided
    phase_names: List[str]
    rounds_run: int
    wall_s: float
    log_wealth: Optional[np.ndarray] = None     # (C,) e-wealth (evalue)
    continuations: int = 0          # continuation phases opened

    @property
    def wealth(self) -> Optional[np.ndarray]:
        """Per-cell e-process wealth in linear space (overflow-capped),
        cell order; ``None`` under the Bonferroni engine."""
        if self.log_wealth is None:
            return None
        return np.exp(np.minimum(np.asarray(self.log_wealth, np.float64),
                                 700.0))

    @property
    def matrix(self) -> np.ndarray:
        """(generators, streams) decision matrix (CELL_* codes)."""
        return stitch.campaign_matrix(self.decisions,
                                      len(self.spec.generators),
                                      self.spec.n_streams)

    @property
    def report(self) -> str:
        """The rendered screening matrix + knockout summary."""
        return stitch.campaign_report(self.spec.generators,
                                      self.spec.n_streams, self.decisions,
                                      self.decided_phase, self.phase_names)

    def decision(self, gen: str, stream: int = 0) -> str:
        """PASS/FAIL/UNDECIDED for one (generator, stream) cell."""
        i = self.cells.index((gen, stream))
        return {CELL_UNDECIDED: stitch.UNDECIDED, CELL_PASS: stitch.PASS,
                CELL_FAIL: stitch.FAIL}[int(self.decisions[i])]

    @property
    def survivors(self) -> List[Tuple[str, int]]:
        """Cells that passed every wave."""
        return [c for c, d in zip(self.cells, self.decisions)
                if d == CELL_PASS]

    @property
    def knockouts(self) -> List[Tuple[str, int]]:
        """Cells knocked out by some phase."""
        return [c for c, d in zip(self.cells, self.decisions)
                if d == CELL_FAIL]


class Campaign:
    """Driver for one ``CampaignSpec`` on a ``PoolSession``.

    Build it, call ``run()``; with a ``ledger_path`` the campaign is
    restartable at both granularities (phase list + mid-phase rounds).
    The session outlives the campaign: screening several campaigns on
    one session shares every runner the grids have in common."""

    def __init__(self, session: PoolSession, spec: CampaignSpec):
        self.session = session
        self.spec = spec
        need = default_span(spec)
        self.span = spec.span if spec.span is not None else need
        if spec.n_streams > 1 and self.span < need:
            raise ValueError(
                f"span={self.span} is narrower than the widest job "
                f"block ({need} words incl. bucketing); sub-streams "
                "would overlap")
        self.rounds_run = 0
        # one record per phase this object ran: its cell groups (grid
        # indices), padding, rounds, wall time and each group's combined
        # test results
        self.phase_log: List[dict] = []
        self.ledger = self._load_ledger()
        if (spec.verdict_engine == "evalue"
                and self.ledger.log_wealth is None):
            self.ledger.log_wealth = np.zeros((spec.n_cells,), np.float64)

    # -- grid bookkeeping --------------------------------------------------

    def phases(self) -> List[Phase]:
        """The campaign's phase list: the seam check (grids with >1
        stream), then the waves in ascending-scale order, then one
        continuation phase per re-opening the ledger has recorded
        (e-value engine only) — a pure function of (spec, ledger), so a
        resumed campaign reconstructs the identical list."""
        out = []
        if self.spec.stream_check and self.spec.n_streams > 1:
            out.append(Phase("streamcheck", "pairstream",
                             _stream_check_scale(self.spec), "seam"))
        for scale in wave_schedule(self.spec.waves):
            out.append(Phase(f"x{scale:g}", self.spec.battery, scale,
                             "stream"))
        top = max(self.spec.waves)
        for c in range(1, self.ledger.continuations + 1):
            out.append(Phase(f"continue{c}", self.spec.battery, top,
                             "stream", continuation=c))
        return out

    def _load_ledger(self) -> CampaignLedger:
        path = self.spec.ledger_path
        if path and ckpt_io.exists(path):
            ledger = CampaignLedger.load(path)
            if not ledger.matches(self.spec):
                raise ValueError(
                    f"campaign ledger {path} was written by a different "
                    "campaign configuration (grid, battery, waves, seed, "
                    "alpha, policy, stream_check or span) — refusing to "
                    "resume; delete the ledger to start fresh")
            return ledger
        return CampaignLedger.fresh(self.spec)

    def _save_ledger(self) -> None:
        if self.spec.ledger_path:
            self.ledger.save(self.spec.ledger_path)

    def _survivor_idx(self) -> List[int]:
        """Grid-cell positions still in play."""
        return [i for i, d in enumerate(self.ledger.decisions)
                if d == CELL_UNDECIDED]

    # -- phase execution ---------------------------------------------------

    def _phase_cells(self, phase: Phase) -> List[Tuple[int, ...]]:
        """The cells a phase dispatches, as tuples of GRID cell indices:
        a wave runs each surviving cell ``(i,)``; the seam check runs
        each adjacent PAIR ``(i, i+1)`` whose two cells both survive
        (its verdict binds both)."""
        alive = set(self._survivor_idx())
        if phase.offset_rule == "stream":
            return [(i,) for i in sorted(alive)]
        S = self.spec.n_streams
        pairs = []
        for i in sorted(alive):
            if (i % S) < S - 1 and (i + 1) in alive:
                pairs.append((i, i + 1))
        return pairs

    def _cell_offset(self, phase: Phase, cell_group: Tuple[int, ...],
                     pair_words: int) -> int:
        """The word offset the phase's RunSpec assigns this dispatch
        position (``stream_offsets``/``seam_offsets`` grids).
        Continuation phase k advances each cell by ``k * S * span``
        words — past the whole grid's first k stream blocks — so every
        re-opening reads words no scheduled phase (and no other cell's
        continuation) has touched."""
        s = int(self.ledger.streams[cell_group[0]])
        if phase.offset_rule == "stream":
            base = int(stream_offsets(s + 1, self.span)[s])
            return base + (phase.continuation * self.spec.n_streams
                           * self.span)
        return int(seam_offsets(s + 2, self.span, pair_words)[s])

    def _run_phase(self, k: int, phase: Phase) -> bool:
        """Drive one phase to its verdicts; returns True when the phase
        COMPLETED (every dispatched cell reached a decision or ran its
        full battery). False means jobs stayed HELD through the retry
        budget — the phase's partial checkpoint is kept and the caller
        must not advance past it, so a resume retries the phase instead
        of freezing its undecided cells forever."""
        groups = self._phase_cells(phase)
        if not groups:
            emit_progress(self.spec.progress,
                          f"phase {k} ({phase.name}): no surviving cells — "
                          "skipped")
            return True
        pair_words = 0
        if phase.offset_rule == "seam":
            pair_words = max_words(
                build_battery(phase.battery, phase.scale,
                              device="cpu")) // 2
        srcs = [self.spec.sources[g // self.spec.n_streams]
                for g in [grp[0] for grp in groups]]
        offs = [self._cell_offset(phase, grp, pair_words) for grp in groups]
        # pad the cell axis to its power-of-two bucket (repeat cell 0;
        # padding results are discarded) so knockouts between waves
        # re-enter seen grid shapes instead of retracing — word_bucket
        # is the same rounding rule generation uses
        n_real = len(groups)
        pad = word_bucket(max(n_real, 1)) - n_real
        srcs += [srcs[0]] * pad
        offs += [offs[0]] * pad
        ck = (f"{self.spec.ledger_path}.phase{k}"
              if self.spec.ledger_path else None)
        spec = RunSpec(phase.battery, sources=tuple(srcs),
                       seeds=(self.spec.seed,), scale=phase.scale,
                       policy=self.spec.policy, retry=self.spec.retry,
                       alpha=self.spec.alpha,
                       verdict_engine=self.spec.verdict_engine,
                       backend=self.spec.backend, offsets=tuple(offs),
                       checkpoint_path=ck, progress=self.spec.progress)
        emit_progress(self.spec.progress,
                      f"phase {k} ({phase.name}): {n_real} cell(s) "
                      f"(+{pad} pad) on battery={phase.battery} "
                      f"scale={phase.scale:g}")
        # the shared drive loop (BatteryRun.drive) owns the hold/release
        # retry budget; stop_when cancels the phase's residual rounds the
        # moment every REAL cell (padding excluded) is decided. A stalled
        # phase is DATA here (the ledger keeps it retryable), so budget
        # exhaustion must not raise out of the campaign driver.
        t0 = time.perf_counter()
        handle = self.session.submit(spec).drive(
            stop_when=lambda h: all(
                v.decided for v in h.verdicts_by_position()[:n_real]),
            raise_on_exhausted=False)
        self.rounds_run += handle.rounds_run
        self.phase_log.append({
            "phase": k, "name": phase.name, "groups": groups, "pad": pad,
            "rounds": handle.rounds_run,
            "wall_s": time.perf_counter() - t0,
            "results": handle.results_by_position()[:n_real]})
        completed = handle.done or handle.cancelled
        verdicts = handle.verdicts_by_position()[:n_real]
        evalue = self.spec.verdict_engine == "evalue"
        if evalue and phase.offset_rule == "stream":
            # cumulative-wealth knockout: a stream phase's e-values fold
            # into the cell's ledger wealth ONCE, when the phase
            # completes — a stalled phase retries from its checkpoint,
            # and folding its partial wealth now would double-count on
            # the retry. Seam phases never reach here: their reads
            # overlap the stream words, so their evidence stays
            # knockout-only (the generic branch below).
            if completed:
                self._fold_wealth(k, groups, verdicts)
        else:
            for grp, v in zip(groups, verdicts):
                if v.decision == stitch.FAIL:
                    for i in grp:       # a failed seam binds both cells
                        self.ledger.decisions[i] = CELL_FAIL
                        self.ledger.decided_phase[i] = k
                elif (v.decision == stitch.PASS
                      and phase.offset_rule == "stream"
                      and k == len(self.phases()) - 1):
                    i = grp[0]          # survived the final wave
                    self.ledger.decisions[i] = CELL_PASS
                    self.ledger.decided_phase[i] = k
        return completed

    def _fold_wealth(self, k: int, groups, verdicts) -> None:
        """Fold one completed stream phase's per-cell e-process evidence
        into the ledger and decide what wealth now decides: FAIL at
        cumulative wealth >= 1/alpha (Ville boundary, valid mid-campaign);
        at the LAST currently-scheduled phase, PASS below the
        continuation band — a borderline cell (wealth in
        [band/alpha, 1/alpha)) is left UNDECIDED while continuation
        budget remains, which is what re-opens it."""
        log_thr = math.log(1.0 / self.spec.alpha)
        last = k == len(self.phases()) - 1
        band = self.spec.continue_band
        for grp, v in zip(groups, verdicts):
            i = grp[0]
            self.ledger.log_wealth[i] += v.log_wealth
            logw = float(self.ledger.log_wealth[i])
            if logw >= log_thr:
                self.ledger.decisions[i] = CELL_FAIL
                self.ledger.decided_phase[i] = k
            elif last:
                borderline = (band > 0.0
                              and logw >= log_thr + math.log(band))
                if (borderline and self.ledger.continuations
                        < self.spec.max_continuations):
                    continue            # re-opened by the next phase
                self.ledger.decisions[i] = CELL_PASS
                self.ledger.decided_phase[i] = k

    # -- public ------------------------------------------------------------

    def _wants_continuation(self) -> bool:
        """True when finishing the current phase list would still leave
        borderline (undecided) cells AND the spec's continuation budget
        has re-openings left — the condition under which the campaign
        appends a continuation phase instead of finishing."""
        if (self.spec.verdict_engine != "evalue"
                or self.spec.continue_band <= 0.0
                or self.ledger.continuations >= self.spec.max_continuations):
            return False
        return bool(np.any(self.ledger.decisions == CELL_UNDECIDED))

    @property
    def complete(self) -> bool:
        """True once the ledger records every phase as done and no
        borderline cell is waiting on a continuation re-opening."""
        if self.ledger.phases_done < len(self.phases()):
            return False
        return not self._wants_continuation()

    def run_next_phase(self) -> bool:
        """Drive ONE remaining phase — the serve daemon's unit of work
        (a campaign ticket advances a phase per daemon step instead of
        monopolizing the loop). Returns True when the phase COMPLETED
        and the ledger advanced; False when the campaign is already
        complete, or the phase stalled with jobs HELD through the retry
        budget (the saved ledger + per-phase checkpoint make the next
        call retry it instead of freezing its cells forever)."""
        phases = self.phases()
        k = self.ledger.phases_done
        if k >= len(phases):
            if not self._wants_continuation():
                return False
            # open a continuation: record it in the ledger FIRST (the
            # phase list is a pure function of (spec, ledger), so a
            # crash right after this save resumes into the same phase)
            self.ledger.continuations += 1
            self._save_ledger()
            phases = self.phases()
            emit_progress(self.spec.progress,
                          f"continuation {self.ledger.continuations}: "
                          f"{len(self._survivor_idx())} borderline "
                          f"cell(s) re-opened on fresh stream words")
        if not self._run_phase(k, phases[k]):
            self._save_ledger()     # decisions so far; phase k retries
            return False
        self.ledger.phases_done = k + 1
        self._save_ledger()
        # drop the phase's resume file only AFTER the ledger records
        # the phase as done — a crash between the two must lose the
        # checkpoint-or-progress, never both
        ck = (f"{self.spec.ledger_path}.phase{k}"
              if self.spec.ledger_path else None)
        if ck and ckpt_io.exists(ck):
            os.remove(ck)
        return True

    def result_snapshot(self, wall_s: float = 0.0) -> CampaignResult:
        """The per-cell decision matrix as it stands — valid after any
        phase boundary, not just at completion (a serve ticket's interim
        and final result both come from here)."""
        lw = (np.asarray(self.ledger.log_wealth, np.float64).copy()
              if (self.spec.verdict_engine == "evalue"
                  and self.ledger.log_wealth is not None) else None)
        return CampaignResult(
            self.spec, self.spec.cells,
            np.asarray(self.ledger.decisions, np.int8).copy(),
            np.asarray(self.ledger.decided_phase, np.int8).copy(),
            [p.name for p in self.phases()], self.rounds_run, wall_s,
            log_wealth=lw, continuations=int(self.ledger.continuations))

    def run(self) -> CampaignResult:
        """Drive every remaining phase (resuming from the ledger) and
        return the per-cell decision matrix. An incomplete phase (jobs
        HELD through the retry budget) stops the campaign at that phase
        with its cells undecided; the saved ledger + per-phase
        checkpoint make the next ``run()`` retry it."""
        t0 = time.time()
        while not self.complete:
            if not self.run_next_phase():
                break
        return self.result_snapshot(time.time() - t0)


def screen(spec: CampaignSpec,
           session: Optional[PoolSession] = None) -> CampaignResult:
    """One-call campaign: build a session (or reuse one) and run."""
    return Campaign(session or PoolSession(), spec).run()
