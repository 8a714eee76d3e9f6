"""The screening service's submission queue (``repro/serve/queue.py``).

The paper's usage model is "submit from your desk, poll while the pool
works". ``SubmissionQueue`` is that model as a long-lived daemon: one
``PoolSession`` (one device, one runner cache) serving many clients,
each of whom submits a ``RunSpec`` or ``CampaignSpec`` and gets back a
``Ticket`` with the HTCondor-shaped verbs (``poll``/``held``/
``release``/``cancel``/``result``). Three mechanisms make repeated,
many-client screening cheap (DESIGN.md §10):

  admission batching   pending specs that agree on ``admission_key``
                       (battery, scale, alpha, resolved backend, policy,
                       stop_on_verdict, fault plan, verdict engine) are
                       merged into ONE multi-generator spec: strangers
                       share each round, and the results are split back
                       per ticket (``stitch.demux_positions``). A lone
                       submission is admitted once it has waited
                       ``max_wait`` seconds, batched or not.
  result cache         every cell is content-addressed
                       (``serve/cache.py``); a repeat submission returns
                       its stored verdict with zero dispatches.
  crash recovery       a batch checkpoints to ``batch-<digest>.ck`` under
                       ``state_dir`` (checkpoint v5, the name derived from
                       the batch's cells as the reference derives it), and
                       the cache persists there too: a restarted daemon of
                       either package, given the same submissions, forms
                       the same batch and resumes its rounds; a campaign
                       ticket resumes from its own ledger.

The backend a cell is filed under is resolved on the session's device
(``auto`` is ``accelerated`` on an H100, ``reference`` on the CPU, as the
reference resolves ``auto`` on the CPU), so the digests agree with the
reference's for the same work.

The loop is cooperative: ``step()`` does one unit of work (serve cache
hits, admit due groups, advance every active batch by one round and
every campaign by one phase). It is driven inline (``drain()``, or
``Ticket.result()``) or by the thread ``start()`` spawns, which runs on
the session's CUDA device and on the stream that was current when it was
started, so its kernels queue where an inline ``drain()`` would queue
them. Submissions are thread-safe either way.

    queue = SubmissionQueue(PoolSession(device="cuda"), state_dir="st")
    t1 = queue.submit(RunSpec("smallcrush", "splitmix64", seeds=(7,)))
    t2 = queue.submit(RunSpec("smallcrush", "pcg32", seeds=(7,)))
    queue.drain()                       # one shared dispatch per round
    t3 = queue.submit(RunSpec("smallcrush", "splitmix64", seeds=(7,)))
    assert t3.done                      # a cache hit: zero dispatches
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import threading
import time
from typing import Dict, List, Optional, Union

import torch

from repro_torch.core import stitch
from repro_torch.core.api import (BatteryResult, CampaignSpec, PoolSession,
                                  RunResult, RunSpec)
from repro_torch.core.campaign import Campaign
from repro_torch.core.faults import FaultPlan
from repro_torch.core.policies import RetryBudgetExhausted, get_policy
from repro_torch.serve.cache import CacheEntry, ResultCache, cell_digest
from repro_torch.stats import backends as kernel_backends

# ticket states (DESIGN.md §10; FAILED is §12's terminal for a batch whose
# retry budget ran out: such tickets resolve, they never hang)
QUEUED, RUNNING, DONE, CANCELLED, FAILED = (
    "queued", "running", "done", "cancelled", "failed")


@dataclasses.dataclass(frozen=True)
class _Cell:
    """One unit of cacheable work in a spec: a source position with its
    seed and stream offset, its address, and its ``BitSource`` (a merged
    batch is built from these, so captured sources ride through
    admission unchanged)."""
    generator: str
    seed: int
    offset: int
    digest: str
    source: object = None


def spec_cells(spec: RunSpec, device="cuda") -> List[_Cell]:
    """The spec's positions as cells. The digest folds in the spec's
    battery, scale and alpha, the backend resolved on ``device`` (so
    ``auto`` shares cells with what it resolves to), a captured source's
    file digest, and a verdict engine other than Bonferroni."""
    resolved = kernel_backends.resolve(spec.backend, device)
    cells = []
    for g, src in enumerate(spec.sources):
        gen = spec.generators[g]
        off = int(spec.offsets[g]) if spec.offsets is not None else 0
        cells.append(_Cell(gen, int(spec.seeds[g]), off,
                           cell_digest(spec.battery, spec.scale, gen,
                                       spec.seeds[g], off, spec.alpha,
                                       resolved,
                                       src.digest() if src.captured
                                       else "",
                                       engine=spec.verdict_engine),
                           src))
    return cells


def admission_key(spec: RunSpec, device="cuda") -> tuple:
    """The class admission batching merges within: specs that agree on
    (battery, scale, alpha, backend resolved on ``device``, policy and
    its signature, stop_on_verdict, fault plan, verdict engine) share
    one dispatch; their generators, seeds and offsets are per-position
    arguments of the merged run. A fault plan is part of the key, so
    strangers never inherit one."""
    policy = get_policy(spec.policy)
    return (spec.battery, float(spec.scale), float(spec.alpha),
            kernel_backends.resolve(spec.backend, device), policy.name,
            policy.signature(), bool(spec.stop_on_verdict), spec.inject,
            spec.verdict_engine)


class Ticket:
    """A client's handle on one submission. ``poll()`` advances the
    daemon one step (unless its thread serves) and reports;
    ``held()``/``release()`` reach the shared batch run; ``cancel()``
    withdraws the ticket; ``result()`` waits for, or drives to, the end.
    ``cache_hits`` counts the ticket's cells served from the cache."""

    def __init__(self, queue: "SubmissionQueue", tid: str,
                 spec: Union[RunSpec, CampaignSpec], kind: str):
        self._queue = queue
        self.id = tid
        self.spec = spec
        self.kind = kind                      # "run" | "campaign"
        self.state = QUEUED
        self.submitted = time.monotonic()
        self.batch_id: Optional[int] = None
        self.cache_hits = 0
        self.failure: Optional[dict] = None         # a FAILED ticket's detail
        self._cached: Dict[int, CacheEntry] = {}    # position -> entry
        self._positions: Dict[int, int] = {}        # position -> batch pos
        self._campaign: Optional[Campaign] = None
        self._result = None
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        """True in a terminal state: DONE, CANCELLED or FAILED."""
        return self.state in (DONE, CANCELLED, FAILED)

    def poll(self) -> dict:
        """Advance the daemon one step (unless its thread is serving)
        and return this ticket's status."""
        if not self._queue.serving:
            self._queue.step()
        return self.status()

    def held(self) -> List[int]:
        """Job ids HELD in the shared batch this ticket rides on (empty
        while queued, served from the cache or finished)."""
        batch = self._queue._batch_of(self)
        return batch.handle.held() if batch else []

    def release(self) -> int:
        """condor_release on the shared batch: a manual release, which
        does not spend the retry budget, of the whole batch's HELD set."""
        batch = self._queue._batch_of(self)
        return batch.handle.release() if batch else 0

    def cancel(self) -> bool:
        """Withdraw the submission: a queued ticket leaves the pending
        set, a running one is marked cancelled and its results are
        dropped when the batch ends, while the batch runs on for the
        other riders. Returns True if the state changed."""
        return self._queue._cancel(self)

    def result(self, timeout: Optional[float] = None):
        """Block until the ticket ends and return its ``RunResult``
        (``BatteryResult`` for several generators, ``CampaignResult``
        for a campaign). With the daemon thread running this waits;
        otherwise it drives the queue. ``timeout`` seconds raise
        ``TimeoutError``. A FAILED ticket raises ``RetryBudgetExhausted``
        with the HELD job ids; a cancelled one ``RuntimeError``."""
        if self._queue.serving:
            if not self._event.wait(timeout):
                raise TimeoutError(f"ticket {self.id} not done within "
                                   f"{timeout}s")
        else:
            deadline = (time.monotonic() + timeout
                        if timeout is not None else None)
            while not self.done:
                worked = self._queue.step(flush=True)
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ticket {self.id} not done "
                                       f"within {timeout}s")
                if not worked and not self.done:
                    raise RuntimeError(
                        f"ticket {self.id} stalled: the queue reports "
                        "no work left but the ticket is not terminal")
        if self.state == CANCELLED:
            raise RuntimeError(f"ticket {self.id} was cancelled")
        if self.state == FAILED:
            raise RetryBudgetExhausted(self.failure["held_jobs"],
                                       self.failure["retries"])
        return self._result

    def status(self) -> dict:
        """A condor_q-shaped snapshot: state, batch, cache hits, the
        failure of a FAILED ticket, the shared batch's counters while it
        runs, and a campaign's phases done."""
        out = {"ticket": self.id, "kind": self.kind, "state": self.state,
               "batch": self.batch_id, "cache_hits": self.cache_hits}
        if self.failure is not None:
            out["failure"] = dict(self.failure)
        batch = self._queue._batch_of(self)
        if batch is not None:
            run = batch.handle.status()
            out.update({"rounds_run": run["rounds_run"],
                        "pending_rounds": run["pending_rounds"],
                        "held": run["held"], "retries": run["retries"]})
        if self.kind == "campaign" and self._campaign is not None:
            out["phases_done"] = int(self._campaign.ledger.phases_done)
        return out


@dataclasses.dataclass
class _Batch:
    """One admitted group: its cells in digest order, the merged spec's
    run handle, and the tickets riding on it."""
    id: int
    key: tuple
    cells: List[_Cell]
    tickets: List[Ticket]
    handle: object                  # BatteryRun
    digest: str


class SubmissionQueue:
    """The daemon: one ``PoolSession``, many clients (module docstring).
    ``session`` defaults to a new one on ``cuda``. ``state_dir`` persists
    the result cache (``state_dir/cache``) and the batch checkpoints
    across restarts. ``max_wait`` (seconds) is the longest a submission
    waits for companions. ``inject`` applies one ``faults.FaultPlan`` to
    every batch the daemon forms (chaos testing, DESIGN.md §12: the
    recovered results are bitwise, so they still fill the cache
    correctly)."""

    def __init__(self, session: Optional[PoolSession] = None,
                 cache: Optional[ResultCache] = None,
                 state_dir: Optional[str] = None,
                 max_wait: float = 0.0,
                 inject: Optional[FaultPlan] = None):
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.session = session or PoolSession()
        self.inject = inject
        self._peak_workers = self.session.n_workers
        self.state_dir = state_dir
        if state_dir:
            os.makedirs(state_dir, exist_ok=True)
        self.cache = cache if cache is not None else ResultCache(
            os.path.join(state_dir, "cache") if state_dir else None)
        self.max_wait = float(max_wait)
        self._lock = threading.RLock()
        self._tickets: Dict[str, Ticket] = {}
        self._pending: List[Ticket] = []
        self._active: List[_Batch] = []
        self._next_ticket = 0
        self._next_batch = 0
        self.dispatch_rounds = 0        # rounds dispatched, in total
        self.batches_formed = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- client surface ----------------------------------------------------

    def submit(self, spec: Union[RunSpec, CampaignSpec]) -> Ticket:
        """Accept one submission and return its ticket at once. A
        ``RunSpec`` whose every cell is in the cache is DONE here, with
        zero dispatches; anything else waits for admission."""
        with self._lock:
            tid = f"t{self._next_ticket}"
            self._next_ticket += 1
            kind = "campaign" if isinstance(spec, CampaignSpec) else "run"
            ticket = Ticket(self, tid, spec, kind)
            self._tickets[tid] = ticket
            if kind == "run" and self._try_cache(ticket):
                return ticket
            self._pending.append(ticket)
            return ticket

    @property
    def serving(self) -> bool:
        """True while the daemon thread runs the loop."""
        return self._thread is not None and self._thread.is_alive()

    @property
    def idle(self) -> bool:
        """True when nothing is pending or running."""
        with self._lock:
            return not self._pending and not self._active

    def step(self, flush: bool = False) -> bool:
        """One unit of daemon work: complete the pending tickets the
        cache now serves, admit every group past its ``max_wait`` window
        (every group with ``flush``), then advance each batch by one
        round and each campaign by one phase. False means idle."""
        with self._lock:
            worked = self._admit(flush)
            worked = self._advance() or worked
            return worked

    def drain(self) -> None:
        """Run the loop inline until every ticket is terminal."""
        while self.step(flush=True):
            pass

    def start(self, poll_s: float = 0.01) -> "SubmissionQueue":
        """Start the daemon thread, which steps the loop and sleeps
        ``poll_s`` when idle. On a CUDA session the thread sets the
        session's device and runs on the stream current here. Returns
        self."""
        if self.serving:
            return self
        self._stop.clear()
        dev = torch.device(self.session.device)
        stream = None
        if dev.type == "cuda":
            index = (dev.index if dev.index is not None
                     else torch.cuda.current_device())
            stream = torch.cuda.current_stream(index)

        def _loop():
            with contextlib.ExitStack() as ctx:
                if stream is not None:
                    torch.cuda.set_device(index)
                    ctx.enter_context(torch.cuda.stream(stream))
                while not self._stop.is_set():
                    if not self.step():
                        time.sleep(poll_s)

        self._thread = threading.Thread(target=_loop,
                                        name="repro-torch-serve",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the daemon thread after its current step; pending work
        stays queued for a later ``start()``/``drain()``."""
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None

    def stats(self) -> dict:
        """Daemon counters: tickets, batches, dispatches, cache traffic,
        runner builds, and pool health: ``workers`` and ``status``,
        ``degraded`` once the pool shrank below its widest (a quarantine
        or a lost worker), while the daemon keeps serving."""
        with self._lock:
            cur = self.session.n_workers
            self._peak_workers = max(self._peak_workers, cur)
            return {"tickets": len(self._tickets),
                    "pending": len(self._pending),
                    "active_batches": len(self._active),
                    "batches": self.batches_formed,
                    "dispatch_rounds": self.dispatch_rounds,
                    "cache": {"hits": self.cache.hits,
                              "misses": self.cache.misses,
                              "entries": len(self.cache)},
                    "traces": self.session.total_traces,
                    "workers": cur,
                    "status": ("degraded" if cur < self._peak_workers
                               else "ok")}

    # -- cache path --------------------------------------------------------

    def _cells(self, spec: RunSpec) -> List[_Cell]:
        return spec_cells(spec, self.session.device)

    def _try_cache(self, ticket: Ticket) -> bool:
        """Complete the ticket from the cache when every cell hits; keep
        partial hits on the ticket, so its batch runs only the rest."""
        spec = ticket.spec
        cells = self._cells(spec)
        for g, cell in enumerate(cells):
            if g in ticket._cached:
                continue
            entry = self.cache.get(cell.digest, spec.stop_on_verdict)
            if entry is not None:
                ticket._cached[g] = entry
        ticket.cache_hits = len(ticket._cached)
        if len(ticket._cached) == len(cells):
            self._finalize_ticket(ticket, {}, rounds_run=0, retries=0,
                                  plan_rounds=0)
            return True
        return False

    # -- admission ---------------------------------------------------------

    def _admit(self, flush: bool) -> bool:
        """Campaign tickets start one by one; run tickets group by
        ``admission_key``, and each group past its window becomes one
        batch."""
        now = time.monotonic()
        worked = False
        groups: Dict[tuple, List[Ticket]] = {}
        for t in list(self._pending):
            if t.kind == "campaign":
                if flush or now - t.submitted >= self.max_wait:
                    self._pending.remove(t)
                    t._campaign = Campaign(self.session, t.spec)
                    t.state = RUNNING
                    worked = True
            else:
                groups.setdefault(admission_key(t.spec, self.session.device),
                                  []).append(t)
        for key, tickets in groups.items():
            oldest = min(t.submitted for t in tickets)
            if not flush and now - oldest < self.max_wait:
                continue
            worked = self._admit_group(key, tickets) or worked
        return worked

    def _admit_group(self, key: tuple, tickets: List[Ticket]) -> bool:
        """Merge one group into a single batch run."""
        riders: List[Ticket] = []
        need: Dict[str, _Cell] = {}
        for t in tickets:
            self._pending.remove(t)
            if self._try_cache(t):      # the cache may have filled since
                continue
            riders.append(t)
            for g, cell in enumerate(self._cells(t.spec)):
                if g not in t._cached:
                    need[cell.digest] = cell
        if not riders:
            return True
        # digest order: the same submissions on a restarted daemon form
        # the same batch, under the same checkpoint name
        cells = [need[d] for d in sorted(need)]
        pos = {c.digest: i for i, c in enumerate(cells)}
        for t in riders:
            t._positions = {g: pos[c.digest]
                            for g, c in enumerate(self._cells(t.spec))
                            if g not in t._cached}
        digest = hashlib.sha256(
            repr((key, tuple(c.digest for c in cells))).encode()
        ).hexdigest()[:16]
        spec = self._merged_spec(key, cells, riders, digest)
        batch = _Batch(self._next_batch, key, cells, riders,
                       self.session.submit(spec), digest)
        self._next_batch += 1
        self.batches_formed += 1
        for t in riders:
            t.state = RUNNING
            t.batch_id = batch.id
        self._active.append(batch)
        return True

    def _merged_spec(self, key: tuple, cells: List[_Cell],
                     riders: List[Ticket], digest: str) -> RunSpec:
        """The merged ``RunSpec``: one source position per unique cell,
        checkpointed to ``state_dir/batch-<digest>.ck``. It keeps the
        first rider's retry knobs (backoff, deadline, quarantine) with
        the group's largest budget; the daemon's ``inject`` plan takes
        precedence over a rider's."""
        (battery, scale, alpha, backend, _pname, _psig, sov, inject,
         engine) = key
        offsets = (tuple(c.offset for c in cells)
                   if any(c.offset for c in cells) else None)
        ck = (os.path.join(self.state_dir, f"batch-{digest}.ck")
              if self.state_dir else None)
        return RunSpec(
            battery, sources=tuple(c.source for c in cells),
            seeds=tuple(c.seed for c in cells), scale=scale,
            policy=riders[0].spec.policy,
            retry=dataclasses.replace(
                riders[0].spec.retry, max_retries=max(
                    t.spec.retry.max_retries for t in riders)),
            checkpoint_path=ck, alpha=alpha, stop_on_verdict=sov,
            verdict_engine=engine, backend=backend, offsets=offsets,
            inject=self.inject if self.inject is not None else inject)

    # -- advance -----------------------------------------------------------

    def _advance(self) -> bool:
        """One round per active batch, one phase per active campaign."""
        worked = False
        for batch in list(self._active):
            worked = self._advance_batch(batch) or worked
        for t in list(self._tickets.values()):
            if t.kind == "campaign" and t.state == RUNNING:
                worked = self._advance_campaign(t) or worked
        return worked

    def _advance_batch(self, batch: _Batch) -> bool:
        """Dispatch one round of the batch, or one release pass of the
        drive loop's budget, and finalize it once ``BatteryRun.drive``
        would stop. A batch whose budget ran out with jobs HELD goes to
        ``_fail_batch``: every rider resolves and the daemon serves on."""
        h = batch.handle
        if h.pending_rounds:
            before = h.rounds_run
            h.poll()
            self.dispatch_rounds += h.rounds_run - before
            if h.pending_rounds or not (h.done or h.cancelled):
                return True
        if not (h.done or h.cancelled) and h.held():
            if h.driver_retries < h.spec.retry.max_retries:
                h._driver_release()
                return True
            self._fail_batch(batch)
            return True
        self._finalize_batch(batch)
        return True

    def _advance_campaign(self, ticket: Ticket) -> bool:
        """One campaign phase; the ticket is DONE when the campaign is
        complete or a phase stalls HELD through the retry budget (as
        ``Campaign.run`` stops)."""
        camp = ticket._campaign
        before = camp.rounds_run
        progressed = camp.run_next_phase()
        self.dispatch_rounds += camp.rounds_run - before
        if camp.complete or not progressed:
            ticket._result = camp.result_snapshot(
                time.monotonic() - ticket.submitted)
            self._terminate(ticket, DONE)
        return True

    # -- finalize and demultiplex ------------------------------------------

    def _entries(self, h, per_res) -> List[CacheEntry]:
        """One cache entry per batch position; those that can serve
        someone (``serves(stop_on_verdict=True)``) are stored."""
        n_total = len(self.session.entries(h.spec))
        return [CacheEntry.from_results(res, n_total, h.spec.alpha,
                                        engine=h.spec.verdict_engine)
                for res in per_res]

    def _deliver(self, batch: _Batch, per_res, riders: List[Ticket]) -> None:
        """Split the batch's per-position results among ``riders`` and
        finalize each."""
        h = batch.handle
        groups = {t.id: sorted(t._positions.values()) for t in riders}
        sliced = stitch.demux_positions(per_res, groups)
        for t in riders:
            by_batch_pos = dict(zip(groups[t.id], sliced[t.id]))
            per_cell = {g: by_batch_pos[p] for g, p in t._positions.items()}
            self._finalize_ticket(t, per_cell, rounds_run=h.rounds_run,
                                  retries=h.retries,
                                  plan_rounds=h.plan_rounds)

    def _finalize_batch(self, batch: _Batch) -> None:
        """Store every cell's outcome, hand each riding ticket its own
        positions, and retire the batch."""
        per_res = batch.handle.results_by_position()
        for c, entry in zip(batch.cells, self._entries(batch.handle,
                                                       per_res)):
            if entry.serves(stop_on_verdict=True):
                self.cache.put(c.digest, entry)
        self._deliver(batch, per_res,
                      [t for t in batch.tickets if t.state != CANCELLED])
        self._active.remove(batch)

    def _fail_batch(self, batch: _Batch) -> None:
        """Resolve a batch whose retry budget ran out, without hanging or
        poisoning the cache: cells that can serve someone are still
        stored (an undecided partial never is), riders whose own cells
        all serve them are DONE, and every other rider is FAILED with
        its reason, the HELD job ids and the passes spent, which
        ``Ticket.result()`` raises as ``RetryBudgetExhausted``."""
        h = batch.handle
        held = [int(j) for j in h.held()]
        per_res = h.results_by_position()
        entries = self._entries(h, per_res)
        for c, entry in zip(batch.cells, entries):
            if entry.serves(stop_on_verdict=True):
                self.cache.put(c.digest, entry)
        live = [t for t in batch.tickets if t.state != CANCELLED]
        salvaged = [t for t in live
                    if all(entries[p].serves(
                        stop_on_verdict=t.spec.stop_on_verdict)
                        for p in t._positions.values())]
        self._deliver(batch, per_res, salvaged)
        for t in live:
            if t not in salvaged:
                t.failure = {
                    "reason": (f"retry budget exhausted after "
                               f"{h.driver_retries} release pass(es)"),
                    "held_jobs": held, "retries": h.driver_retries}
                self._terminate(t, FAILED)
        self._active.remove(batch)

    def _finalize_ticket(self, ticket: Ticket,
                         dispatched: Dict[int, Dict[int, tuple]],
                         rounds_run: int, retries: int,
                         plan_rounds: int) -> None:
        """Build the ticket's ``RunResult``/``BatteryResult`` from its
        cached cells and its batch positions: what ``BatteryRun.result()``
        returns for the ticket's spec alone."""
        spec = ticket.spec
        entries = self.session.entries(spec)
        wall = time.monotonic() - ticket.submitted
        runs: Dict[str, RunResult] = {}
        for g, gen in enumerate(spec.generators):
            combined = (ticket._cached[g].results
                        if g in ticket._cached else dispatched[g])
            verdict = stitch.verdict_for(spec.verdict_engine)(
                combined, len(entries), spec.alpha)
            rep = stitch.report(entries, combined, gen, spec.seeds[g])
            runs[gen] = RunResult(combined, rep, rounds_run, retries,
                                  wall, plan_rounds, verdict=verdict)
        if spec.n_generators == 1:
            ticket._result = runs[spec.generators[0]]
        else:
            ticket._result = BatteryResult(spec, runs, rounds_run,
                                           retries, wall)
        self._terminate(ticket, DONE)

    # -- bookkeeping -------------------------------------------------------

    def _terminate(self, ticket: Ticket, state: str) -> None:
        """Move a ticket to a terminal state and wake its waiters."""
        ticket.state = state
        ticket._event.set()

    def _batch_of(self, ticket: Ticket) -> Optional[_Batch]:
        with self._lock:
            for b in self._active:
                if ticket in b.tickets:
                    return b
        return None

    def _cancel(self, ticket: Ticket) -> bool:
        with self._lock:
            if ticket.done:
                return False
            if ticket in self._pending:
                self._pending.remove(ticket)
            self._terminate(ticket, CANCELLED)
            return True
