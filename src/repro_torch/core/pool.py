"""The battery pool's job function and round runners
(``repro/core/pool.py``).

A job is ``(job_id, seed, gen_id[, offset]) -> (stat, p)``: generate
the job's power-of-two bucket of words from ``(seed,
stream_table[job_id])`` with the registered generator (from word
``offset`` of that sequence, for a campaign's sub-stream), then run the
job's bound test kernel. ``job_id == -1`` is an idle slot and returns
``(0, nan)`` without generating anything. The runners:

  ``make_round_runner``     one round for one generator;
  ``make_fanout_runner``    one round for G generators;
  ``make_grid_runner``      one round for G (generator, sub-stream)
                            cells, each lane with its own word offset:
                            one runner serves every cell of every wave of
                            a campaign;
  ``make_external_runner``  one round for L captured-source lanes, whose
                            words ``gather_captured_bits`` reads on the
                            host and the runner copies to the device once
                            per round;
  ``make_batch_runner``     a whole plan for one generator.

Each brings its round's results to the host in one copy. Lanes of one
round that read the same words (a campaign pads its cell axis with
copies of its first cell) are computed once. ``run_sequential`` runs a
table in order on one worker (the stock TestU01 baseline).

Job results are a pure function of the job table, the bit source, the
seed and the offset: which slot or round runs a job changes nothing,
which is what makes hold/release, replanning and a resize of the pool
reconcilable (DESIGN.md §6), and a capture of a generator's words scores
bitwise what the generator scores. ``inject_round_faults`` is the one
place a simulated fault touches a round's results (DESIGN.md §12): on the
host, after the runner returned them, before they are folded.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.ints import MASK32
from repro_torch.core.battery import TestEntry
from repro_torch.rng.sources import switch_block


def word_bucket(n: int) -> int:
    """The power-of-two bucket a job's block is generated at: the
    smallest power of two >= n (0 for an empty block)."""
    return 0 if n <= 0 else 1 << max(int(n) - 1, 0).bit_length()


def bucket_table(entries: List[TestEntry]):
    """``(sizes, bucket_ids)``: the sorted distinct bucket sizes of the
    job table, and each job's index into them."""
    sizes = sorted({word_bucket(e.n_words) for e in entries})
    index = {s: i for i, s in enumerate(sizes)}
    bids = np.asarray([index[word_bucket(e.n_words)] for e in entries],
                      np.int32)
    return sizes, bids


def generated_words(entries: List[TestEntry]) -> int:
    """Words the bucketed job function generates for one pass."""
    return sum(word_bucket(e.n_words) for e in entries)


def read_words(entries: List[TestEntry]) -> int:
    """Words the kernels consume in one pass over the table."""
    return sum(e.n_words for e in entries)


def block_ratio(entries: List[TestEntry]) -> float:
    """generated/read words under bucketing (1.0 = nothing wasted)."""
    r = read_words(entries)
    return generated_words(entries) / r if r else 1.0


def stream_table(entries: List[TestEntry]) -> np.ndarray:
    """Per-job generator stream ids: identity for an unsplit battery,
    ``group + n_groups * part`` for sub-jobs."""
    if not entries:
        return np.zeros((0,), np.int32)
    n_groups = max(e.group for e in entries) + 1
    return np.asarray([e.group + n_groups * e.part for e in entries],
                      np.int32)


def _score(entry: TestEntry, bits, device) -> torch.Tensor:
    """``entry``'s kernel on ``bits``: ``(stat, p)`` as a float32 (2,)
    tensor on ``device``. The generator and captured paths share it, so
    the same bits score the same way through either."""
    stat, p = entry.kernel(bits)
    return torch.stack([torch.as_tensor(v, device=device)
                        .to(torch.float32).reshape(()) for v in (stat, p)])


def _job_fn(entries: List[TestEntry], device):
    """``(job_id, seed, gen_id, offset=None) -> (stat, p)`` as a float32
    (2,) tensor on ``device``; ``offset`` is a grid cell's word offset
    (``None`` is the classic path)."""
    streams = stream_table(entries)
    sizes, bids = bucket_table(entries)
    idle = torch.tensor([0.0, float("nan")], dtype=torch.float32,
                        device=device)

    def run(job_id: int, seed: int, gen_id: int,
            offset=None) -> torch.Tensor:
        if job_id < 0:
            return idle
        j = min(job_id, len(entries) - 1)
        bits = switch_block(gen_id, seed, int(streams[j]), sizes[bids[j]],
                            offset, device=device)
        return _score(entries[j], bits, device)

    return run


def _round(job, row: Sequence[int], seeds: Sequence[int],
           gen_ids: Sequence[int], offsets: Optional[Sequence] = None):
    """One round for G lanes: ``(stats, ps)`` of shape (G, W), in one
    device-to-host copy. Lanes with equal (seed, gen_id, offset) are
    computed once."""
    if offsets is None:
        offsets = [None] * len(seeds)
    lanes = [(int(s), int(g), None if o is None else int(o))
             for s, g, o in zip(seeds, gen_ids, offsets)]
    unique = list(dict.fromkeys(lanes))
    out = torch.stack([job(int(j), *lane) for lane in unique for j in row])
    out = out.cpu().numpy().reshape(len(unique), len(row), 2)
    pick = [unique.index(lane) for lane in lanes]
    return out[pick, :, 0], out[pick, :, 1]


def make_round_runner(entries: List[TestEntry], mesh,
                      on_trace: Optional[Callable[[], None]] = None):
    """``(round_assignment (W,), seed, gen_id) -> (stats, ps)``, each (W,)."""
    job = _job_fn(entries, mesh.device)
    if on_trace is not None:
        on_trace()

    def round_fn(row, seed, gen_id):
        stats, ps = _round(job, row, [seed], [gen_id])
        return stats[0], ps[0]

    return round_fn


def make_fanout_runner(entries: List[TestEntry], mesh,
                       on_trace: Optional[Callable[[], None]] = None):
    """``(round_assignment (W,), seeds (G,), gen_ids (G,)) -> (stats,
    ps)``, each (G, W): G generators assessed in one round."""
    job = _job_fn(entries, mesh.device)
    if on_trace is not None:
        on_trace()

    def round_fn(row, seeds, gen_ids):
        return _round(job, row, seeds, gen_ids)

    return round_fn


def make_grid_runner(entries: List[TestEntry], mesh,
                     on_trace: Optional[Callable[[], None]] = None):
    """``(round_assignment (W,), seeds (G,), gen_ids (G,), offsets (G,))
    -> (stats, ps)``, each (G, W): the fan-out with a word offset per
    lane, so one runner serves every (generator, sub-stream) cell of a
    campaign, wave after wave (DESIGN.md §8)."""
    job = _job_fn(entries, mesh.device)
    if on_trace is not None:
        on_trace()

    def round_fn(row, seeds, gen_ids, offsets):
        return _round(job, row, seeds, gen_ids, offsets)

    return round_fn


@dataclasses.dataclass
class CapturedRound:
    """One round's captured words, read on the host. ``words`` is one
    flat int32 buffer holding the uint32 words' bits (pinned when the
    pool's device is cuda); ``spans[u][w]`` is the ``(start, n)`` of slot
    w's block for unique lane u (``None`` for an idle slot); lane l is
    unique lane ``lane_of[l]``; ``seconds`` is the host time of the
    read."""
    words: torch.Tensor
    spans: List[List[Optional[tuple]]]
    lane_of: List[int]
    seconds: float = 0.0

    @property
    def nbytes(self) -> int:
        """Bytes the round copies to the device."""
        return 4 * int(self.words.numel())


def gather_captured_bits(entries: List[TestEntry], jobs, lanes,
                         pin: bool = False) -> CapturedRound:
    """Host prefetch for ``make_external_runner``: for each lane
    ``(source, seed, offset)`` (offset ``None`` is no offset) and each
    slot of the round ``jobs``, the job's power-of-two bucket read from
    the source's shard ``stream_table[job]`` from word ``offset``. The
    bucket sizes and stream ids mirror ``_job_fn``, so each kernel gets
    the words the generator path would give it. An idle slot reads
    nothing, and so does a lane that reads what an earlier one reads (a
    capture ignores the seed); the reference's zero padding to the
    widest bucket is not built, since no kernel reads it."""
    t0 = time.perf_counter()
    streams = stream_table(entries)
    sizes, bids = bucket_table(entries)
    jobs = [int(j) for j in np.asarray(jobs).reshape(-1)]
    # a capture has no seed, and no offset reads what offset 0 reads
    keys = [(src, int(off or 0)) for src, _, off in lanes]
    unique = list(dict.fromkeys(keys))
    spans, total = [], 0
    for _ in unique:
        row = []
        for j in jobs:
            nb = 0 if j < 0 else sizes[bids[min(j, len(entries) - 1)]]
            row.append(None if j < 0 else (total, nb))
            total += nb
        spans.append(row)
    buf = torch.empty((total,), dtype=torch.int32, pin_memory=pin)
    view = buf.numpy().view(np.uint32)
    for (src, off), row in zip(unique, spans):
        for j, span in zip(jobs, row):
            if span is not None:
                start, nb = span
                view[start:start + nb] = src.words(
                    int(streams[min(j, len(entries) - 1)]), nb, off)
    return CapturedRound(buf, spans, [unique.index(k) for k in keys],
                         time.perf_counter() - t0)


def _external_job_fn(entries: List[TestEntry], device):
    """``(job_id, bits) -> (stat, p)``: the captured-buffer twin of
    ``_job_fn``, with no generator; the same idle sentinel and kernel
    table, so the same bits score the same through either."""
    idle = torch.tensor([0.0, float("nan")], dtype=torch.float32,
                        device=device)

    def run(job_id: int, bits) -> torch.Tensor:
        if job_id < 0:
            return idle
        return _score(entries[min(job_id, len(entries) - 1)], bits, device)

    return run


def make_external_runner(entries: List[TestEntry], mesh,
                         on_trace: Optional[Callable[[], None]] = None):
    """``(round_assignment (W,), CapturedRound) -> (stats, ps)``, each
    (L, W): the captured-source twin of the fan-out. The round's words go
    to the device in one copy, 4 bytes a word, and are widened there
    (``& 0xFFFFFFFF``, so a word at or above 2^31 keeps its unsigned
    value); each slot's kernel gets its job's bucket, as from
    ``_job_fn``."""
    device = mesh.device
    job = _external_job_fn(entries, device)
    if on_trace is not None:
        on_trace()

    def round_fn(row, gathered: CapturedRound):
        words = gathered.words.to(device, non_blocking=True)
        words = words.to(torch.int64) & MASK32
        out = [job(-1 if span is None else int(j),
                   None if span is None
                   else words[span[0]:span[0] + span[1]])
               for spans in gathered.spans for j, span in zip(row, spans)]
        out = torch.stack(out).cpu().numpy().reshape(
            len(gathered.spans), len(row), 2)
        return out[gathered.lane_of, :, 0], out[gathered.lane_of, :, 1]

    return round_fn


def make_batch_runner(entries: List[TestEntry], mesh):
    """Whole-plan runner: ``(plan (R, W), seed, gen_id) -> (stats, ps)``,
    each (R, W), brought to the host in one copy (benchmarks use it; the
    checkpointing driver runs round by round)."""
    job = _job_fn(entries, mesh.device)

    def plan_fn(plan, seed, gen_id):
        plan = np.asarray(plan)
        stats, ps = _round(job, plan.reshape(-1), [seed], [gen_id])
        return stats[0].reshape(plan.shape), ps[0].reshape(plan.shape)

    return plan_fn


def inject_round_faults(injector, round_idx, row, arrays, deadline=None):
    """The host-side fault-injection boundary (DESIGN.md §12). The round
    loop in ``core/api.py`` calls it after a runner has brought the round's
    results to the host as numpy arrays and before ``stitch.fold``, so a
    simulated eviction, corruption or straggle never reaches a kernel, a
    runner or anything a runner caches. ``arrays`` is the round's
    per-generator ``[(stats, ps), ...]`` (each (W,)), changed in place;
    returns ``(events, resize_to)`` of ``FaultInjector.apply_round``."""
    return injector.apply_round(round_idx, np.asarray(row), arrays,
                                deadline=deadline)


def _entry_signature(e: TestEntry) -> tuple:
    """Structural identity of an entry: everything ``_job_fn`` reads.
    Registry-built kernels are a pure function of (kname, backend,
    params); an entry with a custom callable (no kname) keys on the
    callable's identity."""
    return (e.kname or id(e.kernel), e.params, e.backend, e.n_words,
            e.group, e.part)


_SEQ_RUNNERS: dict = {}
_SEQ_RUNNERS_MAX = 32


def run_sequential(entries: List[TestEntry], seed: int, gen_id: int,
                   device=None):
    """Stock TestU01: every test in order on one worker (the baseline).
    Returns ``(stats, ps)``, each (K,). The job function is cached on the
    table's structural signature and the device, so equal tables (seed
    or generator sweeps, fresh ``build_battery`` results) reuse it; the
    cache keeps the newest 32."""
    dev = resolve_device(device)
    key = (str(dev), tuple(_entry_signature(e) for e in entries))
    job = _SEQ_RUNNERS.get(key)
    if job is None:
        job = _job_fn(entries, dev)
        if len(_SEQ_RUNNERS) >= _SEQ_RUNNERS_MAX:
            _SEQ_RUNNERS.pop(next(iter(_SEQ_RUNNERS)))
        _SEQ_RUNNERS[key] = job
    stats, ps = _round(job, range(len(entries)), [seed], [gen_id])
    return stats[0], ps[0]
