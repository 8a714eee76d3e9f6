"""The battery pool's job function and round runners
(``repro/core/pool.py``, classic path).

A job is ``(job_id, seed, gen_id) -> (stat, p)``: generate the job's
power-of-two bucket of words from ``(seed, stream_table[job_id])`` with
the registered generator, then run the job's bound test kernel.
``job_id == -1`` is an idle slot and returns ``(0, nan)`` without
generating anything. A round runner covers the W slots of one round for
one generator (``make_round_runner``) or several (``make_fanout_runner``)
and brings the round's results to the host in one copy;
``make_batch_runner`` does the same for a whole plan, and
``run_sequential`` runs a table in order on one worker (the stock
TestU01 baseline).

Job results are a pure function of the job table, the generator and the
seed: which slot or round runs a job changes nothing, which is what
makes hold/release and replanning reconcilable (DESIGN.md §6).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import resolve_device
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


def _job_fn(entries: List[TestEntry], device):
    """``(job_id, seed, gen_id) -> (stat, p)`` as a float32 (2,) tensor on
    ``device``."""
    streams = stream_table(entries)
    sizes, bids = bucket_table(entries)
    idle = torch.tensor([0.0, float("nan")], dtype=torch.float32,
                        device=device)

    def run(job_id: int, seed: int, gen_id: int) -> torch.Tensor:
        if job_id < 0:
            return idle
        j = min(job_id, len(entries) - 1)
        bits = switch_block(gen_id, seed, int(streams[j]), sizes[bids[j]],
                            device=device)
        stat, p = entries[j].kernel(bits)
        return torch.stack([torch.as_tensor(v, device=device)
                            .to(torch.float32).reshape(()) for v in (stat, p)])

    return run


def _round(job, row: Sequence[int], seeds: Sequence[int],
           gen_ids: Sequence[int]):
    """One round for G generators: ``(stats, ps)`` of shape (G, W), in
    one device-to-host copy."""
    out = torch.stack([job(int(j), int(s), int(g))
                       for s, g in zip(seeds, gen_ids) for j in row])
    out = out.cpu().numpy().reshape(len(seeds), len(row), 2)
    return out[..., 0], out[..., 1]


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
