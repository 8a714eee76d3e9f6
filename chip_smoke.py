#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (details in ``reports/chip_smoke/chip_smoke.json``):

1. device: the card's name and power limit (nvidia-smi);
2. build: the four CUDA kernels compiled from the checkout for sm_90a,
   one nvcc each, started together; the flash-attention library's SASS
   must hold tensor-core (HGMMA) instructions, and the mwc library's no
   CALL (its product mod the prime has no software 128-bit division);
3. kernels: the histogram and GF(2)-rank kernels against their plain
   PyTorch versions on the card, bitwise, at the parity shapes below
   (every histogram route and its boundaries; matrices of every rank
   0-32, through the int64 entry); the flash-attention kernel against
   its plain version at the reference suite's shapes; the mwc kernel
   against its plain loop, bitwise, at every BigCrush bucket (2^10-2^20
   words; plan, per-call and device times printed), around PR 18's
   64-word chunk, at 2^23 - 1 and 2^23, and at every length up to 2^23
   where its launch plan changes its layout or block count, from several
   seeds, two whose start carry is >= a (found by search) and the largest
   start state; an empty launch (``torch.cuda._sleep(0)``) timed the same
   way, the part of a call that no kernel's design removes; the serving shapes
   (bfloat16 and float32), one padded length and the tensor-core route's
   softcap and MQA dh-64 cases, within
   the reference suite's tolerances (2e-5 float32, 2e-2 bfloat16); the
   tensor-core route also row by row against its own arithmetic emulated
   in float32 (``tests/test_torch_flash.py``: P in bfloat16), each row
   within WGMMA_ROW_RTOL of its largest value;
   CUDA-event medians of each kernel, its plain version and the library
   yardstick (``torch.bincount``, ``scaled_dot_product_attention``; timed
   here, used nowhere in the port); at the bfloat16 tensor-core shapes
   also the CUDA-core route on the same inputs (checked and timed, not
   counted). Every kernel, sdpa and the CUDA-core route also get a
   device time per call (``device_ms``: calls queued behind a sleep
   kernel, so the host's launch work is hidden). Integer work is
   bounded at the INT32 rate, floating point at the float32 or bf16
   tensor-core rate;
4. main path: ``repro_torch.launch.battery`` on cuda with
   ``--backend accelerated``: BigCrush at scale 1.0 and the adaptive
   SmallCrush acceptance run, splitmix64 + randu. Launch counts are zeroed
   just before each run and read just after, and BigCrush's kernel shapes
   are printed with their launches; SmallCrush is held against the
   reference's golden JSON (``src/repro_torch/golden``); then BigCrush
   x1.0 of mwc + splitmix64, whose mwc words come from the mwc kernel;
5. the same two runs with ``--backend reference``: same verdicts and the
   same (stat, p); then the warm wall time of BigCrush under both
   backends, in turns, and one more warm accelerated BigCrush under
   torch.profiler: kernels and device ms by name, device busy time and
   idle share, and a check that each histogram and gf2_rank call was one
   device kernel, none on the histogram's global-atomics route;
   resume: the BigCrush x1.0 command with ``--ckpt`` in a subprocess,
   SIGKILLed once its checkpoint holds a third of the job ids, run again
   (only the missing jobs; per-test (stat, p) and verdicts bitwise those
   of phase 4's uninterrupted run), and a third time (``rounds=0``); the
   host time of one checkpoint save; the same kill and resume under
   ``--adaptive --verdict-engine evalue`` (splitmix64 PASS, randu FAIL
   before its last test, the ``evidence`` key), held against the same
   run on ``--backend reference``: same verdicts and checked tests,
   log-wealth within the tolerance derived from the tests' p
   (``tests/test_torch_reference.py::log_wealth_tolerance``);
6. serve: qwen2-1.5b at full width on cuda, weights from seed 0, bfloat16
   compute: 4 requests of 512-token prompts with 64 greedy tokens each,
   then 2 of 2048 tokens with 16 each; 28 flash-attention launches per
   prefill, every one on the tensor-core (``wgmma``) route; then one
   profiled prefill at each shape and one decode step (device busy time,
   idle share, flash attention's device time, the top kernels);
7. serve parity: the 4 x 512 requests in float32 compute, once through the
   kernel and once with the model's attention rebound to the plain
   version: last-position logits within SERVE_LOGITS_ATOL and all greedy
   tokens equal. The bfloat16 run is repeated with the plain version and
   the first step where the tokens differ is reported (not checked);
8. captured bitstreams: splitmix64 captured on the card by
   ``capture_generator`` (106 shards x 2^20 words, 0.44 GB ``.npy`` in a
   temporary directory, deleted at the end: what BigCrush x1.0 reads),
   then BigCrush x1.0 of ``--gen randu --source file:...`` accelerated:
   the capture's every (stat, p) bitwise phase 4's splitmix64, randu
   FAIL, the host prefetch ms and bytes copied to the card per round,
   and the kernels' launches; the same command with ``--ckpt`` killed
   and resumed (bitwise), then resumed against a copy of the capture
   with one byte changed, which must be refused;
9. a generator-fleet campaign: 8 generators x 4 sub-streams of BigCrush
   at waves 0.25 and 1.0 after the seam phase (the reference's 8 x 4
   acceptance grid at full scale), phase by phase with wall time,
   rounds, cells knocked out and launches per phase; at most one runner
   build per phase; randu knocked out before the last wave; the same
   campaign on ``--backend reference``: the same decisions and decided
   phases, every (stat, p) within the contract; one warm x0.25 wave of
   one sub-stream per generator (8 cells) under torch.profiler, the
   device traced alone (device busy, idle share, top kernels); the CLI
   killed by SIGKILL once its ledger holds a phase,
   resumed to the same matrix, then run a third time (``rounds=0``);
   the CLI under ``--verdict-engine evalue``; and the capture cut to 2
   sub-streams at the default span of a x0.25 wave, screened beside
   splitmix64: its cells decided as splitmix64's;
10. elastic width and the fault domain, BigCrush x1.0 on the kernels:
   splitmix64, randu and mwc at W=8 fixed against 8 -> 3 -> 8 resized
   between polls (``PoolSession.resize``), under lpt and over_decompose,
   in turns: every (stat, p) bitwise, one runner build per width; the CLI
   with ``--ckpt --workers 8`` SIGKILLed at a third of the jobs and
   resumed with ``--workers 4`` (bitwise the uninterrupted run, then
   ``rounds=0``), and ``--resize-at 2:4,5:8`` (its ``resizes``); a
   composed fault plan at W=8 (evict, corrupt, straggle past the
   deadline, lose_worker to 6, a slot quarantined after 2 faults), in
   turns with the fault-free run: bitwise, the ledger replayed, host ms
   per round of injection, gate and health; the CLI under ``--inject``
   twice (the same ``faults`` ledger) and killed mid-fault with ``--ckpt``
   and resumed, bitwise phase 4's fault-free run;
11. the screening service (``repro_torch.serve``), BigCrush x1.0 on the
   kernels: the battery CLI with ``--serve --serve-state
   --serve-resubmit`` on splitmix64 and randu (2 tickets, 1 batch):
   every (stat, p) and verdict bitwise phase 4's classic run, the
   resubmit served from the cache with no dispatch, the reference's
   ``serve`` JSON keys; warm walls of the served and the classic
   BigCrush in turns (the host cost of serving, printed); the daemon CLI
   (``repro_torch.launch.serve``) on splitmix64, randu and mwc, run
   through here, then in a subprocess SIGKILLed once its
   ``batch-*.ck`` holds a third of the job ids, rerun (only the missing
   jobs; every cell bitwise the uninterrupted run's, and phase 4's) and
   run a third time (``dispatch_rounds=0``); a degraded daemon through
   the library (a 4-slot session whose slot 1 evicts every round,
   quarantined down): its ticket DONE, bitwise phase 4's, ``status``
   degraded.

Phase 3 times every kernel at the shapes the main paths gave it (BigCrush
for the battery kernels and mwc, phase 6 for flash attention).

Any failure raises, and the script exits non-zero without a result line;
the traceback and ``nvidia-smi -q`` go to ``reports/chip_smoke/chip_smoke_failure.txt``.
The kernels' JSON adds each kernel's launches in phases 8, 9, 10 and 11
(``launches_captured_bigcrush``, ``launches_campaign``,
``launches_elastic_faults``, ``launches_serve``) beside those of the
main path. The last three lines are the kernels' JSON, the card, and
``{"ok": true, "device": {...}}``.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "reports", "chip_smoke")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12       # float32 outside the tensor cores
TENSOR_BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores
# integer work (the battery kernels): Hopper's SM issues INT32 on 64 of
# its 128 lanes (NVIDIA's H100 white paper), so 132 SMs x 64 lanes x
# 1.98 GHz (boost clock) = 16.7e12 ops/s
INT32_OPS_PER_S = 16.7e12
# the GF(2) elimination's work per 32x32 matrix (gf2_rank.cu): 496 row
# pairs, a bit test and a predicated XOR each, and per row its lowest set
# bit (negate, AND) and the rank count (compare, add)
RANK_OPS_PER_MATRIX = 496 * 2 + 32 * 4

# (N, nbins): large shapes of each route, and the route boundaries of
# kernels/histogram/kernel.py::plan (COPY_MAX_BINS 57,344 and one more;
# HIST_MAX_BINS 65,536; CLUSTER_MAX_BINS 2^17 and one more)
HIST_PARITY = [(1 << 26, 4), (1 << 24, 22), (1 << 24, 4096),
               (1 << 26, 65536), (1 << 26, 1 << 20),
               (1 << 24, 57344), (1 << 24, 57345), (1 << 24, 1 << 17),
               (1 << 24, (1 << 17) + 1)]
# M: matrix i has rank i % 33, so every M >= 33 covers ranks 0-32
RANK_PARITY = [256, 1024, 1 << 16, 1 << 20]
MAIN_ARGS = [
    ("bigcrush", ["--battery", "bigcrush", "--gen", "splitmix64,randu",
                  "--scale", "1.0", "--seed", "7"]),
    ("smallcrush", ["--battery", "smallcrush", "--gen", "splitmix64,randu",
                    "--scale", "0.0625", "--seed", "7", "--adaptive"]),
]
# mwc: lengths around PR 18's 64-word chunk, odd and large, every
# BigCrush bucket (2^10-2^20 words a call) and 2^23 - 1, timed; start
# states from (seed, stream), the last two found by search with a start
# carry c0 >= a (tests/test_torch_rng.py::MWC_WIDE_CARRY), and the largest
# state (x0 = 2^32 - 1, c0 = a), whose first step passes the prime
# a*2^32 - 1; above MWC_ALL_STATES words the plain loop takes seconds, so
# two states only. Beside them, checked and not timed, every length up to
# 2^23 where the card's plan changes its layout or its block count
# (kernels/mwc/kernel.py::boundaries)
MWC_BUCKETS = [1 << e for e in range(10, 21)]
MWC_PARITY = sorted({1, 2, 63, 64, 65, (1 << 10) + 3, (1 << 23) - 1,
                     1 << 23, *MWC_BUCKETS})
MWC_SEEDS = [(7, 3), (42, 0), (123456, 77), (131490111, 0), (2010969873, 1)]
MWC_ALL_STATES = 1 << 20
MWC_BOUNDARY_LIMIT = 1 << 23
MWC_ARGS = ["--battery", "bigcrush", "--gen", "mwc,splitmix64", "--scale",
            "1.0", "--seed", "7"]
# phase 8: splitmix64 captured at the size BigCrush x1.0 reads (106 jobs,
# widest bucket 2^20 words), 0.44 GB, in a temporary directory
CAPTURE_SEED = 7
CAPTURE_SHARDS = 106
CAPTURE_STRIDE = 1 << 20
CAPTURED_ARGS = ["--battery", "bigcrush", "--gen", "randu", "--scale", "1.0"]
# phase 9: the reference's 8 x 4 acceptance grid at BigCrush's size
CAMPAIGN_ARGS = ["--campaign", "--battery", "bigcrush", "--gen",
                 "splitmix64,pcg32,threefry,lcg64,xorshift64s,msweyl,randu,"
                 "minstd", "--streams", "4", "--waves", "0.25,1.0",
                 "--seed", "7"]
# phase 10: elastic width and the fault domain at BigCrush x1.0 (106 jobs,
# 14 rounds at W=8), mwc on its kernel beside splitmix64 and randu
ELASTIC_BATTERY, ELASTIC_SCALE = "bigcrush", 1.0
ELASTIC_GENS = ("splitmix64", "randu", "mwc")
ELASTIC_ARGS = ["--battery", ELASTIC_BATTERY, "--gen", ",".join(ELASTIC_GENS),
                "--scale", str(ELASTIC_SCALE), "--seed", "7"]
# (rounds polled, then the width to resize to): 8 -> 3 -> 8 mid-battery
BOUNCE = [(4, 3), (8, 8)]
RESIZE_AT = "2:4,5:8"
# the composed plan at W=8 on splitmix64 and randu: an evict, a corrupt
# (p bit-flipped, caught by the gate), a straggle past the deadline, a
# worker lost (to 6), and slot 5 faulting (p 0.9) until quarantined after
# 2 faults in a row (the pool walks down until slot 5 is gone)
FAULT_GENS = ("splitmix64", "randu")
FAULT_RULES = [dict(kind="evict", round=0, slot=0),
               dict(kind="corrupt", round=1, slot=1),
               dict(kind="straggle", round=2, slot=2, delay_s=90.0),
               dict(kind="lose_worker", round=3, width=6),
               dict(kind="evict", slot=5, p=0.9)]
FAULT_RETRY = dict(max_retries=8, deadline=60.0, quarantine_after=2)
# the CLI's plan (the CLI sets no deadline or quarantine), with faults
# before and after the kill at a third of the jobs
CLI_FAULT_RULES = [dict(kind="evict", round=1, slot=0),
                   dict(kind="corrupt", round=3, slot=1),
                   dict(kind="lose_worker", round=4, width=6),
                   dict(kind="evict", round=8, slot=2),
                   dict(kind="straggle", round=9, slot=3, delay_s=5.0)]
# families whose float path was seen not to repeat bit for bit on the card
# (ROADMAP queue 3): only these are held to the parity tolerance, by name,
# when a resumed run is compared with an uninterrupted one
NONDETERMINISTIC_FAMILIES = ()
# (B, S, H, K, dh, softcap, dtype): the reference suite's four shapes
# (tests/test_kernels.py), the serving shapes in bfloat16 and in float32
# (the float32 cases hold the CUDA-core route's 4- and 16-tile kv loop at
# dh 128 to 2e-5), one padded length, and the tensor-core route's softcap
# and MQA dh-64 cases
FA_PARITY = [(2, 256, 4, 2, 64, 0.0, "float32"),
             (1, 384, 2, 2, 128, 50.0, "float32"),
             (1, 128, 8, 1, 64, 0.0, "float32"),
             (2, 256, 4, 4, 64, 0.0, "bfloat16"),
             (4, 512, 12, 2, 128, 0.0, "bfloat16"),
             (2, 2048, 12, 2, 128, 0.0, "bfloat16"),
             (4, 512, 12, 2, 128, 0.0, "float32"),
             (2, 2048, 12, 2, 128, 0.0, "float32"),
             (1, 200, 12, 2, 128, 0.0, "bfloat16"),
             (1, 384, 2, 2, 128, 50.0, "bfloat16"),
             (1, 128, 8, 1, 64, 0.0, "bfloat16")]
FA_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (batch, prompt length, generated tokens) of the serve phase
SERVE = [(4, 512, 64), (2, 2048, 16)]
# float32 serve parity, kernel vs plain: last-position logits are O(1)
# (random weights, scale 0.02); float32 rounding of two summation orders
# through 28 layers stays far below this
SERVE_LOGITS_ATOL = 1e-3
# phase 11: the reference's --serve JSON keys (src/repro/launch/battery.py,
# the serve_info dict), and the daemon's submissions: BigCrush x1.0 on the
# kernels, mwc's words from its kernel
SERVE_KEYS = {"state", "max_wait", "tickets", "batches", "dispatch_rounds",
              "cache", "traces", "resubmit"}
SERVE_TICKET_KEYS = {"ticket", "gen", "state", "batch", "cache_hits"}
SERVE_RESUBMIT_KEYS = {"ticket", "cache_hits", "done_at_submit",
                       "dispatches_added"}
DAEMON_SUBMISSIONS = [{"battery": "bigcrush", "gen": g, "seed": 7,
                       "scale": 1.0, "backend": "accelerated"}
                      for g in ("splitmix64", "randu", "mwc")]
GOLDEN = os.path.join(ROOT, "src", "repro_torch", "golden",
                      "smallcrush_splitmix64_randu_s7_x0.0625_adaptive.json")


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def median_ms(fn, reps=25, warmup=3):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, n=20, reps=5):
    """Device time per call of ``fn``, in ms: ``n`` calls enqueued back to
    back behind a sleep kernel, so that the device runs them without
    waiting for the host; CUDA events around the ``n`` calls, median over
    ``reps``. A sleep that ends before the host has enqueued the calls is
    doubled and the run repeated; a ``fn`` that waits for the device
    (``torch.bincount`` reads its input's maximum) never lets the queue
    build, and raises once the sleep passes about a second."""
    import torch
    fn()
    torch.cuda.synchronize()
    times, cycles = [], 20_000_000
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        if a.query():            # the device reached a: it waited on us
            cycles *= 2
            torch.cuda.synchronize()
            check(cycles < 1 << 31, "device_ms: the calls wait for the "
                                    "device, so no device time is measured")
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def bound_ms(n_bytes, n_ops, ops_per_s):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def hist_case(n, nbins, seed=0):
    """Check the histogram kernel at (N, nbins) against its plain version,
    bitwise, and time both, ``torch.bincount`` and the kernel's device
    time per call."""
    import torch
    from repro_torch.kernels.histogram.kernel import histogram
    from repro_torch.kernels.histogram.ref import histogram_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, nbins, (n,), generator=g, device="cuda",
                        dtype=torch.int32)
    got = histogram(idx, nbins)
    want = histogram_ref(idx, nbins)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"histogram N={n} k={nbins}: kernel != plain")
    # one increment per index
    bound, by = bound_ms(4 * n + 4 * nbins, n, INT32_OPS_PER_S)
    return {"n": n, "nbins": nbins, "max_abs_err": err,
            "ms": median_ms(lambda: histogram(idx, nbins)),
            "device_ms": device_ms(lambda: histogram(idx, nbins)),
            "plain_ms": median_ms(lambda: histogram_ref(idx, nbins)),
            "library_ms": median_ms(
                lambda: torch.bincount(idx, minlength=nbins)),
            "bound_ms": bound, "bound_by": by}


def rank_words(m, seed=0, device="cuda"):
    """(m, 32) int64 words of 32x32 bit matrices, matrix i of rank
    i % 33, and those ranks: i % 33 rows with distinct leading bits
    (independent), the others random XOR combinations of them, the 32
    rows shuffled."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    want = torch.arange(m, device=device) % 33
    k = torch.arange(32, device=device)
    low = torch.randint(0, 1 << 31, (m, 32), generator=g, device=device)
    base = (1 << (31 - k)) | (low & ((1 << (31 - k)) - 1))
    fixed = k[None, :] < want[:, None]     # row i is base row i
    base = torch.where(fixed, base, 0)
    words = torch.zeros((m, 32), dtype=torch.int64, device=device)
    for j in range(32):
        pick = torch.randint(0, 2, (m, 32), generator=g, device=device) == 1
        pick = torch.where(fixed, k[None, :] == j, pick)
        words ^= torch.where(pick, base[:, j:j + 1], 0)
    perm = torch.argsort(torch.rand((m, 32), generator=g, device=device), 1)
    return torch.gather(words, 1, perm), want.to(torch.int32)


def rank_case(m, seed=0):
    """Check the GF(2) rank kernel at M matrices of every rank 0-32, on
    the int64 words of the main path's entry (``ops.rank32``), against
    the plain version and the ranks built in; time the entry (``ms``,
    ``device_ms``) and the plain version."""
    import torch
    from repro_torch.kernels.gf2_rank.ops import rank32
    from repro_torch.kernels.gf2_rank.ref import gf2_rank_ref
    words, ranks = rank_words(m, seed)
    got = rank32(words)
    want = gf2_rank_ref(words)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(want, ranks), f"gf2_rank M={m}: plain version != "
                                    f"the ranks built in")
    check(torch.equal(got, want), f"gf2_rank M={m}: kernel != plain")
    # int64 words read once, ranks written once; the elimination's work
    bound, by = bound_ms(8 * 32 * m + 4 * m, RANK_OPS_PER_MATRIX * m,
                         INT32_OPS_PER_S)
    return {"m": m, "max_abs_err": err,
            "ms": median_ms(lambda: rank32(words)),
            "device_ms": device_ms(lambda: rank32(words)),
            "plain_ms": median_ms(lambda: gf2_rank_ref(words)),
            "library_ms": None, "bound_ms": bound, "bound_by": by}


def mwc_state(seed, stream):
    """The (x0, c0) that ``mwc_block`` starts from."""
    from repro_torch.rng.generators import _mix_seed
    s = _mix_seed(seed, stream) % (1 << 64)
    return (s >> 32) | 1, (s & 0xFFFFFFFF) | 1


def mwc_case(n, states):
    """Check the mwc kernel at ``n`` words from each state against the
    plain loop, bitwise; time the kernel (per call, device) and the loop
    (on the card's inputs: the loop, then the copy to the card) from the
    first state. Records the launch plan where the tree has one."""
    import torch
    from repro_torch.kernels.mwc import kernel as mk
    from repro_torch.kernels.mwc.ref import mwc_ref
    err = 0
    for x0, c0 in states:
        got = mk.mwc_words(x0, c0, n, "cuda")
        torch.cuda.synchronize()
        want = mwc_ref(x0, c0, n, "cpu")
        err = max(err, int((got.cpu() - want).abs().max()) if n else 0)
        check(torch.equal(got.cpu(), want),
              f"mwc n={n} state ({x0}, {c0}): kernel != plain")
    x0, c0 = states[0]
    # int64 words written once; one 32x32->64-bit multiply-add a word
    bound, by = bound_ms(8 * n, 2 * n, INT32_OPS_PER_S)
    slow = n > MWC_ALL_STATES
    plan = (list(mk.plan(n, mk.sm_count(torch.cuda.current_device())))
            if n and hasattr(mk, "plan") else None)
    return {"n": n, "states": len(states), "max_abs_err": float(err),
            "plan": plan,
            "ms": median_ms(lambda: mk.mwc_words(x0, c0, n, "cuda")),
            "device_ms": device_ms(lambda: mk.mwc_words(x0, c0, n, "cuda")),
            "plain_ms": median_ms(lambda: mwc_ref(x0, c0, n, "cuda"),
                                  reps=1 if slow else 3, warmup=0),
            "library_ms": None, "bound_ms": bound, "bound_by": by}


def mwc_boundary_check(states, limit):
    """The mwc kernel against the plain loop, bitwise, at every length up
    to ``limit`` where the card's plan changes its layout or block count:
    each state's loop is run once at the longest length it is checked at
    (``limit`` for the first and the largest state, ``MWC_ALL_STATES`` for
    the others) and each launch is held to its prefix. Returns the
    number of lengths and launches."""
    import torch
    from repro_torch.kernels.mwc import kernel as mk
    from repro_torch.kernels.mwc.ref import mwc_ref
    lengths = mk.boundaries(limit, mk.sm_count(torch.cuda.current_device()))
    launches = 0
    for i, (x0, c0) in enumerate(states):
        top = limit if i in (0, len(states) - 1) else MWC_ALL_STATES
        want = mwc_ref(x0, c0, top, "cuda")
        for n in lengths:
            if n <= top:
                got = mk.mwc_words(x0, c0, n, "cuda")
                check(torch.equal(got, want[:n]), f"mwc n={n} state ({x0}, "
                                                  f"{c0}): kernel != plain")
                launches += 1
    return len(lengths), launches


def print_battery(name, c):
    """One ``[kernels]`` line of a battery kernel: per-call times (CUDA
    events around one call), then device time per call."""
    if name == "histogram":
        shape = f"N={c['n']} k={c['nbins']}"
        extra = f", torch.bincount {c['library_ms']:.4f} ms"
    elif name == "mwc":
        shape = f"n={c['n']} ({c['states']} state(s))"
        extra = (f", plan (chunk, threads, blocks) {tuple(c['plan'])}"
                 if c.get("plan") else "")
    else:
        shape, extra = f"M={c['m']}", ""
    launches = (f" x{c['launches']} on the main path" if "launches" in c
                else "")
    print(f"[kernels] {name} {shape}{launches}: bitwise | kernel "
          f"{c['ms']:.4f} ms (device {c['device_ms']:.4f}), plain "
          f"{c['plain_ms']:.4f} ms{extra}, bound {c['bound_ms']:.4f} ms "
          f"({c['bound_by']})", flush=True)


def simt_attention(q, k, v, scale, softcap):
    """The CUDA-core flash-attention route on the same inputs, launched
    uncounted (``kernel._call``, not through the launcher): the yardstick
    of the tensor-core route at its own shapes. S a multiple of 128."""
    from repro_torch.kernels.flash_attention import kernel as fk
    rc, o = fk._call("simt", q, k, v, scale, softcap)
    check(rc == 0, f"flash_attention simt route: CUDA error {rc}")
    return o


def fa_case(b, s, h, kh, dh, cap, dtype, seed=0):
    """Check the flash-attention kernel against its plain version at
    q (B, S, H, dh), k/v (B, S, K, dh), and time both and the library
    call. ``ops.mha`` pads S to a multiple of 128; the kernel call is
    timed through it, as the model calls it. Where the tensor-core route
    takes the shape (S a multiple of 128), its output is also held, row by
    row, against its own arithmetic emulated in float32, and the CUDA-core
    route is checked and timed on the same inputs."""
    import torch
    import torch.nn.functional as F
    from test_torch_flash import WGMMA_ROW_RTOL, row_rel_err, wgmma_emulation
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import mha_ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, dh), generator=g, device="cuda").to(dt)
               for n in (h, kh, kh))
    scale = dh ** -0.5
    got = mha(q, k, v, scale=scale, softcap=cap)
    want = mha_ref(q, k, v, scale=scale, softcap=cap)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"flash_attention {b}x{s}: shape or non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(err <= FA_ATOL[dtype], f"flash_attention B{b} S{s} H{h} K{kh} "
          f"dh{dh} cap{cap} {dtype}: max |kernel - plain| {err} > "
          f"{FA_ATOL[dtype]}")
    # unmasked (query, key) pairs of the causal mask, on the real length;
    # QK^T and PV each take 2 * dh operations per pair
    esize = torch.finfo(dt).bits // 8
    n_ops = 4 * dh * b * h * s * (s + 1) // 2
    n_bytes = esize * dh * b * (2 * s * h + 2 * s * kh)
    peak = SCALAR_OPS_PER_S if dt == torch.float32 else TENSOR_BF16_FLOPS
    bound, by = bound_ms(n_bytes, n_ops, peak)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    def kernel():
        return mha(q, k, v, scale=scale, softcap=cap)

    def library():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    times = {"device_ms": device_ms(kernel), "library_ms": None,
             "library_device_ms": None}
    if not cap:
        times["library_ms"] = median_ms(library)
        times["library_device_ms"] = device_ms(library)
    kind = route(dt, dh)
    if kind == "wgmma" and s % 128 == 0:
        same = wgmma_emulation(q, k, v, scale=scale, softcap=cap)
        times["row_rel_err"] = row_rel_err(got, same)
        times["plain_row_rel_err"] = row_rel_err(got, want)
        times["row_rtol"] = WGMMA_ROW_RTOL
        check(times["row_rel_err"] <= WGMMA_ROW_RTOL, f"flash_attention "
              f"B{b} S{s} H{h} K{kh} dh{dh} cap{cap}: row-relative error "
              f"against its arithmetic {times['row_rel_err']} > "
              f"{WGMMA_ROW_RTOL}")
        del same
        old = simt_attention(q, k, v, scale, cap)
        torch.cuda.synchronize()
        times["simt_err"] = float((old.float() - want.float()).abs().max())
        check(times["simt_err"] <= FA_ATOL[dtype], f"flash_attention simt "
              f"B{b} S{s}: max |kernel - plain| {times['simt_err']}")
        times["simt_ms"] = median_ms(
            lambda: simt_attention(q, k, v, scale, cap))
        times["simt_device_ms"] = device_ms(
            lambda: simt_attention(q, k, v, scale, cap))
    return {"b": b, "s": s, "h": h, "kh": kh, "dh": dh, "softcap": cap,
            "dtype": dtype, "route": kind, **times,
            "max_abs_err": err, "atol": FA_ATOL[dtype],
            "ms": median_ms(kernel),
            "plain_ms": median_ms(lambda: mha_ref(q, k, v, scale=scale,
                                                  softcap=cap)),
            "bound_ms": bound, "bound_by": by, "peak_ops_per_s": peak}


def print_fa(c):
    """One ``[kernels]`` line: per-call times (CUDA events around one call,
    the host's launch work included), then device times per call."""
    lib = ("none (softcap)" if c["library_ms"] is None
           else f"{c['library_ms']:.4f} ms (device "
                f"{c['library_device_ms']:.4f})")
    simt = (f", row err vs its arithmetic {c['row_rel_err']:.3g} <= "
            f"{c['row_rtol']:.3g} (vs plain {c['plain_row_rel_err']:.3g}), "
            f"simt route {c['simt_ms']:.4f} ms (device "
            f"{c['simt_device_ms']:.4f}, err {c['simt_err']:.3g})"
            if "simt_ms" in c else "")
    print(f"[kernels] flash_attention B{c['b']} S{c['s']} H{c['h']} "
          f"K{c['kh']} dh{c['dh']} cap{c['softcap']} {c['dtype']} "
          f"({c['route']}): max err {c['max_abs_err']:.3g} <= {c['atol']} | "
          f"kernel {c['ms']:.4f} ms (device {c['device_ms']:.4f}), plain "
          f"{c['plain_ms']:.4f} ms, sdpa {lib}, bound {c['bound_ms']:.4f} ms "
          f"({c['bound_by']}){simt}", flush=True)


def greedy(params, prompts, cfg, gen_len):
    """One batch of greedy requests: prefill, then argmax -> decode_step.
    Returns the prefill's last-position logits, the (B, gen_len) tokens
    (the first from the prefill) and the prefill and decode seconds."""
    import torch
    from repro_torch.models.decode import decode_step, prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, cfg,
                            max_seq=prompts.shape[1] + gen_len)
    first = logits.float()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = logits.argmax(-1, keepdim=True)
    toks = [tok]
    for _ in range(gen_len - 1):
        logits, cache = decode_step(params, cache, tok, cfg)
        tok = logits.argmax(-1, keepdim=True)
        toks.append(tok)
    out = torch.cat(toks, dim=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(bool(torch.isfinite(first).all())
          and bool(torch.isfinite(logits.float()).all()),
          "serve: non-finite logits")
    check(first.shape == (prompts.shape[0], cfg.padded_vocab),
          f"serve: logits shape {tuple(first.shape)}")
    return first, out, t1 - t0, t2 - t1


def device_busy(fn, cpu=True):
    """Device busy ms of one call of ``fn`` (sum of its kernels' device
    time under torch.profiler; one stream, so they do not overlap), the
    flash-attention kernels' share of it (both routes: ``fa_wgmma``,
    ``fa_fwd``), the count and device ms of every kernel by name, most
    first, and the five that took the most. ``cpu=False`` traces the
    device alone: a run of a million kernels then takes minutes, not
    many, to trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "flash_ms": sum(e.self_device_time_total for e in kernels
                            if "fa_wgmma" in e.key or "fa_fwd" in e.key) / 1e3,
            "kernels": sum(e.count for e in kernels),
            "by_name": [(e.key, e.count, e.self_device_time_total / 1e3)
                        for e in kernels],
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in kernels[:5]]}


def prompts_for(cfg, batch, length, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, length), generator=g,
                         device="cuda")


def _kernel_fns():
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.gf2_rank.kernel import gf2_rank
    from repro_torch.kernels.histogram.kernel import histogram
    from repro_torch.kernels.mwc.kernel import mwc_words
    return {"histogram": histogram, "gf2_rank": gf2_rank,
            "flash_attention": flash_attention, "mwc": mwc_words}


def zero_counts():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for fn in _kernel_fns().values():
        fn.launches = 0
        fn.calls.clear()


def launch_counts():
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def run_cli(name, args, backend, codes=(1,)):
    """One main-path run through the CLI, in this process; returns its JSON
    report, with its standard output (also in ``OUT_DIR/<name>.log``)."""
    from repro_torch.launch import battery as cli
    path = os.path.join(OUT_DIR, f"{name}_{backend}.json")
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        code = cli.main(args + ["--backend", backend, "--json", path])
    wall = time.perf_counter() - t0
    with open(os.path.join(OUT_DIR, f"{name}_{backend}.log"), "w") as f:
        f.write(out.getvalue())
    check(code in codes, f"{name}/{backend}: exit {code}, want {codes}")
    with open(path) as f:
        rep = json.load(f)
    rep["_wall_s"] = wall
    rep["_out"] = out.getvalue()
    return rep


def words_generated(rep, scale):
    """Words the run generated: each executed job's power-of-two bucket."""
    from repro_torch.core.battery import build_battery
    from repro_torch.core.pool import word_bucket
    entries = build_battery(rep["battery"], scale, device="cpu")
    return sum(word_bucket(entries[t["index"]].n_words)
               for run in rep["runs"].values() for t in run["tests"]
               if t["p"] is not None)


def ran(test):
    """Whether a ``--json`` test entry holds a result. A run resumed from
    a checkpoint reports a test that one generator never ran with a NaN
    p (the checkpoint's (G, K) arrays hold NaN there), as the reference
    does; a run from scratch reports no p."""
    return test["p"] is not None and not math.isnan(test["p"])


def compare_runs(a, b, what, tol):
    """Same verdicts, checked tests and failures; (stat, p) within tol."""
    for gen, ra in a["runs"].items():
        rb = b["runs"][gen]
        for key in ("verdict", "tests_checked", "failed_tests"):
            check(ra[key] == rb[key], f"{what} {gen}: {key} {ra[key]} != "
                                      f"{rb[key]}")
        for ta, tb in zip(ra["tests"], rb["tests"]):
            check(ran(ta) == ran(tb),
                  f"{what} {gen} {ta['name']}: ran in one run only")
            if not ran(ta):
                continue
            ok_s = math.isclose(ta["stat"], tb["stat"], rel_tol=1e-5,
                                abs_tol=1e-7)
            ok_p = abs(ta["p"] - tb["p"]) <= tol(ta, tb)
            check(ok_s and ok_p, f"{what} {gen} {ta['name']}: "
                                 f"{ta['stat']}/{ta['p']} vs "
                                 f"{tb['stat']}/{tb['p']}")


def run_proc(name, args, ckpt, kill_when=None, flag="--ckpt",
             module="repro_torch.launch.battery"):
    """The battery CLI (or ``module``: the serve daemon's) in a subprocess
    with ``--ckpt ckpt`` (or ``flag``: ``--ledger`` for a campaign,
    ``--state`` for the daemon); with ``kill_when``, SIGKILLed once it
    returns true (asked after each progress line of the battery CLI, and
    every 2 ms for the daemon, which prints none). Returns the exit code,
    the standard output, the JSON report (None when killed or failed) and
    the seconds it ran."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    path = os.path.join(OUT_DIR, f"{name}.json")
    if os.path.exists(path):
        os.remove(path)
    cmd = [sys.executable, "-m", module, *args, flag, ckpt, "--json", path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, bufsize=1)
    watcher = None
    if kill_when and module != "repro_torch.launch.battery":
        def watch():
            while proc.poll() is None:
                if kill_when():
                    proc.kill()
                    return
                time.sleep(0.002)
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if (kill_when and watcher is None
                    and line.lstrip().startswith("round ") and kill_when()):
                proc.kill()
                break
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if watcher is not None:
            watcher.join(timeout=60)
        proc.stdout.close()
    out = "".join(lines)
    with open(os.path.join(OUT_DIR, f"{name}.log"), "w") as f:
        f.write(out)
    rep = None
    if os.path.exists(path):
        with open(path) as f:
            rep = json.load(f)
    return proc.returncode, out, rep, time.perf_counter() - t0


def rounds_line(out):
    """``rounds=R/P`` of a CLI run's summary line, as (R, P)."""
    tail = [ln for ln in out.splitlines() if " rounds=" in ln][-1]
    r, p = tail.split(" rounds=")[1].split()[0].split("/")
    return int(r), int(p)


def compare_bitwise(a, b, what, entries):
    """Same verdicts and every per-test (stat, p) equal bit for bit,
    except for NONDETERMINISTIC_FAMILIES, held to the parity tolerance
    and named. A decided Bonferroni verdict keeps the look it was made at
    (its checked and failed tests), and a resumed run's first look is at
    the checkpoint's results, so those two fields are not compared."""
    loose = set()
    for gen, ra in a["runs"].items():
        rb = b["runs"][gen]
        check(ra["verdict"] == rb["verdict"], f"{what} {gen}: verdict "
                                              f"{ra['verdict']} != "
                                              f"{rb['verdict']}")
        for ta, tb in zip(ra["tests"], rb["tests"]):
            if (ta["stat"], ta["p"]) == (tb["stat"], tb["p"]):
                continue
            kname = entries[ta["index"]].kname
            check(kname in NONDETERMINISTIC_FAMILIES and ta["p"] is not None
                  and tb["p"] is not None
                  and math.isclose(ta["stat"], tb["stat"], rel_tol=1e-5,
                                   abs_tol=1e-7)
                  and math.isclose(ta["p"], tb["p"], rel_tol=1e-5,
                                   abs_tol=1e-7),
                  f"{what} {gen} {ta['name']} ({kname}): "
                  f"{ta['stat']!r}/{ta['p']!r} vs {tb['stat']!r}/{tb['p']!r}")
            loose.add(kname)
    return sorted(loose)


def kill_and_resume(name, args, n_jobs, resume_args=None):
    """Start ``args`` with a fresh checkpoint, kill it once the file holds
    a third of the ``n_jobs`` job ids, and run the same command (or
    ``resume_args``) again to its end. Returns (jobs saved at the kill,
    the resumed run's code, output and report, the checkpoint path)."""
    from repro_torch.core.api import Checkpoint
    ckpt = os.path.join(OUT_DIR, f"{name}.ck")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    code, _, _, secs = run_proc(
        f"{name}_killed", args, ckpt,
        lambda: len(Checkpoint.load(ckpt).job_idx) >= -(-n_jobs // 3))
    saved = len(Checkpoint.load(ckpt).job_idx)
    check(code == -9, f"{name}: the first run exited {code} before the kill")
    check(-(-n_jobs // 3) <= saved < n_jobs,
          f"{name}: killed with {saved} of {n_jobs} job ids saved")
    print(f"[resume] {name}: killed after {secs:.1f}s with {saved} of "
          f"{n_jobs} job ids in the checkpoint", flush=True)
    code, out, rep, secs = run_proc(f"{name}_resumed", resume_args or args,
                                    ckpt)
    return saved, code, out, rep, ckpt, secs


def parse_prefetch(out):
    """``captured_rounds``, ``prefetch_ms`` and ``h2d_bytes`` of a CLI
    run's summary line."""
    tail = [ln for ln in out.splitlines() if " captured_rounds=" in ln][-1]
    fields = dict(tok.split("=") for tok in tail.split() if "=" in tok)
    return (int(fields["captured_rounds"]), float(fields["prefetch_ms"]),
            int(fields["h2d_bytes"]))


def captured_phase(tmp, big_ref, big_entries, card):
    """Phase 8: splitmix64 captured on the card at BigCrush x1.0's size
    (106 shards x 2^20 words), BigCrush x1.0 over the capture beside
    randu, bitwise against phase 4's splitmix64; killed with --ckpt and
    resumed bitwise; a one-byte-modified copy refused on resume. Returns
    (details, the capture's path)."""
    from repro_torch.rng.sources import capture_generator, resolve_source
    path = os.path.join(tmp, "sm64_s7.npy")
    t0 = time.perf_counter()
    capture_generator("splitmix64", path, seed=CAPTURE_SEED,
                      n_streams=CAPTURE_SHARDS, stride=CAPTURE_STRIDE)
    cap_s = time.perf_counter() - t0
    src = resolve_source(f"file:{path}")
    t0 = time.perf_counter()
    uid = src.uid()
    digest_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(f"[captured] splitmix64 seed {CAPTURE_SEED} captured on cuda: "
          f"{CAPTURE_SHARDS} shards x {CAPTURE_STRIDE} words, {size} B in "
          f"{cap_s:.2f}s; uid {uid} (sha256 of the file {digest_s:.2f}s)",
          flush=True)
    args = CAPTURED_ARGS + ["--source", f"file:{path}", "--seed",
                            str(CAPTURE_SEED)]
    zero_counts()
    rep = run_cli("captured_bigcrush", args, "accelerated")
    launches = launch_counts()
    check(launches["histogram"] and launches["gf2_rank"],
          f"captured bigcrush: a kernel was not launched {launches}")
    runs = rep["runs"]
    check(runs["randu"]["verdict"] == "FAIL",
          f"captured bigcrush: randu {runs['randu']['verdict']}")
    want = big_ref["runs"]["splitmix64"]
    check(runs[src.name]["verdict"] == want["verdict"],
          f"captured bigcrush: the capture's verdict "
          f"{runs[src.name]['verdict']} != splitmix64's {want['verdict']}")
    for ta, tb in zip(runs[src.name]["tests"], want["tests"]):
        check((ta["stat"], ta["p"]) == (tb["stat"], tb["p"]),
              f"captured bigcrush {ta['name']}: {ta['stat']!r}/{ta['p']!r} "
              f"vs splitmix64 {tb['stat']!r}/{tb['p']!r}")
    check(rep["sources"] == [{"spec": f"file:{path}", "uid": uid}],
          f"captured bigcrush: sources key {rep['sources']}")
    rounds, prefetch_ms, h2d = parse_prefetch(rep["_out"])
    print(f"[captured] bigcrush x1.0, randu + the capture, accelerated on "
          f"cuda ({card}): every (stat, p) of the capture bitwise phase "
          f"4's splitmix64, randu FAIL | wall {rep['_wall_s']:.2f}s, "
          f"{rounds} captured rounds, host prefetch {prefetch_ms:.1f} ms "
          f"({prefetch_ms / rounds:.3f} ms a round), {h2d} B to the card "
          f"({h2d / rounds:.0f} B a round), launches {launches}",
          flush=True)
    n_jobs = len(big_entries)
    cargs = args + ["--backend", "accelerated"]
    saved, code, out, resumed, ckpt, secs = kill_and_resume(
        "resume_captured", cargs, n_jobs)
    check(code == 1 and resumed is not None,
          f"resumed captured bigcrush: exit {code}")
    check(rounds_line(out)[0] == n_jobs - saved,
          f"resumed captured bigcrush ran {rounds_line(out)} rounds for "
          f"{n_jobs - saved} missing jobs")
    compare_bitwise(resumed, rep, "resumed captured bigcrush", big_entries)
    resumed_rounds = rounds_line(out)
    print(f"[captured] killed with {saved} of {n_jobs} job ids saved, "
          f"resumed in {secs:.1f}s (rounds={resumed_rounds}): every "
          f"(stat, p) bitwise the uninterrupted run's", flush=True)
    mod_dir = os.path.join(tmp, "modified")
    os.makedirs(mod_dir)
    mod = os.path.join(mod_dir, os.path.basename(path))
    shutil.copyfile(path, mod)
    with open(mod, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)[0]
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last ^ 0xFF]))
    margs = [f"file:{mod}" if a == f"file:{path}" else a for a in cargs]
    code, out, refused, _ = run_proc("resume_captured_modified", margs, ckpt)
    check(code != 0 and refused is None and "re-captured" in out,
          f"a one-byte-modified copy of the capture was not refused on "
          f"resume (exit {code})")
    print(f"[captured] a copy of the capture with its last byte changed, "
          f"same stem: resume refused (exit {code}, 're-captured')",
          flush=True)
    return {"capture_s": cap_s, "bytes": size, "uid": uid,
            "digest_s": digest_s, "wall_s": rep["_wall_s"],
            "launches": launches, "captured_rounds": rounds,
            "prefetch_ms": prefetch_ms, "h2d_bytes": h2d,
            "saved_at_kill": saved, "resumed_rounds": resumed_rounds}, path


def pool_run(spec, steps=(), width=8):
    """One run of ``spec`` on a new cuda session of ``width`` slots, with
    ``steps`` (rounds to poll, then the width to resize to) before it is
    driven to its end. Returns (result, handle, session, wall seconds)."""
    import torch
    from repro_torch.core.api import PoolSession
    session = PoolSession(n_workers=width, device="cuda")
    t0 = time.perf_counter()
    handle = session.submit(spec)
    for rounds, w in steps:
        for _ in range(rounds):
            handle.poll()
        session.resize(w)
    res = handle.result()
    torch.cuda.synchronize()
    return res, handle, session, time.perf_counter() - t0


def same_results(a, b, what):
    """Two API results: the same verdicts and every (stat, p) bit for bit."""
    for gen, ra in a.runs.items():
        rb = b.runs[gen]
        check(ra.verdict.decision == rb.verdict.decision,
              f"{what} {gen}: verdict {ra.verdict.decision} != "
              f"{rb.verdict.decision}")
        diff = sorted(k for k in set(ra.results) | set(rb.results)
                      if ra.results.get(k) != rb.results.get(k))
        check(not diff, f"{what} {gen}: tests {diff[:6]} differ, e.g. "
                        f"{[(ra.results.get(k), rb.results.get(k)) for k in diff[:2]]}")


def elastic_fault_phase(card, big_ref, big_entries):
    """Phase 10: elastic width and the fault domain at BigCrush x1.0 on
    the kernels. W=8 fixed against 8 -> 3 -> 8 (lpt and over_decompose),
    bitwise; the CLI with --ckpt --workers 8 killed at a third and resumed
    with --workers 4, bitwise, then rounds=0; --resize-at; a composed
    fault plan at W=8 (evict, corrupt, straggle past the deadline, a lost
    worker, a quarantined slot), bitwise the fault-free run and replayed
    bit for bit; the CLI under --inject killed mid-fault and resumed,
    bitwise phase 4's run. Launch counts are zeroed just before the phase
    and read just after."""
    from repro_torch.core.api import RunSpec
    from repro_torch.core.faults import FaultPlan, FaultRule
    from repro_torch.core.policies import RetryPolicy
    n_jobs = len(big_entries)
    zero_counts()
    details = {}
    # resize 8 -> 3 -> 8 between polls, in turns with the fixed run
    for policy in ("lpt", "over_decompose"):
        spec = RunSpec(ELASTIC_BATTERY, ELASTIC_GENS, 7, scale=ELASTIC_SCALE,
                       policy=policy, backend="accelerated")
        walls = {"fixed": [], "resized": []}
        fixed = None
        for kind in ("fixed", "resized", "resized", "fixed"):
            res, handle, session, wall = pool_run(
                spec, BOUNCE if kind == "resized" else ())
            walls[kind].append(wall)
            if fixed is None:
                fixed = res
                continue
            same_results(res, fixed, f"{kind} {policy} vs fixed W=8")
            if kind == "resized":
                traces = sorted([k[2], v]
                                for k, v in session.trace_counts.items())
                check(traces == [[3, 1], [8, 1]],
                      f"resized {policy}: runner builds by width {traces}")
                rounds = (handle.rounds_run, handle.plan_rounds)
        details[policy] = {"walls": walls, "traces": traces,
                           "rounds_resized": rounds,
                           "verdicts": {g: r.verdict.decision
                                        for g, r in fixed.runs.items()}}
        print(f"[elastic] {ELASTIC_BATTERY} x{ELASTIC_SCALE} "
              f"{','.join(ELASTIC_GENS)} "
              f"--policy {policy}, accelerated on cuda ({card}): W=8 fixed "
              f"against 8 -> 3 -> 8 ({BOUNCE}): every (stat, p) bitwise, "
              f"verdicts {details[policy]['verdicts']}; runner builds by "
              f"width {traces}; resized rounds {rounds[0]} (plan "
              f"{rounds[1]} at W=8); warm wall fixed "
              f"{[round(w, 4) for w in walls['fixed']]} s, resized "
              f"{[round(w, 4) for w in walls['resized']]} s", flush=True)
    # the CLI with a checkpoint at W=8, killed at a third of the jobs and
    # resumed at W=4; then run a third time; and --resize-at
    full = run_cli("elastic_w8", ELASTIC_ARGS + ["--workers", "8"],
                   "accelerated")
    accel = ["--backend", "accelerated"]
    saved, code, out, rep, ckpt, secs = kill_and_resume(
        "elastic_resume", ELASTIC_ARGS + ["--workers", "8"] + accel, n_jobs,
        ELASTIC_ARGS + ["--workers", "4"] + accel)
    check(code == 1 and rep is not None and rep["workers"] == 4,
          f"elastic resume at W=4: exit {code}")
    resumed_rounds = rounds_line(out)
    compare_bitwise(rep, full, "resumed at W=4 vs W=8", big_entries)
    code, out, rep3, secs3 = run_proc(
        "elastic_resume_again", ELASTIC_ARGS + ["--workers", "4"] + accel,
        ckpt)
    check(code == 1 and rounds_line(out)[0] == 0,
          f"third elastic run: exit {code}, {rounds_line(out)}")
    print(f"[elastic] CLI --ckpt --workers 8 killed with {saved} of {n_jobs} "
          f"job ids saved, resumed with --workers 4 in {secs:.1f}s "
          f"(rounds={resumed_rounds[0]}/{resumed_rounds[1]}): every (stat, "
          f"p) bitwise the uninterrupted W=8 run's; a third run rounds=0 "
          f"({secs3:.1f}s)", flush=True)
    rat = run_cli("elastic_resize_at", ELASTIC_ARGS + [
        "--workers", "8", "--resize-at", RESIZE_AT], "accelerated")
    want = [{"round": 2, "workers": 4}, {"round": 5, "workers": 8}]
    check(rat["resizes"] == want and rat["workers"] == 8,
          f"--resize-at {RESIZE_AT}: resizes {rat['resizes']}")
    compare_bitwise(rat, full, "--resize-at vs W=8", big_entries)
    print(f"[elastic] --resize-at {RESIZE_AT}: resizes {rat['resizes']}, "
          f"every (stat, p) bitwise the W=8 run's | wall "
          f"{rat['_wall_s']:.2f}s (fixed W=8 {full['_wall_s']:.2f}s)",
          flush=True)
    details["cli"] = {"saved_at_kill": saved, "resumed_rounds":
                      resumed_rounds, "resize_at": rat["resizes"]}
    # the composed fault plan at W=8, against the fault-free run, in turns
    spec = dict(battery=ELASTIC_BATTERY, generators=FAULT_GENS, seeds=7,
                scale=ELASTIC_SCALE, backend="accelerated")
    plan = FaultPlan(seed=7, rules=tuple(FaultRule(**r)
                                         for r in FAULT_RULES))
    fspec = RunSpec(**spec, inject=plan, retry=RetryPolicy(**FAULT_RETRY))
    walls = {"clean": [], "faulted": []}
    ledgers, clean = [], None
    for kind in ("clean", "faulted", "faulted", "clean"):
        res, handle, session, wall = pool_run(
            fspec if kind == "faulted" else RunSpec(**spec))
        walls[kind].append(wall)
        if clean is None:
            clean, clean_handle = res, handle
            continue
        same_results(res, clean, f"{kind} vs fault-free W=8")
        if kind == "faulted":
            kinds = {}
            for ev in handle.fault_events:
                kinds[ev.kind] = kinds.get(ev.kind, 0) + 1
            check({"evict", "corrupt", "corrupt_result", "straggle",
                   "lose_worker", "quarantine"} <= set(kinds),
                  f"faulted run: events {kinds}")
            ledgers.append(([e.to_dict() for e in handle.fault_events],
                            list(handle.quarantines), res.retries,
                            res.rounds_run, session.n_workers))
            host_ms = {k: v * 1e3 / handle.rounds_run
                       for k, v in handle.fault_s.items()}
    check(ledgers[0] == ledgers[1], "the faulted run did not replay its "
                                    "ledger bit for bit")
    events, quarantines, retries, rounds, width = ledgers[0]
    clean_ms = {k: v * 1e3 / clean_handle.rounds_run
                for k, v in clean_handle.fault_s.items()}
    details["faults"] = {"walls": walls, "events": kinds,
                         "quarantines": quarantines, "retries": retries,
                         "rounds": rounds, "plan_rounds":
                         clean_handle.plan_rounds, "final_width": width,
                         "host_ms_per_round": host_ms,
                         "clean_host_ms_per_round": clean_ms}
    print(f"[faults] {ELASTIC_BATTERY} x{ELASTIC_SCALE} "
          f"{','.join(FAULT_GENS)} at W=8 under "
          f"{len(FAULT_RULES)} rules, accelerated on cuda ({card}): events "
          f"{kinds}, quarantines {quarantines}, pool ends at {width}; "
          f"{rounds} rounds (fault-free {clean_handle.rounds_run}), "
          f"{retries} release passes; every (stat, p) bitwise the "
          f"fault-free run's, the ledger replayed bit for bit | warm wall "
          f"faulted {[round(w, 4) for w in walls['faulted']]} s, "
          f"fault-free {[round(w, 4) for w in walls['clean']]} s; host ms "
          f"per round inject/gate/health "
          + "/".join(f"{host_ms[k]:.4f}" for k in ("inject", "gate",
                                                   "health"))
          + " (fault-free: gate " f"{clean_ms['gate']:.4f})", flush=True)
    # the CLI under --inject, uninterrupted twice, then killed mid-fault
    # with --ckpt and resumed: bitwise phase 4's fault-free W=1 run
    plan_path = os.path.join(OUT_DIR, "cli_fault_plan.json")
    FaultPlan(seed=7, rules=tuple(FaultRule(**r)
                                  for r in CLI_FAULT_RULES)).save(plan_path)
    fargs = ["--battery", ELASTIC_BATTERY, "--gen", ",".join(FAULT_GENS),
             "--scale", str(ELASTIC_SCALE), "--seed", "7", "--workers", "8",
             "--retries", "4", "--inject", plan_path]
    reps = [run_cli(f"faults_cli{i}", fargs, "accelerated")
            for i in range(2)]
    check(reps[0]["faults"] == reps[1]["faults"]
          and set(reps[0]["faults"]) == {"plan", "events", "quarantines"},
          "the CLI's faults ledger did not replay")
    for r in reps:
        compare_bitwise(r, big_ref, "--inject vs phase 4", big_entries)
    saved, code, out, rep, _, secs = kill_and_resume(
        "faults_resume", fargs + accel, n_jobs)
    check(code == 1 and rep is not None and "faults" in rep,
          f"faults resume: exit {code}")
    compare_bitwise(rep, big_ref, "--inject resumed vs phase 4", big_entries)
    cli_kinds = [e["kind"] for e in reps[0]["faults"]["events"]]
    print(f"[faults] CLI --inject ({len(CLI_FAULT_RULES)} rules, W=8): "
          f"events {cli_kinds}, twice the same ledger, every (stat, p) "
          f"bitwise phase 4's fault-free run; killed with {saved} of "
          f"{n_jobs} job ids saved and resumed ({secs:.1f}s, rounds="
          f"{rounds_line(out)}, resumed events "
          f"{[e['kind'] for e in rep['faults']['events']]}): bitwise again",
          flush=True)
    details["cli_faults"] = {"events": cli_kinds, "saved_at_kill": saved,
                             "resumed_rounds": rounds_line(out)}
    launches = launch_counts()
    check(launches["histogram"] and launches["gf2_rank"] and launches["mwc"],
          f"elastic/faults phase: a kernel was not launched {launches}")
    details["launches"] = launches
    print(f"[elastic] launches of the phase (in this process): {launches}",
          flush=True)
    return details


def cache_entries(state):
    """The result cache a daemon left under ``state``: digest -> entry."""
    from repro_torch.serve import CacheEntry
    root = os.path.join(state, "cache")
    return {f[:-3]: CacheEntry.load(os.path.join(root, f))
            for f in sorted(os.listdir(root))}


def same_tests(results, rep_run, what):
    """A result dict and a ``--json`` run: every test bitwise."""
    want = {t["index"]: (t["stat"], t["p"]) for t in rep_run["tests"]
            if ran(t)}
    diff = sorted(k for k in set(want) | set(results)
                  if results.get(k) != want.get(k))
    check(not diff, f"{what}: tests {diff[:6]} differ, e.g. "
                    f"{[(results.get(k), want.get(k)) for k in diff[:2]]}")


def screening_phase(tmp, big_ref, mwc_ref, big_entries, card):
    """Phase 11: the screening service (``repro_torch.serve``) at BigCrush
    x1.0 on the kernels. The battery CLI with ``--serve --serve-state
    --serve-resubmit`` (2 tickets, 1 batch): bitwise phase 4's BigCrush,
    the resubmit from the cache with no dispatch, the reference's
    ``serve`` keys; warm walls of the served and the classic BigCrush in
    turns. The daemon CLI on splitmix64, randu and mwc: uninterrupted in
    this process, then in a subprocess SIGKILLed once its batch
    checkpoint holds a third of the job ids, rerun (only the missing
    jobs, bitwise), and run a third time (``dispatch_rounds=0``). A
    degraded daemon (a 4-slot session quarantined by a flaky slot) ends
    DONE, bitwise, with ``status`` degraded. Launch counts are zeroed
    just before the phase and read just after."""
    import glob
    from repro_torch.core.api import Checkpoint, PoolSession, RunSpec
    from repro_torch.core.faults import FaultPlan, FaultRule
    from repro_torch.core.policies import RetryPolicy
    from repro_torch.launch import serve as daemon
    from repro_torch.serve import DONE, SubmissionQueue, spec_cells
    n_jobs = len(big_entries)
    zero_counts()
    details = {}
    # the battery CLI through the service: bitwise phase 4's BigCrush
    big = MAIN_ARGS[0][1]
    rep = run_cli("served_bigcrush", big + [
        "--serve", "--serve-state", os.path.join(tmp, "cli_state"),
        "--serve-resubmit"], "accelerated")
    sv = rep["serve"]
    check(set(sv) == SERVE_KEYS
          and all(set(t) == SERVE_TICKET_KEYS for t in sv["tickets"])
          and set(sv["resubmit"]) == SERVE_RESUBMIT_KEYS,
          f"--serve: JSON keys {sorted(sv)}")
    check(len(sv["tickets"]) == 2 and sv["batches"] == 1
          and all(t["state"] == "done" and t["batch"] == 0
                  for t in sv["tickets"]),
          f"--serve: tickets {sv['tickets']}, batches {sv['batches']}")
    check(sv["resubmit"]["cache_hits"] == 1
          and sv["resubmit"]["dispatches_added"] == 0
          and sv["resubmit"]["done_at_submit"],
          f"--serve-resubmit: {sv['resubmit']}")
    compare_bitwise(rep, big_ref, "served bigcrush vs phase 4", big_entries)
    print(f"[screening] bigcrush x1.0 splitmix64,randu --serve on cuda "
          f"({card}): {len(sv['tickets'])} tickets -> {sv['batches']} "
          f"batch, {sv['dispatch_rounds']} dispatch rounds, cache "
          f"{sv['cache']}; every (stat, p) and verdict bitwise phase 4's "
          f"classic run; resubmit cache_hits={sv['resubmit']['cache_hits']} "
          f"dispatches_added={sv['resubmit']['dispatches_added']}",
          flush=True)
    details["cli"] = {"serve": sv, "wall_s": rep["_wall_s"]}
    # host cost of serving: warm walls of the served (no state dir: every
    # round dispatched) and the classic BigCrush, in turns
    walls = {"classic": [], "served": []}
    for kind in ("classic", "served", "served", "classic"):
        r = run_cli(f"wall_{kind}", big + (["--serve"] if kind == "served"
                                           else []), "accelerated")
        check(r["rounds_run"] == big_ref["rounds_run"],
              f"warm {kind}: {r['rounds_run']} rounds")
        walls[kind].append(r["_wall_s"])
    details["walls"] = walls
    print(f"[screening] warm wall, in turns: classic "
          f"{[round(w, 4) for w in walls['classic']]} s, served "
          f"{[round(w, 4) for w in walls['served']]} s (the CLI in this "
          f"process, report and JSON included)", flush=True)
    # the daemon CLI: uninterrupted here, then killed in a subprocess and
    # resumed, then run a third time
    subs = os.path.join(tmp, "subs.json")
    with open(subs, "w") as f:
        json.dump(DAEMON_SUBMISSIONS, f)
    digests = {d["gen"]: spec_cells(daemon.spec_from_dict(d), "cuda")[0]
               .digest for d in DAEMON_SUBMISSIONS}

    def run_daemon(name, state):
        path = os.path.join(OUT_DIR, f"{name}.json")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = daemon.main(["--submit", subs, "--state", state,
                                "--json", path])
        wall = time.perf_counter() - t0
        with open(os.path.join(OUT_DIR, f"{name}.log"), "w") as f:
            f.write(out.getvalue())
        check(code == 0, f"{name}: daemon exit {code}")
        with open(path) as f:
            return json.load(f), out.getvalue(), wall

    full_state = os.path.join(tmp, "daemon_full")
    full, _, full_wall = run_daemon("daemon_full", full_state)
    check(full["stats"]["batches"] == 1
          and full["stats"]["dispatch_rounds"] == n_jobs,
          f"daemon: {full['stats']}")
    entries = cache_entries(full_state)
    check(set(entries) == set(digests.values()),
          f"daemon cache {sorted(entries)} != cells {digests}")
    for gen, ref_run in (("splitmix64", big_ref["runs"]["splitmix64"]),
                         ("randu", big_ref["runs"]["randu"]),
                         ("mwc", mwc_ref["runs"]["mwc"])):
        same_tests(entries[digests[gen]].results, ref_run,
                   f"daemon {gen} vs phase 4")
    state = os.path.join(tmp, "daemon_killed")

    def third_saved():
        found = glob.glob(os.path.join(state, "batch-*.ck"))
        return bool(found) and (len(Checkpoint.load(found[0]).job_idx)
                                >= -(-n_jobs // 3))
    code, _, _, secs = run_proc("daemon_killed", ["--submit", subs], state,
                                third_saved, flag="--state",
                                module="repro_torch.launch.serve")
    (batch_ck,) = glob.glob(os.path.join(state, "batch-*.ck"))
    saved = len(Checkpoint.load(batch_ck).job_idx)
    check(code == -9 and -(-n_jobs // 3) <= saved < n_jobs,
          f"daemon: exit {code} with {saved} of {n_jobs} job ids saved")
    resumed, _, resumed_wall = run_daemon("daemon_resumed", state)
    check(resumed["stats"]["dispatch_rounds"] == n_jobs - saved,
          f"resumed daemon ran {resumed['stats']['dispatch_rounds']} rounds "
          f"for {n_jobs - saved} missing jobs")
    again = cache_entries(state)
    check(set(again) == set(entries), "resumed daemon: other cells")
    for gen, dg in digests.items():
        check(again[dg].results == entries[dg].results
              and again[dg].decision == entries[dg].decision,
              f"resumed daemon {gen}: not bitwise the uninterrupted run")
    third, out3, third_wall = run_daemon("daemon_third", state)
    check(third["stats"]["dispatch_rounds"] == 0
          and "dispatch_rounds=0" in out3
          and all(t["cache_hits"] == 1 and t["state"] == "done"
                  for t in third["tickets"]),
          f"third daemon run: {third['stats']}")
    verdicts = {g: t["verdicts"][g] for g, t in zip(digests,
                                                      full["tickets"])}
    print(f"[screening] daemon CLI on {','.join(digests)} (bigcrush x1.0, "
          f"accelerated): 1 batch of {n_jobs} rounds in {full_wall:.2f}s, "
          f"cells bitwise phase 4's, verdicts {verdicts}; killed after "
          f"{secs:.1f}s with {saved} of {n_jobs} job ids in "
          f"{os.path.basename(batch_ck)}, rerun dispatched "
          f"{resumed['stats']['dispatch_rounds']} rounds in "
          f"{resumed_wall:.2f}s, every cell bitwise the uninterrupted run's; "
          f"a third run dispatch_rounds=0 ({third_wall:.2f}s)", flush=True)
    details["daemon"] = {"saved_at_kill": saved, "full_wall_s": full_wall,
                         "resumed_rounds":
                             resumed["stats"]["dispatch_rounds"],
                         "resumed_wall_s": resumed_wall,
                         "third_wall_s": third_wall, "verdicts": verdicts}
    # a degraded daemon: slot 1 of a 4-slot session evicts every round and
    # is quarantined until one slot is left
    session = PoolSession(n_workers=4, device="cuda")
    queue = SubmissionQueue(session, state_dir=os.path.join(tmp, "degraded"),
                            inject=FaultPlan(rules=(FaultRule("evict",
                                                              slot=1),)))
    t0 = time.perf_counter()
    ticket = queue.submit(RunSpec(
        "bigcrush", "splitmix64", seeds=(7,), scale=1.0, policy="roundrobin",
        retry=RetryPolicy(max_retries=10, quarantine_after=2),
        backend="accelerated"))
    queue.drain()
    wall = time.perf_counter() - t0
    stats = queue.stats()
    check(ticket.state == DONE, f"degraded daemon: ticket {ticket.state}")
    same_tests(ticket.result().results, big_ref["runs"]["splitmix64"],
               "degraded daemon vs phase 4")
    check(stats["status"] == "degraded" and stats["workers"] < 4,
          f"degraded daemon: stats {stats}")
    print(f"[screening] degraded daemon, bigcrush x1.0 splitmix64 at W=4 "
          f"with slot 1 evicting every round: ticket DONE, bitwise phase "
          f"4's; status {stats['status']}, workers {stats['workers']}, "
          f"{stats['dispatch_rounds']} dispatch rounds in {wall:.2f}s",
          flush=True)
    details["degraded"] = {"stats": stats, "wall_s": wall}
    launches = launch_counts()
    check(launches["histogram"] and launches["gf2_rank"] and launches["mwc"],
          f"screening phase: a kernel was not launched {launches}")
    details["launches"] = launches
    print(f"[screening] launches of the phase (in this process): "
          f"{launches}", flush=True)
    return details


def drive_campaign(spec, session):
    """Run a campaign phase by phase (``Campaign.run_next_phase``); per
    phase its wall time, cells, rounds, cells knocked out and kernel
    launches (counts zeroed just before the phase). Returns (campaign,
    result, phase records)."""
    import numpy as np
    import torch
    from repro_torch.core.api import CELL_FAIL
    from repro_torch.core.campaign import Campaign
    camp = Campaign(session, spec)
    records, t_all = [], time.perf_counter()
    while not camp.complete:
        k = camp.ledger.phases_done
        before = np.asarray(camp.ledger.decisions).copy()
        logged = len(camp.phase_log)
        zero_counts()
        t0 = time.perf_counter()
        check(camp.run_next_phase(), f"campaign phase {k} did not complete")
        torch.cuda.synchronize()
        rec = camp.phase_log[-1] if len(camp.phase_log) > logged else None
        records.append({
            "phase": k, "name": camp.phases()[k].name,
            "wall_s": time.perf_counter() - t0,
            "cells": len(rec["groups"]) if rec else 0,
            "pad": rec["pad"] if rec else 0,
            "rounds": rec["rounds"] if rec else 0,
            "knocked": int(np.sum((np.asarray(camp.ledger.decisions)
                                   == CELL_FAIL) & (before != CELL_FAIL))),
            "launches": launch_counts()})
    return camp, camp.result_snapshot(time.perf_counter() - t_all), records


def print_campaign(label, res, records, session, card):
    for r in records:
        print(f"[campaign] {label} phase {r['phase']} ({r['name']}): "
              f"{r['cells']} cell(s) +{r['pad']} pad, {r['rounds']} rounds, "
              f"{r['wall_s']:.2f}s, knocked out {r['knocked']}, launches "
              f"{r['launches']}", flush=True)
    print(f"[campaign] {label} on cuda ({card}): {res.wall_s:.2f}s, "
          f"{res.rounds_run} rounds, {session.total_traces} runner builds "
          f"for {len(res.phase_names)} phases; survivors "
          f"{len(res.survivors)}, knockouts {len(res.knockouts)}",
          flush=True)


def compare_phase_results(a, b, what):
    """Two campaigns' per-phase results (``Campaign.phase_log``): the same
    phases, cells and tests; stat within rtol 1e-5 / atol 1e-7, p within
    atol 1e-7 + rtol 1e-5 (the contract between the port's backends).
    Returns the number of tests compared."""
    check([(r["phase"], r["groups"]) for r in a]
          == [(r["phase"], r["groups"]) for r in b],
          f"{what}: the phases ran other cells")
    n = 0
    for ra, rb in zip(a, b):
        for ca, cb in zip(ra["results"], rb["results"]):
            check(set(ca) == set(cb), f"{what} phase {ra['phase']}: other "
                                      f"tests ran")
            for k, (sa, pa) in ca.items():
                sb, pb = cb[k]
                check(math.isclose(sa, sb, rel_tol=1e-5, abs_tol=1e-7)
                      and abs(pa - pb) <= 1e-7 + 1e-5 * abs(pb),
                      f"{what} phase {ra['phase']} test {k}: {sa}/{pa} vs "
                      f"{sb}/{pb}")
                n += 1
    return n


def campaign_phase(cap_path, card):
    """Phase 9: the 8 x 4 BigCrush campaign at waves 0.25, 1.0 with the
    seam phase, accelerated against --backend reference, and one
    profiled warm wave; the CLI killed by SIGKILL after its first phase,
    resumed, and run a third time (rounds=0); the CLI under the e-value
    engine; a captured campaign of 2 sub-streams against splitmix64's."""
    import numpy as np
    from repro_torch.core.api import CampaignLedger, CampaignSpec, PoolSession
    from repro_torch.core.campaign import default_span
    def arg(flag):
        return CAMPAIGN_ARGS[CAMPAIGN_ARGS.index(flag) + 1]
    battery, gens = arg("--battery"), tuple(arg("--gen").split(","))
    waves = tuple(float(w) for w in arg("--waves").split(","))
    spec = CampaignSpec(battery, gens, n_streams=int(arg("--streams")),
                        seed=int(arg("--seed")), waves=waves,
                        backend="accelerated")
    session = PoolSession(device="cuda")
    camp, res, records = drive_campaign(spec, session)
    print_campaign(f"{len(gens)} x {spec.n_streams} {battery} accelerated",
                   res, records, session, card)
    print(res.report, flush=True)
    n_phases = len(res.phase_names)
    check(res.phase_names == ["streamcheck"] + [f"x{w:g}" for w in waves],
          f"campaign phases {res.phase_names}")
    check(session.total_traces <= n_phases,
          f"campaign: {session.total_traces} runner builds > {n_phases} "
          f"phases")
    for name in ("histogram", "gf2_rank"):
        check(sum(r["launches"][name] for r in records
                  if r["name"] != "streamcheck"),
              f"campaign: {name} was not launched by the grid runner")
    mat = res.matrix
    randu = gens.index("randu")
    check(set(mat[randu].tolist()) == {2}
          and int(res.decided_phase.reshape(mat.shape)[randu].max())
          < n_phases - 1,
          f"campaign: randu's cells {mat[randu].tolist()} decided at "
          f"{res.decided_phase.reshape(mat.shape)[randu].tolist()}, not all "
          f"knocked out before the last wave")
    check(not np.any(mat == 0), "campaign: undecided cells")

    ref_session = PoolSession(device="cuda")
    ref_camp, ref_res, ref_records = drive_campaign(
        dataclasses.replace(spec, backend="reference"), ref_session)
    print_campaign(f"{len(gens)} x {spec.n_streams} {battery} reference",
                   ref_res, ref_records, ref_session, card)
    check(res.decisions.tolist() == ref_res.decisions.tolist()
          and res.decided_phase.tolist() == ref_res.decided_phase.tolist(),
          "campaign: accelerated and reference backends decide differently")
    n_tests = compare_phase_results(camp.phase_log, ref_camp.phase_log,
                                    "campaign accelerated vs reference")
    print(f"[campaign] --backend reference: the same decisions and decided "
          f"phases; {n_tests} (stat, p) within the contract", flush=True)

    # one warm x0.25 wave of one sub-stream per generator (8 cells, a
    # quarter of the grid: a device trace of the 32-cell wave's million
    # kernels takes minutes), without the seam phase: its wall time, then
    # the same under torch.profiler
    wave = dataclasses.replace(spec, waves=waves[:1], n_streams=1,
                               stream_check=False)
    _, wave_res, _ = drive_campaign(wave, session)
    t0 = time.perf_counter()
    prof = device_busy(lambda: drive_campaign(wave, session), cpu=False)
    prof["trace_s"] = time.perf_counter() - t0
    warm = wave_res.wall_s * 1e3
    prof["wall_ms"] = warm
    prof["idle_share"] = max(0.0, 1 - prof["busy_ms"] / warm)
    top = ", ".join(f"{k[:70]} x{c} {t:.2f} ms" for k, c, t in prof["top"])
    print(f"[campaign] profile of a warm x{waves[0]:g} wave of "
          f"{wave.n_cells} cells (device trace, {prof['trace_s']:.1f}s): "
          f"{prof['kernels']} device kernels, device busy "
          f"{prof['busy_ms']:.2f} ms of {warm:.1f} ms warm wall (idle share "
          f"{prof['idle_share']:.1%}); top: {top}", flush=True)

    # the CLI, killed once its ledger holds a phase, run again, and again
    ledger = os.path.join(OUT_DIR, "campaign.ledger")
    for stale in (ledger, ledger + ".phase1", ledger + ".phase2"):
        if os.path.exists(stale):
            os.remove(stale)
    args = CAMPAIGN_ARGS + ["--backend", "accelerated"]

    def one_phase_done():
        return (os.path.exists(ledger)
                and CampaignLedger.load(ledger).phases_done >= 1)
    code, _, _, secs = run_proc("campaign_killed", args, ledger,
                                flag="--ledger", kill_when=one_phase_done)
    done = CampaignLedger.load(ledger).phases_done
    check(code == -9 and 1 <= done < n_phases,
          f"campaign CLI: exit {code} with {done} phases in the ledger")
    code, out, rep, secs2 = run_proc("campaign_resumed", args, ledger,
                                     flag="--ledger")
    check(code == 0 and rep is not None, f"resumed campaign: exit {code}")
    cells = [(c["decision"], c["phase"]) for c in rep["campaign"]["cells"]]
    want = [(res.decision(g, s), int(p) if p >= 0 else None)
            for (g, s), p in zip(res.cells, res.decided_phase)]
    check(cells == want, "resumed campaign: another matrix than the "
                         "uninterrupted run's")
    code, out3, _, secs3 = run_proc("campaign_again", args, ledger,
                                    flag="--ledger")
    check(code == 0 and " rounds=0 " in out3,
          f"third campaign run: exit {code}, no rounds=0")
    print(f"[campaign] CLI killed after {secs:.1f}s with {done} phase(s) in "
          f"the ledger, resumed in {secs2:.1f}s to the uninterrupted matrix "
          f"(rounds={rep['rounds_run']}); a third run: rounds=0 "
          f"({secs3:.1f}s)", flush=True)

    zero_counts()
    ev_ledger = os.path.join(OUT_DIR, "campaign_evalue.ledger")
    if os.path.exists(ev_ledger):
        os.remove(ev_ledger)
    ev = run_cli("campaign_evalue", CAMPAIGN_ARGS + [
        "--verdict-engine", "evalue", "--ledger", ev_ledger], "accelerated",
        codes=(0,))
    check("evidence" in ev and all(
        c["decision"] == "FAIL" for c in ev["campaign"]["cells"]
        if c["gen"] == "randu"), "evalue campaign: no evidence key, or a "
                                 "randu cell not FAIL")
    print(f"[campaign] --verdict-engine evalue: phases "
          f"{ev['campaign']['phases']}, survivors "
          f"{ev['campaign']['survivors']}, knockouts "
          f"{ev['campaign']['knockouts']}, continuations "
          f"{ev['evidence']['continuations']}, {ev['_wall_s']:.2f}s, "
          f"launches {launch_counts()}", flush=True)

    # the capture, cut to 2 sub-streams at the default span of a x0.25
    # wave, beside splitmix64 in one grid
    span = default_span(CampaignSpec(battery, ("splitmix64",),
                                     n_streams=2, waves=waves[:1]))
    cut = os.path.join(os.path.dirname(cap_path), "sm64_s7_2x.npy")
    np.save(cut, np.ascontiguousarray(
        np.load(cap_path, mmap_mode="r")[:, :2 * span]))
    cspec = CampaignSpec(battery, sources=("splitmix64", f"file:{cut}"),
                         n_streams=2, seed=CAPTURE_SEED, waves=waves[:1],
                         backend="accelerated")
    csession = PoolSession(device="cuda")
    _, cres, crecords = drive_campaign(cspec, csession)
    print_campaign(f"captured 2-stream x{waves[0]:g}", cres, crecords,
                   csession, card)
    cmat, cphase = cres.matrix, cres.decided_phase.reshape(cres.matrix.shape)
    check(cmat[1].tolist() == cmat[0].tolist()
          and cphase[1].tolist() == cphase[0].tolist(),
          f"captured campaign: the capture's cells {cmat[1].tolist()} "
          f"{cphase[1].tolist()} != splitmix64's {cmat[0].tolist()} "
          f"{cphase[0].tolist()}")
    check(sum(r["launches"]["histogram"] for r in crecords),
          "captured campaign: the histogram was not launched")
    print(f"[campaign] captured cells (span {span}) decided as splitmix64's: "
          f"{cmat.tolist()} at phases {cphase.tolist()}", flush=True)
    launches = {name: sum(r["launches"][name] for r in records)
                for name in ("histogram", "gf2_rank", "mwc",
                             "flash_attention")}
    return {"phases": records, "reference_phases": ref_records,
            "wall_s": res.wall_s, "rounds": res.rounds_run,
            "runner_builds": session.total_traces,
            "decisions": res.decisions.tolist(),
            "decided_phase": res.decided_phase.tolist(),
            "wave_profile": prof, "killed_with_phases": done,
            "evalue": {k: ev[k] for k in ("campaign", "evidence")},
            "captured": {"span": span, "phases": crecords,
                         "decisions": cres.decisions.tolist()},
            "launches": launches}


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    details = {}

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} device(s)",
          flush=True)

    # 2. build
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    built = build.build()
    details["build"] = built
    print(f"[build] {len(built)} kernel(s) compiled in "
          f"{time.perf_counter() - t0:.1f}s: "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in built.items()),
          flush=True)
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  ptxas[{name}] {line.strip()}")

    def sass(name):
        return subprocess.run(
            [os.path.join(os.path.dirname(build.nvcc()), "cuobjdump"),
             "--dump-sass", str(build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass("flash_attention")
                .splitlines())
    details["flash_attention_hgmma"] = hgmma
    check(hgmma > 0, "the flash-attention library holds no HGMMA "
                     "(tensor-core) instruction")
    print(f"[build] flash_attention SASS: {hgmma} HGMMA (wgmma) "
          f"instructions", flush=True)
    # the mwc product is 64-bit multiplies and adds: no call to a
    # software division routine (a 128-bit %) or any other
    instrs = [line for line in sass("mwc").splitlines()
              if re.match(r"\s*/\*[0-9a-f]+\*/\s+\S", line)]
    calls = [line.strip() for line in instrs if re.search(r"\bCALL\b", line)]
    details["mwc_sass"] = {"instructions": len(instrs), "calls": calls}
    check(instrs and not calls, f"the mwc library's SASS holds "
                                f"{len(instrs)} instructions and CALLs "
                                f"{calls[:4]}")
    print(f"[build] mwc SASS: {len(instrs)} instructions, no CALL",
          flush=True)

    # 3. kernels at their parity shapes
    from repro_torch.kernels.gf2_rank.kernel import gf2_rank
    from repro_torch.kernels.histogram.kernel import histogram
    hist_parity = [hist_case(n, k) for n, k in HIST_PARITY]
    rank_parity = [rank_case(m) for m in RANK_PARITY]
    from repro_torch.kernels.mwc.kernel import MWC_A, mwc_words
    mwc_states = [mwc_state(*pair) for pair in MWC_SEEDS]
    check(all(c0 >= MWC_A for _, c0 in mwc_states[-2:]),
          "the mwc wide-carry seeds do not start with c0 >= a")
    mwc_states.append(((1 << 32) - 1, MWC_A))
    mwc_parity = [mwc_case(n, mwc_states if n <= MWC_ALL_STATES
                           else mwc_states[:1] + mwc_states[-2:-1])
                  for n in MWC_PARITY]
    n_lengths, n_launches = mwc_boundary_check(mwc_states,
                                               MWC_BOUNDARY_LIMIT)
    details["mwc_boundaries"] = {"lengths": n_lengths,
                                 "launches": n_launches}
    print(f"[kernels] mwc: bitwise the plain loop at {n_lengths} plan "
          f"boundaries up to 2^23 words ({n_launches} launches, "
          f"{len(mwc_states)} states)", flush=True)
    # what no kernel's design can take off a call: an empty launch
    empty = {"ms": median_ms(lambda: torch.cuda._sleep(0)),
             "device_ms": device_ms(lambda: torch.cuda._sleep(0))}
    details["empty_launch"] = empty
    print(f"[kernels] empty launch (torch.cuda._sleep(0)): "
          f"{empty['ms']:.4f} ms (device {empty['device_ms']:.4f})",
          flush=True)
    fa_parity = [fa_case(*shape) for shape in FA_PARITY]
    details["parity"] = {"histogram": hist_parity, "gf2_rank": rank_parity,
                         "mwc": mwc_parity, "flash_attention": fa_parity}
    for c in hist_parity:
        print_battery("histogram", c)
    for c in rank_parity:
        print_battery("gf2_rank", c)
    for c in mwc_parity:
        print_battery("mwc", c)
    for c in fa_parity:
        print_fa(c)

    # 4. main path, accelerated
    from test_torch_reference import ATOL, RTOL, p_tolerance
    from repro_torch.core.battery import build_battery
    accel, calls = {}, {}
    for name, args in MAIN_ARGS:
        zero_counts()
        rep = run_cli(name, args, "accelerated")
        launches = launch_counts()
        calls[name] = {"histogram": dict(histogram.calls),
                       "gf2_rank": dict(gf2_rank.calls)}
        check(launches["histogram"] and launches["gf2_rank"],
              f"{name}: a kernel was not launched on the main path "
              f"{launches}")
        verdicts = {g: r["verdict"] for g, r in rep["runs"].items()}
        check(verdicts == {"splitmix64": "PASS", "randu": "FAIL"},
              f"{name}: verdicts {verdicts}")
        scale = float(args[args.index("--scale") + 1])
        rep["_launches"] = launches
        rep["_words"] = words_generated(rep, scale)
        accel[name] = rep
        print(f"[main] {name} accelerated on cuda: {verdicts} | wall "
              f"{rep['_wall_s']:.2f}s, rounds {rep['rounds_run']}/"
              f"{rep['plan_rounds']}, words {rep['_words']}, launches "
              f"{launches}", flush=True)
        print(f"[main] {name} shapes x launches: histogram (N, k) "
              f"{sorted(calls[name]['histogram'].items())}; gf2_rank M "
              f"{sorted(calls[name]['gf2_rank'].items())}", flush=True)
    with open(GOLDEN) as f:
        golden = json.load(f)
    entries = build_battery("smallcrush", 0.0625, device="cpu")

    def golden_tol(t, g):
        e = entries[t["index"]]
        return p_tolerance(e.kname, dict(e.params), g["stat"], g["p"])
    compare_runs(accel["smallcrush"], golden, "smallcrush vs golden",
                 golden_tol)
    print("[main] smallcrush matches the reference golden JSON "
          "(verdicts, checked tests, (stat, p) within tolerance)",
          flush=True)

    # BigCrush x1.0 of mwc + splitmix64: mwc's words from its kernel
    zero_counts()
    rep = run_cli("bigcrush_mwc", MWC_ARGS, "accelerated", codes=(0, 1))
    launches = launch_counts()
    calls["bigcrush_mwc"] = {"mwc": dict(mwc_words.calls)}
    check(launches["mwc"] and launches["histogram"] and launches["gf2_rank"],
          f"bigcrush_mwc: a kernel was not launched {launches}")
    check(sum(mwc_words.calls.values()) == launches["mwc"]
          == len(build_battery("bigcrush", 1.0, device="cpu")),
          f"bigcrush_mwc: {launches['mwc']} mwc launches, want one per job")
    rep["_launches"] = launches
    rep["_words"] = words_generated(rep, 1.0)
    mwc_words_per_run = sum(n * c for n, c in mwc_words.calls.items())
    accel["bigcrush_mwc"] = rep
    verdicts = {g: r["verdict"] for g, r in rep["runs"].items()}
    print(f"[main] bigcrush_mwc accelerated on cuda: {verdicts} (suspects "
          f"{ {g: r['suspects'] for g, r in rep['runs'].items()} }) | wall "
          f"{rep['_wall_s']:.2f}s, rounds {rep['rounds_run']}/"
          f"{rep['plan_rounds']}, launches {launches}, mwc words "
          f"{mwc_words_per_run} in {launches['mwc']} launches, shapes "
          f"{sorted(mwc_words.calls.items())}", flush=True)

    # 5. the same runs with the plain versions
    for name, args in MAIN_ARGS:
        zero_counts()
        rep = run_cli(name, args, "reference")
        check(not any(launch_counts().values()),
              f"{name}/reference launched a kernel")
        compare_runs(accel[name], rep, f"{name} accelerated vs reference",
                     lambda a, b: ATOL + RTOL * abs(b["p"]))
        print(f"[reference] {name} reference on cuda: same verdicts and "
              f"(stat, p) | wall {rep['_wall_s']:.2f}s", flush=True)
        details[f"{name}_reference_wall_s"] = rep["_wall_s"]

    # warm wall time of the BigCrush run, the two backends in turns
    # (accelerated, reference, reference, accelerated), after the runs
    # above loaded every CUDA module the path needs
    big = dict(MAIN_ARGS)["bigcrush"]
    walls = {"accelerated": [], "reference": []}
    for backend in ("accelerated", "reference", "reference", "accelerated"):
        walls[backend].append(run_cli("bigcrush_warm", big,
                                      backend)["_wall_s"])
    details["bigcrush_warm_wall_s"] = walls
    print(f"[timing] bigcrush warm wall on cuda: accelerated "
          f"{walls['accelerated']} s, reference {walls['reference']} s",
          flush=True)

    # one more warm accelerated BigCrush under torch.profiler: where the
    # device time goes, and each battery kernel call is exactly one device
    # kernel (no memset, no conversion kernel, never the histogram's
    # global-atomics route); the idle share is against the unprofiled
    # warm wall time
    zero_counts()
    prof = device_busy(lambda: run_cli("bigcrush_profiled", big,
                                       "accelerated"))
    launches = launch_counts()

    def kernels_named(word):
        return sum(c for key, c, _ in prof["by_name"] if word in key)
    hist_k, hist_global = kernels_named("hist_"), kernels_named("hist_global")
    check(hist_k == launches["histogram"] and hist_global == 0,
          f"profiled bigcrush: {hist_k} histogram kernels ({hist_global} on "
          f"the global route) for {launches['histogram']} calls")
    check(kernels_named("gf2_rank32") == launches["gf2_rank"],
          f"profiled bigcrush: {kernels_named('gf2_rank32')} gf2_rank "
          f"kernels for {launches['gf2_rank']} calls")
    warm = statistics.median(walls["accelerated"]) * 1e3
    prof["wall_ms"] = warm
    prof["idle_share"] = max(0.0, 1 - prof["busy_ms"] / warm)
    prof["memsets"] = kernels_named("Memset")
    prof["launches"] = launches
    details["bigcrush_profile"] = prof
    print(f"[profile] bigcrush warm, accelerated: {prof['kernels']} device "
          f"kernels, device busy {prof['busy_ms']:.3f} ms of {warm:.1f} ms "
          f"warm wall (idle share {prof['idle_share']:.1%}), memsets "
          f"{prof['memsets']}; histogram {hist_k} kernels for "
          f"{launches['histogram']} calls (global route {hist_global}), "
          f"gf2_rank {kernels_named('gf2_rank32')} for "
          f"{launches['gf2_rank']}", flush=True)
    for key, count, ms in prof["by_name"][:12]:
        print(f"[profile]   {ms:8.3f} ms x{count:5d}  {key[:90]}", flush=True)

    # resume after an eviction: the BigCrush command with --ckpt, killed
    # mid-way and run again, in subprocesses (the paper's restart)
    from test_torch_reference import log_wealth_tolerance
    from repro_torch.core.api import PoolSession, RunSpec
    big_entries = build_battery("bigcrush", 1.0, device="cpu")
    n_jobs = len(big_entries)
    resume_args = big + ["--backend", "accelerated"]
    saved, code, out, rep, ckpt, secs = kill_and_resume(
        "resume_bigcrush", resume_args, n_jobs)
    check(code == 1 and rep is not None,
          f"resumed bigcrush: exit {code}, want 1 (randu fails)")
    rounds = rounds_line(out)
    check(rounds[0] == n_jobs - saved,
          f"resumed bigcrush ran {rounds} rounds for {n_jobs - saved} "
          f"missing jobs")
    loose = compare_bitwise(rep, accel["bigcrush"],
                            "resumed bigcrush vs uninterrupted", big_entries)
    print(f"[resume] bigcrush resumed in {secs:.1f}s: rounds={rounds[0]}/"
          f"{rounds[1]} (the {n_jobs - saved} missing jobs); verdicts "
          f"{ {g: r['verdict'] for g, r in rep['runs'].items()} } and every "
          f"per-test (stat, p) bitwise those of the uninterrupted run"
          + (f", except families {loose} (within rtol 1e-5)" if loose
             else ""), flush=True)
    code, out, rep3, secs = run_proc("resume_bigcrush_again", resume_args,
                                     ckpt)
    check(code == 1 and rounds_line(out)[0] == 0,
          f"third bigcrush run: exit {code}, {rounds_line(out)}")
    compare_bitwise(rep3, accel["bigcrush"], "third bigcrush run",
                    big_entries)
    print(f"[resume] bigcrush run a third time: rounds=0 "
          f"({rounds_line(out)}), same results, {secs:.1f}s", flush=True)
    # host time of one checkpoint save, at its largest (every job of both
    # generators), against the wall time of a warm round
    handle = PoolSession(device="cuda").submit(RunSpec(
        "bigcrush", ("splitmix64", "randu"), seeds=(7,), scale=1.0,
        backend="accelerated", checkpoint_path=ckpt))
    save_ms = []
    for _ in range(21):
        t0 = time.perf_counter()
        handle._save_checkpoint()
        save_ms.append((time.perf_counter() - t0) * 1e3)
    round_ms = statistics.median(walls["accelerated"]) * 1e3 / n_jobs
    details["resume"] = {
        "saved_at_kill": saved, "rounds": rounds, "families_loose": loose,
        "ckpt_save_ms": save_ms, "ckpt_bytes": os.path.getsize(ckpt),
        "warm_round_ms": round_ms}
    print(f"[resume] checkpoint save on the host ({n_jobs} jobs x 2 "
          f"generators, {os.path.getsize(ckpt)} B): median "
          f"{statistics.median(save_ms):.3f} ms (min {min(save_ms):.3f}) "
          f"per round, against {round_ms:.3f} ms of warm wall per round "
          f"without a checkpoint", flush=True)

    # the same kill and resume under the e-value engine with early stop
    ev_args = big + ["--adaptive", "--verdict-engine", "evalue"]
    saved, code, out, rep, _, secs = kill_and_resume(
        "resume_evalue", ev_args + ["--backend", "accelerated"], n_jobs)
    check(code == 1 and rep is not None and "evidence" in rep,
          f"resumed evalue bigcrush: exit {code}, evidence key "
          f"{rep is not None and 'evidence' in rep}")
    runs = rep["runs"]
    check(runs["splitmix64"]["verdict"] == "PASS"
          and runs["randu"]["verdict"] == "FAIL"
          and runs["randu"]["tests_checked"] < n_jobs,
          f"resumed evalue bigcrush: {runs['splitmix64']['verdict']}, "
          f"{runs['randu']['verdict']} after "
          f"{runs['randu']['tests_checked']} tests")
    ev_ref = run_cli("bigcrush_evalue", ev_args, "reference")
    def p_tol(kname, params, stat, p):
        """The parity contract between the port's two backends."""
        return ATOL + RTOL * abs(p)
    compare_runs(rep, ev_ref, "evalue accelerated (resumed) vs reference",
                 lambda a, b: p_tol(None, None, None, b["p"]))
    wealth = {}
    for gen, run in ev_ref["runs"].items():
        parts = [(big_entries[t["index"]].kname,
                  dict(big_entries[t["index"]].params), t["stat"], t["p"])
                 for t in run["tests"] if t["p"] is not None]
        tol = log_wealth_tolerance(parts, p_tol=p_tol)
        got = rep["evidence"]["runs"][gen]["log_wealth"]
        want = ev_ref["evidence"]["runs"][gen]["log_wealth"]
        check(abs(got - want) <= tol, f"evalue {gen}: log_wealth {got} vs "
                                      f"reference backend {want} > {tol}")
        wealth[gen] = (got, want, tol)
    details["resume_evalue"] = {"saved_at_kill": saved,
                                "rounds": rounds_line(out),
                                "log_wealth": wealth}
    print(f"[resume] evalue adaptive bigcrush, killed with {saved} job ids "
          f"saved and resumed ({secs:.1f}s, rounds={rounds_line(out)}): "
          f"splitmix64 PASS after {runs['splitmix64']['tests_checked']} "
          f"tests, randu FAIL after {runs['randu']['tests_checked']} of "
          f"{n_jobs}; --backend reference gives the same verdicts and "
          f"checked tests, log_wealth (resumed, reference, tolerance) "
          f"{wealth}", flush=True)

    # 6. serve: qwen2-1.5b at full width, bfloat16 compute
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params
    flash = _kernel_fns()["flash_attention"]
    cfg = get_config("qwen2-1.5b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"[serve] qwen2-1.5b at full width ({cfg.n_layers}L d"
          f"{cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}kv dh"
          f"{cfg.head_dim_} ff{cfg.d_ff} vocab {cfg.vocab_size}): "
          f"{cfg.n_params()} {cfg.param_dtype} parameters from seed 0 on "
          f"cuda in {time.perf_counter() - t0:.2f}s, compute "
          f"{cfg.compute_dtype}", flush=True)
    serve_runs, serve_prompts, fa_calls = [], [], {}
    serve_launches, routes = 0, {}
    for i, (batch, plen, gen) in enumerate(SERVE):
        prompts = prompts_for(cfg, batch, plen, seed=i)
        greedy(params, prompts, cfg, 2)          # warm-up at this shape
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        first, toks, t_pre, t_dec = greedy(params, prompts, cfg, gen)
        launches = launch_counts()
        check(launches["flash_attention"] == cfg.n_layers,
              f"serve {batch}x{plen}: {launches['flash_attention']} "
              f"flash-attention launches, want {cfg.n_layers} per prefill")
        run_routes = {}
        for key, c in flash.calls.items():
            fa_calls[key] = fa_calls.get(key, 0) + c
            run_routes[key[-1]] = run_routes.get(key[-1], 0) + c
            routes[key[-1]] = routes.get(key[-1], 0) + c
        check(run_routes == {"wgmma": cfg.n_layers},
              f"serve {batch}x{plen}: flash-attention launches by route "
              f"{run_routes}, want all {cfg.n_layers} on wgmma")
        serve_launches += launches["flash_attention"]
        run = {"batch": batch, "prompt_len": plen, "gen_len": gen,
               "prefill_ms": t_pre * 1e3,
               "decode_ms_per_step": t_dec * 1e3 / (gen - 1),
               "tokens_per_s": batch * gen / (t_pre + t_dec),
               "prefill_tokens_per_s": batch * plen / t_pre,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "launches": launches, "routes": run_routes,
               "tokens": toks.tolist()}
        serve_runs.append(run)
        serve_prompts.append(prompts)
        print(f"[serve] {batch} x {plen}-token prompts, {gen} greedy tokens "
              f"each: prefill {run['prefill_ms']:.2f} ms, decode "
              f"{run['decode_ms_per_step']:.3f} ms/token (one per request "
              f"per step), {run['tokens_per_s']:.1f} generated tokens/s, "
              f"max_memory_allocated {run['max_memory_allocated']} B, "
              f"flash_attention launches {launches['flash_attention']} "
              f"by route {run_routes}", flush=True)
        if i == 0:
            bf16_prompts, bf16_first, bf16_tokens = prompts, first, toks
    details["serve"] = serve_runs
    print(f"[serve] flash_attention launches of the serve phase by route: "
          f"{routes} ({serve_launches} in all)", flush=True)

    # where the serve time goes: one profiled prefill at each shape and one
    # decode step at the first; the idle share is against the unprofiled
    # times
    from repro_torch.models.decode import decode_step, prefill
    state, profiles = {}, []
    for i, (run, prompts) in enumerate(zip(serve_runs, serve_prompts)):
        def prof_prefill():
            state["out"] = prefill(params, prompts, cfg,
                                   max_seq=run["prompt_len"] + 2)
        profiles.append(("prefill", run, device_busy(prof_prefill),
                         run["prefill_ms"]))
        if i == 0:
            logits, cache = state["out"]
            profiles.append(("decode step", run, device_busy(
                lambda: decode_step(params, cache,
                                    logits.argmax(-1, keepdim=True), cfg)),
                run["decode_ms_per_step"]))
            del logits, cache
    del state
    for what, run, rec, wall in profiles:
        rec["idle_share"] = (max(0.0, 1 - rec["busy_ms"] / wall)
                             if rec["busy_ms"] else None)
        top = ", ".join(f"{k} x{c} {t:.2f} ms" for k, c, t in rec["top"][:3])
        idle = ("not measured" if rec["idle_share"] is None
                else f"{rec['idle_share']:.1%}")
        print(f"[serve] profile of one {what} at {run['batch']} x "
              f"{run['prompt_len']}: device busy {rec['busy_ms']:.2f} ms of "
              f"{wall:.2f} ms (idle share {idle}), {rec['kernels']} kernels, "
              f"flash attention {rec['flash_ms']:.2f} ms; top: {top}",
              flush=True)
    details["serve_profile"] = {
        f"{what} {run['batch']}x{run['prompt_len']}": rec
        for what, run, rec, _ in profiles}

    # 7. serve parity: float32 compute, kernel vs plain attention
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 parity needs full float32")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gen = SERVE[0][2]
    zero_counts()
    k_first, k_toks, _, _ = greedy(params, bf16_prompts, cfg32, gen)
    check(launch_counts()["flash_attention"] == cfg.n_layers,
          "float32 serve did not go through the kernel")
    kernel_mha = attn_mod.mha
    attn_mod.mha = mha_ref
    try:
        zero_counts()
        p_first, p_toks, _, _ = greedy(params, bf16_prompts, cfg32, gen)
        pb_first, pb_toks, _, _ = greedy(params, bf16_prompts, cfg, gen)
        check(launch_counts()["flash_attention"] == 0,
              "the plain serve run launched the kernel")
    finally:
        attn_mod.mha = kernel_mha
    logit_err = float((k_first - p_first).abs().max())
    check(logit_err <= SERVE_LOGITS_ATOL,
          f"float32 serve: last-position logits kernel vs plain differ by "
          f"{logit_err} > {SERVE_LOGITS_ATOL}")
    check(torch.equal(k_toks, p_toks),
          "float32 serve: greedy tokens differ between kernel and plain")
    differ = (bf16_tokens != pb_toks).any(dim=0).nonzero()
    bf16_first_diff = int(differ[0]) if len(differ) else None
    bf16_err = float((bf16_first - pb_first).abs().max())
    details["serve_parity"] = {
        "float32_logits_max_abs_err": logit_err, "atol": SERVE_LOGITS_ATOL,
        "float32_tokens_equal": True,
        "bfloat16_logits_max_abs_err": bf16_err,
        "bfloat16_first_differing_step": bf16_first_diff}
    print(f"[serve parity] float32, {k_toks.shape[0]} x {k_toks.shape[1]} "
          f"greedy tokens: equal with the kernel and the plain version; "
          f"last-position logits max |diff| {logit_err:.3g} <= "
          f"{SERVE_LOGITS_ATOL} | bfloat16 kernel vs plain: logits max "
          f"|diff| {bf16_err:.3g}, tokens "
          + ("all equal" if bf16_first_diff is None else
             f"first differ at step {bf16_first_diff} (reported, not "
             f"checked)"), flush=True)
    del params

    # 8-9. captured bitstreams and a generator-fleet campaign, at full size
    tmp = tempfile.mkdtemp(prefix="chip_smoke_capture_")
    try:
        t0 = time.perf_counter()
        details["captured"], cap_path = captured_phase(
            tmp, accel["bigcrush"], big_entries, card)
        t1 = time.perf_counter()
        details["campaign"] = campaign_phase(cap_path, card)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # 10. elastic width and the fault domain
    details["elastic_faults"] = elastic_fault_phase(card, accel["bigcrush"],
                                                    big_entries)
    t3 = time.perf_counter()
    # 11. the screening service
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        details["screening"] = screening_phase(
            tmp, accel["bigcrush"], accel["bigcrush_mwc"], big_entries, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t4 = time.perf_counter()
    details["phase_s"] = {"captured": t1 - t0, "campaign": t2 - t1,
                          "elastic_faults": t3 - t2, "screening": t4 - t3}
    print(f"[time] phase 8 (captured) {t1 - t0:.1f}s, phase 9 (campaign) "
          f"{t2 - t1:.1f}s, phase 10 (elastic, faults) {t3 - t2:.1f}s, "
          f"phase 11 (screening) {t4 - t3:.1f}s, "
          f"{t0 - t_start:.1f}s before them", flush=True)

    # the kernels at the shapes their main paths gave them
    main_calls = calls["bigcrush"]
    shapes = {"histogram": [hist_case(n, k, seed=1) | {"launches": c}
                            for (n, k), c in main_calls["histogram"].items()],
              "gf2_rank": [rank_case(m, seed=1) | {"launches": c}
                           for m, c in main_calls["gf2_rank"].items()],
              "mwc": [mwc_case(n, [mwc_state(7, 0)]) | {"launches": c}
                      for n, c in calls["bigcrush_mwc"]["mwc"].items()],
              "flash_attention": [
                  fa_case(b, s, h, kh, dh, 0.0, dt.split(".")[-1], seed=1)
                  | {"launches": c}
                  for (b, s, t, h, kh, dh, dt, _), c in fa_calls.items()]}
    for name in ("histogram", "gf2_rank", "mwc"):
        for c in shapes[name]:
            print_battery(name, c)
    for c in shapes["flash_attention"]:
        print_fa(c)
    details["main_path_shapes"] = shapes
    details["main_path"] = {n: {k: r[k] for k in ("_wall_s", "_words",
                                                  "_launches", "rounds_run")}
                            for n, r in accel.items()}
    main_launches = {"histogram": accel["bigcrush"]["_launches"]["histogram"],
                     "gf2_rank": accel["bigcrush"]["_launches"]["gf2_rank"],
                     "mwc": accel["bigcrush_mwc"]["_launches"]["mwc"],
                     "flash_attention": serve_launches}
    rows = []
    meta = {"histogram": ("src/repro_torch/kernels/histogram/histogram.cu",
                          "src/repro/kernels/histogram/kernel.py:39"),
            "gf2_rank": ("src/repro_torch/kernels/gf2_rank/gf2_rank.cu",
                         "src/repro/kernels/gf2_rank/kernel.py:61"),
            "mwc": ("src/repro_torch/kernels/mwc/mwc.cu",
                    "src/repro/rng/generators.py:290"),
            "flash_attention": (
                "src/repro_torch/kernels/flash_attention/fa_hopper.cuh",
                "src/repro/kernels/flash_attention/kernel.py:80")}
    for name, cases in shapes.items():
        def total(key):
            if any(c[key] is None for c in cases):
                return None
            return sum(c[key] * c["launches"] for c in cases)
        bytes_bound = sum(c["bound_ms"] * c["launches"] for c in cases
                          if c["bound_by"] == "bytes")
        rows.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": main_launches[name],
            "launches_captured_bigcrush":
                details["captured"]["launches"][name],
            "launches_campaign": details["campaign"]["launches"][name],
            "launches_elastic_faults":
                details["elastic_faults"]["launches"][name],
            "launches_serve": details["screening"]["launches"][name],
            "max_abs_err": max(c["max_abs_err"] for c in
                               cases + details["parity"][name]),
            "ms": total("ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if bytes_bound * 2 >= total("bound_ms")
                         else "operations"),
            "library_ms": total("library_ms")})
    details["kernels"] = rows
    details["card"] = card
    details["seconds"] = time.perf_counter() - t_start
    print(f"[time] chip_smoke.py ran {details['seconds']:.1f}s, the "
          f"kernels' build included", flush=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1, default=str)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def save_failure():
    """After a failed run: the traceback and ``nvidia-smi -q`` into
    ``OUT_DIR/chip_smoke_failure.txt`` (kept for a fault that does not
    repeat, such as an illegal address after wrong kernel values)."""
    import traceback
    os.makedirs(OUT_DIR, exist_ok=True)
    try:
        smi = subprocess.run(["nvidia-smi", "-q"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"nvidia-smi -q failed: {exc}"
    with open(os.path.join(OUT_DIR, "chip_smoke_failure.txt"), "w") as f:
        f.write(traceback.format_exc() + "\n" + smi)


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        save_failure()
        raise
    sys.exit(code)
