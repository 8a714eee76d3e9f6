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
   within WGMMA_ROW_RTOL of its largest value; the sliding window (gemma2's
   local layers) on both routes against ``mha_ref(window=...)`` at
   windows 4096, 128, 300 and 1 (FA_WINDOW_PARITY), and a window of at
   least S bitwise the causal result on both routes; gemma2's prefill
   attention at its 8192-token prompt (GEMMA2_FA) timed with its window
   and without, beside the bounds of the pairs each mask keeps;
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
   degraded;
12. the static analyzer (``repro_torch.analysis``) against the card:
   ``python -m repro_torch.analysis --strict --json`` in a subprocess
   (exit 0, the reference's keys and 14 rules); one warm BigCrush x1.0
   on the kernels under ``torch.cuda.set_sync_debug_mode("warn")``,
   bitwise phase 4's: the syncs per round and each sync's innermost line
   under ``src/repro_torch``, every such line in a hot-path module one
   that RPA101/RPA102 reports; the analyzer's shared-memory budget equal
   to the card's per-block opt-in limit, and each kernel's static shared
   bytes equal to ptxas's.
13. (run right after phase 7) gemma2-27b on the card: at full width and
   depth with bfloat16 parameters (54.45 GB; float32 would not fit), a
   1 x 8192-token prompt with 16 greedy tokens and 4 x 512 with 32; 46
   flash-attention launches per prefill, all on ``wgmma``, 23 with the
   window; one profiled prefill and decode step; then 4 layers at full
   width in float32, a 1 x 5000-token prompt greedy through the kernel
   and the plain version (logits within SERVE_LOGITS_ATOL, tokens
   equal), and the 8192 prompt in bfloat16 at that depth (the first
   differing step reported).
14. (run right after phase 13) glm4-9b, chameleon-34b and
   nemotron-4-340b on the card: the kernel alone at each one's prefill
   attention shape (glm4's GQA group of 16, chameleon's 64 heads,
   nemotron's head dim 192 on the CUDA-core route in bfloat16 and
   float32) against its plain version, timed beside its bound and
   ``scaled_dot_product_attention``; then each at full width in bfloat16
   parameters, glm4 and chameleon at full depth (18.80 and 68.59 GB),
   nemotron at 4 of its 96 layers (46.51 GB): glm4 1 x 8192 with 16
   greedy tokens, chameleon and nemotron 1 x 4096 with 16 and 8, each 4 x
   512 with 32 (nemotron 16); one flash-attention launch a layer a
   prefill (``wgmma``, ``wgmma``, ``simt``); one profiled prefill and
   decode step each; then float32 greedy parity, kernel against plain,
   on a 1 x 1000-token prompt at 4 layers (nemotron 1). Each model is
   freed before the next is built.
15. (run right after phase 14) granite-moe-1b-a400m and deepseek-v2-236b
   on the card: the kernel alone at deepseek's MLA prefill attention
   shape (1 x 4096, 128 heads, q and k 192 wide, v 128: the CUDA-core
   route's (192, 128) instantiation, bfloat16 and float32) and granite's
   (1 x 4096, 16 heads on 8, dh 64, ``wgmma``) against its plain version,
   timed beside its bound and ``scaled_dot_product_attention``, with the
   sdpa backend that took the call and those that take it alone; then
   each at full width in bfloat16 parameters, granite at full depth
   (2.67 GB), deepseek at 8 of its 60 layers (1 dense + 7 MoE, 58.38
   GB): granite 1 x 4096 with 16 greedy tokens and 4 x 512 with 32,
   deepseek 1 x 4096 with 8 and 4 x 512 with 16; one flash-attention
   launch a layer a prefill (granite's 24 on ``wgmma``, deepseek's 8 on
   ``simt`` with dv 128); one profiled prefill and decode step each; then
   float32 greedy parity, kernel against plain, on a 1 x 1000-token
   prompt (granite at full depth, deepseek at 2 layers), the router's
   least top-k margin per step printed before a failure. Each model is
   freed before the next is built.
16. (run right after phase 15) zamba2-1.2b and xlstm-1.3b on the card:
   the kernel alone at zamba2's prefill attention shape (1 x 4096, 32
   heads on 32, dh 64, ``wgmma``) against its plain version, timed
   beside its bound and ``scaled_dot_product_attention`` with the sdpa
   backend that took the call; then both at full width and depth in
   bfloat16 parameters (2.34 and 4.04 GB), 1 x 4096 with 16 greedy
   tokens and 4 x 512 with 32: 7 flash-attention launches per zamba2
   prefill (its shared block before each of 6 groups of 6 Mamba-2 layers
   and before the tail of 2), all ``wgmma``, none for xlstm (no
   attention); one profiled prefill and decode step each (xlstm's 4 x 512
   prefill, device activity alone); then float32: zamba2 at full depth on
   a 1 x 1000 prompt (chunks of 8) with 8 greedy tokens through the
   kernel and the plain version, xlstm at full width and 8 layers on a 1
   x 256 prompt with 4 tokens on the card and on the CPU (logits within
   SERVE_LOGITS_ATOL, tokens equal); and for both, ``decode_step`` after
   ``prefill(255)`` (chunks of 1) against ``prefill(256)`` (chunks of
   128). Each model is freed before the next is built; the phase's
   seconds are printed.
17. (run right after phase 16) whisper-small on the card: the kernel's
   non-causal form alone on both routes (bfloat16 ``wgmma``, float32
   ``simt``) at the encoder's shape (8 x 1,500 frames, 12 heads, dh 64,
   padded to 1,536 with a key count of 1,500), timed beside its bound and
   ``scaled_dot_product_attention`` on the same unpadded inputs with the
   backend that took the call, and at the cross attention's (8 x 4 and 1
   x 224 queries on 1,500 keys), and at key counts 1, 64, 128 and 1,536,
   against its plain version (the tensor-core route also row by row
   against its arithmetic); then full width and depth (12 encoder + 12
   decoder layers) in bfloat16 parameters (0.61 GB), frames from the
   seed: 8 x 1,500 frames behind 4-token prompts with 64 greedy tokens,
   and 1 x 1,500 behind a 224-token prompt with 32; 36 flash-attention
   launches per prefill, all ``wgmma``, 24 non-causal (12 encoder, 12
   cross) and 12 causal; one profiled prefill and decode step; then
   float32 greedy parity, kernel (``simt``) against plain, at full depth
   on the 8 x 1,500 shape. The phase's seconds are printed.
18. (run right after phase 17) training on the card: the flash-attention
   forward with its row log-sum-exp (``return_lse``) bitwise the forward
   without on both routes, the lse within FA_ATOL of the plain one; the
   hand-written backward (``fa_bwd.cuh``) against ``attention_bwd_ref``
   within FA_BWD_TOL (of each gradient's largest magnitude) in both
   dtypes at every form the forward serves (qwen2's 2 x 2048 training
   microbatch, gemma2's softcap with window 4096 and without at S 4096, a
   window of 300, nemotron's dh 192, MLA's 192/128, whisper's non-causal
   encoder and cross attention with kv_len 1,500, and a ragged length
   through ``ops.mha`` under autograd), two calls bitwise equal, each form
   timed beside its bound and, where it computes the same function,
   sdpa's backward; a float32 train step
   of qwen2-1.5b at full width and 2 layers, kernel against plain
   attention (loss, every gradient leaf); then ``launch.train.train`` on
   qwen2-1.5b at full width and depth (8 x 2048 tokens a step, float32
   parameters and Adam, bf16 compute, 4 microbatches, full remat) for 6
   steps: finite losses, ms a step, tokens/s, peak memory, 224 forward
   and 112 backward flash-attention calls a step; one profiled step. The
   phase's seconds are printed.

Phase 3 times every kernel at the shapes the main paths gave it (BigCrush
for the battery kernels and mwc, phase 6 for flash attention).

Any failure raises, and the script exits non-zero without a result line;
the traceback and ``nvidia-smi -q`` go to ``reports/chip_smoke/chip_smoke_failure.txt``.
The kernels' JSON adds each kernel's launches in phases 8, 9, 10, 11,
13, 14, 15, 16, 17 and 18 (``launches_captured_bigcrush``,
``launches_campaign``, ``launches_elastic_faults``, ``launches_serve``,
``launches_gemma2``, ``launches_dense_archs``, ``launches_moe``,
``launches_recurrent``, ``launches_whisper``, ``launches_train``) beside
those of the main path, and flash attention's row its non-causal launches
in phase 17 (``bidir``); the backward's row (``flash_attention_bwd``)
counts its calls in phase 18's training run, each timed at qwen2's
training shape. The last three
lines are the kernels' JSON, the card, and ``{"ok": true, "device":
{...}}``.
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
# the sliding window on both routes (bfloat16 dh 64/128 on wgmma, float32
# on simt), each shape at every window of FA_WINDOWS and at S (a window
# of at least S: bitwise the causal result): 4096 is gemma2's, 128 one
# tile, 300 not a multiple of 128 (two edge tiles masked), 1 the diagonal
FA_WINDOW_PARITY = [(1, 5120, 4, 2, 128, 50.0, "bfloat16"),
                    (2, 1024, 4, 2, 64, 0.0, "bfloat16"),
                    (1, 5120, 4, 2, 128, 50.0, "float32"),
                    (2, 1024, 4, 2, 64, 0.0, "float32")]
FA_WINDOWS = [4096, 128, 300, 1]
# gemma2-27b's prefill attention at phase 13's 8192-token prompt, timed
# with its window and without (its local and global layers)
GEMMA2_FA = (1, 8192, 32, 16, 128, 50.0, "bfloat16")
GEMMA2_WINDOW = 4096
# phase 13: (batch, prompt length, generated tokens) at full depth, then
# the float32 parity run at reduced depth (a ragged prompt past the window)
GEMMA2_SERVE = [(1, 8192, 16), (4, 512, 32)]
GEMMA2_PARITY_LAYERS = 4
GEMMA2_PARITY = (1, 5000, 8)
# phase 14: the rest of the dense and vlm architectures at full width in
# bfloat16 parameters: layers served (None: full depth; nemotron-4-340b's
# 96 layers are 682 GB, so 4 of them, 46.51 GB), the flash-attention
# route every prefill launch must take, and (batch, prompt length,
# generated tokens) of each request
DENSE_ARCHS = {
    "glm4-9b": (None, "wgmma", [(1, 8192, 16), (4, 512, 32)]),
    "chameleon-34b": (None, "wgmma", [(1, 4096, 16), (4, 512, 32)]),
    "nemotron-4-340b": (4, "simt", [(1, 4096, 8), (4, 512, 16)]),
}
# then float32 parity at full width, kernel against plain: layers per arch
# (nemotron's one layer is 51.56 GB in float32), a ragged prompt
DENSE_PARITY_LAYERS = {"glm4-9b": 4, "chameleon-34b": 4,
                       "nemotron-4-340b": 1}
DENSE_PARITY = (1, 1000, 8)
# each arch's prefill attention at its longest phase-14 prompt, the kernel
# alone: (B, S, H, K, dh, softcap, dtype); nemotron's dh 192 in both dtypes
DENSE_FA = [("glm4-9b", (1, 8192, 32, 2, 128, 0.0, "bfloat16")),
            ("chameleon-34b", (1, 4096, 64, 8, 128, 0.0, "bfloat16")),
            ("nemotron-4-340b", (1, 4096, 96, 8, 192, 0.0, "bfloat16")),
            ("nemotron-4-340b", (1, 4096, 96, 8, 192, 0.0, "float32"))]
# phase 15: the moe family at full width in bfloat16 parameters: layers
# served (None: full depth; deepseek-v2-236b's 60 layers are 471.5 GB, so
# 8 of them, 1 dense + 7 MoE, 58.38 GB), the flash-attention route of
# every prefill launch, its q/k and v head dims, and (batch, prompt
# length, generated tokens) of each request
MOE_ARCHS = {
    "granite-moe-1b-a400m": (None, "wgmma", (64, 64),
                             [(1, 4096, 16), (4, 512, 32)]),
    "deepseek-v2-236b": (8, "simt", (192, 128),
                         [(1, 4096, 8), (4, 512, 16)]),
}
# then float32 parity at full width, kernel against plain: layers per arch
# (None: granite's 24, 5.34 GB; deepseek 1 dense + 1 MoE, 21.43 GB), a
# ragged prompt
MOE_PARITY_LAYERS = {"granite-moe-1b-a400m": None, "deepseek-v2-236b": 2}
MOE_PARITY = (1, 1000, 8)
# each arch's prefill attention at its longest phase-15 prompt, the kernel
# alone: (B, S, H, K, dh, softcap, dtype, dv); deepseek's MLA (dh 192,
# dv 128 on the CUDA-core route) in both dtypes
MOE_FA = [("deepseek-v2-236b", (1, 4096, 128, 128, 192, 0.0, "bfloat16",
                                128)),
          ("deepseek-v2-236b", (1, 4096, 128, 128, 192, 0.0, "float32",
                                128)),
          ("granite-moe-1b-a400m", (1, 4096, 16, 8, 64, 0.0, "bfloat16",
                                    64))]
# phase 16: the recurrent families at full width and depth in bfloat16
# parameters (zamba2-1.2b 2.34 GB, xlstm-1.3b 4.04 GB): the
# flash-attention launches a prefill must make (zamba2's shared block, 7
# applications: 38 = 6 x 6 + a tail of 2; xlstm has no attention), the
# request whose prefill is profiled (xlstm: the 4 x 512 one, device
# activity alone, since its 1 x 4096 prefill is ~0.5 M kernels), and
# (batch, prompt length, generated tokens) of each request; each request
# is warmed up on its first RECURRENT_WARMUP_LEN tokens (chunks of 128,
# as at 4096)
RECURRENT_WARMUP_LEN = 512
RECURRENT_ARCHS = {
    "zamba2-1.2b": (7, (1, 4096), [(1, 4096, 16), (4, 512, 32)]),
    "xlstm-1.3b": (0, (4, 512), [(1, 4096, 16), (4, 512, 32)]),
}
# zamba2's prefill attention at phase 16's 4096-token prompt, the kernel
# alone: (B, S, H, K, dh, softcap, dtype)
RECURRENT_FA = [("zamba2-1.2b", (1, 4096, 32, 32, 64, 0.0, "bfloat16"))]
# float32 parity: zamba2 at full depth, kernel against plain, a 1 x 1000
# prompt (chunks of 8) and 8 greedy tokens; xlstm (no kernel) on the card
# against the CPU at full width and 8 layers (one superblock), a 1 x 256
# prompt and 4 tokens
ZAMBA2_PARITY = (1, 1000, 8)
XLSTM_PARITY_LAYERS = 8
XLSTM_PARITY = (1, 256, 4)
# the chunked form against the recurrent one, float32: decode_step after
# prefill(L) against prefill(L + 1); L = 255 prefills in chunks of 1, L +
# 1 = 256 in chunks of 128
STEP_VS_CHUNK_LEN = 255
# phase 17: whisper-small at full width and depth in bfloat16 parameters
# (0.61 GB; 12 encoder + 12 decoder layers), encoder_seq frames a request
# drawn from the seed: (batch, decoder prompt length, generated tokens):
# 8 utterances behind whisper's 4-token start-of-transcript prompt, and
# one behind a 224-token prompt (a previous window's text); 36
# flash-attention launches a prefill, all ``wgmma`` at dh 64: 12 encoder
# (non-causal), 12 decoder self (causal), 12 cross (non-causal)
WHISPER_SERVE = [(8, 4, 64), (1, 224, 32)]
WHISPER_LAUNCHES = {"launches": 36, "bidir": 24}
# the kernel alone, non-causal, on both routes (bfloat16 ``wgmma``,
# float32 ``simt``): (B, S, T, H, dh); the encoder's 1,500 frames (padded
# to 1,536 with kv_len 1,500; timed), the cross attention of both
# prompts (S 4 -> 128, 224 -> 256) against them
WHISPER_FA = [("encoder", (8, 1500, 1500, 12, 64)),
              ("cross, 4-token prompt", (8, 4, 1500, 12, 64)),
              ("cross, 224-token prompt", (1, 224, 1500, 12, 64))]
# the key count's edge cases on T = 1,536 keys (S 256): one key, half a
# tile of either route, one tensor-core tile, every key
WHISPER_KV_LENS = [1, 64, 128, 1536]
# float32 greedy parity, kernel against plain, at full depth: the first
# request's shape, this many tokens
WHISPER_PARITY_GEN = 16
# phase 18: the flash-attention backward against its plain version at
# each form the forward serves, in both dtypes: (what, B, S, T, H, K,
# dqk, dv, causal, window, softcap, kv_len). qwen2's training microbatch
# (timed); gemma2's local layer (softcap 50, window 4096) and global one
# at its 4,096-token training length, and a window that bites at S 1024;
# nemotron's dh 192; deepseek's MLA (dqk 192, dv 128); whisper's encoder
# (1,500 frames padded to 1,536) and its cross attention (a 4-token
# prompt padded to 128 on the 1,500 frames)
FA_BWD_FORMS = [
    ("qwen2 training", 2, 2048, 2048, 12, 2, 128, 128, True, 0, 0.0, None),
    ("gemma2 local", 1, 4096, 4096, 32, 16, 128, 128, True, 4096, 50.0, None),
    ("gemma2 global", 1, 4096, 4096, 32, 16, 128, 128, True, 0, 50.0, None),
    ("window 300", 1, 1024, 1024, 8, 4, 128, 128, True, 300, 50.0, None),
    ("nemotron dh 192", 1, 1024, 1024, 96, 8, 192, 192, True, 0, 0.0, None),
    ("MLA 192/128", 1, 1024, 1024, 128, 128, 192, 128, True, 0, 0.0, None),
    ("whisper encoder", 8, 1536, 1536, 12, 12, 64, 64, False, 0, 0.0, 1500),
    ("whisper cross", 8, 128, 1536, 12, 12, 64, 64, False, 0, 0.0, 1500)]
# a length that is not a multiple of 128, through ``ops.mha`` under
# autograd (the padded call and its backward): (B, S, H, K, dh)
FA_BWD_RAGGED = (2, 1000, 12, 2, 128)
# max |kernel - plain| / max |plain| of each gradient (the plain version in
# float32 on the same inputs): float32 sums in other orders; bfloat16
# inputs, outputs and the forward's bfloat16 O in D = rowsum(dO . O)
FA_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the float32 train step, kernel against plain attention: qwen2-1.5b at
# full width and TRAIN_PARITY_LAYERS layers, (batch, sequence)
TRAIN_PARITY_LAYERS = 2
TRAIN_PARITY_SHAPE = (2, 1024)
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
# the training run: qwen2-1.5b at full width and depth through
# launch.train.train: float32 parameters and Adam moments, bfloat16
# compute, train_accum 4 (microbatches of 2), full remat
TRAIN_RUN = {"arch": "qwen2-1.5b", "steps": 6, "global_batch": 8,
             "seq_len": 2048}
# flash-attention launches a step: 28 layers x 4 microbatches, the
# forward twice under full remat (the backward's recompute), the backward
# once (three kernels a call)
TRAIN_LAUNCHES = {"forward": 224, "backward": 112}
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
# phase 12: the reference analyzer's --json keys
# (tests/test_analysis_cli.py) and its 14 rule codes and names
# (src/repro/analysis/rules), which the port's catalog keeps
ANALYSIS_KEYS = {"version", "strict", "clean", "files_scanned", "rules",
                 "findings", "baselined", "suppressed", "stale_baseline",
                 "counts"}
ANALYSIS_RULES = {
    "RPA101": "traced-python-branch", "RPA102": "traced-host-sync",
    "RPA103": "traced-closure-mutation", "RPA106": "fault-injection-in-trace",
    "RPA201": "cache-key-missing-field", "RPA202": "unclassified-spec-field",
    "RPA301": "backend-registry-closure",
    "RPA302": "unpinned-integer-reduction", "RPA303": "vmem-budget",
    "RPA401": "offset-registry-closure", "RPA402": "version-upgrade-path",
    "RPA403": "dynamic-registry-declaration", "RPA501": "unreachable-module",
    "RPA502": "stale-quarantine"}


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


def simt_attention(q, k, v, scale, softcap, window=0):
    """The CUDA-core flash-attention route on the same inputs, launched
    uncounted (``kernel._call``, not through the launcher): the yardstick
    of the tensor-core route at its own shapes. S a multiple of 128."""
    from repro_torch.kernels.flash_attention import kernel as fk
    rc, o = fk._call("simt", q, k, v, scale, softcap, window)
    check(rc == 0, f"flash_attention simt route: CUDA error {rc}")
    return o


def fa_case(b, s, h, kh, dh, cap, dtype, seed=0, dv=None, name_sdpa=False):
    """Check the flash-attention kernel against its plain version at
    q (B, S, H, dh), k (B, S, K, dh), v (B, S, K, dv) (dv default dh),
    and time both and the library call. ``ops.mha`` pads S to a multiple
    of 128; the kernel call is timed through it, as the model calls it.
    Where the tensor-core route takes the shape (S a multiple of 128), its
    output is also held, row by row, against its own arithmetic emulated
    in float32, and the CUDA-core route is checked and timed on the same
    inputs. ``name_sdpa`` also records which of sdpa's backends take the
    call alone and which one its dispatch picks (``sdpa_backend``)."""
    import torch
    import torch.nn.functional as F
    from test_torch_flash import WGMMA_ROW_RTOL, row_rel_err, wgmma_emulation
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import mha_ref
    dt = getattr(torch, dtype)
    dv = dh if dv is None else dv
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device="cuda").to(dt)
               for n, d in ((h, dh), (kh, dh), (kh, dv)))
    scale = dh ** -0.5
    got = mha(q, k, v, scale=scale, softcap=cap)
    want = mha_ref(q, k, v, scale=scale, softcap=cap)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"flash_attention {b}x{s}: shape or non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(got.shape[-1] == dv, f"flash_attention {b}x{s}: output head dim "
          f"{got.shape[-1]}, want v's {dv}")
    check(err <= FA_ATOL[dtype], f"flash_attention B{b} S{s} H{h} K{kh} "
          f"dh{dh} dv{dv} cap{cap} {dtype}: max |kernel - plain| {err} > "
          f"{FA_ATOL[dtype]}")
    # unmasked (query, key) pairs of the causal mask, on the real length;
    # QK^T takes 2 * dh operations per pair and PV 2 * dv
    esize = torch.finfo(dt).bits // 8
    n_ops = 2 * (dh + dv) * b * h * s * (s + 1) // 2
    n_bytes = esize * b * s * (h + kh) * (dh + dv)
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
        if name_sdpa:
            times["sdpa"] = sdpa_backend(library, qt, kt, vt, scale)
    kind = route(dt, dh, dv)
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
    return {"b": b, "s": s, "h": h, "kh": kh, "dh": dh, "dv": dv,
            "softcap": cap,
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
    dv = "" if c["dv"] == c["dh"] else f" dv{c['dv']}"
    if "sdpa" in c:
        kernels = ", ".join(n[:48] for n in c["sdpa"]["kernels"][:2])
        lib += (f" [backend {c['sdpa']['took']} ({kernels or 'kernels not '
                'captured'}); alone: {','.join(c['sdpa']['accept'])}]")
    print(f"[kernels] flash_attention B{c['b']} S{c['s']} H{c['h']} "
          f"K{c['kh']} dh{c['dh']}{dv} cap{c['softcap']} {c['dtype']} "
          f"({c['route']}): max err {c['max_abs_err']:.3g} <= {c['atol']} | "
          f"kernel {c['ms']:.4f} ms (device {c['device_ms']:.4f}), plain "
          f"{c['plain_ms']:.4f} ms, sdpa {lib}, bound {c['bound_ms']:.4f} ms "
          f"({c['bound_by']}){simt}", flush=True)


def sdpa_backend(call, q, k, v, scale, causal=True):
    """Which of ``scaled_dot_product_attention``'s backends take ``call``
    (causal unless ``causal`` is False, GQA, on q, k, v in its (B, H, S,
    d) layout) when it is the
    only one allowed (``accept``), which one its dispatch picks with all
    allowed (``took``: ``torch._fused_sdp_choice`` on the same inputs),
    and the device kernels of one profiled call (``kernels``; the
    profiler has returned none for so short a call late in a run)."""
    import warnings
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    accept = []
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        try:
            # a refusing backend warns its reasons before it raises
            with warnings.catch_warnings(), sdpa_kernel(
                    getattr(SDPBackend, name)):
                warnings.simplefilter("ignore")
                call()
            torch.cuda.synchronize()
            accept.append(name.lower())
        except RuntimeError:
            pass
    backends = {int(getattr(SDPBackend, n)): n.lower() for n in dir(SDPBackend)
                if n.isupper()}
    choice = int(torch._fused_sdp_choice(q, k, v, None, 0.0, causal,
                                         scale=scale, enable_gqa=True))
    return {"accept": accept, "took": backends.get(choice, str(choice)),
            "kernels": [n for n, _, _ in device_busy(call)["by_name"]][:6]}


def attended_pairs(s, window):
    """(query, key) pairs the mask keeps over one head's S queries:
    causal (window 0) or a sliding window."""
    if not window or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def fa_window_case(b, s, h, kh, dh, cap, dtype, window, seed=0,
                   timed=False):
    """Check the flash-attention kernel with a sliding window (0: causal)
    against its plain version (``mha_ref(window=...)``) within FA_ATOL at
    q (B, S, H, dh), k/v (B, S, K, dh); where the tensor-core route takes
    it, also row by row against its arithmetic emulated in float32, and
    the CUDA-core route on the same inputs (uncounted). A window of at
    least S must give the causal result bit for bit, on the launcher's
    route and on the CUDA-core one. ``timed`` adds per-call and device
    times of the kernel, the plain version's time (3 runs) and the bound
    from the pairs the mask keeps; the library column is None when the
    softcap is on (no single PyTorch call computes softcapped attention),
    and ``scaled_dot_product_attention`` with the window as a boolean mask
    and no softcap is timed beside it as a different function."""
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
    what = (f"flash_attention B{b} S{s} H{h} K{kh} dh{dh} cap{cap} {dtype} "
            f"window {window}")
    got = mha(q, k, v, scale=scale, softcap=cap, window=window)
    want = mha_ref(q, k, v, scale=scale, softcap=cap, window=window)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape or non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(err <= FA_ATOL[dtype], f"{what}: max |kernel - plain| {err} > "
                                 f"{FA_ATOL[dtype]}")
    kind = route(dt, dh)
    rec = {"b": b, "s": s, "h": h, "kh": kh, "dh": dh, "softcap": cap,
           "dtype": dtype, "window": window, "route": kind,
           "max_abs_err": err, "atol": FA_ATOL[dtype]}
    if kind == "wgmma":
        same = wgmma_emulation(q, k, v, scale=scale, softcap=cap,
                               window=window)
        rec["row_rel_err"] = row_rel_err(got, same)
        check(rec["row_rel_err"] <= WGMMA_ROW_RTOL, f"{what}: row-relative "
              f"error against its arithmetic {rec['row_rel_err']} > "
              f"{WGMMA_ROW_RTOL}")
        del same
        old = simt_attention(q, k, v, scale, cap, window)
        torch.cuda.synchronize()
        rec["simt_err"] = float((old.float() - want.float()).abs().max())
        check(rec["simt_err"] <= FA_ATOL[dtype], f"{what}: simt route max "
              f"|kernel - plain| {rec['simt_err']}")
        if window >= s:
            check(torch.equal(old, simt_attention(q, k, v, scale, cap)),
                  f"{what}: simt route, a window of at least S is not the "
                  f"causal result bit for bit")
        del old
    del want
    if window >= s:
        check(torch.equal(got, mha(q, k, v, scale=scale, softcap=cap)),
              f"{what}: a window of at least S is not the causal result "
              f"bit for bit")
        rec["bitwise_causal"] = True
    if not timed:
        return rec

    def kernel():
        return mha(q, k, v, scale=scale, softcap=cap, window=window)
    pairs = attended_pairs(s, window)
    esize = torch.finfo(dt).bits // 8
    peak = SCALAR_OPS_PER_S if dt == torch.float32 else TENSOR_BF16_FLOPS
    bound, by = bound_ms(esize * dh * b * (2 * s * h + 2 * s * kh),
                         4 * dh * b * h * pairs, peak)
    mask = (torch.ones((s, s), dtype=torch.bool, device="cuda").tril()
            .triu(1 - window) if 0 < window < s else None)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        if mask is None:
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    rec.update({
        "pairs": pairs, "bound_ms": bound, "bound_by": by,
        "peak_ops_per_s": peak, "ms": median_ms(kernel),
        "device_ms": device_ms(kernel),
        "plain_ms": median_ms(lambda: mha_ref(q, k, v, scale=scale,
                                              softcap=cap, window=window),
                              reps=3, warmup=1),
        "sdpa_no_softcap_ms": median_ms(sdpa),
        "sdpa_no_softcap_device_ms": device_ms(sdpa)})
    rec["library_ms"] = None if cap else rec["sdpa_no_softcap_ms"]
    return rec


def print_fa_window(c):
    """One ``[kernels]`` line of a windowed (or, timed, causal) case."""
    extra = ""
    if "row_rel_err" in c:
        extra += (f", row err vs its arithmetic {c['row_rel_err']:.3g}, "
                  f"simt route err {c['simt_err']:.3g}")
    if c.get("bitwise_causal"):
        extra += ", bitwise the causal result"
    if "ms" in c:
        extra += (f" | kernel {c['ms']:.4f} ms (device {c['device_ms']:.4f})"
                  f", plain {c['plain_ms']:.4f} ms, bound "
                  f"{c['bound_ms']:.4f} ms ({c['bound_by']}, {c['pairs']} "
                  f"pairs a head), library "
                  + ("none (softcap)" if c["library_ms"] is None
                     else f"{c['library_ms']:.4f} ms")
                  + f"; sdpa without softcap (a different function) "
                  f"{c['sdpa_no_softcap_ms']:.4f} ms (device "
                  f"{c['sdpa_no_softcap_device_ms']:.4f})")
    print(f"[kernels] flash_attention B{c['b']} S{c['s']} H{c['h']} "
          f"K{c['kh']} dh{c['dh']} cap{c['softcap']} {c['dtype']} window "
          f"{c['window']} ({c['route']}): max err {c['max_abs_err']:.3g} <= "
          f"{c['atol']}{extra}", flush=True)


def greedy(params, prompts, cfg, gen_len, frames=None):
    """One batch of greedy requests: prefill (whisper's from ``frames``),
    then argmax -> decode_step. Returns the prefill's last-position
    logits, the (B, gen_len) tokens (the first from the prefill) and the
    prefill and decode seconds."""
    import torch
    from repro_torch.models.decode import decode_step, prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts, cfg,
                            max_seq=prompts.shape[1] + gen_len,
                            frames=frames)
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
    """Set every kernel's launch count to 0 (just before a path runs),
    the flash-attention backward's too."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd
    for fn in _kernel_fns().values():
        fn.launches = 0
        fn.calls.clear()
        if hasattr(fn, "windowed"):
            fn.windowed = 0
            fn.split_dv = 0
            fn.bidir = 0
    flash_attention_bwd.launches = 0
    flash_attention_bwd.calls.clear()


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


def ptxas_smem(built):
    """``{mangled kernel: static shared bytes}`` from ptxas's report
    (``-Xptxas=-v``) of every kernel library: phase 2's build where it
    compiled the library, else a compile with the same flags into a
    temporary directory (the libraries were built already)."""
    from repro_torch.kernels import build
    logs = {n: built[n]["ptxas"] for n in build.SOURCES if n in built}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ptxas_")
    try:
        procs = {n: subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o",
             os.path.join(tmp, f"{n}.so"), str(build.SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for n in build.SOURCES if n not in logs}
        for n, proc in procs.items():
            logs[n] = proc.communicate(timeout=600)[0]
            check(proc.returncode == 0, f"nvcc {n}: exit {proc.returncode}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out, entry = {}, None
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif entry and re.search(r"Used \d+ registers", line):
                m = re.search(r"(\d+) bytes smem", line)
                out[entry] = int(m.group(1)) if m else 0
                entry = None
    return out


def analysis_phase(card, big_ref, big_entries, built):
    """Phase 12: the static analyzer (``repro_torch.analysis``) held to
    the card. (a) ``python -m repro_torch.analysis --strict --json`` in a
    subprocess: exit 0, the reference's keys and 14 rules. (b) one warm
    BigCrush x1.0 of splitmix64 and randu on the kernels under
    ``torch.cuda.set_sync_debug_mode("warn")``, bitwise phase 4's: every
    sync the card reports is traced to its innermost line under
    ``src/repro_torch``, and each such line in a hot-path module must be
    one RPA101/RPA102 reports (a finding or a suppressed one). (c) the
    analyzer's shared-memory budget equals the card's per-block opt-in
    limit, and each kernel's static shared bytes equal ptxas's."""
    import torch
    from repro_torch.analysis import Project
    from repro_torch.analysis.rules.kernels import (SMEM_BUDGET_BYTES,
                                                    shared_memory)
    from repro_torch.analysis.rules.trace import TRACED_MODULE_PATHS
    from repro_torch.kernels.histogram.kernel import device_limits
    # (a) the gate, as a user runs it
    path = os.path.join(OUT_DIR, "analysis.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict", "--json",
         path], cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(
             ROOT, "src")), capture_output=True, text=True, timeout=300)
    gate_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"analysis --strict: exit {proc.returncode}"
                                f"\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    with open(path) as f:
        rep = json.load(f)
    check(set(rep) == ANALYSIS_KEYS and rep["clean"] and rep["strict"],
          f"analysis report keys {sorted(rep)}, clean {rep.get('clean')}")
    rules = {r["code"]: r["name"] for r in rep["rules"]}
    check(rules == ANALYSIS_RULES, f"analysis rules {rules}")
    reported = {(f["path"], f["line"]) for f in rep["findings"]
                + rep["suppressed"] if f["code"] in ("RPA101", "RPA102")}
    print(f"[analysis] --strict on Python {sys.version.split()[0]}: exit 0 in "
          f"{gate_s:.1f}s, {rep['files_scanned']} files, {len(rules)} rules, "
          f"{rep['counts']['findings']} findings, "
          f"{rep['counts']['suppressed']} suppressed "
          f"({len(reported)} RPA101/RPA102 lines)", flush=True)

    # (b) host syncs of a warm BigCrush, by the innermost repro_torch line
    import warnings
    src = os.path.join(ROOT, "src", "repro_torch") + os.sep
    sites = {}

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        frame, site = sys._getframe(1), ("(outside src/repro_torch)", 0)
        while frame is not None:
            if frame.f_code.co_filename.startswith(src):
                site = (os.path.relpath(frame.f_code.co_filename, ROOT)
                        .replace(os.sep, "/"), frame.f_lineno)
                break
            frame = frame.f_back
        sites[site] = sites.get(site, 0) + 1

    big = dict(MAIN_ARGS)["bigcrush"]
    zero_counts()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run = run_cli("bigcrush_syncs", big, "accelerated")
        finally:
            torch.cuda.set_sync_debug_mode(0)
    launches = launch_counts()
    check(launches["histogram"] and launches["gf2_rank"],
          f"syncs run: a kernel was not launched {launches}")
    compare_bitwise(run, big_ref, "syncs run vs phase 4", big_entries)
    hot = {s: n for s, n in sites.items()
           if s[0].startswith(TRACED_MODULE_PATHS)}
    missed = sorted(s for s in hot if s not in reported)
    total, rounds = sum(sites.values()), run["rounds_run"]
    print(f"[analysis] syncs of a warm bigcrush on the kernels: {total} in "
          f"{rounds} rounds ({total / rounds:.2f} a round), "
          f"{sum(hot.values())} at {len(hot)} hot-path lines; bitwise "
          f"phase 4's", flush=True)
    for (p, ln), n in sorted(sites.items(), key=lambda kv: -kv[1]):
        tag = ("hot, reported" if (p, ln) in reported else "hot, MISSED"
               if (p, ln) in hot else "not hot")
        print(f"[analysis]   {n:5d} x {p}:{ln} ({tag})", flush=True)
    check(not missed, f"syncs the analyzer does not report: {missed}")

    # (c) shared memory: the budget is the card's, the static bytes ptxas's
    dev = torch.device("cuda", 0)
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    check(SMEM_BUDGET_BYTES == optin, f"SMEM_BUDGET_BYTES {SMEM_BUDGET_BYTES} "
                                      f"!= the card's opt-in {optin}")
    kernels = shared_memory(Project.from_tree(ROOT))
    ptxas = ptxas_smem(built)
    rows = []
    for k in kernels:
        entries = {e: b for e, b in ptxas.items()
                   if f"{len(k.name)}{k.name}" in e}
        check(entries and set(entries.values()) == {k.static_bytes},
              f"{k.name}: analyzer {k.static_bytes} static shared bytes, "
              f"ptxas {entries}")
        check(k.total_bytes is not None and k.total_bytes <= optin,
              f"{k.name}: {k.total_bytes} shared bytes over {optin}")
        rows.append({"kernel": k.name, "path": k.path,
                     "static_bytes": k.static_bytes,
                     "ptxas_entries": len(entries),
                     "dynamic_bound": k.dynamic_bytes,
                     "total_bytes": k.total_bytes})
        print(f"[analysis] shared memory {k.name}: {k.static_bytes} B static "
              f"(ptxas: the same in {len(entries)} entr"
              f"{'y' if len(entries) == 1 else 'ies'}), dynamic bound "
              f"{k.dynamic_bytes}, at most {k.total_bytes} of {optin} B",
              flush=True)
    matched = {e for e in ptxas for k in kernels
               if f"{len(k.name)}{k.name}" in e}
    check(matched == set(ptxas), f"ptxas entries the analyzer does not see: "
                                 f"{sorted(set(ptxas) - matched)}")
    hist_static = max(k.static_bytes for k in kernels
                      if k.path.endswith("histogram.cu"))
    limit = device_limits(0)[1]
    check(limit == optin - hist_static,
          f"histogram's dynamic limit {limit} != opt-in {optin} - "
          f"{hist_static} static")
    print(f"[analysis] SMEM_BUDGET_BYTES {SMEM_BUDGET_BYTES} == the card's "
          f"opt-in per block; histogram's dynamic limit {limit} = opt-in - "
          f"{hist_static} static ({card})", flush=True)
    return {"gate_s": gate_s, "files_scanned": rep["files_scanned"],
            "suppressed": rep["counts"]["suppressed"],
            "syncs": total, "rounds": rounds,
            "sites": [{"path": p, "line": ln, "count": n,
                       "hot": (p, ln) in hot, "reported": (p, ln) in reported}
                      for (p, ln), n in sorted(sites.items())],
            "launches": launches, "wall_s": run["_wall_s"],
            "shared_memory": rows, "optin": optin}


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


def fa_launches(flash):
    """The flash-attention launches since the counts were zeroed: in all,
    by route, and those given a window."""
    routes = {}
    for key, c in flash.calls.items():
        routes[key[-1]] = routes.get(key[-1], 0) + c
    return {"launches": flash.launches, "routes": routes,
            "windowed": flash.windowed}


def gemma2_phase(card):
    """Phase 13: gemma2-27b on the card, weights from seed 0.

    (a) Full width and depth (46 layers, 27.23e9 parameters) with the
    parameters in bfloat16 (54.45 GB; the reference's float32 master copy
    would be 108.9 GB and does not fit on one 80 GB card), compute
    bfloat16: GEMMA2_SERVE's requests, each after a warm-up at its shape;
    46 flash-attention launches per prefill, every one on the ``wgmma``
    route, 23 of them (the local layers) with gemma2's window; prefill
    ms, decode ms per token, tokens/s, peak memory; one profiled prefill
    of the longest prompt and one decode step. Launch counts are zeroed
    just before each measured request and read just after.
    (b) Full width, GEMMA2_PARITY_LAYERS layers, float32 parameters and
    compute: the GEMMA2_PARITY prompt (ragged, longer than the window: the
    CUDA-core route's window) greedy through the kernel and with the
    model's attention rebound to the plain version: last-position logits
    within SERVE_LOGITS_ATOL and every greedy token equal. Then (a)'s
    longest prompt in bfloat16 compute at that depth, kernel against
    plain: the first differing step is reported, not checked.
    Each model is freed before the next."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params
    from repro_torch.models.params import leaves
    flash = _kernel_fns()["flash_attention"]
    base = get_config("gemma2-27b")
    cfg = dataclasses.replace(base, param_dtype="bfloat16")
    n_local = cfg.n_layers // len(cfg.attn_pattern)
    out = {"launches": {name: 0 for name in _kernel_fns()}, "runs": []}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["param_bytes"] = sum(p.numel() * p.element_size() for p in
                             leaves(params))
    print(f"[gemma2] gemma2-27b at full width and depth ({cfg.n_layers}L "
          f"d{cfg.d_model} {cfg.n_heads}H/{cfg.n_kv_heads}kv dh"
          f"{cfg.head_dim_} ff{cfg.d_ff} vocab {cfg.vocab_size}, pattern "
          f"{cfg.attn_pattern}, window {cfg.local_window}, softcaps "
          f"{cfg.attn_softcap}/{cfg.final_softcap}): {cfg.n_params()} "
          f"bfloat16 parameters ({out['param_bytes']} B; float32 would "
          f"take {4 * cfg.n_params()} B, more than the card holds) from "
          f"seed 0 on cuda in {out['init_s']:.2f}s, compute "
          f"{cfg.compute_dtype} | {card}", flush=True)
    prompts_by_len = {}
    for i, (batch, plen, gen) in enumerate(GEMMA2_SERVE):
        prompts = prompts_for(cfg, batch, plen, seed=100 + i)
        prompts_by_len[plen] = prompts
        greedy(params, prompts, cfg, 2)          # warm-up at this shape
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        first, toks, t_pre, t_dec = greedy(params, prompts, cfg, gen)
        launches = launch_counts()
        fa = fa_launches(flash)
        check(fa == {"launches": cfg.n_layers,
                     "routes": {"wgmma": cfg.n_layers}, "windowed": n_local},
              f"gemma2 {batch}x{plen}: flash-attention launches {fa}, want "
              f"{cfg.n_layers} on wgmma, {n_local} windowed")
        for name, c in launches.items():
            out["launches"][name] += c
        run = {"batch": batch, "prompt_len": plen, "gen_len": gen,
               "prefill_ms": t_pre * 1e3,
               "decode_ms_per_step": t_dec * 1e3 / (gen - 1),
               "tokens_per_s": batch * gen / (t_pre + t_dec),
               "prefill_tokens_per_s": batch * plen / t_pre,
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "flash": fa, "calls": {str(k): c for k, c in
                                      flash.calls.items()},
               "tokens": toks.tolist()}
        out["runs"].append(run)
        print(f"[gemma2] {batch} x {plen}-token prompts, {gen} greedy "
              f"tokens each: prefill {run['prefill_ms']:.2f} ms, decode "
              f"{run['decode_ms_per_step']:.3f} ms/token (one per request "
              f"per step), {run['tokens_per_s']:.2f} generated tokens/s, "
              f"max_memory_allocated {run['max_memory_allocated']} B, "
              f"flash_attention {fa['launches']} launches by route "
              f"{fa['routes']}, {fa['windowed']} windowed", flush=True)

    # where the time goes: one profiled prefill of the longest prompt and
    # one decode step after it; idle share against the unprofiled times
    run = max(out["runs"], key=lambda r: r["prompt_len"] * r["batch"])
    out["profile"] = profile_serving("gemma2", params, cfg, run,
                                     prompts_by_len[run["prompt_len"]])
    del params
    torch.cuda.empty_cache()

    # (b) parity at full width and reduced depth, float32
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 parity needs full float32")
    cfg32 = dataclasses.replace(base, n_layers=GEMMA2_PARITY_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    n_local = cfg32.n_layers // len(cfg32.attn_pattern)
    params = init_params(cfg32, seed=0)
    batch, plen, gen = GEMMA2_PARITY
    prompts = prompts_for(cfg32, batch, plen, seed=200)
    zero_counts()
    k_first, k_toks, k_pre, _ = greedy(params, prompts, cfg32, gen)
    fa = fa_launches(flash)
    check(fa == {"launches": cfg32.n_layers,
                 "routes": {"simt": cfg32.n_layers}, "windowed": n_local},
          f"gemma2 float32 parity: flash-attention launches {fa}")
    kernel_mha = attn_mod.mha
    attn_mod.mha = mha_ref
    try:
        zero_counts()
        p_first, p_toks, p_pre, _ = greedy(params, prompts, cfg32, gen)
        check(launch_counts()["flash_attention"] == 0,
              "the plain gemma2 run launched the kernel")
    finally:
        attn_mod.mha = kernel_mha
    logit_err = float((k_first - p_first).abs().max())
    check(logit_err <= SERVE_LOGITS_ATOL,
          f"gemma2 float32: last-position logits kernel vs plain differ by "
          f"{logit_err} > {SERVE_LOGITS_ATOL}")
    check(torch.equal(k_toks, p_toks),
          "gemma2 float32: greedy tokens differ between kernel and plain")
    # bfloat16 compute at this depth on (a)'s longest prompt
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    prompts = prompts_for(cfg16, run["batch"], run["prompt_len"], seed=100)
    zero_counts()
    b_first, b_toks, _, _ = greedy(params, prompts, cfg16, run["gen_len"])
    fa16 = fa_launches(flash)
    check(fa16 == {"launches": cfg16.n_layers,
                   "routes": {"wgmma": cfg16.n_layers}, "windowed": n_local},
          f"gemma2 bfloat16 parity: flash-attention launches {fa16}")
    attn_mod.mha = mha_ref
    try:
        pb_first, pb_toks, _, _ = greedy(params, prompts, cfg16,
                                         run["gen_len"])
    finally:
        attn_mod.mha = kernel_mha
    differ = (b_toks != pb_toks).any(dim=0).nonzero()
    bf16_first_diff = int(differ[0]) if len(differ) else None
    bf16_err = float((b_first - pb_first).abs().max())
    out["parity"] = {
        "layers": cfg32.n_layers, "prompt": [batch, plen], "gen": gen,
        "float32_logits_max_abs_err": logit_err, "atol": SERVE_LOGITS_ATOL,
        "float32_tokens_equal": True, "float32_flash": fa,
        "float32_prefill_ms": {"kernel": k_pre * 1e3, "plain": p_pre * 1e3},
        "bfloat16_prompt": [run["batch"], run["prompt_len"]],
        "bfloat16_flash": fa16,
        "bfloat16_logits_max_abs_err": bf16_err,
        "bfloat16_first_differing_step": bf16_first_diff}
    print(f"[gemma2 parity] {cfg32.n_layers} layers at full width, float32 "
          f"parameters and compute, {batch} x {plen}-token prompt, {gen} "
          f"greedy tokens: equal with the kernel ({fa['launches']} launches "
          f"on {fa['routes']}, {fa['windowed']} windowed) and the plain "
          f"version; last-position logits max |diff| {logit_err:.3g} <= "
          f"{SERVE_LOGITS_ATOL} | bfloat16 compute, {run['batch']} x "
          f"{run['prompt_len']}: logits max |diff| {bf16_err:.3g}, tokens "
          + ("all equal" if bf16_first_diff is None else
             f"first differ at step {bf16_first_diff} (reported, not "
             f"checked)"), flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def profile_serving(tag, params, cfg, run, prompts, cpu=True, frames=None):
    """One profiled prefill of ``prompts`` (whisper's from ``frames``) and
    one decode step after it: device busy ms, idle share against the
    run's unprofiled times, flash attention's device ms, the top kernels
    (printed under ``tag``). ``cpu=False`` traces the device alone
    (``device_busy``)."""
    from repro_torch.models.decode import decode_step, prefill
    state = {}

    def prof_prefill():
        state["out"] = prefill(params, prompts, cfg,
                               max_seq=run["prompt_len"] + 2, frames=frames)
    profiles = {"prefill": (device_busy(prof_prefill, cpu=cpu),
                            run["prefill_ms"])}
    logits, cache = state.pop("out")
    profiles["decode step"] = (device_busy(lambda: decode_step(
        params, cache, logits.argmax(-1, keepdim=True), cfg), cpu=cpu),
        run["decode_ms_per_step"])
    del logits, cache
    out = {}
    for what, (rec, wall) in profiles.items():
        rec["wall_ms"] = wall
        rec["idle_share"] = (max(0.0, 1 - rec["busy_ms"] / wall)
                             if rec["busy_ms"] else None)
        top = ", ".join(f"{k} x{c} {t:.2f} ms" for k, c, t in rec["top"][:3])
        idle = ("not measured" if rec["idle_share"] is None
                else f"{rec['idle_share']:.1%}")
        print(f"[{tag}] profile of one {what} at {run['batch']} x "
              f"{run['prompt_len']}: device busy {rec['busy_ms']:.2f} ms of "
              f"{wall:.2f} ms (idle share {idle}), {rec['kernels']} "
              f"kernels, flash attention {rec['flash_ms']:.2f} ms; top: "
              f"{top}", flush=True)
        out[what] = {k: rec[k] for k in rec if k != "by_name"}
    return out


def dense_archs_phase(card):
    """Phase 14: glm4-9b, chameleon-34b and nemotron-4-340b on the card,
    weights from seed 0, each model freed before the next is built.

    (a) The kernel alone at each arch's prefill attention shape
    (DENSE_FA: glm4's GQA group of 16, chameleon's 64 heads, nemotron's
    dh 192 on the CUDA-core route in bfloat16 and float32), through
    ``fa_case``: against ``mha_ref`` within FA_ATOL, per-call and device
    ms, the operations bound, ``scaled_dot_product_attention``'s time
    (no softcap: the same function).
    (b) Each arch at full width with bfloat16 parameters (glm4 and
    chameleon at full depth, nemotron at 4 of 96 layers), compute
    bfloat16: DENSE_ARCHS' requests, each after a warm-up at its shape;
    one flash-attention launch per layer per prefill, all on the arch's
    route, none windowed; prefill ms, decode ms per step, tokens/s, peak
    memory; one profiled prefill of the longest prompt and one decode
    step. Launch counts are zeroed just before each measured request and
    read just after.
    (c) Each arch at full width and DENSE_PARITY_LAYERS layers in float32
    parameters and compute: the ragged DENSE_PARITY prompt greedy through
    the kernel and with the model's attention rebound to the plain
    version: last-position logits within SERVE_LOGITS_ATOL and every
    greedy token equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params
    from repro_torch.models.params import leaves
    flash = _kernel_fns()["flash_attention"]
    out = {"launches": {name: 0 for name in _kernel_fns()},
           "attention": [], "archs": {}}
    torch.cuda.empty_cache()
    for arch, shape in DENSE_FA:
        c = fa_case(*shape, seed=3)
        c["arch"] = arch
        out["attention"].append(c)
        print_fa(c)
        torch.cuda.empty_cache()

    for arch, (layers, fa_route, requests) in DENSE_ARCHS.items():
        base = get_config(arch)
        cfg = dataclasses.replace(base, param_dtype="bfloat16",
                                  n_layers=layers or base.n_layers)
        rec = {"layers": cfg.n_layers, "full_layers": base.n_layers,
               "reduced": (None if layers is None else
                           f"n_layers {base.n_layers} -> {layers}: "
                           f"{base.n_params()} bfloat16 parameters do not "
                           f"fit on one 80 GB card"),
               "n_params": cfg.n_params(), "runs": []}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in leaves(params))
        print(f"[dense] {arch} at full width, {cfg.n_layers} of "
              f"{base.n_layers} layers (d{cfg.d_model} {cfg.n_heads}H/"
              f"{cfg.n_kv_heads}kv dh{cfg.head_dim_} ff{cfg.d_ff} "
              f"{cfg.act}{'' if cfg.gated_mlp else ' ungated'}"
              f"{' qk-norm' if cfg.qk_norm else ''} vocab {cfg.vocab_size}, "
              f"family {cfg.family}, frontend {cfg.frontend}): "
              f"{rec['n_params']} bfloat16 parameters ({rec['param_bytes']} "
              f"B) from seed 0 on cuda in {rec['init_s']:.2f}s | {card}",
              flush=True)
        prompts_by_len = {}
        for i, (batch, plen, gen) in enumerate(requests):
            prompts = prompts_for(cfg, batch, plen, seed=300 + i)
            prompts_by_len[plen] = prompts
            greedy(params, prompts, cfg, 2)          # warm-up at this shape
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            first, toks, t_pre, t_dec = greedy(params, prompts, cfg, gen)
            launches = launch_counts()
            fa = fa_launches(flash)
            dhs = sorted({key[5] for key in flash.calls})
            check(fa == {"launches": cfg.n_layers,
                         "routes": {fa_route: cfg.n_layers}, "windowed": 0}
                  and dhs == [cfg.head_dim_],
                  f"{arch} {batch}x{plen}: flash-attention launches {fa} at "
                  f"dh {dhs}, want {cfg.n_layers} on {fa_route} at dh "
                  f"{cfg.head_dim_}")
            for name, n in launches.items():
                out["launches"][name] += n
            run = {"batch": batch, "prompt_len": plen, "gen_len": gen,
                   "prefill_ms": t_pre * 1e3,
                   "decode_ms_per_step": t_dec * 1e3 / (gen - 1),
                   "tokens_per_s": batch * gen / (t_pre + t_dec),
                   "prefill_tokens_per_s": batch * plen / t_pre,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "flash": fa, "calls": {str(k): n for k, n in
                                          flash.calls.items()},
                   "tokens": toks.tolist()}
            rec["runs"].append(run)
            print(f"[dense] {arch} {batch} x {plen}-token prompts, {gen} "
                  f"greedy tokens each: prefill {run['prefill_ms']:.2f} ms, "
                  f"decode {run['decode_ms_per_step']:.3f} ms/token (one per "
                  f"request per step), {run['tokens_per_s']:.2f} generated "
                  f"tokens/s, max_memory_allocated "
                  f"{run['max_memory_allocated']} B, flash_attention "
                  f"{fa['launches']} launches by route {fa['routes']} at dh "
                  f"{cfg.head_dim_}", flush=True)
        run = max(rec["runs"], key=lambda r: r["prompt_len"] * r["batch"])
        rec["profile"] = profile_serving("dense", params, cfg, run,
                                         prompts_by_len[run["prompt_len"]])
        del params, prompts_by_len
        torch.cuda.empty_cache()

        # (c) float32 parity at reduced depth, kernel against plain
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: float32 parity needs full float32")
        cfg32 = dataclasses.replace(base, n_layers=DENSE_PARITY_LAYERS[arch],
                                    param_dtype="float32",
                                    compute_dtype="float32")
        params = init_params(cfg32, seed=0)
        batch, plen, gen = DENSE_PARITY
        prompts = prompts_for(cfg32, batch, plen, seed=400)
        zero_counts()
        k_first, k_toks, k_pre, _ = greedy(params, prompts, cfg32, gen)
        fa = fa_launches(flash)
        check(fa == {"launches": cfg32.n_layers,
                     "routes": {"simt": cfg32.n_layers}, "windowed": 0},
              f"{arch} float32 parity: flash-attention launches {fa}")
        kernel_mha = attn_mod.mha
        attn_mod.mha = mha_ref
        try:
            zero_counts()
            p_first, p_toks, p_pre, _ = greedy(params, prompts, cfg32, gen)
            check(launch_counts()["flash_attention"] == 0,
                  f"the plain {arch} run launched the kernel")
        finally:
            attn_mod.mha = kernel_mha
        logit_err = float((k_first - p_first).abs().max())
        check(logit_err <= SERVE_LOGITS_ATOL,
              f"{arch} float32: last-position logits kernel vs plain differ "
              f"by {logit_err} > {SERVE_LOGITS_ATOL}")
        check(torch.equal(k_toks, p_toks),
              f"{arch} float32: greedy tokens differ between kernel and "
              f"plain")
        rec["parity"] = {
            "layers": cfg32.n_layers, "prompt": [batch, plen], "gen": gen,
            "float32_logits_max_abs_err": logit_err,
            "atol": SERVE_LOGITS_ATOL, "float32_tokens_equal": True,
            "float32_flash": fa,
            "float32_prefill_ms": {"kernel": k_pre * 1e3,
                                   "plain": p_pre * 1e3}}
        print(f"[dense parity] {arch}, {cfg32.n_layers} layers at full "
              f"width, float32 parameters and compute, {batch} x {plen}-"
              f"token prompt, {gen} greedy tokens: equal with the kernel "
              f"({fa['launches']} launches on {fa['routes']}) and the plain "
              f"version; last-position logits max |diff| {logit_err:.3g} <= "
              f"{SERVE_LOGITS_ATOL}", flush=True)
        del params
        torch.cuda.empty_cache()
        out["archs"][arch] = rec
    return out


@contextlib.contextmanager
def router_margins(store):
    """While inside, each MoE layer call also appends to ``store`` its
    router's least top-k margin over its tokens: the k-th largest
    probability minus the (k+1)-th (a 0-d tensor; read after the run).
    A near-tie there is where two runs may route a token apart."""
    from repro_torch.models import moe as moe_mod
    original = moe_mod.moe

    def recorded(p, x, cfg):
        probs, _, _ = moe_mod.route(p, x.reshape(-1, x.shape[-1]), cfg.moe)
        top = probs.topk(cfg.moe.top_k + 1, dim=-1).values
        store.append((top[:, -2] - top[:, -1]).min())
        return original(p, x, cfg)
    moe_mod.moe = recorded
    try:
        yield store
    finally:
        moe_mod.moe = original


def moe_phase(card):
    """Phase 15: granite-moe-1b-a400m and deepseek-v2-236b on the card,
    weights from seed 0, each model freed before the next is built.

    (a) The kernel alone at each arch's prefill attention shape (MOE_FA:
    deepseek's MLA heads, q and k 192 wide and v 128, on the CUDA-core
    route in bfloat16 and float32; granite's dh 64 on ``wgmma``), through
    ``fa_case``: against ``mha_ref`` within FA_ATOL, per-call and device
    ms, the operations bound, ``scaled_dot_product_attention``'s time and
    the backend that took it.
    (b) Each arch at full width with bfloat16 parameters (granite at full
    depth, deepseek at 8 of 60 layers), compute bfloat16: MOE_ARCHS'
    requests, each after a warm-up at its shape; one flash-attention
    launch per layer per prefill, all on the arch's route at its head
    dims (deepseek's all with dv 128: ``split_dv``); prefill ms, decode
    ms per step, tokens/s, peak memory; one profiled prefill of the
    longest prompt and one decode step. Launch counts are zeroed just
    before each measured request and read just after.
    (c) Each arch at full width and MOE_PARITY_LAYERS layers in float32
    parameters and compute: the ragged MOE_PARITY prompt greedy through
    the kernel and with the model's attention rebound to the plain
    version: last-position logits within SERVE_LOGITS_ATOL and every
    greedy token equal; the router's least top-k margin per step is
    recorded and printed before a failure."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params
    from repro_torch.models.params import leaves
    flash = _kernel_fns()["flash_attention"]
    out = {"launches": {name: 0 for name in _kernel_fns()},
           "attention": [], "archs": {}}
    torch.cuda.empty_cache()
    for arch, (b, s, h, kh, dh, cap, dtype, dv) in MOE_FA:
        c = fa_case(b, s, h, kh, dh, cap, dtype, seed=5, dv=dv,
                    name_sdpa=True)
        c["arch"] = arch
        out["attention"].append(c)
        print_fa(c)
        torch.cuda.empty_cache()

    for arch, (layers, fa_route, (dqk, dv), requests) in MOE_ARCHS.items():
        base = get_config(arch)
        cfg = dataclasses.replace(base, param_dtype="bfloat16",
                                  n_layers=layers or base.n_layers)
        m = cfg.moe
        rec = {"layers": cfg.n_layers, "full_layers": base.n_layers,
               "reduced": (None if layers is None else
                           f"n_layers {base.n_layers} -> {layers}: "
                           f"{base.n_params()} bfloat16 parameters do not "
                           f"fit on one 80 GB card"),
               "n_params": cfg.n_params(),
               "n_active_params": cfg.n_active_params(), "runs": []}
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in leaves(params))
        attn = (f"MLA q_lora {cfg.mla.q_lora_rank} kv_lora "
                f"{cfg.mla.kv_lora_rank} dqk {dqk} dv {dv}" if cfg.mla else
                f"GQA {cfg.n_heads}H/{cfg.n_kv_heads}kv dh {cfg.head_dim_}")
        print(f"[moe] {arch} at full width, {cfg.n_layers} of "
              f"{base.n_layers} layers (d{cfg.d_model}, {attn}; "
              f"{m.first_dense_layers} dense layers ff{m.d_ff_dense}, "
              f"{m.n_experts} experts top-{m.top_k} ff{m.d_ff_expert}, "
              f"{m.n_shared} shared ff{m.d_ff_shared}; vocab "
              f"{cfg.vocab_size}): {rec['n_params']} bfloat16 parameters "
              f"({rec['param_bytes']} B; {rec['n_active_params']} active a "
              f"token) from seed 0 on cuda in {rec['init_s']:.2f}s | {card}",
              flush=True)
        prompts_by_len = {}
        for i, (batch, plen, gen) in enumerate(requests):
            prompts = prompts_for(cfg, batch, plen, seed=500 + i)
            prompts_by_len[plen] = prompts
            greedy(params, prompts, cfg, 2)          # warm-up at this shape
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            first, toks, t_pre, t_dec = greedy(params, prompts, cfg, gen)
            launches = launch_counts()
            fa = fa_launches(flash)
            dhs = sorted({key[5] for key in flash.calls})
            split = flash.split_dv
            check(fa == {"launches": cfg.n_layers,
                         "routes": {fa_route: cfg.n_layers}, "windowed": 0}
                  and dhs == [dqk]
                  and split == (cfg.n_layers if dv != dqk else 0),
                  f"{arch} {batch}x{plen}: flash-attention launches {fa} at "
                  f"dh {dhs}, {split} with dv != dh; want {cfg.n_layers} on "
                  f"{fa_route} at dh {dqk}, dv {dv}")
            for name, n in launches.items():
                out["launches"][name] += n
            run = {"batch": batch, "prompt_len": plen, "gen_len": gen,
                   "prefill_ms": t_pre * 1e3,
                   "decode_ms_per_step": t_dec * 1e3 / (gen - 1),
                   "tokens_per_s": batch * gen / (t_pre + t_dec),
                   "prefill_tokens_per_s": batch * plen / t_pre,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "flash": fa, "split_dv": split,
                   "calls": {str(k): n for k, n in flash.calls.items()},
                   "tokens": toks.tolist()}
            rec["runs"].append(run)
            print(f"[moe] {arch} {batch} x {plen}-token prompts, {gen} "
                  f"greedy tokens each: prefill {run['prefill_ms']:.2f} ms, "
                  f"decode {run['decode_ms_per_step']:.3f} ms/token (one per "
                  f"request per step), {run['tokens_per_s']:.2f} generated "
                  f"tokens/s, max_memory_allocated "
                  f"{run['max_memory_allocated']} B, flash_attention "
                  f"{fa['launches']} launches by route {fa['routes']} at dh "
                  f"{dqk} dv {dv} ({split} with dv != dh)", flush=True)
        run = max(rec["runs"], key=lambda r: r["prompt_len"] * r["batch"])
        rec["profile"] = profile_serving("moe", params, cfg, run,
                                         prompts_by_len[run["prompt_len"]])
        del params, prompts_by_len
        torch.cuda.empty_cache()

        # (c) float32 parity, kernel against plain
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: float32 parity needs full float32")
        cfg32 = dataclasses.replace(
            base, n_layers=MOE_PARITY_LAYERS[arch] or base.n_layers,
            param_dtype="float32", compute_dtype="float32")
        params = init_params(cfg32, seed=0)
        batch, plen, gen = MOE_PARITY
        prompts = prompts_for(cfg32, batch, plen, seed=600)
        zero_counts()
        with router_margins([]) as k_margins:
            k_first, k_toks, k_pre, _ = greedy(params, prompts, cfg32, gen)
        fa = fa_launches(flash)
        check(fa == {"launches": cfg32.n_layers,
                     "routes": {"simt": cfg32.n_layers}, "windowed": 0},
              f"{arch} float32 parity: flash-attention launches {fa}")
        kernel_mha = attn_mod.mha
        attn_mod.mha = mha_ref
        try:
            zero_counts()
            with router_margins([]) as p_margins:
                p_first, p_toks, p_pre, _ = greedy(params, prompts, cfg32,
                                                   gen)
            check(launch_counts()["flash_attention"] == 0,
                  f"the plain {arch} run launched the kernel")
        finally:
            attn_mod.mha = kernel_mha
        n_moe = cfg32.n_layers - cfg32.moe.first_dense_layers
        margins = [[float(min(ms[i:i + n_moe]))
                    for i in range(0, len(ms), n_moe)]
                   for ms in (k_margins, p_margins)]
        logit_err = float((k_first - p_first).abs().max())
        differ = (k_toks != p_toks).any(dim=0).nonzero()
        if logit_err > SERVE_LOGITS_ATOL or len(differ):
            last = int(differ[0]) if len(differ) else 0
            for step in range(last + 1):
                here = " (tokens differ here)" if len(differ) else ""
                print(f"[moe parity] {arch} step {step}: least router "
                      f"top-{cfg32.moe.top_k} margin kernel "
                      f"{margins[0][step]:.3g}, plain {margins[1][step]:.3g}"
                      f"{here if step == last else ''}", flush=True)
        check(logit_err <= SERVE_LOGITS_ATOL,
              f"{arch} float32: last-position logits kernel vs plain differ "
              f"by {logit_err} > {SERVE_LOGITS_ATOL}")
        check(not len(differ),
              f"{arch} float32: greedy tokens differ between kernel and "
              f"plain from step {int(differ[0]) if len(differ) else -1}")
        rec["parity"] = {
            "layers": cfg32.n_layers, "prompt": [batch, plen], "gen": gen,
            "float32_logits_max_abs_err": logit_err,
            "atol": SERVE_LOGITS_ATOL, "float32_tokens_equal": True,
            "float32_flash": fa,
            "router_margin_min": {"kernel": min(margins[0]),
                                  "plain": min(margins[1])},
            "float32_prefill_ms": {"kernel": k_pre * 1e3,
                                   "plain": p_pre * 1e3}}
        print(f"[moe parity] {arch}, {cfg32.n_layers} layers at full "
              f"width, float32 parameters and compute, {batch} x {plen}-"
              f"token prompt, {gen} greedy tokens: equal with the kernel "
              f"({fa['launches']} launches on {fa['routes']}) and the plain "
              f"version; last-position logits max |diff| {logit_err:.3g} <= "
              f"{SERVE_LOGITS_ATOL}; least router top-{cfg32.moe.top_k} "
              f"margin {min(margins[0]):.3g}", flush=True)
        del params
        torch.cuda.empty_cache()
        out["archs"][arch] = rec
    return out


def step_vs_chunk(params, cfg, prompts):
    """Max |decode_step after prefill(L) - prefill(L + 1)| over the last
    logits, for the (B, L + 1) ``prompts``: the recurrent form against the
    chunked one."""
    from repro_torch.models.decode import decode_step, prefill
    n = prompts.shape[1] - 1
    _, cache = prefill(params, prompts[:, :n], cfg, max_seq=n + 1)
    got, _ = decode_step(params, cache, prompts[:, n:], cfg)
    want, _ = prefill(params, prompts, cfg)
    return float((got.float() - want.float()).abs().max())


def recurrent_phase(card):
    """Phase 16: zamba2-1.2b and xlstm-1.3b on the card, weights from
    seed 0, each model freed before the next is built.

    (a) The kernel alone at zamba2's prefill attention shape
    (RECURRENT_FA: 32 heads on 32, dh 64, ``wgmma``), through ``fa_case``:
    against ``mha_ref`` within FA_ATOL, per-call and device ms, the
    operations bound, ``scaled_dot_product_attention``'s time and the
    backend that took it.
    (b) Each arch at full width and depth with bfloat16 parameters,
    compute bfloat16: RECURRENT_ARCHS' requests, each after a warm-up at
    its batch on its first RECURRENT_WARMUP_LEN tokens; zamba2's prefill launches flash attention 7 times, all on
    ``wgmma`` at dh 64, xlstm's no kernel at all; prefill ms, decode ms
    per step, tokens/s, peak memory; one profiled prefill and decode step.
    Launch counts are zeroed just before each measured request and read
    just after.
    (c) Float32 parameters and compute: zamba2 at full depth, the
    ZAMBA2_PARITY prompt greedy through the kernel and with the model's
    attention rebound to the plain version, last-position logits within
    SERVE_LOGITS_ATOL and every token equal; xlstm at full width and
    XLSTM_PARITY_LAYERS layers, the XLSTM_PARITY prompt greedy on the card
    and on the CPU from the same weights, the same checks.
    (d) Float32: ``decode_step`` after ``prefill(STEP_VS_CHUNK_LEN)``
    against ``prefill(STEP_VS_CHUNK_LEN + 1)``'s last logits within
    SERVE_LOGITS_ATOL (zamba2 at full depth, xlstm at its parity
    depth)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params
    from repro_torch.models.params import leaves, tree_map
    flash = _kernel_fns()["flash_attention"]
    out = {"launches": {name: 0 for name in _kernel_fns()},
           "attention": [], "archs": {}}
    torch.cuda.empty_cache()
    for arch, shape in RECURRENT_FA:
        c = fa_case(*shape, seed=7, name_sdpa=True)
        c["arch"] = arch
        out["attention"].append(c)
        print_fa(c)
        torch.cuda.empty_cache()

    for arch, (n_fa, prof_shape, requests) in RECURRENT_ARCHS.items():
        t_arch = time.perf_counter()
        base = get_config(arch)
        cfg = dataclasses.replace(base, param_dtype="bfloat16")
        rec = {"layers": cfg.n_layers, "n_params": cfg.n_params(),
               "runs": []}
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0)
        torch.cuda.synchronize()
        rec["init_s"] = time.perf_counter() - t0
        rec["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in leaves(params))
        blocks = (f"Mamba-2 d_state {cfg.ssm.d_state} head_dim "
                  f"{cfg.ssm.head_dim}, shared attention+MLP every "
                  f"{cfg.shared_attn_every} ({cfg.n_heads}H dh "
                  f"{cfg.head_dim_}, ff {cfg.d_ff} {cfg.act})"
                  if cfg.family == "hybrid" else
                  f"mLSTM:sLSTM {cfg.xlstm.slstm_every - 1}:1, {cfg.n_heads} "
                  f"heads, proj {cfg.xlstm.proj_factor_m}")
        print(f"[recurrent] {arch} at full width and depth, {cfg.n_layers} "
              f"layers (d{cfg.d_model}, {blocks}; vocab {cfg.vocab_size}): "
              f"{rec['n_params']} bfloat16 parameters ({rec['param_bytes']} "
              f"B) from seed 0 on cuda in {rec['init_s']:.2f}s | {card}",
              flush=True)
        prompts_by_shape = {}
        for i, (batch, plen, gen) in enumerate(requests):
            prompts = prompts_for(cfg, batch, plen, seed=700 + i)
            prompts_by_shape[(batch, plen)] = prompts
            # warm-up at this batch and chunk length (xlstm's 4096-token
            # prefill is seconds of host time, so not at its full length)
            greedy(params, prompts[:, :RECURRENT_WARMUP_LEN], cfg, 2)
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            first, toks, t_pre, t_dec = greedy(params, prompts, cfg, gen)
            launches = launch_counts()
            fa = fa_launches(flash)
            dhs = sorted({key[5] for key in flash.calls})
            want = {"launches": n_fa, "windowed": 0,
                    "routes": {"wgmma": n_fa} if n_fa else {}}
            check(fa == want and dhs == ([cfg.head_dim_] if n_fa else [])
                  and sum(launches.values()) == n_fa,
                  f"{arch} {batch}x{plen}: kernel launches {launches}, "
                  f"flash attention {fa} at dh {dhs}; want {want}")
            for name, n in launches.items():
                out["launches"][name] += n
            run = {"batch": batch, "prompt_len": plen, "gen_len": gen,
                   "prefill_ms": t_pre * 1e3,
                   "decode_ms_per_step": t_dec * 1e3 / (gen - 1),
                   "tokens_per_s": batch * gen / (t_pre + t_dec),
                   "prefill_tokens_per_s": batch * plen / t_pre,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "flash": fa, "tokens": toks.tolist()}
            rec["runs"].append(run)
            print(f"[recurrent] {arch} {batch} x {plen}-token prompts, {gen} "
                  f"greedy tokens each: prefill {run['prefill_ms']:.2f} ms, "
                  f"decode {run['decode_ms_per_step']:.3f} ms/token (one per "
                  f"request per step), {run['tokens_per_s']:.2f} generated "
                  f"tokens/s, max_memory_allocated "
                  f"{run['max_memory_allocated']} B, flash_attention "
                  f"{fa['launches']} launches by route {fa['routes']}",
                  flush=True)
        run = next(r for r in rec["runs"]
                   if (r["batch"], r["prompt_len"]) == prof_shape)
        rec["profile"] = profile_serving(
            "recurrent", params, cfg, run, prompts_by_shape[prof_shape],
            cpu=bool(n_fa))
        rec["profile_shape"] = list(prof_shape)
        del params, prompts_by_shape
        torch.cuda.empty_cache()

        # (c) float32 parity; (d) the recurrent form against the chunked
        check(not torch.backends.cuda.matmul.allow_tf32,
              "TF32 matmuls are on: float32 parity needs full float32")
        layers = base.n_layers if n_fa else XLSTM_PARITY_LAYERS
        cfg32 = dataclasses.replace(base, n_layers=layers,
                                    param_dtype="float32",
                                    compute_dtype="float32")
        params = init_params(cfg32, seed=0)
        batch, plen, gen = ZAMBA2_PARITY if n_fa else XLSTM_PARITY
        prompts = prompts_for(cfg32, batch, plen, seed=800)
        zero_counts()
        k_first, k_toks, k_pre, _ = greedy(params, prompts, cfg32, gen)
        fa = fa_launches(flash)
        check(fa == {"launches": n_fa, "windowed": 0,
                     "routes": {"simt": n_fa} if n_fa else {}},
              f"{arch} float32 parity: flash-attention launches {fa}")
        if n_fa:
            other = "the plain version"
            kernel_mha = attn_mod.mha
            attn_mod.mha = mha_ref
            try:
                zero_counts()
                p_first, p_toks, p_pre, _ = greedy(params, prompts, cfg32,
                                                   gen)
                check(launch_counts()["flash_attention"] == 0,
                      f"the plain {arch} run launched the kernel")
            finally:
                attn_mod.mha = kernel_mha
        else:
            other = "the CPU"
            cpu_params = tree_map(lambda a: a.cpu(), params)
            t0 = time.perf_counter()
            p_first, p_toks, _, _ = greedy(cpu_params, prompts.cpu(), cfg32,
                                           gen)
            p_pre = time.perf_counter() - t0
            del cpu_params
        logit_err = float((k_first.cpu() - p_first.cpu()).abs().max())
        check(logit_err <= SERVE_LOGITS_ATOL,
              f"{arch} float32: last-position logits against {other} "
              f"differ by {logit_err} > {SERVE_LOGITS_ATOL}")
        check(torch.equal(k_toks.cpu(), p_toks.cpu()),
              f"{arch} float32: greedy tokens differ from {other}'s")
        step_prompts = prompts_for(cfg32, 2, STEP_VS_CHUNK_LEN + 1, seed=801)
        step_err = step_vs_chunk(params, cfg32, step_prompts)
        check(step_err <= SERVE_LOGITS_ATOL,
              f"{arch} float32: decode_step after prefill("
              f"{STEP_VS_CHUNK_LEN}) differs from prefill("
              f"{STEP_VS_CHUNK_LEN + 1}) by {step_err} > "
              f"{SERVE_LOGITS_ATOL}")
        rec["parity"] = {
            "layers": layers, "against": other, "prompt": [batch, plen],
            "gen": gen, "float32_logits_max_abs_err": logit_err,
            "atol": SERVE_LOGITS_ATOL, "float32_tokens_equal": True,
            "float32_flash": fa,
            "float32_prefill_s": {"card": k_pre, "other": p_pre},
            "step_vs_chunk": {"prompt": [2, STEP_VS_CHUNK_LEN + 1],
                              "max_abs_err": step_err}}
        print(f"[recurrent parity] {arch}, {layers} layers at full width, "
              f"float32 parameters and compute, {batch} x {plen}-token "
              f"prompt, {gen} greedy tokens: equal on the card "
              f"({fa['launches']} flash-attention launches on "
              f"{fa['routes']}) and with {other}; last-position logits max "
              f"|diff| {logit_err:.3g} <= {SERVE_LOGITS_ATOL} | decode_step "
              f"after prefill({STEP_VS_CHUNK_LEN}) against prefill("
              f"{STEP_VS_CHUNK_LEN + 1}), 2 prompts: max |diff| "
              f"{step_err:.3g} <= {SERVE_LOGITS_ATOL}", flush=True)
        del params
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t_arch
        out["archs"][arch] = rec
    return out


def fa_bidir_case(b, s, t, h, dh, dtype, seed=0, timed=False):
    """Check the flash-attention kernel's non-causal form against its
    plain version at q (B, S, H, dh), k/v (B, T, H, dh), through
    ``ops.mha(causal=False)`` as the model calls it (S and T padded to
    128, ``kv_len = T``), within FA_ATOL; on the tensor-core route also
    row by row against its own arithmetic emulated in float32.
    ``timed`` adds per-call and device times of the kernel, the plain
    version's time, ``scaled_dot_product_attention`` on the same unpadded
    non-causal inputs (the same function) with the backend that takes it,
    and the bound from the S x T pairs."""
    import torch
    import torch.nn.functional as F
    from test_torch_flash import WGMMA_ROW_RTOL, row_rel_err, wgmma_emulation
    from repro_torch.kernels.flash_attention.kernel import BLOCK, route
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import mha_ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, n, h, dh), generator=g, device="cuda").to(dt)
               for n in (s, t, t))
    scale = dh ** -0.5
    what = f"flash_attention non-causal B{b} S{s} T{t} H{h} dh{dh} {dtype}"
    got = mha(q, k, v, scale=scale, causal=False)
    want = mha_ref(q, k, v, scale=scale, causal=False)
    torch.cuda.synchronize()
    check(got.shape == want.shape == (b, s, h, dh)
          and bool(torch.isfinite(got).all()),
          f"{what}: shape or non-finite output")
    err = float((got.float() - want.float()).abs().max())
    check(err <= FA_ATOL[dtype], f"{what}: max |kernel - plain| {err} > "
                                 f"{FA_ATOL[dtype]}")
    kind = route(dt, dh)
    rec = {"b": b, "s": s, "t": t, "h": h, "dh": dh, "dtype": dtype,
           "route": kind, "kv_len": t, "padded": [-(-s // BLOCK) * BLOCK,
                                                  -(-t // BLOCK) * BLOCK],
           "max_abs_err": err, "atol": FA_ATOL[dtype]}
    if kind == "wgmma":
        pad = lambda x, n: F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))
        sp, tp = rec["padded"]
        same = wgmma_emulation(pad(q, sp), pad(k, tp), pad(v, tp),
                               scale=scale, causal=False, kv_len=t)[:, :s]
        rec["row_rel_err"] = row_rel_err(got, same)
        check(rec["row_rel_err"] <= WGMMA_ROW_RTOL, f"{what}: row-relative "
              f"error against its arithmetic {rec['row_rel_err']} > "
              f"{WGMMA_ROW_RTOL}")
        del same
    del want
    if not timed:
        return rec

    def kernel():
        return mha(q, k, v, scale=scale, causal=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
    esize = torch.finfo(dt).bits // 8
    peak = SCALAR_OPS_PER_S if dt == torch.float32 else TENSOR_BF16_FLOPS
    # QK^T and PV, 2 * dh operations each a (query, key) pair; q, k, v
    # read once and o written once, unpadded
    bound, by = bound_ms(esize * b * h * dh * 2 * (s + t),
                         4 * dh * b * h * s * t, peak)
    rec.update({"ms": median_ms(kernel), "device_ms": device_ms(kernel),
                "plain_ms": median_ms(lambda: mha_ref(q, k, v, scale=scale,
                                                      causal=False),
                                      reps=3, warmup=1),
                "library_ms": median_ms(library),
                "library_device_ms": device_ms(library),
                "sdpa": sdpa_backend(library, qt, kt, vt, scale,
                                     causal=False),
                "bound_ms": bound, "bound_by": by, "peak_ops_per_s": peak})
    return rec


def fa_kv_len_case(kv_len, dtype, seed=0):
    """The launcher's non-causal form at one key count on T = 1,536 keys
    (S 256, 12 heads, dh 64) against ``mha_ref(kv_len=...)``."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((1, n, 12, 64), generator=g, device="cuda").to(dt)
               for n in (256, 1536, 1536))
    got = flash_attention(q, k, v, scale=0.125, causal=False, kv_len=kv_len)
    want = mha_ref(q, k, v, scale=0.125, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and err <= FA_ATOL[dtype],
          f"flash_attention non-causal kv_len {kv_len} of 1536 {dtype}: max "
          f"|kernel - plain| {err} > {FA_ATOL[dtype]}")
    return err


def whisper_phase(card):
    """Phase 17: whisper-small on the card, weights and frames from seed 0.

    (a) The kernel's non-causal form alone on both routes (bfloat16
    ``wgmma``, float32 ``simt``), through ``fa_bidir_case``: at the
    encoder's shape (8 x 1,500 frames, 12 heads, dh 64; timed beside
    ``scaled_dot_product_attention`` and the bound) and the cross
    attention's (8 x 4 and 1 x 224 queries on 1,500 keys) against
    ``mha_ref`` within FA_ATOL; the key counts WHISPER_KV_LENS through the
    launcher.
    (b) Full width and depth with bfloat16 parameters, compute bfloat16,
    frames (B, encoder_seq, d_model) from the seed: WHISPER_SERVE's
    requests, each after a warm-up at its shape; 36 flash-attention
    launches a prefill, all ``wgmma``, 24 non-causal (encoder and
    cross); prefill ms, decode ms per step, tokens/s, peak memory; one
    profiled prefill and decode step at the first shape. Launch counts
    are zeroed just before each measured request and read just after.
    (c) Float32 parameters and compute, full depth, the first request's
    shape and frames, WHISPER_PARITY_GEN greedy tokens through the kernel
    (``simt``) and with the model's attention rebound to the plain
    version: last-position logits within SERVE_LOGITS_ATOL and every
    token equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.lm import init_params
    from repro_torch.models.params import leaves
    flash = _kernel_fns()["flash_attention"]
    out = {"launches": {name: 0 for name in _kernel_fns()}, "bidir": 0,
           "attention": [], "kv_lens": {}, "runs": []}
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        for i, (what, shape) in enumerate(WHISPER_FA):
            c = fa_bidir_case(*shape, dtype, seed=17 + i, timed=i == 0)
            c["what"] = what
            out["attention"].append(c)
            times = ""
            if "ms" in c:
                times = (f" | kernel {c['ms']:.4f} ms (device "
                         f"{c['device_ms']:.4f}), plain {c['plain_ms']:.4f} "
                         f"ms, sdpa {c['library_ms']:.4f} ms (device "
                         f"{c['library_device_ms']:.4f}) [backend "
                         f"{c['sdpa']['took']}; alone: "
                         f"{','.join(c['sdpa']['accept'])}], bound "
                         f"{c['bound_ms']:.4f} ms ({c['bound_by']})")
            row = (f", row err vs its arithmetic {c['row_rel_err']:.3g}"
                   if "row_rel_err" in c else "")
            print(f"[whisper kernels] {what}: B{c['b']} S{c['s']} T{c['t']} "
                  f"(padded {c['padded']}, kv_len {c['kv_len']}) H{c['h']} "
                  f"dh{c['dh']} {dtype} ({c['route']}): max err "
                  f"{c['max_abs_err']:.3g} <= {c['atol']}{row}{times}",
                  flush=True)
            torch.cuda.empty_cache()
        errs = {n: fa_kv_len_case(n, dtype, seed=n) for n in WHISPER_KV_LENS}
        out["kv_lens"][dtype] = errs
        print(f"[whisper kernels] kv_len on 1536 keys, {dtype}: max err "
              + ", ".join(f"{n}: {e:.3g}" for n, e in errs.items())
              + f" <= {FA_ATOL[dtype]}", flush=True)

    base = get_config("whisper-small")
    cfg = dataclasses.replace(base, param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    out["n_params"] = cfg.n_params()
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in leaves(params))
    print(f"[whisper] whisper-small at full width and depth, "
          f"{cfg.n_encoder_layers} encoder + {cfg.n_layers} decoder layers "
          f"(d{cfg.d_model}, {cfg.n_heads}H dh {cfg.head_dim_}, ff {cfg.d_ff} "
          f"{cfg.act}; vocab {cfg.vocab_size}; {cfg.encoder_seq} frames): "
          f"{out['n_params']} bfloat16 parameters ({out['param_bytes']} B) "
          f"from seed 0 on cuda in {out['init_s']:.2f}s | {card}", flush=True)
    inputs = []
    for i, (batch, plen, gen) in enumerate(WHISPER_SERVE):
        prompts = prompts_for(cfg, batch, plen, seed=1700 + i)
        g = torch.Generator(device="cuda").manual_seed(1710 + i)
        frames = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                             generator=g, device="cuda")
        inputs.append((prompts, frames))
        greedy(params, prompts, cfg, 2, frames=frames)       # warm-up
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        first, toks, t_pre, t_dec = greedy(params, prompts, cfg, gen,
                                           frames=frames)
        launches = launch_counts()
        fa = fa_launches(flash) | {"bidir": flash.bidir}
        dhs = sorted({key[5] for key in flash.calls})
        want = dict(WHISPER_LAUNCHES, windowed=0,
                    routes={"wgmma": WHISPER_LAUNCHES["launches"]})
        check(fa == want and dhs == [cfg.head_dim_]
              and sum(launches.values()) == want["launches"],
              f"whisper {batch}x{plen}: kernel launches {launches}, flash "
              f"attention {fa} at dh {dhs}; want {want}")
        for name, n in launches.items():
            out["launches"][name] += n
        out["bidir"] += fa["bidir"]
        run = {"batch": batch, "prompt_len": plen, "gen_len": gen,
               "frames": cfg.encoder_seq, "prefill_ms": t_pre * 1e3,
               "decode_ms_per_step": t_dec * 1e3 / (gen - 1),
               "tokens_per_s": batch * gen / (t_pre + t_dec),
               "max_memory_allocated": torch.cuda.max_memory_allocated(),
               "flash": fa, "tokens": toks.tolist()}
        out["runs"].append(run)
        print(f"[whisper] {batch} x {cfg.encoder_seq} frames, {plen}-token "
              f"prompts, {gen} greedy tokens each: prefill "
              f"{run['prefill_ms']:.2f} ms, decode "
              f"{run['decode_ms_per_step']:.3f} ms/token (one per request "
              f"per step), {run['tokens_per_s']:.2f} generated tokens/s, "
              f"max_memory_allocated {run['max_memory_allocated']} B, "
              f"flash_attention {fa['launches']} launches ({fa['bidir']} "
              f"non-causal) by route {fa['routes']}", flush=True)
    out["profile"] = profile_serving("whisper", params, cfg, out["runs"][0],
                                     inputs[0][0], frames=inputs[0][1])
    del params
    torch.cuda.empty_cache()

    # (c) float32 parity at full depth, kernel against plain
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 parity needs full float32")
    cfg32 = dataclasses.replace(base, param_dtype="float32",
                                compute_dtype="float32")
    params = init_params(cfg32, seed=0)
    prompts, frames = inputs[0]
    zero_counts()
    k_first, k_toks, _, _ = greedy(params, prompts, cfg32,
                                   WHISPER_PARITY_GEN, frames=frames)
    fa = fa_launches(flash) | {"bidir": flash.bidir}
    check(fa == dict(WHISPER_LAUNCHES, windowed=0,
                     routes={"simt": WHISPER_LAUNCHES["launches"]}),
          f"whisper float32 parity: flash-attention launches {fa}")
    kernel_mha = attn_mod.mha
    attn_mod.mha = mha_ref
    try:
        zero_counts()
        p_first, p_toks, _, _ = greedy(params, prompts, cfg32,
                                       WHISPER_PARITY_GEN, frames=frames)
        check(launch_counts()["flash_attention"] == 0,
              "the plain whisper run launched the kernel")
    finally:
        attn_mod.mha = kernel_mha
    logit_err = float((k_first - p_first).abs().max())
    check(logit_err <= SERVE_LOGITS_ATOL,
          f"whisper float32: last-position logits kernel vs plain differ by "
          f"{logit_err} > {SERVE_LOGITS_ATOL}")
    check(torch.equal(k_toks, p_toks),
          "whisper float32: greedy tokens differ between kernel and plain")
    out["parity"] = {"prompt": list(prompts.shape), "gen": WHISPER_PARITY_GEN,
                     "float32_logits_max_abs_err": logit_err,
                     "atol": SERVE_LOGITS_ATOL, "float32_tokens_equal": True,
                     "float32_flash": fa}
    print(f"[whisper parity] full depth, float32 parameters and compute, "
          f"{prompts.shape[0]} x {cfg32.encoder_seq} frames, "
          f"{prompts.shape[1]}-token prompts, {WHISPER_PARITY_GEN} greedy "
          f"tokens: equal with the kernel ({fa['launches']} launches on "
          f"{fa['routes']}) and the plain version; last-position logits "
          f"max |diff| {logit_err:.3g} <= {SERVE_LOGITS_ATOL}", flush=True)
    del params
    torch.cuda.empty_cache()
    return out


def fa_bwd_case(what, b, s, t, h, kh, dqk, dv, causal, window, cap, kv_len,
                dtype, seed=0, timed=False):
    """Phase 18 (a) and (b) at one form: the forward with ``return_lse``
    gives O bitwise the one without, on the launcher's route and (bf16 at
    dh 64/128) the CUDA-core one; its lse within FA_ATOL of
    ``attention_ref``'s; the backward within FA_BWD_TOL of
    ``attention_bwd_ref`` (float32, the same inputs) in each gradient,
    and two calls equal bit for bit. ``timed`` adds the backward's per-call
    and device ms, the plain version's, the bound (the five products of
    the pairs the mask keeps; the bytes of q, k, v, o, dO and the three
    gradients) and ``scaled_dot_product_attention``'s backward on the same
    inputs where it computes the same function (causal, no window, no
    softcap, dv = dqk)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         mha_ref)
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for shape in ((b, s, h, dqk), (b, t, kh, dqk),
                                 (b, t, kh, dv), (b, s, h, dv)))
    m = {"scale": dqk ** -0.5, "softcap": cap, "window": window,
         "causal": causal, "kv_len": kv_len}
    name = (f"flash_attention_bwd {what} B{b} S{s} T{t} H{h} K{kh} "
            f"dqk{dqk} dv{dv} {dtype}")
    o0 = fk.flash_attention(q, k, v, **m)
    o, lse = fk.flash_attention(q, k, v, **m, return_lse=True)
    kind = fk.route(dt, dqk, dv)
    rec = {"what": what, "b": b, "s": s, "t": t, "h": h, "kh": kh,
           "dqk": dqk, "dv": dv, "causal": causal, "window": window,
           "softcap": cap, "kv_len": kv_len, "dtype": dtype, "route": kind}
    check(torch.equal(o0, o), f"{name}: the forward's O with lse is not "
                              f"bitwise the one without ({kind})")
    want_o, want_lse = mha_ref(q, k, v, **m, return_lse=True)
    rec["lse_err"] = float((lse - want_lse).abs().max())
    check(rec["lse_err"] <= FA_ATOL[dtype], f"{name}: max |lse - plain| "
          f"{rec['lse_err']} > {FA_ATOL[dtype]}")
    if kind == "wgmma":
        # the CUDA-core route on the same inputs, uncounted
        lse_s = torch.empty_like(lse)
        rc0, a = fk._call("simt", q, k, v, m["scale"], cap, window, causal,
                          kv_len)
        rc1, a_lse = fk._call("simt", q, k, v, m["scale"], cap, window,
                              causal, kv_len, lse_s)
        torch.cuda.synchronize()
        check(rc0 == rc1 == 0 and torch.equal(a, a_lse),
              f"{name}: the simt route's O with lse is not bitwise the one "
              f"without")
        rec["simt_lse_err"] = float((lse_s - want_lse).abs().max())
        check(rec["simt_lse_err"] <= FA_ATOL[dtype], f"{name}: simt route "
              f"max |lse - plain| {rec['simt_lse_err']}")
        del a, a_lse, lse_s
    del o0, want_o, want_lse
    g1 = fk.flash_attention_bwd(q, k, v, o, lse, do, **m)
    g2 = fk.flash_attention_bwd(q, k, v, o, lse, do, **m)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(g1, g2)),
          f"{name}: two backward calls differ")
    del g2
    want = attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                             do.float(), **m)
    rec["rel_err"], rec["abs_err"] = [], []
    for label, x, w in zip(("dq", "dk", "dv"), g1, want):
        check(bool(torch.isfinite(x).all()), f"{name}: non-finite {label}")
        diff = float((x.float() - w).abs().max())
        rel = diff / float(w.abs().max())
        rec["abs_err"].append(diff)
        rec["rel_err"].append(rel)
        check(rel <= FA_BWD_TOL[dtype], f"{name}: {label} max |kernel - "
              f"plain| / max |plain| {rel} > {FA_BWD_TOL[dtype]}")
    rec["max_abs_err"] = max(rec["abs_err"])
    rec["tol"] = FA_BWD_TOL[dtype]
    del want, g1
    if not timed:
        return rec
    # (query, key) pairs the mask keeps over one head
    pairs = (attended_pairs(s, window) if causal
             else s * (t if kv_len is None else kv_len))
    esize = torch.finfo(dt).bits // 8
    n_ops = 2 * (3 * dqk + 2 * dv) * b * h * pairs
    n_bytes = (esize * (b * s * h * (2 * dqk + 2 * dv)
                        + 2 * b * t * kh * (dqk + dv)) + 4 * b * h * s)
    peak = SCALAR_OPS_PER_S if dt == torch.float32 else TENSOR_BF16_FLOPS
    bound, by = bound_ms(n_bytes, n_ops, peak)

    def kernel():
        return fk.flash_attention_bwd(q, k, v, o, lse, do, **m)
    rec.update({"pairs": pairs, "flop": n_ops, "bytes": n_bytes,
                "bound_ms": bound, "bound_by": by, "peak_ops_per_s": peak,
                "ms": median_ms(kernel), "device_ms": device_ms(kernel),
                "plain_ms": median_ms(lambda: attention_bwd_ref(
                    q, k, v, o, lse, do, **m), reps=3, warmup=1),
                "library_ms": None, "library_device_ms": None})
    # sdpa computes the same function where the mask is causal with no
    # window, there is no softcap, and v is as wide as q and k
    if not cap and causal and not window and dqk == dv:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=m["scale"], enable_gqa=True)
        dot = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        rec["library_ms"] = median_ms(library)
        rec["library_device_ms"] = device_ms(library)
        del out
    return rec


def fa_bwd_ragged(dtype, seed=0):
    """``ops.mha`` under autograd at a length that is not a multiple of
    128 (padded to the next one by ``_Attention``): its gradients against
    autograd through ``mha_ref`` in float32 on the unpadded inputs, within
    FA_BWD_TOL; one forward with lse and one backward launched."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import mha
    from repro_torch.kernels.flash_attention.ref import mha_ref
    b, s, h, kh, dh = FA_BWD_RAGGED
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, n, dh), generator=g, device="cuda")
                   .to(dt) for n in (h, kh, kh, h))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    plain = [x.float().requires_grad_(True) for x in (q, k, v)]
    before = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    got = torch.autograd.grad(mha(*leaves, scale=dh ** -0.5), leaves, do)
    after = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    want = torch.autograd.grad(mha_ref(*plain, scale=dh ** -0.5), plain,
                               do.float())
    check(after == (before[0] + 1, before[1] + 1), f"ragged mha autograd: "
          f"launches {before} -> {after}")
    errs = [float((x.float() - w).abs().max() / w.abs().max())
            for x, w in zip(got, want)]
    check(max(errs) <= FA_BWD_TOL[dtype], f"ragged mha autograd B{b} S{s} "
          f"{dtype}: relative errors {errs} > {FA_BWD_TOL[dtype]}")
    return {"b": b, "s": s, "h": h, "kh": kh, "dh": dh, "dtype": dtype,
            "rel_err": errs}


def train_phase(card):
    """Phase 18: training on the card.

    (a, b) The flash-attention backward kernel (``fa_bwd.cuh``) at every
    form of FA_BWD_FORMS in both dtypes (``fa_bwd_case``): the forward
    with lse bitwise the forward without on both routes, lse within
    FA_ATOL, the backward within FA_BWD_TOL of its plain version and
    deterministic; each form timed beside its bound and, where it
    computes the same function, sdpa's backward; a ragged length through
    ``ops.mha`` under autograd.
    (c) A float32 train step's loss and gradients, kernel against plain
    attention: qwen2-1.5b at full width and TRAIN_PARITY_LAYERS layers.
    (d) The training run through ``launch.train.train`` at full width and
    depth (TRAIN_RUN): finite losses, ms per step, tokens/s, peak memory,
    flash-attention launches a step (TRAIN_LAUNCHES, all forward launches
    on ``wgmma``); then one more step under torch.profiler (device trace):
    busy ms, idle share, top kernels and the backward's device ms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import batch_at
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.launch.train import train
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm
    from repro_torch.models.params import leaves
    from repro_torch.train.optim import OptConfig
    from repro_torch.train.step import make_train_step, value_and_grad
    out = {"forms": [], "ragged": []}
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        for i, form in enumerate(FA_BWD_FORMS):
            c = fa_bwd_case(*form, dtype, seed=1800 + i, timed=True)
            out["forms"].append(c)
            times = ""
            if "ms" in c:
                lib = ("none" if c["library_ms"] is None else
                       f"{c['library_ms']:.4f} ms (device "
                       f"{c['library_device_ms']:.4f})")
                times = (f" | backward {c['ms']:.4f} ms (device "
                         f"{c['device_ms']:.4f}), plain {c['plain_ms']:.4f} "
                         f"ms, sdpa backward {lib}, bound "
                         f"{c['bound_ms']:.4f} ms ({c['bound_by']}, "
                         f"{c['flop']:.3e} FLOP)")
            print(f"[train kernels] {c['what']}: B{c['b']} S{c['s']} "
                  f"T{c['t']} H{c['h']} K{c['kh']} dqk{c['dqk']} dv{c['dv']} "
                  f"{'causal' if c['causal'] else 'non-causal'} window "
                  f"{c['window']} cap {c['softcap']} kv_len {c['kv_len']} "
                  f"{dtype} (forward {c['route']}): O with lse bitwise, lse "
                  f"err {c['lse_err']:.3g}; dq/dk/dv rel err "
                  + "/".join(f"{e:.3g}" for e in c["rel_err"])
                  + f" <= {c['tol']}, deterministic{times}", flush=True)
            torch.cuda.empty_cache()
        r = fa_bwd_ragged(dtype, seed=1890)
        out["ragged"].append(r)
        print(f"[train kernels] ragged S{r['s']} through ops.mha under "
              f"autograd, {dtype}: rel err "
              + "/".join(f"{e:.3g}" for e in r["rel_err"])
              + f" <= {FA_BWD_TOL[dtype]}", flush=True)

    # (c) a float32 train step, kernel against plain attention
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on: float32 parity needs full float32")
    cfg32 = dataclasses.replace(get_config(TRAIN_RUN["arch"]),
                                n_layers=TRAIN_PARITY_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    params = lm.init_params(cfg32, seed=0)
    b, s = TRAIN_PARITY_SHAPE
    batch = batch_at(0, 0, b, s, cfg32.vocab_size, device="cuda")
    zero_counts()
    k_loss, k_grads = value_and_grad(params, batch, cfg32)
    k_fa = (fk.flash_attention.launches, fk.flash_attention_bwd.launches)
    check(k_fa == (2 * TRAIN_PARITY_LAYERS, TRAIN_PARITY_LAYERS),
          f"float32 train step: flash-attention launches (forward, "
          f"backward) {k_fa}")
    kernel_mha = attn_mod.mha
    attn_mod.mha = mha_ref
    try:
        zero_counts()
        p_loss, p_grads = value_and_grad(params, batch, cfg32)
        check(fk.flash_attention.launches == fk.flash_attention_bwd.launches
              == 0, "the plain train step launched the kernel")
    finally:
        attn_mod.mha = kernel_mha
    loss_err = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    check(loss_err <= TRAIN_LOSS_RTOL, f"float32 train step: loss kernel "
          f"{float(k_loss)} vs plain {float(p_loss)} ({loss_err})")
    grad_err = max(float((a - b_).abs().max() / b_.abs().max().clamp_min(
        1e-30)) for a, b_ in zip(leaves(k_grads), leaves(p_grads)))
    check(grad_err <= TRAIN_GRAD_TOL, f"float32 train step: a gradient "
          f"leaf differs by {grad_err} of its largest magnitude")
    out["parity"] = {"layers": TRAIN_PARITY_LAYERS, "shape": [b, s],
                     "loss_kernel": float(k_loss), "loss_plain": float(p_loss),
                     "loss_rel_err": loss_err, "grad_rel_err": grad_err,
                     "launches": list(k_fa)}
    print(f"[train parity] qwen2-1.5b full width, {TRAIN_PARITY_LAYERS} "
          f"layers, float32, {b} x {s}: loss kernel {float(k_loss):.6f} vs "
          f"plain {float(p_loss):.6f} (rel {loss_err:.3g} <= "
          f"{TRAIN_LOSS_RTOL}); gradients within {grad_err:.3g} of each "
          f"leaf's largest magnitude (<= {TRAIN_GRAD_TOL}); {k_fa[0]} "
          f"forward and {k_fa[1]} backward launches", flush=True)
    del params, k_grads, p_grads, batch
    torch.cuda.empty_cache()

    # (d) the training run at full width and depth
    run = TRAIN_RUN
    cfg = get_config(run["arch"])
    tokens = run["global_batch"] * run["seq_len"]
    steps = []
    last = {"t": 0.0, "fwd": 0, "bwd": 0}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        fa_calls = dict(fk.flash_attention.calls)
        steps.append({"step": step, "seconds": now - last["t"],
                      "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "forward": fk.flash_attention.launches - last["fwd"],
                      "backward": fk.flash_attention_bwd.launches
                      - last["bwd"],
                      "routes": sorted({key[-1] for key in fa_calls})})
        last.update(t=now, fwd=fk.flash_attention.launches,
                    bwd=fk.flash_attention_bwd.launches)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last["t"] = t0
    state, losses = train(run["arch"], run["steps"], reduced=False,
                          global_batch=run["global_batch"],
                          seq_len=run["seq_len"], log_every=1,
                          device="cuda", on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == run["steps"]
          and all(math.isfinite(x) for x in losses),
          f"training run: losses {losses}")
    for st in steps:
        check(st["forward"] == TRAIN_LAUNCHES["forward"]
              and st["backward"] == TRAIN_LAUNCHES["backward"],
              f"training step {st['step']}: {st['forward']} forward and "
              f"{st['backward']} backward flash-attention launches, want "
              f"{TRAIN_LAUNCHES}")
    routes = {key[-1] for key in fk.flash_attention.calls}
    bwd_keys = sorted(fk.flash_attention_bwd.calls)
    check(routes == {"wgmma"}, f"training run: forward routes {routes}")
    steady = statistics.median(st["seconds"] for st in steps[1:])
    out["run"] = {**run, "n_params": cfg.n_params(), "losses": losses,
                  "steps": steps, "wall_s": wall, "first_step_s":
                  steps[0]["seconds"], "step_ms": steady * 1e3,
                  "tokens_per_s": tokens / steady,
                  "max_memory_allocated": peak,
                  "launches": {"forward": fk.flash_attention.launches,
                               "backward": fk.flash_attention_bwd.launches},
                  "backward_calls": [list(k) + [c] for k, c in
                                     fk.flash_attention_bwd.calls.items()]}
    print(f"[train] qwen2-1.5b at full width and depth ({cfg.n_layers} "
          f"layers, {out['run']['n_params']} float32 parameters, float32 "
          f"Adam, bf16 compute, train_accum {cfg.train_accum}, remat "
          f"{cfg.remat_policy}), {run['global_batch']} x {run['seq_len']} "
          f"tokens a step, {run['steps']} steps in {wall:.2f} s: losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f" | {steady * 1e3:.1f} ms a step (median of steps 2-"
          f"{run['steps']}; the first {steps[0]['seconds'] * 1e3:.1f} ms), "
          f"{tokens / steady:.0f} tokens/s, max_memory_allocated {peak} B; "
          f"flash attention a step: {TRAIN_LAUNCHES['forward']} forward "
          f"(wgmma) and {TRAIN_LAUNCHES['backward']} backward calls at "
          f"{bwd_keys} | {card}", flush=True)
    # one more step under torch.profiler, device activity alone
    oc = OptConfig(lr=1e-3, warmup_steps=20, total_steps=run["steps"])
    step_fn = make_train_step(cfg, oc)
    nxt = batch_at(0, run["steps"], run["global_batch"], run["seq_len"],
                   cfg.vocab_size, device="cuda")
    box = {"state": state}
    del state

    def one_step():
        box["state"], _ = step_fn(box["state"], nxt)
    prof = device_busy(one_step, cpu=False)
    prof["wall_ms"] = steady * 1e3
    prof["idle_share"] = max(0.0, 1 - prof["busy_ms"] / prof["wall_ms"])
    prof["bwd_ms"] = sum(t for key, _, t in prof["by_name"]
                         if "fa_bwd" in key)
    prof["bwd_kernels"] = sum(c for key, c, _ in prof["by_name"]
                              if "fa_bwd" in key)
    check(prof["bwd_kernels"] == 3 * TRAIN_LAUNCHES["backward"],
          f"profiled step: {prof['bwd_kernels']} backward kernels for "
          f"{TRAIN_LAUNCHES['backward']} calls of three")
    out["profile"] = {k: prof[k] for k in prof if k != "by_name"}
    out["profile"]["top12"] = [(k[:90], c, t) for k, c, t in
                               prof["by_name"][:12]]
    print(f"[train] profile of one step: device busy {prof['busy_ms']:.1f} "
          f"ms of {prof['wall_ms']:.1f} ms (idle share "
          f"{prof['idle_share']:.1%}), {prof['kernels']} kernels; flash "
          f"attention forward {prof['flash_ms']:.1f} ms, backward "
          f"{prof['bwd_ms']:.1f} ms ({prof['bwd_kernels']} kernels)",
          flush=True)
    for key, count, ms in prof["by_name"][:12]:
        print(f"[train]   {ms:9.3f} ms x{count:6d}  {key[:90]}", flush=True)
    del box, step_fn
    torch.cuda.empty_cache()
    return out


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
    fa_window = [fa_window_case(*shape, w) for shape in FA_WINDOW_PARITY
                 for w in sorted(set(FA_WINDOWS + [shape[1]]))]
    gemma2_fa = [fa_window_case(*GEMMA2_FA, w, seed=1, timed=True)
                 for w in (GEMMA2_WINDOW, 0)]
    details["parity"] = {"histogram": hist_parity, "gf2_rank": rank_parity,
                         "mwc": mwc_parity,
                         "flash_attention": fa_parity + fa_window}
    details["gemma2_attention"] = gemma2_fa
    for c in hist_parity:
        print_battery("histogram", c)
    for c in rank_parity:
        print_battery("gf2_rank", c)
    for c in mwc_parity:
        print_battery("mwc", c)
    for c in fa_parity:
        print_fa(c)
    for c in fa_window + gemma2_fa:
        print_fa_window(c)
    local, glob = gemma2_fa
    details["gemma2_attention_ratio"] = {
        "device": local["device_ms"] / glob["device_ms"],
        "work": local["pairs"] / glob["pairs"]}
    print(f"[kernels] gemma2 prefill attention, window {GEMMA2_WINDOW} "
          f"against global: device time ratio "
          f"{details['gemma2_attention_ratio']['device']:.3f}, work ratio "
          f"{details['gemma2_attention_ratio']['work']:.3f}", flush=True)

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

    # 13. gemma2-27b on the card (after qwen2's parameters are freed)
    t0 = time.perf_counter()
    details["gemma2"] = gemma2_phase(card)
    t_gemma2 = time.perf_counter() - t0
    # 14. glm4-9b, chameleon-34b, nemotron-4-340b (after gemma2's are freed)
    t0 = time.perf_counter()
    details["dense_archs"] = dense_archs_phase(card)
    t_dense = time.perf_counter() - t0
    # 15. granite-moe-1b-a400m, deepseek-v2-236b (after phase 14's are freed)
    t0 = time.perf_counter()
    details["moe"] = moe_phase(card)
    t_moe = time.perf_counter() - t0
    # 16. zamba2-1.2b, xlstm-1.3b (after phase 15's are freed)
    t0 = time.perf_counter()
    details["recurrent"] = recurrent_phase(card)
    t_rec = time.perf_counter() - t0
    print(f"[time] phase 16 (zamba2, xlstm) {t_rec:.1f}s", flush=True)
    # 17. whisper-small (after phase 16's are freed)
    t0 = time.perf_counter()
    details["whisper"] = whisper_phase(card)
    t_whisper = time.perf_counter() - t0
    print(f"[time] phase 17 (whisper) {t_whisper:.1f}s", flush=True)
    # 18. training (after phase 17's model is freed)
    t0 = time.perf_counter()
    details["train"] = train_phase(card)
    t_train = time.perf_counter() - t0
    print(f"[time] phase 18 (training) {t_train:.1f}s", flush=True)

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
    # 12. the static analyzer against the card
    details["analysis"] = analysis_phase(card, accel["bigcrush"],
                                         big_entries, built)
    t5 = time.perf_counter()
    details["phase_s"] = {"captured": t1 - t0, "campaign": t2 - t1,
                          "elastic_faults": t3 - t2, "screening": t4 - t3,
                          "analysis": t5 - t4, "gemma2": t_gemma2,
                          "dense_archs": t_dense, "moe": t_moe,
                          "recurrent": t_rec, "whisper": t_whisper,
                          "train": t_train}
    print(f"[time] phase 8 (captured) {t1 - t0:.1f}s, phase 9 (campaign) "
          f"{t2 - t1:.1f}s, phase 10 (elastic, faults) {t3 - t2:.1f}s, "
          f"phase 11 (screening) {t4 - t3:.1f}s, phase 12 (analysis) "
          f"{t5 - t4:.1f}s, phase 13 (gemma2, run after phase 7) "
          f"{t_gemma2:.1f}s, phase 14 (glm4, chameleon, nemotron, after "
          f"13) {t_dense:.1f}s, phase 15 (granite-moe, deepseek-v2, after "
          f"14) {t_moe:.1f}s, phase 16 (zamba2, xlstm, after 15) "
          f"{t_rec:.1f}s, phase 17 (whisper, after 16) {t_whisper:.1f}s, "
          f"phase 18 (training, after 17) {t_train:.1f}s, "
          f"{t0 - t_start - t_gemma2 - t_dense - t_moe - t_rec - t_whisper - t_train:.1f}"
          f"s before phase 8 besides them", flush=True)

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
            "launches_gemma2": details["gemma2"]["launches"][name],
            "launches_dense_archs":
                details["dense_archs"]["launches"][name],
            "launches_moe": details["moe"]["launches"][name],
            "launches_recurrent": details["recurrent"]["launches"][name],
            "launches_whisper": details["whisper"]["launches"][name],
            "launches_train": (details["train"]["run"]["launches"]["forward"]
                               if name == "flash_attention" else 0),
            "max_abs_err": max(c["max_abs_err"] for c in
                               cases + details["parity"][name]
                               + (details["gemma2_attention"]
                                  + details["dense_archs"]["attention"]
                                  + details["moe"]["attention"]
                                  + details["recurrent"]["attention"]
                                  + details["whisper"]["attention"]
                                  if name == "flash_attention" else [])),
            "ms": total("ms"), "device_ms": total("device_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if bytes_bound * 2 >= total("bound_ms")
                         else "operations"),
            "library_ms": total("library_ms")})
        if name == "flash_attention":
            # its non-causal launches in phase 17 (encoder and cross)
            rows[-1]["bidir"] = details["whisper"]["bidir"]
    # the backward: its main path is phase 18's training run, every call at
    # qwen2's training microbatch (the timed bfloat16 form)
    train = details["train"]
    timed = next(c for c in train["forms"]
                 if "ms" in c and c["dtype"] == "bfloat16")
    n_bwd = train["run"]["launches"]["backward"]
    rows.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/fa_bwd.cuh",
        "replaces": "src/repro/models/attention.py:154",
        "launches": n_bwd,
        "max_abs_err": max(c["max_abs_err"] for c in train["forms"]),
        "ms": timed["ms"] * n_bwd, "device_ms": timed["device_ms"] * n_bwd,
        "plain_ms": timed["plain_ms"] * n_bwd,
        "bound_ms": timed["bound_ms"] * n_bwd, "bound_by": timed["bound_by"],
        "library_ms": timed["library_ms"] * n_bwd})
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
