#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (details in ``reports/chip_smoke/chip_smoke.json``):

1. device: the card's name and power limit (nvidia-smi);
2. build: the three CUDA kernels compiled from the checkout for sm_90a,
   one nvcc each, started together; the flash-attention library's SASS
   must hold tensor-core (HGMMA) instructions;
3. kernels: the histogram and GF(2)-rank kernels against their plain
   PyTorch versions on the card, bitwise, at the parity shapes below; the
   flash-attention kernel against its plain version at the reference
   suite's shapes, the serving shapes (bfloat16 and float32), one padded
   length and the tensor-core route's softcap and MQA dh-64 cases, within
   the reference suite's tolerances (2e-5 float32, 2e-2 bfloat16); the
   tensor-core route also row by row against its own arithmetic emulated
   in float32 (``tests/test_torch_flash.py``: P in bfloat16), each row
   within WGMMA_ROW_RTOL of its largest value;
   CUDA-event medians of each kernel, its plain version and the library
   yardstick (``torch.bincount``, ``scaled_dot_product_attention``; timed
   here, used nowhere in the port); at the bfloat16 tensor-core shapes
   also the CUDA-core route on the same inputs (checked and timed, not
   counted). Flash attention, sdpa and the CUDA-core route also get a
   device time per call (``device_ms``: calls queued behind a sleep
   kernel, so the host's launch work is hidden);
4. main path: ``repro_torch.launch.battery`` on cuda with
   ``--backend accelerated``: BigCrush at scale 1.0 and the adaptive
   SmallCrush acceptance run, splitmix64 + randu. Launch counts are zeroed
   just before each run and read just after; SmallCrush is held against
   the reference's golden JSON (``src/repro_torch/golden``);
5. the same two runs with ``--backend reference``: same verdicts and the
   same (stat, p); then the warm wall time of BigCrush under both
   backends, in turns;
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
   the first step where the tokens differ is reported (not checked).

Phase 3 times every kernel at the shapes the main paths gave it (BigCrush
for the battery kernels, phase 6 for flash attention).

Any failure raises, and the script exits non-zero without a result line.
The last three lines are the kernels' JSON, the card, and
``{"ok": true, "device": {...}}``.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "reports", "chip_smoke")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12       # float32 outside the tensor cores
TENSOR_BF16_FLOPS = 989e12     # bf16 / fp16 tensor cores

HIST_PARITY = [(1 << 26, 4), (1 << 24, 22), (1 << 24, 4096),
               (1 << 26, 65536), (1 << 26, 1 << 20)]
RANK_PARITY = [256, 1 << 16, 1 << 20]
MAIN_ARGS = [
    ("bigcrush", ["--battery", "bigcrush", "--gen", "splitmix64,randu",
                  "--scale", "1.0", "--seed", "7"]),
    ("smallcrush", ["--battery", "smallcrush", "--gen", "splitmix64,randu",
                    "--scale", "0.0625", "--seed", "7", "--adaptive"]),
]
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
    doubled and the run repeated."""
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
            continue
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def bound_ms(n_bytes, n_ops, ops_per_s=SCALAR_OPS_PER_S):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def hist_case(n, nbins, seed=0):
    """Time and check the histogram kernel at (N, nbins)."""
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
    bound, by = bound_ms(4 * n + 4 * nbins, n)
    return {"n": n, "nbins": nbins, "max_abs_err": err,
            "ms": median_ms(lambda: histogram(idx, nbins)),
            "plain_ms": median_ms(lambda: histogram_ref(idx, nbins)),
            "library_ms": median_ms(
                lambda: torch.bincount(idx, minlength=nbins)),
            "bound_ms": bound, "bound_by": by}


def rank_case(m, seed=0):
    """Time and check the GF(2) rank kernel at M matrices, a quarter of
    them rank-deficient."""
    import torch
    from repro_torch.common.ints import to_int32_bits
    from repro_torch.kernels.gf2_rank.kernel import gf2_rank
    from repro_torch.kernels.gf2_rank.ref import gf2_rank_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    words = torch.randint(0, 1 << 32, (m, 32), generator=g, device="cuda",
                          dtype=torch.int64)
    words[::4, 16:] = words[::4, :16] ^ words[::4, 8:24]
    words[1::4, ::3] = 0
    mats = to_int32_bits(words)
    got = gf2_rank(mats)
    want = gf2_rank_ref(words)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(torch.equal(got, want), f"gf2_rank M={m}: kernel != plain")
    check(int(want.min()) < 30, "parity set lacks rank-deficient matrices")
    # a bit test and an XOR per row per column step
    bound, by = bound_ms(4 * 32 * m + 4 * m, 2 * 32 * 32 * m)
    return {"m": m, "max_abs_err": err,
            "ms": median_ms(lambda: gf2_rank(mats)),
            "plain_ms": median_ms(lambda: gf2_rank_ref(words)),
            "library_ms": None, "bound_ms": bound, "bound_by": by}


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


def device_busy(fn):
    """Device busy ms of one call of ``fn`` (sum of its kernels' device
    time under torch.profiler; one stream, so they do not overlap), the
    flash-attention kernels' share of it (both routes: ``fa_wgmma``,
    ``fa_fwd``) and the five kernels that took the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {"busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
            "flash_ms": sum(e.self_device_time_total for e in kernels
                            if "fa_wgmma" in e.key or "fa_fwd" in e.key) / 1e3,
            "kernels": sum(e.count for e in kernels),
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
    return {"histogram": histogram, "gf2_rank": gf2_rank,
            "flash_attention": flash_attention}


def zero_counts():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    for fn in _kernel_fns().values():
        fn.launches = 0
        fn.calls.clear()


def launch_counts():
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def run_cli(name, args, backend):
    """One main-path run through the CLI; returns its JSON report."""
    from repro_torch.launch import battery as cli
    path = os.path.join(OUT_DIR, f"{name}_{backend}.json")
    t0 = time.perf_counter()
    code = cli.main(args + ["--backend", backend, "--json", path])
    wall = time.perf_counter() - t0
    check(code == 1, f"{name}/{backend}: exit {code}, want 1 (randu fails)")
    with open(path) as f:
        rep = json.load(f)
    rep["_wall_s"] = wall
    return rep


def words_generated(rep, scale):
    """Words the run generated: each executed job's power-of-two bucket."""
    from repro_torch.core.battery import build_battery
    from repro_torch.core.pool import word_bucket
    entries = build_battery(rep["battery"], scale, device="cpu")
    return sum(word_bucket(entries[t["index"]].n_words)
               for run in rep["runs"].values() for t in run["tests"]
               if t["p"] is not None)


def compare_runs(a, b, what, tol):
    """Same verdicts, checked tests and failures; (stat, p) within tol."""
    for gen, ra in a["runs"].items():
        rb = b["runs"][gen]
        for key in ("verdict", "tests_checked", "failed_tests"):
            check(ra[key] == rb[key], f"{what} {gen}: {key} {ra[key]} != "
                                      f"{rb[key]}")
        for ta, tb in zip(ra["tests"], rb["tests"]):
            check((ta["p"] is None) == (tb["p"] is None),
                  f"{what} {gen} {ta['name']}: ran in one run only")
            if ta["p"] is None:
                continue
            ok_s = math.isclose(ta["stat"], tb["stat"], rel_tol=1e-5,
                                abs_tol=1e-7)
            ok_p = abs(ta["p"] - tb["p"]) <= tol(ta, tb)
            check(ok_s and ok_p, f"{what} {gen} {ta['name']}: "
                                 f"{ta['stat']}/{ta['p']} vs "
                                 f"{tb['stat']}/{tb['p']}")


def main():
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
    sass = subprocess.run(
        [os.path.join(os.path.dirname(build.nvcc()), "cuobjdump"),
         "--dump-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, timeout=300, check=True).stdout
    hgmma = sum("HGMMA" in line for line in sass.splitlines())
    details["flash_attention_hgmma"] = hgmma
    check(hgmma > 0, "the flash-attention library holds no HGMMA "
                     "(tensor-core) instruction")
    print(f"[build] flash_attention SASS: {hgmma} HGMMA (wgmma) "
          f"instructions", flush=True)

    # 3. kernels at their parity shapes
    from repro_torch.kernels.gf2_rank.kernel import gf2_rank
    from repro_torch.kernels.histogram.kernel import histogram
    hist_parity = [hist_case(n, k) for n, k in HIST_PARITY]
    rank_parity = [rank_case(m) for m in RANK_PARITY]
    fa_parity = [fa_case(*shape) for shape in FA_PARITY]
    details["parity"] = {"histogram": hist_parity, "gf2_rank": rank_parity,
                         "flash_attention": fa_parity}
    for c in hist_parity:
        print(f"[kernels] histogram N={c['n']} k={c['nbins']}: bitwise | "
              f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"torch.bincount {c['library_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.4f} ms", flush=True)
    for c in rank_parity:
        print(f"[kernels] gf2_rank M={c['m']}: bitwise | kernel "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.4f} ms", flush=True)
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

    # the kernels at the shapes their main paths gave them
    main_calls = calls["bigcrush"]
    shapes = {"histogram": [hist_case(n, k, seed=1) | {"launches": c}
                            for (n, k), c in main_calls["histogram"].items()],
              "gf2_rank": [rank_case(m, seed=1) | {"launches": c}
                           for m, c in main_calls["gf2_rank"].items()],
              "flash_attention": [
                  fa_case(b, s, h, kh, dh, 0.0, dt.split(".")[-1], seed=1)
                  | {"launches": c}
                  for (b, s, t, h, kh, dh, dt, _), c in fa_calls.items()]}
    for c in shapes["flash_attention"]:
        print_fa(c)
    details["main_path_shapes"] = shapes
    details["main_path"] = {n: {k: r[k] for k in ("_wall_s", "_words",
                                                  "_launches", "rounds_run")}
                            for n, r in accel.items()}
    main_launches = {"histogram": accel["bigcrush"]["_launches"]["histogram"],
                     "gf2_rank": accel["bigcrush"]["_launches"]["gf2_rank"],
                     "flash_attention": serve_launches}
    rows = []
    meta = {"histogram": ("src/repro_torch/kernels/histogram/histogram.cu",
                          "src/repro/kernels/histogram/kernel.py:39"),
            "gf2_rank": ("src/repro_torch/kernels/gf2_rank/gf2_rank.cu",
                         "src/repro/kernels/gf2_rank/kernel.py:61"),
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
            "max_abs_err": max(c["max_abs_err"] for c in
                               cases + details["parity"][name]),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": total("bound_ms"),
            "bound_by": ("bytes" if bytes_bound * 2 >= total("bound_ms")
                         else "operations"),
            "library_ms": total("library_ms")})
    details["kernels"] = rows
    details["card"] = card
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1, default=str)
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
