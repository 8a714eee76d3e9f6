#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (details in ``reports/chip_smoke/chip_smoke.json``):

1. device: the card's name and power limit (nvidia-smi);
2. build: both CUDA kernels compiled from the checkout for sm_90a, one
   nvcc each, started together;
3. kernels: each kernel against its plain PyTorch version on the card,
   bitwise, at the parity shapes below and at every shape the main path
   gave it; CUDA-event medians of the kernel, its plain version and
   ``torch.bincount`` (the library yardstick, used nowhere in the port);
4. main path: ``repro_torch.launch.battery`` on cuda with
   ``--backend accelerated``: BigCrush at scale 1.0 and the adaptive
   SmallCrush acceptance run, splitmix64 + randu. Launch counts are zeroed
   just before each run and read just after; SmallCrush is held against
   the reference's golden JSON (``src/repro_torch/golden``);
5. the same two runs with ``--backend reference``: same verdicts and the
   same (stat, p); then the warm wall time of BigCrush under both
   backends, in turns.

Any failure raises, and the script exits non-zero without a result line.
The last three lines are the kernels' JSON, the card, and
``{"ok": true, "device": {...}}``.
"""
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

HIST_PARITY = [(1 << 26, 4), (1 << 24, 22), (1 << 24, 4096),
               (1 << 26, 65536), (1 << 26, 1 << 20)]
RANK_PARITY = [256, 1 << 16, 1 << 20]
MAIN_ARGS = [
    ("bigcrush", ["--battery", "bigcrush", "--gen", "splitmix64,randu",
                  "--scale", "1.0", "--seed", "7"]),
    ("smallcrush", ["--battery", "smallcrush", "--gen", "splitmix64,randu",
                    "--scale", "0.0625", "--seed", "7", "--adaptive"]),
]
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


def bound_ms(n_bytes, n_ops):
    """Least time for the work: bytes over HBM rate vs ops over peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
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
            if "registers" in line or "smem" in line:
                print(f"  ptxas[{name}] {line.strip()}")

    # 3. kernels at their parity shapes
    from repro_torch.kernels.gf2_rank.kernel import gf2_rank
    from repro_torch.kernels.histogram.kernel import histogram
    hist_parity = [hist_case(n, k) for n, k in HIST_PARITY]
    rank_parity = [rank_case(m) for m in RANK_PARITY]
    details["parity"] = {"histogram": hist_parity, "gf2_rank": rank_parity}
    for c in hist_parity:
        print(f"[kernels] histogram N={c['n']} k={c['nbins']}: bitwise | "
              f"kernel {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"torch.bincount {c['library_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.4f} ms", flush=True)
    for c in rank_parity:
        print(f"[kernels] gf2_rank M={c['m']}: bitwise | kernel "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms, "
              f"bound {c['bound_ms']:.4f} ms", flush=True)

    # 4. main path, accelerated
    from test_torch_reference import ATOL, RTOL, p_tolerance
    from repro_torch.core.battery import build_battery
    accel, calls = {}, {}
    for name, args in MAIN_ARGS:
        histogram.launches, gf2_rank.launches = 0, 0
        histogram.calls.clear()
        gf2_rank.calls.clear()
        rep = run_cli(name, args, "accelerated")
        launches = {"histogram": histogram.launches,
                    "gf2_rank": gf2_rank.launches}
        calls[name] = {"histogram": dict(histogram.calls),
                       "gf2_rank": dict(gf2_rank.calls)}
        check(all(launches.values()),
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
        histogram.launches, gf2_rank.launches = 0, 0
        rep = run_cli(name, args, "reference")
        check(histogram.launches == 0 and gf2_rank.launches == 0,
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

    # the kernels at the shapes the BigCrush run gave them
    main_calls = calls["bigcrush"]
    shapes = {"histogram": [hist_case(n, k, seed=1) | {"launches": c}
                            for (n, k), c in main_calls["histogram"].items()],
              "gf2_rank": [rank_case(m, seed=1) | {"launches": c}
                           for m, c in main_calls["gf2_rank"].items()]}
    details["main_path_shapes"] = shapes
    details["main_path"] = {n: {k: r[k] for k in ("_wall_s", "_words",
                                                  "_launches", "rounds_run")}
                            for n, r in accel.items()}
    rows = []
    meta = {"histogram": ("src/repro_torch/kernels/histogram/histogram.cu",
                          "src/repro/kernels/histogram/kernel.py:39"),
            "gf2_rank": ("src/repro_torch/kernels/gf2_rank/gf2_rank.cu",
                         "src/repro/kernels/gf2_rank/kernel.py:61")}
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
            "launches": accel["bigcrush"]["_launches"][name],
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
