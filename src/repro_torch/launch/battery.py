"""One-command battery CLI on the port (``repro/launch/battery.py``,
classic path)::

  PYTHONPATH=src python -m repro_torch.launch.battery \\
      --battery bigcrush --gen splitmix64,randu --backend accelerated \\
      --json out.json

Runs on ``cuda`` unless ``--device cpu`` is given. ``--gen`` takes a
comma-separated list, assessed in one round loop. ``--adaptive`` orders
rounds by discrimination/cost and cancels a generator's pending rounds
once its verdict is decided. ``--ckpt PATH`` saves progress after every
round in the reference's checkpoint v5; running the same command again
resumes from it, dispatching only the missing jobs (``rounds=0`` once
the file is complete), and either package resumes the other's file.
``--verdict-engine evalue`` judges with anytime-valid e-value wealth
(``core/evidence.py``) and adds the ``evidence`` section to ``--json``.
``--json PATH`` writes the reference's machine-readable report keys.

Exit code: 1 when any p-value is suspect (or, under ``--adaptive`` or
the ``evalue`` engine, any generator FAILs), else 0.

Flags of the reference that select parts not ported yet (campaigns,
captured sources, elastic resize, fault injection, serving) are refused
with an error, never ignored.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

# reference flags whose subsystems are not ported yet: (flag, takes value)
_NOT_PORTED = (("--source", True), ("--register", True), ("--inject", True),
               ("--resize-at", True), ("--campaign", False),
               ("--streams", True), ("--waves", True), ("--ledger", True),
               ("--no-stream-check", False), ("--serve", False),
               ("--serve-state", True), ("--serve-resubmit", False),
               ("--serve-max-wait", True))


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.battery")
    ap.add_argument("--battery", default="smallcrush",
                    choices=["smallcrush", "crush", "bigcrush"])
    ap.add_argument("--gen", default="splitmix64",
                    help="generator name, or a comma-separated list")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--workers", type=int, default=0,
                    help="worker slots; 0 = one per visible device")
    ap.add_argument("--policy", "--mode", dest="policy", default="lpt",
                    choices=["lpt", "roundrobin", "over_decompose",
                             "adaptive"])
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive schedule order + stop_on_verdict")
    ap.add_argument("--alpha", type=float, default=0.01,
                    help="family-wise error rate of the verdict")
    ap.add_argument("--verdict-engine", dest="verdict_engine",
                    default="bonferroni", choices=["bonferroni", "evalue"],
                    help="bonferroni = the sequential test, evalue = "
                         "anytime-valid e-value wealth (adds 'evidence' "
                         "to --json)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "accelerated"],
                    help="reference = plain PyTorch, accelerated = the "
                         "CUDA kernels, auto = accelerated on cuda")
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path: saved after every round, "
                         "resumed from when it exists")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pool runs on (default cuda)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write a machine-readable report to this path")
    for flag, takes_value in _NOT_PORTED:
        ap.add_argument(flag, dest="unported_" + flag[2:].replace("-", "_"),
                        **({"default": None} if takes_value
                           else {"action": "store_true"}),
                        help="not ported yet (refused)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the CLI; returns the exit code."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, _ in _NOT_PORTED:
        if getattr(args, "unported_" + flag[2:].replace("-", "_")):
            ap.error(f"{flag} is not ported to repro_torch yet; run it "
                     f"with python -m repro.launch.battery")
    if args.adaptive:
        if args.policy not in ("lpt", "adaptive"):
            ap.error(f"--adaptive selects the adaptive schedule policy; "
                     f"it cannot be combined with --policy {args.policy}")
        args.policy = "adaptive"

    from repro_torch.core import stitch
    from repro_torch.core.api import BatteryResult, PoolSession, RunSpec
    from repro_torch.core.policies import RetryBudgetExhausted, RetryPolicy
    from repro_torch.stats import backends as kernel_backends

    gens = tuple(g.strip() for g in args.gen.split(",") if g.strip())
    session = PoolSession(n_workers=args.workers or None, device=args.device)
    spec = RunSpec(args.battery, generators=gens, seeds=(args.seed,),
                   scale=args.scale, policy=args.policy,
                   retry=RetryPolicy(max_retries=args.retries),
                   checkpoint_path=args.ckpt, progress=True,
                   alpha=args.alpha, stop_on_verdict=args.adaptive,
                   verdict_engine=args.verdict_engine, backend=args.backend)
    backend_resolved = kernel_backends.resolve(args.backend, session.device)
    print(f"pool: {session.n_workers} workers on {session.device} | "
          f"battery={args.battery} gen={','.join(gens)} scale={args.scale} "
          f"policy={args.policy} backend={args.backend}"
          + (f"->{backend_resolved}" if args.backend == "auto" else "")
          + (f" adaptive(alpha={args.alpha})" if args.adaptive else ""))

    handle = session.submit(spec)
    try:
        res = handle.result()
    except RetryBudgetExhausted as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    runs = res.runs if isinstance(res, BatteryResult) else {gens[0]: res}
    for run in runs.values():
        print(run.report)
    for gen, run in runs.items():
        print(f"verdict[{gen}]: {run.verdict}")
    plan_rounds = next(iter(runs.values())).plan_rounds
    print(f"\nwall={res.wall_s:.1f}s rounds={res.rounds_run}/{plan_rounds}"
          f" retries={res.retries} words={handle.words_generated}")

    if args.json_path:
        entries = session.entries(spec)
        payload = {
            "battery": args.battery, "scale": args.scale,
            "workers": session.n_workers, "policy": args.policy,
            "backend": args.backend, "backend_resolved": backend_resolved,
            "adaptive": args.adaptive, "alpha": args.alpha,
            "resizes": [], "seed": args.seed,
            "wall_s": round(res.wall_s, 3), "rounds_run": res.rounds_run,
            "retries": res.retries, "plan_rounds": plan_rounds, "runs": {},
        }
        if args.verdict_engine != "bonferroni":
            # only under a non-default engine: the wealth trajectories
            # the anytime-valid verdicts were read off
            payload["evidence"] = {
                "engine": args.verdict_engine,
                "threshold": 1.0 / args.alpha,
                "runs": {gen: {"wealth": run.verdict.wealth,
                               "log_wealth": run.verdict.log_wealth,
                               "trajectory": list(run.verdict.trajectory)}
                         for gen, run in runs.items()}}
        for gen, run in runs.items():
            tests = []
            for e in entries:
                stat, p = run.results.get(e.index, (None, None))
                suspect = (p is not None
                           and (p < stitch.SUSPECT_P
                                or p > 1 - stitch.SUSPECT_P))
                tests.append({"index": e.index, "name": e.name,
                              "stat": stat, "p": p, "suspect": suspect})
            v = run.verdict
            payload["runs"][gen] = {
                "suspects": run.n_suspect, "verdict": v.decision,
                "tests_checked": v.n_checked,
                "failed_tests": list(v.failed_tests),
                "rounds_run": run.rounds_run, "tests": tests}
        os.makedirs(os.path.dirname(args.json_path) or ".", exist_ok=True)
        with open(args.json_path, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"json report -> {args.json_path}")

    suspects = sum(run.n_suspect for run in runs.values())
    failed = ((args.adaptive or args.verdict_engine != "bonferroni")
              and any(run.verdict.decision == "FAIL"
                      for run in runs.values()))
    return 0 if suspects == 0 and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
