"""One-command battery CLI on the port (``repro/launch/battery.py``)::

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

``--source file:PATH[:fmt]`` (repeatable) screens a captured bitstream,
``fmt`` ``npy`` (uint32; 2-D is one stream per row) or ``u32`` (raw
little-endian words): the file rides beside the ``--gen`` positions, its
words read on the host and copied to the card once per round, and its
results are bitwise those of the generator whose words it holds. The
``--json`` report gains the ``sources`` key. ``--register PKG.MOD:FN``
imports the module and calls ``FN()`` before the run, so the generators
it registers with ``repro_torch.rng.sources.register_generator`` (torch
block functions) are valid ``--gen`` names.

``--campaign`` screens a generator fleet (DESIGN.md §8): the ``--gen``
list (and ``--source`` files) x ``--streams`` sub-streams, in
``--waves`` battery scales, cheapest first, a failed cell knocked out of
later waves, the ``pairstream`` seam check first unless
``--no-stream-check``::

  PYTHONPATH=src python -m repro_torch.launch.battery --campaign \\
      --battery smallcrush --gen splitmix64,pcg32,randu --streams 4 \\
      --waves 0.125,0.5 --ledger campaign.ck --json report.json

It prints the per-cell PASS/FAIL matrix; ``--ledger`` makes it
resumable (the reference's ledger v3, which either package resumes; a
finished campaign run again prints ``rounds=0``). The ``--json`` report
has the reference's ``campaign`` key (and ``evidence`` under
``--verdict-engine evalue``).

``--resize-at ROUND:WIDTH[,ROUND:WIDTH...]`` resizes the pool mid-battery
(the paper's opportunistic pool, machines joining and vacating): once
ROUND rounds have run the pool takes WIDTH worker slots and the remaining
jobs replan onto it, so ``--resize-at 2:4,5:8`` shrinks the pool to 4
after round 2 and grows it back to 8 after round 5. The stitched
``(stat, p)`` are bitwise those of a fixed-width run (DESIGN.md §6); the
``--json`` report lists the resizes under ``resizes``.

``--inject PLAN.json`` runs the battery under a deterministic fault plan
(``core/faults.py``: seeded rules of kind evict, corrupt, straggle,
lose_worker; DESIGN.md §12), applied on the host after each round; the
run recovers through hold/release, the sanity gate and quarantine, to
the fault-free run's ``(stat, p)`` bit for bit, and the ``--json``
report gains the ``faults`` key (the plan, the event ledger and the
quarantines). ``--retries`` sets the drive loop's release budget.

``--serve`` routes the run through the screening service
(``repro_torch.serve``, DESIGN.md §10): each ``--gen`` entry (and
``--source`` file) is submitted as its own ticket, as separate clients
would, and the submission queue merges them into one shared dispatch
per round, storing every cell in the content-addressed result cache
under ``--serve-state`` (a state directory either package's daemon
resumes). ``--serve-resubmit`` submits the first position's spec again
after the run, to show the cache path (zero added dispatches); the
``--json`` report gains the ``serve`` key (tickets, batches, dispatch
rounds, cache traffic). ``--serve`` does not combine with
``--campaign``, ``--resize-at``, ``--ckpt`` or ``--inject``.

Exit code: a classic or served run exits 1 when any p-value is suspect
(or, under ``--adaptive`` or the ``evalue`` engine, any generator
FAILs), else 0; a campaign exits 0 when no cell is left undecided, else
1; 2 is a usage error, or a run whose held jobs outlived the retry
budget.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.battery")
    ap.add_argument("--battery", default="smallcrush",
                    choices=["smallcrush", "crush", "bigcrush"])
    ap.add_argument("--gen", default=None,
                    help="generator name, or a comma-separated list "
                         "(default splitmix64 when no --source is given)")
    ap.add_argument("--source", action="append", default=None,
                    metavar="file:PATH[:FMT]",
                    help="screen a captured bitstream: file:PATH[:fmt], "
                         "fmt 'npy' (uint32, 2-D = one stream per row) or "
                         "'u32' (raw little-endian words); repeatable")
    ap.add_argument("--register", action="append", default=None,
                    metavar="PKG.MOD:FN",
                    help="import PKG.MOD and call FN() before the run, to "
                         "register generators (torch block functions) via "
                         "repro_torch.rng.sources.register_generator")
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
    ap.add_argument("--inject", default=None, metavar="PLAN.json",
                    help="run under a deterministic fault plan "
                         "(core/faults.py JSON: seeded rules of kind "
                         "evict/corrupt/straggle/lose_worker); --json gains "
                         "a 'faults' ledger. The recovered run is bitwise "
                         "the fault-free one (DESIGN.md §12)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path: saved after every round, "
                         "resumed from when it exists")
    ap.add_argument("--resize-at", dest="resize_at", default=None,
                    help="comma-separated ROUND:WIDTH pairs: resize the pool "
                         "to WIDTH worker slots once ROUND rounds have run")
    ap.add_argument("--campaign", action="store_true",
                    help="generator-fleet screening: the --gen list x "
                         "--streams sub-streams in --waves scales with "
                         "knockout (core/campaign.py)")
    ap.add_argument("--streams", type=int, default=1,
                    help="sub-streams per generator in a campaign grid "
                         "(needs counter-based generators)")
    ap.add_argument("--waves", default=None,
                    help="comma-separated wave scales for --campaign "
                         "(default: one wave at --scale)")
    ap.add_argument("--ledger", default=None,
                    help="campaign ledger path (resumable screening)")
    ap.add_argument("--no-stream-check", dest="stream_check",
                    action="store_false",
                    help="skip the pairstream seam phase of a campaign")
    ap.add_argument("--serve", action="store_true",
                    help="submit through the screening service: one "
                         "ticket per --gen entry, coalesced by the "
                         "admission batcher, memoized in the result "
                         "cache (repro_torch.serve)")
    ap.add_argument("--serve-state", dest="serve_state", default=None,
                    help="serve state dir (result cache + batch "
                         "checkpoints; restart-resumable)")
    ap.add_argument("--serve-resubmit", dest="serve_resubmit",
                    action="store_true",
                    help="resubmit the first generator's spec after "
                         "completion (cache-hit demo: zero dispatches)")
    ap.add_argument("--serve-max-wait", dest="serve_max_wait",
                    type=float, default=0.0,
                    help="admission fairness bound (seconds) for --serve")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pool runs on (default cuda)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write a machine-readable report to this path")
    return ap


def _write_json(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"json report -> {path}")


def _campaign(args, ap, session, positions, gens, source_specs) -> int:
    """The ``--campaign`` path; returns the exit code."""
    from repro_torch.core.api import CampaignSpec
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.policies import RetryPolicy
    from repro_torch.stats import backends as kernel_backends
    if args.adaptive or args.resize_at or args.ckpt:
        ap.error("--campaign cannot combine with --adaptive/--resize-at/"
                 "--ckpt (its own ledger handles resume)")
    waves = (tuple(float(w) for w in args.waves.split(","))
             if args.waves else (args.scale,))
    cspec = CampaignSpec(
        args.battery, sources=positions, n_streams=args.streams,
        seed=args.seed, waves=waves, alpha=args.alpha, policy=args.policy,
        retry=RetryPolicy(max_retries=args.retries), backend=args.backend,
        stream_check=args.stream_check, ledger_path=args.ledger,
        progress=True, verdict_engine=args.verdict_engine)
    campaign = Campaign(session, cspec)
    print(f"campaign: {len(cspec.generators)} source(s) x {args.streams} "
          f"stream(s) | battery={args.battery} waves={waves} "
          f"span={campaign.span} policy={args.policy} "
          f"backend={args.backend} on {session.device}")
    res = campaign.run()
    print(res.report)
    print(f"\nwall={res.wall_s:.1f}s rounds={res.rounds_run} "
          f"traces={session.total_traces}")
    n_open = len(res.cells) - len(res.survivors) - len(res.knockouts)
    if args.json_path:
        payload = {
            "battery": args.battery, "workers": session.n_workers,
            "policy": args.policy, "backend": args.backend,
            "backend_resolved": kernel_backends.resolve(args.backend,
                                                        session.device),
            "alpha": args.alpha, "seed": args.seed,
            "wall_s": round(res.wall_s, 3), "rounds_run": res.rounds_run,
            "campaign": {
                "n_streams": args.streams, "waves": list(waves),
                **({"sources": [
                    {"spec": raw, "uid": src.uid()}
                    for raw, src in zip(source_specs,
                                        cspec.sources[len(gens):])]}
                   if args.source else {}),
                "span": campaign.span,
                "phases": res.phase_names,
                "stream_check": args.stream_check,
                "survivors": len(res.survivors),
                "knockouts": len(res.knockouts),
                "undecided": n_open,
                "cells": [
                    {"gen": g, "stream": s,
                     "decision": res.decision(g, s),
                     "phase": (int(res.decided_phase[i])
                               if res.decided_phase[i] >= 0 else None)}
                    for i, (g, s) in enumerate(res.cells)],
            },
        }
        if args.verdict_engine != "bonferroni":
            payload["evidence"] = {
                "engine": args.verdict_engine,
                "threshold": 1.0 / args.alpha,
                "continuations": res.continuations,
                "cells": [
                    {"gen": g, "stream": s,
                     "wealth": float(res.wealth[i]),
                     "log_wealth": float(res.log_wealth[i])}
                    for i, (g, s) in enumerate(res.cells)]}
        _write_json(args.json_path, payload)
    # knockouts are the product, not an error; an undecided cell means
    # the screening did not finish
    return 0 if n_open == 0 else 1


def _serve(args, session, spec):
    """The ``--serve`` path: one ticket per source position of ``spec``,
    drained together, then (``--serve-resubmit``) the first position's
    spec again. Returns the runs by generator name and the ``serve``
    section of the ``--json`` report."""
    from repro_torch.serve import SubmissionQueue
    queue = SubmissionQueue(session=session, state_dir=args.serve_state,
                            max_wait=args.serve_max_wait)
    # one ticket per position: independent clients whose compatible specs
    # the admission batcher merges into shared dispatches
    gen_specs = [dataclasses.replace(spec, generators=(), seeds=(seed,),
                                     sources=(src,), progress=False)
                 for src, seed in zip(spec.sources, spec.seeds)]
    tickets = [queue.submit(s) for s in gen_specs]
    queue.drain()
    names = spec.generators
    runs = {g: t.result() for g, t in zip(names, tickets)}
    resubmit = None
    if args.serve_resubmit:
        before = queue.dispatch_rounds
        rticket = queue.submit(gen_specs[0])
        done_at_submit = rticket.done
        queue.drain()
        rticket.result()
        resubmit = {"ticket": rticket.id,
                    "cache_hits": rticket.cache_hits,
                    "done_at_submit": done_at_submit,
                    "dispatches_added": queue.dispatch_rounds - before}
        print(f"  resubmit {names[0]}: cache_hits={rticket.cache_hits} "
              f"dispatches_added={resubmit['dispatches_added']}")
    stats = queue.stats()
    print(f"serve: {len(tickets)} ticket(s) -> "
          f"{stats['batches']} batch(es), "
          f"{stats['dispatch_rounds']} dispatch round(s), "
          f"{stats['cache']['hits']} cache hit(s)")
    return runs, {
        "state": args.serve_state, "max_wait": args.serve_max_wait,
        "tickets": [{"ticket": t.id, "gen": g, "state": t.state,
                     "batch": t.batch_id, "cache_hits": t.cache_hits}
                    for g, t in zip(names, tickets)],
        "batches": stats["batches"],
        "dispatch_rounds": stats["dispatch_rounds"],
        "cache": stats["cache"], "traces": stats["traces"],
        "resubmit": resubmit}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the CLI; returns the exit code."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if not args.serve:
        for value, default, name in ((args.serve_state, None,
                                      "--serve-state"),
                                     (args.serve_resubmit, False,
                                      "--serve-resubmit"),
                                     (args.serve_max_wait, 0.0,
                                      "--serve-max-wait")):
            if value != default:
                ap.error(f"{name} only applies with --serve")
    elif args.campaign or args.resize_at or args.ckpt:
        ap.error("--serve cannot combine with --campaign/--resize-at/"
                 "--ckpt (serve batches own their checkpoints under "
                 "--serve-state)")
    if not args.campaign:
        for value, default, name in ((args.waves, None, "--waves"),
                                     (args.streams, 1, "--streams"),
                                     (args.ledger, None, "--ledger"),
                                     (args.stream_check, True,
                                      "--no-stream-check")):
            if value != default:
                ap.error(f"{name} only applies with --campaign")
    if args.inject and (args.serve or args.campaign):
        ap.error("--inject only applies to the classic run path (serve/"
                 "campaign chaos testing is driven through the library: "
                 "SubmissionQueue(inject=...))")
    if args.adaptive:
        if args.policy not in ("lpt", "adaptive"):
            ap.error(f"--adaptive selects the adaptive schedule policy; "
                     f"it cannot be combined with --policy {args.policy}")
        args.policy = "adaptive"
    resize_at = {}
    if args.resize_at:
        try:
            for tok in args.resize_at.split(","):
                rnd, width = tok.strip().split(":")
                resize_at[int(rnd)] = int(width)
        except ValueError:
            ap.error(f"--resize-at wants ROUND:WIDTH[,ROUND:WIDTH...], "
                     f"got {args.resize_at!r}")
        if any(w < 1 for w in resize_at.values()):
            ap.error("--resize-at widths must be >= 1")

    from repro_torch.core import stitch
    from repro_torch.core.api import BatteryResult, PoolSession, RunSpec
    from repro_torch.core.faults import FaultPlan
    from repro_torch.core.policies import RetryBudgetExhausted, RetryPolicy
    from repro_torch.stats import backends as kernel_backends

    # registration hooks run before any name is resolved, so a generator
    # a hook registers is a --gen name like a built-in
    for hook in args.register or ():
        mod_name, sep, fn_name = hook.partition(":")
        if not sep or not mod_name or not fn_name:
            ap.error(f"--register wants PKG.MOD:FN, got {hook!r}")
        try:
            fn = getattr(importlib.import_module(mod_name), fn_name)
        except (ImportError, AttributeError) as exc:
            ap.error(f"--register {hook!r}: {exc}")
        fn()

    gens = (tuple(g.strip() for g in args.gen.split(",") if g.strip())
            if args.gen else ())
    source_specs = tuple(args.source or ())
    if not gens and not source_specs:
        gens = ("splitmix64",)
    positions = gens + source_specs
    session = PoolSession(n_workers=args.workers or None, device=args.device)
    if args.campaign:
        return _campaign(args, ap, session, positions, gens, source_specs)

    launch_workers = session.n_workers          # width before any resize
    fault_plan = None
    if args.inject:
        try:
            fault_plan = FaultPlan.load(args.inject)
        except (OSError, ValueError, TypeError, KeyError) as exc:
            ap.error(f"--inject {args.inject!r}: {exc}")
    spec = RunSpec(args.battery, sources=positions, seeds=(args.seed,),
                   scale=args.scale, policy=args.policy,
                   retry=RetryPolicy(max_retries=args.retries),
                   checkpoint_path=args.ckpt, progress=True,
                   alpha=args.alpha, stop_on_verdict=args.adaptive,
                   verdict_engine=args.verdict_engine, backend=args.backend,
                   inject=fault_plan)
    names = spec.generators
    backend_resolved = kernel_backends.resolve(args.backend, session.device)
    print(f"pool: {session.n_workers} workers on {session.device} | "
          f"battery={args.battery} gen={','.join(names)} scale={args.scale} "
          f"policy={args.policy} backend={args.backend}"
          + (f"->{backend_resolved}" if args.backend == "auto" else "")
          + (f" adaptive(alpha={args.alpha})" if args.adaptive else ""))

    resizes = []
    serve_info = None
    if args.serve:
        try:
            runs, serve_info = _serve(args, session, spec)
        except RetryBudgetExhausted as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        wall_s = max(r.wall_s for r in runs.values())
        rounds_run = max(r.rounds_run for r in runs.values())
        retries = max(r.retries for r in runs.values())
        counters = ""
    else:
        handle = session.submit(spec)
        for rnd in sorted(resize_at):
            while handle.pending_rounds and handle.rounds_run < rnd:
                handle.poll()
            if handle.pending_rounds:
                session.resize(resize_at[rnd])
                resizes.append({"round": handle.rounds_run,
                                "workers": resize_at[rnd]})
                print(f"  resize: pool -> {resize_at[rnd]} workers after "
                      f"round {handle.rounds_run}")
        try:
            res = handle.result()
        except RetryBudgetExhausted as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        runs = (res.runs if isinstance(res, BatteryResult)
                else {names[0]: res})
        wall_s, rounds_run, retries = res.wall_s, res.rounds_run, res.retries
        counters = f" words={handle.words_generated}" + (
            f" captured_rounds={handle.captured_rounds} prefetch_ms="
            f"{handle.prefetch_s * 1e3:.1f} h2d_bytes="
            f"{handle.bytes_to_device}" if handle.captured_rounds else "")
    for run in runs.values():
        print(run.report)
    for gen, run in runs.items():
        print(f"verdict[{gen}]: {run.verdict}")
    plan_rounds = next(iter(runs.values())).plan_rounds
    print(f"\nwall={wall_s:.1f}s rounds={rounds_run}/{plan_rounds}"
          f" retries={retries}" + counters)

    if args.json_path:
        entries = session.entries(spec)
        payload = {
            "battery": args.battery, "scale": args.scale,
            "workers": launch_workers, "policy": args.policy,
            "backend": args.backend, "backend_resolved": backend_resolved,
            "adaptive": args.adaptive, "alpha": args.alpha,
            "resizes": resizes, "seed": args.seed,
            "wall_s": round(wall_s, 3), "rounds_run": rounds_run,
            "retries": retries, "plan_rounds": plan_rounds, "runs": {},
        }
        if serve_info is not None:
            payload["serve"] = serve_info
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
        if args.source:
            # only with --source: the classic payload keeps its keys
            payload["sources"] = [
                {"spec": raw, "uid": src.uid()}
                for raw, src in zip(source_specs, spec.sources[len(gens):])]
        if args.inject:
            # only under --inject: the fault and quarantine ledger
            payload["faults"] = {
                "plan": fault_plan.to_dict(),
                "events": [e.to_dict() for e in handle.fault_events],
                "quarantines": list(handle.quarantines)}
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
        _write_json(args.json_path, payload)

    suspects = sum(run.n_suspect for run in runs.values())
    failed = ((args.adaptive or args.verdict_engine != "bonferroni")
              and any(run.verdict.decision == "FAIL"
                      for run in runs.values()))
    return 0 if suspects == 0 and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
