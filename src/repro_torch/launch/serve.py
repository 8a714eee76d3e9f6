"""The screening daemon's CLI on the port (``repro/launch/serve.py``)::

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --submit specs.json --state serve-state --json out.json

Runs on ``cuda`` unless ``--device cpu`` is given. ``--submit`` names a
JSON file holding a LIST of submission dicts, one ticket each, in the
reference's wire keys. A run submission::

  {"battery": "smallcrush", "gen": "splitmix64", "seed": 7,
   "scale": 0.25, "policy": "lpt", "alpha": 0.01, "adaptive": false,
   "backend": "auto", "offset": 0, "retries": 2}

(only ``battery`` and ``gen`` are required; ``gen`` may be a
comma-separated list, several generators on ONE ticket). A campaign
submission sets ``"kind": "campaign"`` and the campaign fields
(``streams``, ``waves``, ``ledger``, ``stream_check``).

The daemon merges compatible submissions into shared dispatches
(admission batching, window ``--max-wait`` seconds) and answers repeat
submissions from the result cache under ``--state``: a finished spec
submitted again costs zero dispatches, and a daemon restarted on the
same ``--state`` resumes its batches from their checkpoints. Either
package's daemon resumes a state directory the other left (DESIGN.md
§10). ``--workers`` sets the pool's worker slots on the one device.
``--json`` writes the ticket table and the daemon's counters. Exit 0
if and only if every ticket is done.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence


def spec_from_dict(d: dict):
    """One submission dict (the ``--submit`` wire shape, module
    docstring) as a ``RunSpec`` or ``CampaignSpec``."""
    from repro_torch.core.api import CampaignSpec, RunSpec
    from repro_torch.core.policies import RetryPolicy
    d = dict(d)
    kind = d.pop("kind", "run")
    battery = d.pop("battery")
    gens = d.pop("gen")
    if isinstance(gens, str):
        gens = tuple(g.strip() for g in gens.split(",") if g.strip())
    else:
        gens = tuple(gens)
    retry = RetryPolicy(max_retries=int(d.pop("retries", 2)))
    if kind == "campaign":
        waves = d.pop("waves", None)
        spec = CampaignSpec(
            battery, generators=gens,
            n_streams=int(d.pop("streams", 1)),
            seed=int(d.pop("seed", 42)),
            waves=(tuple(float(w) for w in waves) if waves
                   else (float(d.pop("scale", 0.25)),)),
            alpha=float(d.pop("alpha", 0.01)),
            policy=d.pop("policy", "lpt"), retry=retry,
            backend=d.pop("backend", "auto"),
            stream_check=bool(d.pop("stream_check", True)),
            ledger_path=d.pop("ledger", None))
    elif kind == "run":
        offset = int(d.pop("offset", 0))
        spec = RunSpec(
            battery, generators=gens,
            seeds=(int(d.pop("seed", 42)),),
            scale=float(d.pop("scale", 0.25)),
            policy=d.pop("policy", "lpt"), retry=retry,
            alpha=float(d.pop("alpha", 0.01)),
            stop_on_verdict=bool(d.pop("adaptive", False)),
            backend=d.pop("backend", "auto"),
            offsets=offset if offset else None)
    else:
        raise ValueError(f"unknown submission kind {kind!r}")
    if d:
        raise ValueError(f"unknown submission field(s): {sorted(d)}")
    return spec


def ticket_row(ticket) -> dict:
    """One ticket's row of the ``--json`` report: its status and, once
    done, its decisions."""
    row = ticket.status()
    if ticket.state == "done":
        res = ticket.result()
        if ticket.kind == "campaign":
            row["survivors"] = len(res.survivors)
            row["knockouts"] = len(res.knockouts)
        else:
            runs = getattr(res, "runs", None)
            if runs is None:
                runs = {ticket.spec.generators[0]: res}
            row["verdicts"] = {g: r.verdict.decision
                               for g, r in runs.items()}
    return row


def build_parser() -> argparse.ArgumentParser:
    """The CLI's argument parser."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--submit", required=True,
                    help="JSON file: a list of submission dicts "
                         "(one ticket each; see the module docstring)")
    ap.add_argument("--state", default=None,
                    help="daemon state dir: result cache + batch "
                         "checkpoints (restart-resumable)")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker slots; 0 = one per visible device")
    ap.add_argument("--max-wait", dest="max_wait", type=float, default=0.0,
                    help="admission fairness bound (seconds): how long a "
                         "submission may wait for batch companions")
    ap.add_argument("--device", default="cuda",
                    help="torch device the pool runs on (default cuda)")
    ap.add_argument("--json", dest="json_path", default=None,
                    help="write the ticket table + daemon counters here")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Read ``--submit``, drain the queue, report; returns the exit code."""
    ap = build_parser()
    args = ap.parse_args(argv)
    with open(args.submit) as f:
        submissions = json.load(f)
    if not isinstance(submissions, list) or not submissions:
        ap.error(f"--submit {args.submit}: expected a non-empty JSON list "
                 "of submission dicts")

    from repro_torch.core.api import PoolSession
    from repro_torch.serve import SubmissionQueue

    session = PoolSession(n_workers=args.workers or None, device=args.device)
    queue = SubmissionQueue(session=session, state_dir=args.state,
                            max_wait=args.max_wait)
    tickets = [queue.submit(spec_from_dict(d)) for d in submissions]
    print(f"serve: {len(tickets)} submission(s) | "
          f"{session.n_workers} worker(s) on {session.device} | "
          f"state={args.state or '-'} max_wait={args.max_wait:g}s",
          flush=True)
    queue.drain()
    stats = queue.stats()
    for t in tickets:
        print(f"  {t.id}: {t.state} (batch={t.batch_id} "
              f"cache_hits={t.cache_hits})")
    print(f"batches={stats['batches']} "
          f"dispatch_rounds={stats['dispatch_rounds']} "
          f"cache_hits={stats['cache']['hits']} "
          f"traces={stats['traces']}")

    if args.json_path:
        payload = {"workers": session.n_workers, "state": args.state,
                   "max_wait": args.max_wait,
                   "tickets": [ticket_row(t) for t in tickets],
                   "stats": stats}
        os.makedirs(os.path.dirname(args.json_path) or ".", exist_ok=True)
        with open(args.json_path, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"json report -> {args.json_path}")
    return 0 if all(t.state == "done" for t in tickets) else 1


if __name__ == "__main__":
    sys.exit(main())
