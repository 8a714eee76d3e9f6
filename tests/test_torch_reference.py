"""The reference side of the PyTorch port's parity tests.

``repro`` (the JAX package) is the reference. Everything of it that
traces under 64-bit mode (generators, families under the pool's
runner, job tables bound to kernels, pool rounds, the CLI) runs in a
separate process: ``python tests/test_torch_reference.py IN.json OUT``
reads a batch of tasks, computes the reference outputs and writes them
to OUT. That process maps the removed ``jax.experimental.enable_x64``
onto ``jax.enable_x64(True)`` for itself only; the pytest process never
changes JAX's configuration.

The ``test_torch_*.py`` files call ``run_reference`` once per module
(a module-scoped fixture) and compare with the port under the
reference's own tolerance, ``(stat, p)`` within rtol 1e-5 / atol 1e-7
(``tests/test_backends.py``), widened for p only by the reference's
float32 rounding of ``x^a e^-x / Gamma(a)`` (``p_tolerance``).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS32 = float(np.finfo(np.float32).eps)
RTOL, ATOL = 1e-5, 1e-7


def run_reference(tasks: list, out_dir: str, timeout: float = 600,
                  devices: int = 0) -> list:
    """Run ``tasks`` through the reference in a subprocess; returns one
    result per task (arrays come back as numpy arrays). ``devices`` > 1
    gives the subprocess that many host devices (``XLA_FLAGS``, in its
    environment only), for reference pools wider than one device."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "tasks.json")
    with open(spec, "w") as f:
        json.dump(tasks, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    if devices > 1:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), spec,
                           out_dir], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference runner failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(out_dir, "results.json")) as f:
        results = json.load(f)
    return [_load_arrays(r, out_dir) for r in results]


def _load_arrays(obj, out_dir):
    if isinstance(obj, dict):
        if set(obj) == {"npy"}:
            return np.load(os.path.join(out_dir, obj["npy"]))
        return {k: _load_arrays(v, out_dir) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_load_arrays(v, out_dir) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# tolerance

def gamma_args(kname: str, params: dict, stat: float):
    """``(a, x)`` of the incomplete gamma behind a family's p-value, or
    None for the families whose p is normal or Kolmogorov."""
    if kname in ("gap", "poker", "coupon", "weight", "rank", "serial2d"):
        dof = {"gap": params.get("maxlen", 20),
               "poker": params.get("hand", 5) - 2,
               "coupon": params.get("maxlen", 30) - 1,
               "weight": 12, "rank": 3,
               "serial2d": params.get("d", 64) ** 2 - 1}[kname]
        return dof / 2.0, stat / 2.0
    if kname == "birthday":
        return stat + 1.0, params["n"] ** 3 / (4.0 * (1 << params["tbits"]))
    if kname == "collision":
        k, n = float(1 << params["kbits"]), params["n"]
        return stat + 1.0, max(n - k + k * (1.0 - 1.0 / k) ** n, 1e-9)
    if kname == "pairstream" and params.get("mode") in ("match", "shift"):
        lam = (params["n"] if params["mode"] == "match" else 36) / 2.0 ** 32
        return stat + 1.0, lam
    return None


def gamma_tolerance(a: float, x: float, p: float) -> float:
    """Absolute tolerance on a reference p-value computed from the
    incomplete gamma at ``(a, x)``: the contract (atol 1e-7 + rtol 1e-5)
    plus twice the reference's float32 rounding of its prefactor
    ``x^a e^-x / Gamma(a)``, ``eps32 * (a|ln x| + x + |ln Gamma(a)|)``,
    which scales the smaller tail ``min(p, 1 - p)`` computed from it;
    bounded here by ``max(p, 1 - p)``."""
    a, x = max(a, 1e-9), max(x, 1e-300)
    kappa = abs(a * math.log(x)) + x + abs(math.lgamma(a))
    return ATOL + RTOL * abs(p) + 2 * EPS32 * kappa * max(p, 1.0 - p)


def p_tolerance(kname: str, params: dict, stat: float, p: float) -> float:
    """Absolute tolerance on a family's reference p-value: the contract,
    widened by ``gamma_tolerance`` where the p comes from an incomplete
    gamma."""
    ga = gamma_args(kname, params, stat)
    if ga is None or not np.isfinite(stat):
        return ATOL + RTOL * abs(p)
    return gamma_tolerance(ga[0], ga[1], p)


def combined_tolerance(combine, parts) -> tuple:
    """``(stat_tol, p_tol)``: absolute tolerances on the combined
    ``(stat, p)`` of an over-decomposed test, derived from its parts'
    reference results ``parts = [(kname, params, stat, p), ...]`` and the
    port's combiner ``combine(ps) -> (stat, p)`` (``stitch.combine_stouffer``
    or ``stitch.combine_fisher``).

    Each part's p may differ from the reference's by its ``p_tolerance``
    (``gamma_tolerance`` where the p is an incomplete gamma). Both
    combiners are monotone in every part's p: Stouffer's Z and Fisher's
    ``-2 sum ln p`` fall as a part's p rises, and the combined p rises as
    the statistic falls. So for parts within those bounds, the combined
    stat and p lie between their values with every part at its lower
    bound and with every part at its upper bound. The tolerance is the
    larger distance from the reference's combined value to those two,
    plus the contract (atol 1e-7 + rtol 1e-5) for the combiner's own
    rounding. It widens the contract only as far as the parts' own
    tolerances carry through the combiner."""
    ps = np.array([p for _, _, _, p in parts], np.float64)
    tol = np.array([p_tolerance(k, prm, s, p) for k, prm, s, p in parts])
    s0, p0 = combine(ps)
    ends = [combine(np.clip(ps - tol, 0.0, 1.0)),
            combine(np.clip(ps + tol, 0.0, 1.0))]
    return (ATOL + RTOL * abs(s0) + max(abs(s - s0) for s, _ in ends),
            ATOL + RTOL * abs(p0) + max(abs(p - p0) for _, p in ends))


def log_wealth_tolerance(parts, calibrator="mixture", kappa=0.5,
                         p_tol=None) -> float:
    """Absolute tolerance on a generator's e-value log-wealth, the sum of
    its tests' log e-values ``log F(two_sided_p(p))``
    (``repro_torch.core.evidence``), from the reference's per-test
    results ``parts = [(kname, params, stat, p), ...]``.

    Each test's p may differ from the reference's by its ``p_tolerance``
    (the reference evaluates p in float32, the port in float64), and its
    log e-value moves with it by at most
    ``|d log F(two_sided_p(p))/dp| * p_tolerance`` to first order. The
    bound here is that product taken exactly: ``two_sided_p`` is
    monotone on each side of 1/2 and the calibrator is monotone in its
    argument, so over ``[p - tol, p + tol]`` (clipped to [0, 1]) the log
    e-value is extreme at an end or at 1/2, and the bound is the larger
    distance from the reference's value to those. The tolerance is the
    sum of the tests' bounds, each plus the contract (atol 1e-7 + rtol
    1e-5) for the port's own rounding. Tests without a p (held, or not
    run) add nothing. ``p_tol(kname, params, stat, p)`` replaces
    ``p_tolerance`` where both sides are the port's (two backends)."""
    from repro_torch.core import evidence

    def log_e(p):
        return evidence.log_evalue(evidence.two_sided_p(p), calibrator,
                                   kappa)
    total = 0.0
    for kname, params, stat, p in parts:
        if p is None or not np.isfinite(p) or not 0.0 <= p <= 1.0:
            continue
        tol = (p_tol or p_tolerance)(kname, params, stat, p)
        lo, hi = max(p - tol, 0.0), min(p + tol, 1.0)
        ends = [lo, hi] + ([0.5] if lo <= 0.5 <= hi else [])
        le = log_e(p)
        total += (ATOL + RTOL * abs(le)
                  + max(abs(log_e(q) - le) for q in ends))
    return total


def assert_stat_p(kname, params, ref, got, what="", stat_atol=ATOL):
    """(stat, p) parity: stat within the contract (rtol 1e-5, atol
    ``stat_atol``), p within ``p_tolerance``."""
    (s_ref, p_ref), (s_got, p_got) = ref, got
    np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=stat_atol,
                               err_msg=f"stat {kname} {params} {what}")
    tol = p_tolerance(kname, params, s_ref, p_ref)
    assert abs(p_got - p_ref) <= tol, (
        f"p {kname} {params} {what}: port {p_got!r} vs reference "
        f"{p_ref!r} (tolerance {tol:.3g})")


# ---------------------------------------------------------------------------
# the reference runner (subprocess only)

def _install_x64_alias():
    """The reference calls ``jax.experimental.enable_x64``, removed in
    JAX 0.9; map it to ``jax.enable_x64(True)`` in this process only."""
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = lambda: jax.enable_x64(True)


def _entry_row(e):
    return [int(e.index), e.name, e.kname, [list(kv) for kv in e.params],
            int(e.n_words), float(e.cost), int(e.group), int(e.part),
            int(e.n_parts), e.backend]


def _task_words(task, save):
    import jax
    from repro.common.compat import under_x64
    from repro.rng import generators as G
    from repro.rng import sources as S
    out = []
    for name, seed, stream, n, offset in task["cases"]:
        fn = G.GENERATORS[name]
        if offset is None:
            run = under_x64(jax.jit(lambda s, t: fn(s, t, n)))
        else:
            run = under_x64(jax.jit(lambda s, t: fn(s, t, n, offset)))
        out.append(save(np.asarray(run(np.int32(seed), np.int32(stream)),
                                   np.uint32)))
    return {"words": out, "gen_ids": dict(S.GEN_IDS),
            "counter_based": list(S.counter_based_names()),
            "threefry_partitionable":
                bool(jax.config.jax_threefry_partitionable)}


def _task_families(task, save):
    import jax
    import jax.numpy as jnp
    from repro.common.compat import under_x64
    from repro.stats import backends as B
    bits = np.load(task["bits"])
    out = []
    for kname, params in task["cases"]:
        for backend in task["backends"]:
            fn = B.get_kernel(kname, backend)
            run = under_x64(jax.jit(lambda b, fn=fn, kw=params: tuple(
                jnp.asarray(v, jnp.float32) for v in fn(b, **kw))))
            for row in range(bits.shape[0]):
                s, p = run(bits[row])
                out.append([kname, params, backend, row, float(s), float(p)])
    return out


def _task_tables(task, save):
    from repro.core import pool
    from repro.core.battery import build_battery, split_entry
    from repro.core.policies import get_policy
    from repro.core.scheduler import make_plan
    out = []
    for battery, scale in task["specs"]:
        entries = build_battery(battery, scale)
        jobs = get_policy("over_decompose").decompose(entries) or entries
        splits = [[_entry_row(s) for s in split_entry(e, parts, 100)]
                  for e in entries for parts in (2, 3, 8)]
        sizes, bids = pool.bucket_table(entries)
        plans = {f"{mode}/{w}": make_plan([e.cost for e in entries], w, mode,
                                          entries=entries).assignment.tolist()
                 for mode in ("roundrobin", "lpt", "adaptive")
                 for w in (1, 3, 8)}
        out.append({"entries": [_entry_row(e) for e in entries],
                    "over_decompose": [_entry_row(j) for j in jobs],
                    "splits": splits, "bucket_sizes": sizes,
                    "bucket_ids": bids.tolist(),
                    "stream_table": pool.stream_table(jobs).tolist(),
                    "block_ratio": pool.block_ratio(entries),
                    "plans": plans})
    return out


def _task_pool(task, save):
    from repro.core.api import PoolSession, RunSpec
    session = PoolSession()
    spec = RunSpec(task["battery"], tuple(task["generators"]),
                   seeds=tuple(task["seeds"]), scale=task["scale"],
                   policy=task["policy"], backend=task["backend"])
    handle = session.submit(spec)
    res = handle.result()
    runs = res.runs if hasattr(res, "runs") else {spec.generators[0]: res}
    return {"jobs": [_entry_row(j) for j in handle._compiled.jobs],
            "job_results": [{str(k): list(v) for k, v in r.items()}
                            for r in handle._results],
            "results": {g: {str(k): list(v) for k, v in r.results.items()}
                        for g, r in runs.items()},
            "verdicts": {g: r.verdict.decision for g, r in runs.items()},
            "rounds_run": res.rounds_run}


def _task_cli(task, save):
    import runpy
    argv = sys.argv
    sys.argv = ["repro.launch.battery", *task["argv"]]
    try:
        runpy.run_module("repro.launch.battery", run_name="__main__")
        code = 0
    except SystemExit as exc:
        code = exc.code
    finally:
        sys.argv = argv
    return {"exit_code": code}


def _ckpt_fields(ck, save):
    return {"version": int(ck.version), "job_idx": save(ck.job_idx),
            "stats": save(ck.stats), "ps": save(ck.ps),
            "decisions": (None if ck.decisions is None
                          else [int(d) for d in ck.decisions]),
            "rounds_run": int(ck.rounds_run), "alpha": ck.alpha,
            "source_uids": (None if ck.source_uids is None
                            else [u.decode() for u in ck.source_uids]),
            "engine": ck.engine,
            "log_wealth": (None if ck.log_wealth is None
                           else [float(x) for x in ck.log_wealth])}


def _task_ckpt(task, save):
    """Reference runs that write or resume a checkpoint, and reference
    loads of checkpoint files. Each of ``task["runs"]`` is ``{"spec":
    RunSpec keywords, "path": checkpoint path or None, "rounds": polls
    before stopping, or None to run to the end}``; ``task["load"]`` lists
    files to read with the reference's ``Checkpoint.load``."""
    from repro.core.api import Checkpoint, PoolSession, RunSpec
    session = PoolSession()
    runs = []
    for run in task.get("runs", []):
        spec = RunSpec(checkpoint_path=run["path"], **_tuples(run["spec"]))
        handle = session.submit(spec)
        status = handle.status()
        out = {"jobs_done_at_submit": status["jobs_done"],
               "rounds_at_submit": handle.rounds_run}
        if run["rounds"] is None:
            res = handle.result()
            gens = res.runs if hasattr(res, "runs") else {
                spec.generators[0]: res}
            out["results"] = {g: {str(k): list(v)
                                  for k, v in r.results.items()}
                              for g, r in gens.items()}
            out["verdicts"] = {g: r.verdict.decision
                               for g, r in gens.items()}
            out["log_wealth"] = {g: getattr(r.verdict, "log_wealth", None)
                                 for g, r in gens.items()}
        else:
            for _ in range(run["rounds"]):
                handle.poll()
        out["rounds_run"] = handle.rounds_run
        out["plan_rounds"] = handle.plan_rounds
        out["job_results"] = [{str(k): list(v) for k, v in r.items()}
                              for r in handle._results]
        runs.append(out)
    return {"runs": runs,
            "loads": [_ckpt_fields(Checkpoint.load(p), save)
                      for p in task.get("load", [])]}


def _tuples(kw):
    """Spec keywords from JSON: lists back to the tuples specs take."""
    kw = dict(kw)
    for key in ("generators", "seeds", "sources", "offsets", "waves"):
        if isinstance(kw.get(key), list):
            kw[key] = tuple(kw[key])
    return kw


def spec_objects(kw, faults, policies):
    """``RunSpec`` keywords from JSON, for either package: lists to
    tuples, ``inject`` a plan dict (``faults.FaultPlan.from_dict``),
    ``retry`` a dict of ``RetryPolicy`` keywords, ``policy`` a name or
    ``{"over_decompose": {...}}`` (``OverDecomposePolicy`` keywords).
    ``faults`` and ``policies`` are that package's modules."""
    kw = _tuples(kw)
    if isinstance(kw.get("inject"), dict):
        kw["inject"] = faults.FaultPlan.from_dict(kw["inject"])
    if isinstance(kw.get("retry"), dict):
        kw["retry"] = policies.RetryPolicy(**kw["retry"])
    if isinstance(kw.get("policy"), dict):
        kw["policy"] = policies.OverDecomposePolicy(
            **kw["policy"]["over_decompose"])
    return kw


def drive_runs(runs, api, faults, policies, ckpt_io, **session_kw):
    """Drive battery runs step by step on either package (``api``,
    ``faults``, ``policies`` and ``ckpt_io`` are its modules), so the
    reference and the port take the same steps. Each run is ``{"spec":
    RunSpec keywords (see ``spec_objects``), "session": name, "workers":
    width of a new session of that name, "steps": [...]}``; sessions are
    shared by name across runs, and ``"width"`` resizes the session
    before the submit. Steps: ``["poll", n]``, ``["resize" |
    "grow" | "shrink", n]`` (the session), ``["result"]`` (to the end;
    a ``RetryBudgetExhausted`` is recorded, not raised),
    ``["drive_quiet"]`` (``drive(raise_on_exhausted=False)``),
    ``["release"]`` (a manual release), ``["drop", jobs]`` and
    ``["copy", path]`` (on the spec's checkpoint file), ``["v2", path,
    jobs]`` (the checkpoint, less ``jobs``, written to ``path`` in the
    v2 layout). Returns per run: each polled round's row, the queue after
    each width change (once the run absorbed it), counters, job-space
    and test-space results, verdicts, fault events and quarantines, the
    session's width and runner builds per width. ``session_kw`` goes to
    every ``PoolSession`` (the port's ``device``)."""
    sessions, out = {}, []
    for run in runs:
        name = run.get("session", "main")
        if name not in sessions:
            sessions[name] = api.PoolSession(n_workers=run["workers"],
                                             **session_kw)
        session = sessions[name]
        if "width" in run:
            session.resize(run["width"])
        spec = api.RunSpec(**spec_objects(run["spec"], faults, policies))
        handle = session.submit(spec)
        status = handle.status()
        rec = {"jobs_done_at_submit": status["jobs_done"],
               "jobs_total": status["jobs_total"], "rows": [],
               "queues": [], "exhausted": None}
        for step in run["steps"]:
            op = step[0]
            if op == "poll":
                for _ in range(step[1]):
                    if not handle._queue:
                        break
                    handle._sync_width()
                    rec["rows"].append(handle._queue[0].tolist())
                    handle.poll()
            elif op in ("resize", "grow", "shrink"):
                getattr(session, op)(step[1])
                handle._sync_width()
                rec["queues"].append([r.tolist() for r in handle._queue])
            elif op == "result":
                try:
                    res = handle.result()
                except policies.RetryBudgetExhausted as exc:
                    rec["exhausted"] = {"held": exc.held,
                                        "retries": exc.retries,
                                        "message": str(exc)}
                    res = handle._finalize()
                runs_ = res.runs if hasattr(res, "runs") else {
                    spec.generators[0]: res}
                rec["results"] = {g: {str(k): list(v)
                                      for k, v in r.results.items()}
                                  for g, r in runs_.items()}
                rec["verdicts"] = {g: r.verdict.decision
                                   for g, r in runs_.items()}
            elif op == "drive_quiet":
                handle.drive(raise_on_exhausted=False)
            elif op == "release":
                rec["released"] = handle.release()
            elif op == "drop":
                path = spec.checkpoint_path
                api.Checkpoint.load(path).drop(step[1]).save(path)
            elif op == "copy":
                with open(spec.checkpoint_path, "rb") as f:
                    data = f.read()
                with open(step[1], "wb") as f:
                    f.write(data)
            elif op == "v2":
                ck = api.Checkpoint.load(spec.checkpoint_path).drop(step[2])
                ckpt_io.save(step[1], [ck.job_idx, ck.stats, ck.ps,
                                       np.zeros(1, np.int8), np.int64(2)])
            else:
                raise ValueError(f"unknown step {step!r}")
        rec.update({
            "rounds_run": handle.rounds_run, "retries": handle.retries,
            "driver_retries": handle.driver_retries,
            "plan_rounds": handle.plan_rounds, "held": handle.held(),
            "job_results": [{str(k): list(v) for k, v in r.items()}
                            for r in handle._results],
            "events": [e.to_dict() for e in handle.fault_events],
            "quarantines": handle.quarantines,
            "workers": session.n_workers,
            "traces": sorted([k[2], v]
                             for k, v in session.trace_counts.items())})
        out.append(rec)
    return out


def _run_record(res, spec):
    """A run result (``RunResult`` or ``BatteryResult``) as JSON."""
    runs = res.runs if hasattr(res, "runs") else {spec.generators[0]: res}
    return {"results": {g: {str(k): list(v) for k, v in r.results.items()}
                        for g, r in runs.items()},
            "verdicts": {g: r.verdict.decision for g, r in runs.items()},
            "named": {g: g in r.report for g, r in runs.items()},
            "rounds_run": int(res.rounds_run), "retries": int(res.retries),
            "plan_rounds": {g: int(r.plan_rounds) for g, r in runs.items()}}


def drive_serve(ops, api, serve, faults, policies, sessions=None,
                **session_kw):
    """Drive the screening service step by step on either package
    (``api``, ``serve``, ``faults``, ``policies`` are its modules), so
    the reference and the port take the same steps. Objects are named;
    ``sessions`` (name -> session) may be shared between calls, so
    scenarios reuse the runners earlier ones built. Ops (lists):
    ``["session", s, workers]`` (a new session unless ``s`` exists);
    ``["resize", s, workers]``; ``["queue", q, s, {"state",
    "max_wait", "inject"}]`` (a plan dict); ``["submit", q, t, spec]``
    (``spec_objects`` keywords, or ``{"kind": "campaign", ...}``
    ``CampaignSpec`` keywords); ``["step", q, flush]``; ``["drain", q]``;
    ``["start", q]``/``["stop", q]`` (the daemon thread);
    ``["cancel", t]``; ``["result", t, timeout]``; ``["status", t]``;
    ``["stats", q]``; ``["counters", q]`` (its ``traces`` are the runners
built since the queue was made); ``["spoil", n]`` (from here
    on, job 0's result of the first ``n`` dispatches that cover it is
    NaN: the HELD condition); ``["run", r, s, spec]`` (a plain
    ``BatteryRun``) and ``["run_poll_all", r]``, ``["run_held", r]``,
    ``["run_release", r]``, ``["run_result", r]``, ``["run_stream", r]``,
    ``["run_cancel", r]``, ``["run_status", r]``. Returns one record per
    op and, under ``"tickets"``, every ticket's final state."""
    sessions = {} if sessions is None else sessions
    queues, bases, tickets, runs, out = {}, {}, {}, {}, []
    orig_dispatch = api.BatteryRun._dispatch

    def spec_of(kw):
        kw = dict(kw)
        if kw.pop("kind", "run") == "campaign":
            return api.CampaignSpec(**_tuples(kw))
        return api.RunSpec(**spec_objects(kw, faults, policies))

    def outcome(fn, spec):
        try:
            res = fn()
        except policies.RetryBudgetExhausted as exc:
            return {"error": "RetryBudgetExhausted", "held": exc.held,
                    "retries": exc.retries}
        except (RuntimeError, TimeoutError) as exc:
            return {"error": type(exc).__name__, "message": str(exc)}
        if hasattr(res, "survivors"):
            return {"decisions": [int(x) for x in res.decisions],
                    "decided_phase": [int(x) for x in res.decided_phase],
                    "survivors": len(res.survivors),
                    "knockouts": len(res.knockouts),
                    "rounds_run": int(res.rounds_run)}
        return _run_record(res, spec)

    try:
        for op in ops:
            kind, rec = op[0], None
            if kind == "session":
                if op[1] not in sessions:
                    sessions[op[1]] = api.PoolSession(n_workers=op[2],
                                                      **session_kw)
            elif kind == "resize":
                sessions[op[1]].resize(op[2])
            elif kind == "queue":
                kw = dict(op[3]) if len(op) > 3 else {}
                if isinstance(kw.get("inject"), dict):
                    kw["inject"] = faults.FaultPlan.from_dict(kw["inject"])
                queues[op[1]] = serve.SubmissionQueue(
                    session=sessions[op[2]], state_dir=kw.get("state"),
                    max_wait=kw.get("max_wait", 0.0),
                    inject=kw.get("inject"))
                bases[op[1]] = sessions[op[2]].total_traces
            elif kind == "submit":
                t = queues[op[1]].submit(spec_of(op[3]))
                tickets[op[2]] = t
                rec = {"ticket": t.id, "done": t.done, "state": t.state,
                       "cache_hits": t.cache_hits}
            elif kind == "step":
                rec = queues[op[1]].step(flush=op[2])
            elif kind == "drain":
                queues[op[1]].drain()
            elif kind == "start":
                rec = queues[op[1]].start().serving
            elif kind == "stop":
                queues[op[1]].stop()
                rec = queues[op[1]].serving
            elif kind == "cancel":
                rec = tickets[op[1]].cancel()
            elif kind == "result":
                t = tickets[op[1]]
                rec = outcome(lambda: t.result(timeout=op[2]), t.spec)
            elif kind == "status":
                rec = tickets[op[1]].status()
            elif kind == "stats":
                rec = queues[op[1]].stats()
            elif kind == "counters":
                q = queues[op[1]]
                rec = {"batches_formed": q.batches_formed,
                       "dispatch_rounds": q.dispatch_rounds,
                       "traces": q.session.total_traces - bases[op[1]],
                       "cache_len": len(q.cache), "idle": q.idle,
                       "workers": q.session.n_workers}
            elif kind == "spoil":
                seen = {"n": 0}

                def flaky(self, row, limit=op[1], seen=seen):
                    orig_dispatch(self, row)
                    if 0 in {int(j) for j in np.ravel(row)}:
                        if seen["n"] < limit:
                            self._results[0][0] = (float("nan"),
                                                   float("nan"))
                        seen["n"] += 1
                api.BatteryRun._dispatch = flaky
            elif kind == "run":
                runs[op[1]] = sessions[op[2]].submit(spec_of(op[3]))
            elif kind == "run_poll_all":
                h = runs[op[1]]
                while h.pending_rounds:
                    h.poll()
            elif kind == "run_held":
                rec = [int(j) for j in runs[op[1]].held()]
            elif kind == "run_release":
                h = runs[op[1]]
                rec = {"released": h.release(), "retries": h.retries,
                       "driver_retries": h.driver_retries}
            elif kind == "run_result":
                h = runs[op[1]]
                rec = outcome(h.result, h.spec)
                rec.update({"retries_after": h.retries,
                            "driver_retries": h.driver_retries,
                            "done": h.done})
            elif kind == "run_stream":
                h = runs[op[1]]
                rec = {"states": [st["state"] for st in h.stream()],
                       "done": h.done, "held": h.held(),
                       "driver_retries": h.driver_retries,
                       "verdict": h.result().verdict.decision}
            elif kind == "run_cancel":
                rec = runs[op[1]].cancel()
            elif kind == "run_status":
                rec = runs[op[1]].status()["state"]
            else:
                raise ValueError(f"unknown op {op!r}")
            out.append(rec)
    finally:
        api.BatteryRun._dispatch = orig_dispatch
        for q in queues.values():
            q.stop()
    final = {name: {"id": t.id, "state": t.state, "batch": t.batch_id,
                    "cache_hits": t.cache_hits, "failure": t.failure}
             for name, t in tickets.items()}
    return {"ops": out, "tickets": final}


def _task_serve(task, save):
    """The reference's screening service: ``task["scenarios"]`` (named op
    lists for ``drive_serve``, in order, sharing sessions by name),
    ``task["digests"]`` (``cell_digest``
    argument lists), ``task["cells"]`` (``RunSpec`` keywords: their
    ``spec_cells`` digests and ``admission_key`` as a string),
    ``task["entries"]`` (``{"results", "n_total", "alpha", "engine",
    "path"}``: ``CacheEntry.from_results`` saved at path; its decision,
    completeness and ``serves``), ``task["loads"]`` (cache entry files
    the reference loads), ``task["cli"]`` and ``task["daemon"]`` (argv
    lists of ``repro.launch.battery`` and ``repro.launch.serve``: exit
    codes)."""
    import runpy
    from repro.core import api, faults, policies
    from repro import serve
    shared = {}
    out = {"scenarios": {name: drive_serve(ops, api, serve, faults,
                                           policies, shared)
                         for name, ops in task.get("scenarios", {}).items()},
           "digests": [serve.cell_digest(*args)
                       for args in task.get("digests", [])],
           "cells": [], "entries": [], "loads": [], "cli": [],
           "daemon": []}
    for kw in task.get("cells", []):
        spec = api.RunSpec(**spec_objects(kw, faults, policies))
        out["cells"].append({"digests": [c.digest
                                         for c in serve.spec_cells(spec)],
                             "key": repr(serve.admission_key(spec))})
    for item in task.get("entries", []):
        results = {int(k): tuple(v) for k, v in item["results"].items()}
        entry = serve.CacheEntry.from_results(
            results, item["n_total"], item["alpha"],
            engine=item.get("engine", "bonferroni"))
        if item.get("path"):
            entry.save(item["path"])
        out["entries"].append({"decision": entry.decision,
                               "complete": entry.complete,
                               "serves": [entry.serves(False),
                                          entry.serves(True)]})
    for path in task.get("loads", []):
        e = serve.CacheEntry.load(path)
        out["loads"].append({"results": {str(k): list(v)
                                         for k, v in e.results.items()},
                             "decision": e.decision, "alpha": e.alpha,
                             "n_total": e.n_total, "complete": e.complete,
                             "engine": e.engine, "version": e.version})
    for key, module in (("cli", "repro.launch.battery"),
                        ("daemon", "repro.launch.serve")):
        for argv in task.get(key, []):
            saved = sys.argv
            sys.argv = [module, *argv]
            try:
                runpy.run_module(module, run_name="__main__")
                code = 0
            except SystemExit as exc:
                code = exc.code
            finally:
                sys.argv = saved
            out[key].append(code)
    return out


def _task_captured(task, save):
    """Reference captures and captured sources: ``task["captures"]``
    lists ``capture_generator`` keyword sets (files the reference
    writes); ``task["sources"]`` lists source specs whose name, uid,
    digest and shape the reference reports."""
    from repro.rng.sources import capture_generator, resolve_source
    paths = [capture_generator(**kw) for kw in task.get("captures", [])]
    info = []
    for spec in task.get("sources", []):
        src = resolve_source(spec)
        info.append({"name": src.name, "uid": src.uid(),
                     "digest": src.digest(), "fmt": src.fmt,
                     "n_streams": src.n_streams, "stride": src.stride})
    return {"paths": paths, "sources": info}


def _ledger_fields(led):
    return {"version": int(led.version),
            "gen_ids": [int(x) for x in led.gen_ids],
            "streams": [int(x) for x in led.streams],
            "decisions": [int(x) for x in led.decisions],
            "decided_phase": [int(x) for x in led.decided_phase],
            "phases_done": int(led.phases_done), "alpha": led.alpha,
            "spec_digest": str(led.spec_digest),
            "source_uids": (None if led.source_uids is None
                            else [u.decode() for u in led.source_uids]),
            "log_wealth": (None if led.log_wealth is None
                           else [float(x) for x in led.log_wealth]),
            "engine": led.engine, "continuations": int(led.continuations)}


def _task_campaign(task, save):
    """Reference campaign objects, in this order: ``task["offsets"]``
    (``["stream" | "seam", args]``: the offsets ``stream_offsets`` or
    ``seam_offsets`` returns, or its ``ValueError`` message),
    ``task["digests"]``
    (``CampaignSpec`` keyword sets whose ``digest()`` to report, as
    strings), ``task["spans"]`` (their ``default_span``),
    ``task["ledgers"]`` (``{"spec", "path", "set"}``: a fresh
    ``CampaignLedger`` with the fields of ``set`` replaced, saved at
    ``path``), ``task["runs"]`` (``{"spec", "phases", "fresh"}``: a
    ``Campaign`` on one session shared by the runs, or on a new one with
    ``fresh``, run to its end or for ``phases`` calls of
    ``run_next_phase``; ``traces`` counts the runners it built), ``task["loads"]`` (ledger files read with
    ``CampaignLedger.load``, and whether they match ``"spec"``)."""
    from repro.core.api import CampaignLedger, CampaignSpec, PoolSession
    from repro.core.campaign import Campaign, default_span
    from repro.rng import generators as G
    offsets = []
    for kind, args in task.get("offsets", []):
        fn = G.stream_offsets if kind == "stream" else G.seam_offsets
        try:
            offsets.append({"value": fn(*args).tolist()})
        except ValueError as exc:
            offsets.append({"error": str(exc)})
    out = {"offsets": offsets, "digests": [str(CampaignSpec(**_tuples(kw)).digest())
                       for kw in task.get("digests", [])],
           "spans": [default_span(CampaignSpec(**_tuples(kw)))
                     for kw in task.get("spans", [])]}
    for item in task.get("ledgers", []):
        led = CampaignLedger.fresh(CampaignSpec(**_tuples(item["spec"])))
        for key, value in item.get("set", {}).items():
            old = getattr(led, key)
            setattr(led, key, np.asarray(value, old.dtype)
                    if isinstance(old, np.ndarray) else value)
        led.save(item["path"])
    runs, shared = [], PoolSession()
    for item in task.get("runs", []):
        session = PoolSession() if item.get("fresh") else shared
        traces = session.total_traces
        camp = Campaign(session, CampaignSpec(**_tuples(item["spec"])))
        if item.get("phases") is None:
            res = camp.run()
        else:
            for _ in range(item["phases"]):
                camp.run_next_phase()
            res = camp.result_snapshot()
        runs.append({
            "decisions": [int(x) for x in res.decisions],
            "decided_phase": [int(x) for x in res.decided_phase],
            "phase_names": list(res.phase_names),
            "rounds_run": int(res.rounds_run),
            "continuations": int(res.continuations),
            "log_wealth": (None if res.log_wealth is None
                           else [float(x) for x in res.log_wealth]),
            "span": int(camp.span),
            "traces": int(session.total_traces - traces),
            "ledger": _ledger_fields(camp.ledger)})
    out["runs"] = runs
    out["loads"] = []
    for item in task.get("loads", []):
        led = CampaignLedger.load(item["path"])
        row = _ledger_fields(led)
        if item.get("spec") is not None:
            row["matches"] = bool(led.matches(
                CampaignSpec(**_tuples(item["spec"]))))
        out["loads"].append(row)
    return out


def _task_elastic(task, save):
    """Reference runs across pool widths (``drive_runs``; the runner is
    given the devices the widest pool needs), then ``task["load"]``:
    checkpoint files read with the reference's ``Checkpoint.load``."""
    from repro.ckpt import io as ckpt_io
    from repro.core import api, faults, policies
    return {"runs": drive_runs(task.get("runs", []), api, faults, policies,
                               ckpt_io),
            "loads": [_ckpt_fields(api.Checkpoint.load(p), save)
                      for p in task.get("load", [])]}


def _task_faults(task, save):
    """The reference's fault domain: ``task["plans"]`` (``[plan dict,
    path]``: ``FaultPlan.from_dict`` saved at path; its ``to_dict``),
    ``task["draws"]`` (``{"plan", "rounds", "slots"}``: ``_draw`` of every
    (rule, round, slot), slot -1 included), ``task["matches"]``
    (``{"plan", "round", "row"}``: the (rule, slot) pairs that fire),
    ``task["apply"]`` (``{"plan", "round", "row", "arrays", "deadline"}``:
    ``apply_round`` on float64 arrays; the events, the width asked for and
    the arrays after, as saved float64 arrays), ``task["backoff"]``
    (``{"retry", "attempts"}``: ``backoff_for`` of each attempt),
    ``task["flips"]`` (``_bit_flip`` of each value), and
    ``task["runs"]`` (``drive_runs``)."""
    from repro.ckpt import io as ckpt_io
    from repro.core import api, faults, policies
    out = {"plans": [], "draws": [], "matches": [], "apply": [],
           "backoff": [], "flips": []}
    for d, path in task.get("plans", []):
        plan = faults.FaultPlan.from_dict(d)
        plan.save(path)
        out["plans"].append(plan.to_dict())
    for item in task.get("draws", []):
        inj = faults.FaultInjector(faults.FaultPlan.from_dict(item["plan"]))
        out["draws"].append([[[bool(inj._draw(i, r, s))
                               for s in range(-1, item["slots"])]
                              for r in range(item["rounds"])]
                             for i in range(len(inj.plan.rules))])
    for item in task.get("matches", []):
        inj = faults.FaultInjector(faults.FaultPlan.from_dict(item["plan"]))
        out["matches"].append([[i, s] for i, _, s in inj.matches(
            item["round"], np.asarray(item["row"]))])
    for item in task.get("apply", []):
        inj = faults.FaultInjector(faults.FaultPlan.from_dict(item["plan"]))
        arrays = [(np.asarray(st, np.float64), np.asarray(pv, np.float64))
                  for st, pv in item["arrays"]]
        events, resize_to = inj.apply_round(
            item["round"], np.asarray(item["row"]), arrays,
            deadline=item.get("deadline"))
        out["apply"].append({"events": [e.to_dict() for e in events],
                             "resize_to": resize_to,
                             "arrays": [[save(st), save(pv)]
                                        for st, pv in arrays]})
    for item in task.get("backoff", []):
        pol = policies.RetryPolicy(**item["retry"])
        out["backoff"].append([pol.backoff_for(a)
                               for a in range(item["attempts"])])
    out["flips"] = save(np.asarray([faults._bit_flip(x)
                                    for x in task.get("flips", [])],
                                   np.float64))
    out["runs"] = drive_runs(task.get("runs", []), api, faults, policies,
                             ckpt_io)
    return out


def _task_sequential(task, save):
    """The reference's stock-TestU01 baseline (``pool.run_sequential``)
    and whole-plan runner (``pool.make_batch_runner``, one worker, the
    LPT plan) on one generator."""
    from repro.core.battery import build_battery
    from repro.core.pool import make_batch_runner, run_sequential
    from repro.core.scheduler import make_plan
    from repro.launch.mesh import make_pool_mesh
    from repro.rng.sources import GEN_IDS
    entries = build_battery(task["battery"], task["scale"])
    seed, gid = np.int32(task["seed"]), np.int32(GEN_IDS[task["generator"]])
    stats, ps = run_sequential(entries, seed, gid)
    plan = make_plan([e.cost for e in entries], 1, "lpt").assignment
    b_stats, b_ps = make_batch_runner(entries, make_pool_mesh(1))(
        np.asarray(plan), seed, gid)
    return {"stats": save(np.asarray(stats)), "ps": save(np.asarray(ps)),
            "plan": np.asarray(plan).tolist(),
            "batch_stats": save(np.asarray(b_stats)),
            "batch_ps": save(np.asarray(b_ps))}


_TASKS = {"words": _task_words, "families": _task_families,
          "tables": _task_tables, "pool": _task_pool, "cli": _task_cli,
          "ckpt": _task_ckpt, "sequential": _task_sequential,
          "captured": _task_captured, "campaign": _task_campaign,
          "elastic": _task_elastic, "faults": _task_faults,
          "serve": _task_serve}


def _main(spec_path: str, out_dir: str) -> None:
    _install_x64_alias()
    with open(spec_path) as f:
        tasks = json.load(f)
    counter = [0]

    def save(arr):
        name = f"a{counter[0]}.npy"
        counter[0] += 1
        np.save(os.path.join(out_dir, name), arr)
        return {"npy": name}

    results = [_TASKS[t["kind"]](t, save) for t in tasks]
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
