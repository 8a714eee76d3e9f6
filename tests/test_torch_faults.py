"""PyTorch port, the fault domain (DESIGN.md §12): deterministic fault
injection, the result sanity gate, worker health and quarantine, retry
backoff, and the CLI's ``--inject``, transcribed from
``tests/test_faults.py`` (all but the serving daemon's test, which
belongs to the serving slice) and held against the JAX reference.

The headline property, per fault kind and for composed plans: any plan
that leaves a healthy worker stitches ``(stat, p)`` bitwise equal to the
fault-free run. The reference runs in ``test_torch_reference.py``'s
subprocess (task ``faults``, 8 host devices in its environment only);
both packages take the same steps (``drive_runs``). Plan JSON bytes,
draws, bit flips, events (kind, round, slot, job, rule), quarantines,
retries, rounds and exit codes are compared exactly; ``(stat, p)``
within ``p_tolerance``. A straggle is the plan's ``delay_s`` against
``RetryPolicy.deadline``: nothing sleeps, so nothing depends on the
machine's load.
"""
import json
import os

import numpy as np
import pytest

from test_torch_elastic import assert_job_results, jobs_of
from test_torch_reference import drive_runs, run_reference

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import api, faults, policies
from repro_torch.core.api import Checkpoint, PoolSession, RunSpec
from repro_torch.core.faults import (FAULT_KINDS, FaultInjector, FaultPlan,
                                     FaultRule, WorkerHealth, _bit_flip)
from repro_torch.core.policies import RetryBudgetExhausted, RetryPolicy
from repro_torch.launch import battery as cli

SCALE = 0.0625
BASE = {"battery": "smallcrush", "generators": ["splitmix64"], "seeds": [7],
        "scale": SCALE}
RNG_SEED = 2323


def plan(*rules, seed=0):
    return {"seed": seed, "rules": [dict(r) for r in rules]}


def chaos(name, rules, retry=None, steps=(("result",),), session="one",
          workers=1, **kw):
    """A W=1 run of the baseline spec under a plan (``tests/test_faults.py``'s
    ``chaos``)."""
    spec = dict(BASE, inject=plan(*rules), **kw)
    if retry is not None:
        spec["retry"] = retry
    return name, {"spec": spec, "session": session, "workers": workers,
                  "steps": [list(s) for s in steps]}


def fault_runs(d):
    """Named runs: the W=1 cases of ``tests/test_faults.py``, and the W=4
    scenario of ``tests/faults_scenario.py`` (lose_worker, a flaky slot
    walked down by quarantine), with checkpoint files under ``d``."""
    ck = os.path.join(d, "chaos.ck")
    flaky = {"spec": dict(BASE, policy="roundrobin",
                          inject=plan({"kind": "evict", "slot": 1}),
                          retry={"max_retries": 10, "quarantine_after": 2}),
             "session": "four", "width": 4, "steps": [["result"]]}
    runs = [
        ("clean", {"spec": BASE, "session": "one", "workers": 1,
                   "steps": [["result"]]}),
        ("clean_ck", {"spec": dict(BASE, checkpoint_path=os.path.join(
            d, "clean.ck")), "session": "one", "steps": [["result"]]}),
        chaos("evict", [{"kind": "evict", "round": 0}]),
        chaos("corrupt", [{"kind": "corrupt", "round": 0}]),
        chaos("straggle_deadline",
              [{"kind": "straggle", "round": 0, "delay_s": 60.0}],
              retry={"deadline": 30.0}),
        chaos("straggle_none",
              [{"kind": "straggle", "round": 0, "delay_s": 60.0}]),
        chaos("composed", [{"kind": "evict", "round": 0},
                           {"kind": "corrupt", "round": 1},
                           {"kind": "straggle", "round": 2,
                            "delay_s": 60.0}],
              retry={"max_retries": 3, "deadline": 30.0}),
        chaos("replay_a", [{"kind": "corrupt", "p": 0.5, "slot": 0}],
              retry={"max_retries": 8}),
        chaos("replay_b", [{"kind": "corrupt", "p": 0.5, "slot": 0}],
              retry={"max_retries": 8}),
        chaos("exhaust", [{"kind": "corrupt", "job": 0}],
              retry={"max_retries": 1}),
        chaos("exhaust_quiet", [{"kind": "corrupt", "job": 0}],
              retry={"max_retries": 1}, steps=[["drive_quiet"]]),
        chaos("manual_release", [{"kind": "evict", "round": 0}],
              retry={"max_retries": 0},
              steps=[["poll", 99], ["release"], ["result"]]),
        chaos("mid_fault", [{"kind": "evict", "round": 0}],
              steps=[["poll", 1]], checkpoint_path=ck),
        chaos("mid_fault_resumed", [{"kind": "evict", "round": 0}],
              session="fresh", checkpoint_path=ck),
        ("clean4", {"spec": BASE, "session": "four", "workers": 4,
                    "steps": [["result"]]}),
        ("clean4_rr", {"spec": dict(BASE, policy="roundrobin"),
                       "session": "four", "steps": [["result"]]}),
        ("lose_worker", {"spec": dict(BASE, inject=plan(
            {"kind": "lose_worker", "round": 0})), "session": "four",
            "steps": [["result"]]}),
        ("quarantine", flaky),
    ]
    return dict(runs)


def port_runs(runs):
    return dict(zip(runs, drive_runs(list(runs.values()), api, faults,
                                     policies, ckpt_io, device="cpu")))


# the plans whose JSON, draws and matches are compared with the reference
PLANS = [
    plan({"kind": "evict", "round": 0, "slot": 1},
         {"kind": "corrupt", "job": 3, "p": 0.5},
         {"kind": "straggle", "round": 2, "delay_s": 7.5},
         {"kind": "lose_worker", "round": 1, "width": 2}, seed=9),
    plan({"kind": "evict", "p": 0.5}, seed=11),
    plan({"kind": "corrupt", "p": 0.25}, {"kind": "lose_worker", "p": 0.3},
         {"kind": "straggle", "slot": 2, "p": 0.75, "delay_s": 0.5},
         seed=123456789),
]
FLIPS = [0.0, 5e-324, 1e-300, 1e-9, 0.25, 0.5, 0.9999, 1.0, -0.0, 3.5,
         float("inf"), 1e308]
BACKOFF = [{"backoff_base": 1.0, "backoff_mult": 2.0, "backoff_max": 5.0},
           {"backoff_base": 0.05, "backoff_mult": 3.0},
           {}]
# the CLI's plan at W=4 on two generators: an evict, a corrupt, a
# straggle (no deadline from the CLI: ledger only) and a lost worker
CLI_PLAN = plan({"kind": "evict", "round": 0, "slot": 0},
                {"kind": "corrupt", "round": 0, "slot": 2},
                {"kind": "straggle", "round": 1, "slot": 1, "delay_s": 5.0},
                {"kind": "lose_worker", "round": 0, "width": 3}, seed=5)
CLI_ARGS = ["--battery", "smallcrush", "--gen", "splitmix64,randu",
            "--scale", "0.0625", "--seed", "7", "--workers", "4",
            "--retries", "3", "--backend", "reference"]


def apply_cases():
    """``apply_round`` inputs from a seeded numpy generator: rows with
    idle slots, (stat, p) in [0, 1], and the plans above."""
    rng = np.random.default_rng(RNG_SEED)
    cases = []
    for k, pl in enumerate(PLANS):
        for rnd in range(3):
            row = rng.integers(-1, 10, size=5)
            arrays = [(rng.random(5) * 100, rng.random(5)) for _ in range(2)]
            cases.append({"plan": pl, "round": rnd, "row": row.tolist(),
                          "arrays": [[st.tolist(), pv.tolist()]
                                     for st, pv in arrays],
                          "deadline": None if k == 1 else 2.0})
    return cases


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's outputs (one subprocess, 8 host devices) and the
    port's runs, on the CPU."""
    d = tmp_path_factory.mktemp("faults")
    rd, pd = str(d / "ref"), str(d / "port")
    os.makedirs(rd)
    os.makedirs(pd)
    plan_path = str(d / "cli_plan.json")
    FaultPlan.from_dict(CLI_PLAN).save(plan_path)
    cli_json = str(d / "ref_cli.json")
    runs = fault_runs(rd)
    task, cli_res = run_reference(
        [{"kind": "faults",
          "plans": [[p, os.path.join(rd, f"plan{i}.json")]
                    for i, p in enumerate(PLANS)],
          "draws": [{"plan": p, "rounds": 6, "slots": 5} for p in PLANS],
          "matches": [{"plan": p, "round": r, "row": row}
                      for p in PLANS for r in range(3)
                      for row in ([0, 1, 2, 3, 4], [3, -1, 5, -1],
                                  [7, 8])],
          "apply": apply_cases(), "backoff": [
              {"retry": b, "attempts": 10} for b in BACKOFF],
          "flips": FLIPS, "runs": list(runs.values())},
         {"kind": "cli", "argv": CLI_ARGS + ["--inject", plan_path,
                                             "--json", cli_json]}],
        str(d / "out"), devices=8)
    with open(cli_json) as f:
        cli_res["json"] = json.load(f)
    task["runs"] = dict(zip(runs, task["runs"]))
    return {"ref": task, "cli": cli_res, "plan_path": plan_path,
            "port": port_runs(fault_runs(pd)), "rd": rd, "pd": pd}


def events(rec, detail=False):
    keys = ("round", "kind", "slot", "job", "rule") + (
        ("detail",) if detail else ())
    return [tuple(e[k] for k in keys) for e in rec["events"]]


# ------------------------------------------------------- plan validation

def test_fault_rule_validation():
    for bad in (dict(kind="explode"), dict(kind="evict", p=0.0),
                dict(kind="evict", p=1.5), dict(kind="evict", round=-1),
                dict(kind="evict", slot=-2),
                dict(kind="straggle", delay_s=-1.0),
                dict(kind="lose_worker", width=0)):
        with pytest.raises(ValueError):
            FaultRule(**bad)
    assert FaultRule("evict").p == 1.0
    assert set(FAULT_KINDS) == {"evict", "corrupt", "straggle",
                                "lose_worker"}


def test_fault_plan_json_roundtrip(tmp_path):
    p = FaultPlan.from_dict(PLANS[0])
    assert FaultPlan.from_dict(p.to_dict()) == p
    path = str(tmp_path / "plan.json")
    p.save(path)
    assert FaultPlan.load(path) == p
    assert FaultRule("evict").to_dict() == {"kind": "evict"}
    with pytest.raises(ValueError):
        FaultPlan.from_dict({"rules": [{"kind": "explode"}]})
    with pytest.raises(TypeError):
        FaultPlan.from_dict({"rules": [{"kind": "evict", "when": 3}]})
    with pytest.raises(TypeError):
        FaultPlan(rules=({"kind": "evict"},))


def test_plan_json_bytes_match_the_reference(both, tmp_path):
    """The port's ``save`` writes the reference's bytes, and ``to_dict``
    its dicts."""
    for i, d in enumerate(PLANS):
        out = str(tmp_path / f"plan{i}.json")
        FaultPlan.from_dict(d).save(out)
        with open(out, "rb") as f, \
                open(os.path.join(both["rd"], f"plan{i}.json"), "rb") as g:
            assert f.read() == g.read()
        assert FaultPlan.from_dict(d).to_dict() == both["ref"]["plans"][i]


def test_runspec_rejects_non_plan_inject():
    with pytest.raises(TypeError):
        RunSpec("smallcrush", "splitmix64", 7, inject={"seed": 0})


# ------------------------------------------------ deterministic drawing

def test_probabilistic_draws_replay_from_plan_and_seed():
    p = FaultPlan(seed=11, rules=(FaultRule("evict", p=0.5),))
    row = np.arange(4)
    a, b = FaultInjector(p), FaultInjector(p)
    hist_a = [a.matches(r, row) for r in range(64)]
    assert hist_a == [b.matches(r, row) for r in range(64)]
    fired = sum(len(m) for m in hist_a)
    assert 0 < fired < 64 * 4
    other = FaultInjector(FaultPlan(seed=12, rules=p.rules))
    assert [other.matches(r, row) for r in range(64)] != hist_a


def test_draws_and_matches_equal_the_reference(both):
    """``_draw`` over a grid of (rule, round, slot), slot -1 included,
    and the (rule, slot) pairs that fire, bitwise the reference's."""
    for d, want in zip(PLANS, both["ref"]["draws"]):
        inj = FaultInjector(FaultPlan.from_dict(d))
        got = [[[bool(inj._draw(i, r, s)) for s in range(-1, 5)]
                for r in range(6)] for i in range(len(inj.plan.rules))]
        assert got == want
    k = 0
    for d in PLANS:
        inj = FaultInjector(FaultPlan.from_dict(d))
        for r in range(3):
            for row in ([0, 1, 2, 3, 4], [3, -1, 5, -1], [7, 8]):
                got = [[i, s] for i, _, s in inj.matches(r, np.asarray(row))]
                assert got == both["ref"]["matches"][k], (d, r, row)
                k += 1


def test_idle_slots_never_fault():
    inj = FaultInjector(FaultPlan(rules=(FaultRule("evict"),)))
    row = np.asarray([3, -1, 5])
    assert [s for _i, _r, s in inj.matches(0, row)] == [0, 2]


def test_bit_flip_always_escapes_the_unit_interval(both):
    """Flipping the top exponent bit maps every p in [0, 1] outside it,
    and the flips are bitwise the reference's."""
    for p in (0.0, 5e-324, 1e-300, 1e-9, 0.25, 0.5, 0.9999, 1.0):
        bad = _bit_flip(p)
        assert not (np.isfinite(bad) and 0.0 <= bad <= 1.0), (p, bad)
    got = np.asarray([_bit_flip(x) for x in FLIPS], np.float64)
    assert got.view(np.uint64).tolist() \
        == both["ref"]["flips"].view(np.uint64).tolist()


def test_apply_round_equals_the_reference(both):
    """``apply_round`` on seeded rows and arrays: the same events, the
    same width asked for, and the arrays after it bitwise."""
    for case, want in zip(apply_cases(), both["ref"]["apply"]):
        inj = FaultInjector(FaultPlan.from_dict(case["plan"]))
        arrays = [(np.asarray(st, np.float64), np.asarray(pv, np.float64))
                  for st, pv in case["arrays"]]
        evs, resize_to = inj.apply_round(case["round"],
                                         np.asarray(case["row"]), arrays,
                                         deadline=case["deadline"])
        assert [e.to_dict() for e in evs] == want["events"]
        assert resize_to == want["resize_to"]
        for (st, pv), (wst, wpv) in zip(arrays, want["arrays"]):
            assert st.view(np.uint64).tolist() \
                == wst.view(np.uint64).tolist()
            assert pv.view(np.uint64).tolist() \
                == wpv.view(np.uint64).tolist()
        assert inj.events == evs


def test_worker_health_streaks():
    h = WorkerHealth()
    h.record(0, True)
    h.record(0, True)
    h.record(1, False)
    assert h.consecutive(0) == 2 and h.consecutive(1) == 0
    assert h.flaky(2) == [0]
    h.record(0, False)
    assert h.flaky(2) == [] and h.total_faults == 2
    h.reset()
    assert h.consecutive(0) == 0


# --------------------------------------- per-kind bitwise parity (W = 1)

@pytest.mark.parametrize("name,kinds,retries", [
    ("evict", ["evict"], 1),
    ("corrupt", ["corrupt", "corrupt_result"], 1),
    ("straggle_deadline", ["straggle"], 1),
    ("straggle_none", ["straggle"], 0),
    ("composed", ["evict", "corrupt", "corrupt_result", "straggle"], None),
    ("mid_fault_resumed", None, None),
])
def test_fault_parity(both, name, kinds, retries):
    """Each fault kind, and a composed plan, at W=1: the port's stitched
    (stat, p) bitwise its fault-free run's; the events (kind, round,
    slot, job, rule), retries, rounds and verdicts those of the
    reference, whose results are its own fault-free run's; (stat, p)
    within tolerance of the reference's."""
    port, ref = both["port"], both["ref"]["runs"]
    assert port[name]["results"] == port["clean"]["results"]
    assert port[name]["job_results"] == port["clean"]["job_results"]
    assert ref[name]["results"] == ref["clean"]["results"]
    assert port[name]["verdicts"] == ref[name]["verdicts"] \
        == port["clean"]["verdicts"]
    assert events(port[name]) == events(ref[name])
    if name == "composed":
        assert {e[1] for e in events(port[name])} == set(kinds)
    elif kinds is not None:
        assert [e[1] for e in events(port[name])] == kinds
    for key in ("retries", "rounds_run", "driver_retries", "held"):
        assert port[name][key] == ref[name][key], key
    if retries is not None:
        assert port[name]["retries"] == retries
    assert_job_results(ref[name]["job_results"], port[name]["job_results"],
                       jobs_of(BASE), name)


def test_gate_and_straggle_details(both):
    """The gate's event names its rule -1 and the finite-p rule; a
    straggle past the deadline says HELD, one without a deadline says
    so; the texts are the reference's (but for the gated values)."""
    port, ref = both["port"], both["ref"]["runs"]
    gated = port["corrupt"]["events"][1]
    assert gated["rule"] == -1 and "must be finite" in gated["detail"]
    assert "HELD" in port["straggle_deadline"]["events"][0]["detail"]
    assert "no deadline set" in port["straggle_none"]["events"][0]["detail"]
    for name in ("evict", "straggle_deadline", "straggle_none"):
        assert events(port[name], detail=True) \
            == events(ref[name], detail=True)


def test_fault_ledger_replays_bit_for_bit(both):
    """The same plan and seed against the same schedule: identical
    ledgers and results, in both packages alike."""
    port, ref = both["port"], both["ref"]["runs"]
    assert port["replay_a"]["events"] == port["replay_b"]["events"]
    assert port["replay_a"]["results"] == port["replay_b"]["results"] \
        == port["clean"]["results"]
    assert events(port["replay_a"]) == events(ref["replay_a"])
    assert port["replay_a"]["retries"] == ref["replay_a"]["retries"] > 0


def test_checkpoint_resume_mid_fault(both):
    """Killed after the faulted round (its one job evicted, so the
    checkpoint holds no result) and resumed in a fresh session: the
    stitched results are the fault-free run's; the resumed run's events,
    rounds and retries are the reference's."""
    port, ref = both["port"], both["ref"]["runs"]
    assert events(port["mid_fault"]) == events(ref["mid_fault"]) \
        == [(0, "evict", 0, port["mid_fault"]["rows"][0][0], 0)]
    for side in (port, ref):
        assert side["mid_fault_resumed"]["results"] \
            == side["clean"]["results"]
        assert side["mid_fault_resumed"]["jobs_done_at_submit"] == 0
    for key in ("rounds_run", "retries", "rows"):
        assert port["mid_fault_resumed"][key] \
            == ref["mid_fault_resumed"][key], key
    assert events(port["mid_fault_resumed"]) \
        == events(ref["mid_fault_resumed"])


def test_checkpoint_bytes_after_a_fault(both, tmp_path):
    """The reference's checkpoint, written after the faulted round, loaded
    and saved again by the port is its file byte for byte; the port's
    file after the fault and the resume holds the fault-free run's
    leaves bit for bit, but for ``rounds_run`` (the retry's round)."""
    src = os.path.join(both["rd"], "chaos.ck")
    out = str(tmp_path / "chaos.ck")
    Checkpoint.load(src).save(out)
    with open(src, "rb") as f, open(out, "rb") as g:
        assert f.read() == g.read()
    faulted = ckpt_io.load_flat(os.path.join(both["pd"], "chaos.ck"))
    clean = ckpt_io.load_flat(os.path.join(both["pd"], "clean.ck"))
    assert len(faulted) == len(clean) == 10
    for i, (a, b) in enumerate(zip(faulted, clean)):
        if i == 5:                              # rounds_run
            assert int(a) == both["port"]["mid_fault_resumed"]["rounds_run"]
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert a.tobytes() == b.tobytes(), i


# ------------------------------------------------- exhaustion semantics

def test_exhaustion_raises_with_held_jobs(both):
    port, ref = both["port"], both["ref"]["runs"]
    ex = port["exhaust"]["exhausted"]
    assert ex["held"] == [0] and ex["retries"] == 1
    assert "retry budget exhausted" in ex["message"]
    assert ex == ref["exhaust"]["exhausted"]
    session = PoolSession(n_workers=1, device="cpu")
    h = session.submit(RunSpec(
        "smallcrush", "splitmix64", 7, scale=SCALE,
        retry=RetryPolicy(max_retries=1),
        inject=FaultPlan(rules=(FaultRule("corrupt", job=0),))))
    with pytest.raises(RetryBudgetExhausted) as ei:
        h.result()
    assert ei.value.held == [0] and ei.value.retries == 1


def test_exhaustion_nonraising_drive_gives_up_quietly(both):
    port, ref = both["port"], both["ref"]["runs"]
    assert port["exhaust_quiet"]["held"] == [0] == ref["exhaust_quiet"]["held"]
    assert port["exhaust_quiet"]["driver_retries"] == 1
    assert port["exhaust_quiet"]["exhausted"] is None


def test_manual_release_is_budget_free_under_faults(both):
    """A release by hand spends none of the drive loop's budget: with
    ``max_retries=0`` a user releases the evicted job, and the run
    completes."""
    port, ref = both["port"], both["ref"]["runs"]
    rec = port["manual_release"]
    assert rec["released"] > 0 and rec["driver_retries"] == 0
    assert rec["retries"] == 1 and rec["exhausted"] is None
    assert rec["results"] == port["clean"]["results"]
    for key in ("released", "retries", "driver_retries", "rounds_run"):
        assert rec[key] == ref["manual_release"][key], key


# ------------------------------------------------- retry policy surface

def test_retry_policy_validation():
    for bad in (dict(max_retries=-1), dict(backoff_base=-0.1),
                dict(backoff_mult=0.5), dict(backoff_max=-1.0),
                dict(deadline=0.0), dict(quarantine_after=0)):
        with pytest.raises(ValueError):
            RetryPolicy(**bad)
    names = [f.name for f in RetryPolicy.__dataclass_fields__.values()]
    assert names == ["max_retries", "backoff_base", "backoff_mult",
                     "backoff_max", "deadline", "quarantine_after"]


def test_backoff_deterministic_and_capped(both):
    p = RetryPolicy(backoff_base=1.0, backoff_mult=2.0, backoff_max=5.0)
    delays = [p.backoff_for(a) for a in range(8)]
    assert delays == [p.backoff_for(a) for a in range(8)]
    assert all(d <= 5.0 for d in delays)
    assert delays[-1] == 5.0
    assert 1.0 <= delays[0] <= 1.1 and 2.0 <= delays[1] <= 2.2
    assert RetryPolicy().backoff_for(3) == 0.0
    for kw, want in zip(BACKOFF, both["ref"]["backoff"]):
        assert [RetryPolicy(**kw).backoff_for(a) for a in range(10)] == want


def test_driver_release_waits_the_backoff(monkeypatch):
    """The drive loop's release waits ``backoff_for`` of its pass; a
    release by hand does not."""
    from repro_torch.core import api as api_mod
    slept = []
    monkeypatch.setattr(api_mod.time, "sleep", slept.append)
    retry = RetryPolicy(max_retries=3, backoff_base=0.5)
    h = PoolSession(n_workers=1, device="cpu").submit(RunSpec(
        "smallcrush", "splitmix64", 7, scale=SCALE, retry=retry,
        inject=FaultPlan(rules=(FaultRule("evict", round=0),
                                FaultRule("evict", round=10)))))
    h.result()
    assert slept == [retry.backoff_for(0), retry.backoff_for(1)]
    assert h.driver_retries == 2


# ------------------------------------- multi-worker scenario (W = 4)

def test_lose_worker_bitwise(both):
    port, ref = both["port"], both["ref"]["runs"]
    rec = port["lose_worker"]
    assert rec["results"] == port["clean4"]["results"]
    assert rec["workers"] == 3 == ref["lose_worker"]["workers"]
    assert [e[1] for e in events(rec)] == ["lose_worker"]
    assert events(rec) == events(ref["lose_worker"])
    assert rec["rows"] == ref["lose_worker"]["rows"]
    assert port["clean4_rr"]["results"] == port["clean4"]["results"]


def test_quarantine_walks_pool_down_bitwise(both):
    """A slot that evicts every round is quarantined (streak 2), the pool
    walks down 4 -> 3 -> 2 ..., and the run completes with the fault-free
    run's (stat, p); quarantines and events as the reference's."""
    port, ref = both["port"], both["ref"]["runs"]
    rec = port["quarantine"]
    assert rec["results"] == port["clean4_rr"]["results"]
    assert rec["verdicts"] == port["clean4_rr"]["verdicts"]
    assert len(rec["quarantines"]) >= 2
    assert rec["workers"] < 4
    assert rec["quarantines"][0]["slots"] == [1]
    assert rec["quarantines"] == ref["quarantine"]["quarantines"]
    assert events(rec) == events(ref["quarantine"])
    for key in ("retries", "rounds_run", "workers"):
        assert rec[key] == ref["quarantine"][key], key


def test_composed_plan_at_w8_with_quarantine_is_bitwise():
    """Inside the port, the phase ``chip_smoke.py`` runs at BigCrush
    x1.0, here at Crush x0.0625: at W=8 an evict, a corrupt, a straggle
    past its deadline, a lost worker (to 6) and a flaky slot quarantined
    after 2 faults; stitched (stat, p) bitwise the fault-free W=8 run's,
    and a second run replays the same ledger."""
    spec = dict(battery="crush", generators=("splitmix64", "randu"),
                seeds=(7,), scale=SCALE)
    fp = FaultPlan(seed=3, rules=(
        FaultRule("evict", round=0, slot=0),
        FaultRule("corrupt", round=1, slot=1),
        FaultRule("straggle", round=2, slot=2, delay_s=90.0),
        FaultRule("lose_worker", round=3, width=6),
        FaultRule("evict", slot=4, p=0.9)))
    retry = RetryPolicy(max_retries=8, deadline=60.0, quarantine_after=2)
    clean = PoolSession(n_workers=8, device="cpu").submit(
        RunSpec(**spec)).result()
    ledgers = []
    for _ in range(2):
        session = PoolSession(n_workers=8, device="cpu")
        h = session.submit(RunSpec(**spec, inject=fp, retry=retry))
        res = h.result()
        for gen, run in res.runs.items():
            assert run.results == clean.runs[gen].results, gen
            assert run.verdict.decision == clean.runs[gen].verdict.decision
        kinds = {e.kind for e in h.fault_events}
        assert {"evict", "corrupt", "corrupt_result", "straggle",
                "lose_worker", "quarantine"} <= kinds, kinds
        assert h.quarantines and session.n_workers < 6
        ledgers.append(([e.to_dict() for e in h.fault_events],
                        h.quarantines, res.retries, res.rounds_run))
    assert ledgers[0] == ledgers[1]


# ---------------------------------------------------------------- CLI

def test_cli_inject_matches_the_reference(both, tmp_path, capsys):
    """``--inject``: the ``faults`` key (plan, events, quarantines) with
    the reference's keys and events, the same exit code, rounds,
    retries and verdicts; every (stat, p) bitwise the port's fault-free
    CLI run's."""
    ref = both["cli"]["json"]
    path = str(tmp_path / "port.json")
    code = cli.main(CLI_ARGS + ["--inject", both["plan_path"], "--device",
                                "cpu", "--json", path])
    with open(path) as f:
        got = json.load(f)
    assert code == both["cli"]["exit_code"]
    assert set(got) == set(ref) and "faults" in got
    assert set(got["faults"]) == {"plan", "events", "quarantines"}
    assert got["faults"]["plan"] == ref["faults"]["plan"] == CLI_PLAN
    assert events(got["faults"]) == events(ref["faults"])
    assert got["faults"]["quarantines"] == ref["faults"]["quarantines"]
    for key in ("workers", "rounds_run", "retries", "plan_rounds",
                "resizes"):
        assert got[key] == ref[key], key
    for gen, run in got["runs"].items():
        assert run["verdict"] == ref["runs"][gen]["verdict"]
    clean_path = str(tmp_path / "clean.json")
    assert cli.main(CLI_ARGS + ["--device", "cpu", "--json",
                                clean_path]) == code
    with open(clean_path) as f:
        clean = json.load(f)
    assert "faults" not in clean
    for gen, run in got["runs"].items():
        assert run["tests"] == clean["runs"][gen]["tests"]
    capsys.readouterr()


def test_cli_inject_argument_errors(tmp_path, capsys):
    """A missing or malformed plan file and ``--inject`` with
    ``--campaign`` are usage errors (exit 2), as in the reference."""
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"rules": [{"kind": "explode"}]}))
    for argv in (["--inject", str(tmp_path / "missing.json")],
                 ["--inject", str(bad)],
                 ["--campaign", "--inject", str(bad)]):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--battery", "smallcrush", "--scale", "0.0625",
                      "--device", "cpu"] + argv)
        assert exc.value.code == 2, argv
    capsys.readouterr()
