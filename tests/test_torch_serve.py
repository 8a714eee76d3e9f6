"""PyTorch port, the screening service (``repro_torch.serve``, DESIGN.md
§10): the result cache, the submission queue, the daemon CLI and the
battery CLI's ``--serve``, each a twin of a test of
``tests/test_serve.py`` (and of ``tests/test_faults.py``'s degraded
daemon), held against the JAX reference.

Both packages take the same steps (``test_torch_reference.drive_serve``;
the reference in ``test_torch_reference.py``'s subprocess, task
``serve``, with 4 host devices for the degraded daemon's pool). Ticket
states, batch ids, dispatch rounds, cache hits and misses, runner builds,
cell digests, batch checkpoint names and the CLIs' exit codes and JSON
keys are compared exactly; ``(stat, p)`` within ``p_tolerance``;
verdicts identical. Cache entries and batch checkpoints cross between
the packages in both directions, and a state directory either daemon
left mid-batch finishes in the other, running only the missing rounds.
"""
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from test_torch_elastic import assert_job_results
from test_torch_reference import (assert_stat_p, drive_serve,
                                  run_reference, spec_objects)

from repro_torch import serve
from repro_torch.core import api, faults, policies, stitch
from repro_torch.core.api import Checkpoint, PoolSession, RunSpec
from repro_torch.core.battery import build_battery
from repro_torch.core.faults import FaultPlan
from repro_torch.core.queue import run_battery
from repro_torch.launch import battery as cli
from repro_torch.launch import serve as daemon
from repro_torch.serve import (DONE, FAILED, CacheEntry, ResultCache,
                               SubmissionQueue, admission_key, cell_digest,
                               spec_cells)

SCALE = 0.01
CORRUPT = {"seed": 0, "rules": [{"kind": "corrupt", "job": 0}]}
FLAKY = {"seed": 0, "rules": [{"kind": "evict", "slot": 1}]}
RNG_SEED = 2727


def spec(gen="splitmix64", seed=7, **kw):
    """``RunSpec`` keywords of ``tests/test_serve.py``'s ``_spec``."""
    return {"battery": "smallcrush", "generators": [gen], "seeds": [seed],
            "scale": kw.pop("scale", SCALE), **kw}


def scenarios(d):
    """The op lists both packages run (``drive_serve``), in this order
    on one shared session ``s`` of one slot (so the reference traces
    each runner shape once), state dirs under ``d``."""
    one = [["session", "s", 1]]
    retry1 = {"max_retries": 1}
    return {
        # hold/release sweep on one session (tests/test_serve.py's
        # module session): cancel stays sticky, stream() drives a retry
        # round, a manual release leaves the driver its whole budget
        "runs": one + [
            ["run", "c", "s", spec()], ["run_poll_all", "c"],
            ["run_status", "c"], ["run_cancel", "c"], ["run_status", "c"],
            ["spoil", 1], ["run", "st", "s", spec(retry={"max_retries": 2})],
            ["run_stream", "st"],
            ["spoil", 10 ** 9],
            ["run", "m", "s", spec(retry={"max_retries": 2})],
            ["run_poll_all", "m"], ["run_held", "m"], ["run_release", "m"],
            ["run_result", "m"]],
        "two_clients": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "two")}],
            ["submit", "q", "a", spec("splitmix64")],
            ["submit", "q", "b", spec("pcg32")], ["drain", "q"],
            ["counters", "q"], ["result", "a", None], ["result", "b", None],
            ["stats", "q"]],
        "resubmit": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "resubmit")}],
            ["submit", "q", "a", spec()], ["drain", "q"], ["counters", "q"],
            ["submit", "q", "b", spec()], ["drain", "q"], ["counters", "q"],
            ["result", "a", None], ["result", "b", None], ["stats", "q"]],
        "duplicates": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "dup")}],
            ["submit", "q", "a", spec()], ["submit", "q", "b", spec()],
            ["drain", "q"], ["counters", "q"], ["result", "a", None],
            ["result", "b", None]],
        "restart": one + [
            ["queue", "q1", "s", {"state": os.path.join(d, "restart")}],
            ["submit", "q1", "a", spec()], ["step", "q1", True],
            ["step", "q1", True], ["counters", "q1"],
            ["queue", "q2", "s", {"state": os.path.join(d, "restart")}],
            ["submit", "q2", "b", spec()], ["drain", "q2"],
            ["counters", "q2"], ["result", "b", None]],
        # left mid-batch, for the other package's daemon to finish
        "crash": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "crash")}],
            ["submit", "q", "a", spec("splitmix64")],
            ["submit", "q", "b", spec("pcg32")],
            ["step", "q", True], ["step", "q", True], ["step", "q", True],
            ["counters", "q"]],
        "max_wait": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "wait"),
                                 "max_wait": 3600.0}],
            ["submit", "q", "a", spec()], ["step", "q", False],
            ["status", "a"], ["counters", "q"], ["drain", "q"],
            ["counters", "q"], ["status", "a"]],
        "cancel": one + [
            ["queue", "q", "s", {"max_wait": 3600.0}],
            ["submit", "q", "a", spec()], ["cancel", "a"], ["status", "a"],
            ["step", "q", False], ["result", "a", None]],
        "campaign": one + [
            ["queue", "q", "s"],
            ["submit", "q", "a", {
                "kind": "campaign", "battery": "smallcrush",
                "generators": ["splitmix64"], "n_streams": 1, "seed": 7,
                "waves": [SCALE], "stream_check": False,
                "ledger_path": os.path.join(d, "ledger.ck")}],
            ["drain", "q"], ["status", "a"], ["result", "a", None],
            ["counters", "q"]],
        "thread": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "thread")}],
            ["start", "q"], ["submit", "q", "a", spec("splitmix64")],
            ["submit", "q", "b", spec("pcg32", seed=11)],
            ["result", "a", 300], ["result", "b", 300], ["stop", "q"]],
        "exhausted": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "exhausted"),
                                 "inject": CORRUPT}],
            ["submit", "q", "a", spec("splitmix64", retry=retry1)],
            ["submit", "q", "b", spec("pcg32", retry=retry1)],
            ["drain", "q"], ["status", "a"], ["status", "b"],
            ["result", "a", None], ["result", "b", None],
            ["counters", "q"]],
        "no_poison": one + [
            ["queue", "q1", "s", {"state": os.path.join(d, "poison"),
                                  "inject": CORRUPT}],
            ["submit", "q1", "a", spec(retry=retry1)], ["drain", "q1"],
            ["status", "a"],
            ["queue", "q2", "s", {"state": os.path.join(d, "poison")}],
            ["submit", "q2", "b", spec()], ["drain", "q2"],
            ["result", "b", None], ["counters", "q2"]],
        "health": one + [
            ["queue", "q", "s", {"state": os.path.join(d, "health")}],
            ["submit", "q", "a", spec()], ["drain", "q"], ["stats", "q"]],
        # tests/faults_scenario.py's degraded daemon: a 4-slot session
        # whose slot 1 evicts every round is quarantined down; then back
        # to one slot for the scenarios after it
        "degraded": one + [
            ["run", "r", "s", spec()], ["run_result", "r"],
            ["resize", "s", 4],
            ["queue", "q", "s", {"state": os.path.join(d, "degraded"),
                                 "inject": FLAKY}],
            ["submit", "q", "a", spec(
                policy="roundrobin",
                retry={"max_retries": 10, "quarantine_after": 2})],
            ["drain", "q"], ["stats", "q"], ["result", "a", None],
            ["counters", "q"], ["resize", "s", 1]],
    }


def resume_ops(state):
    """A daemon on ``state`` given the crash scenario's submissions."""
    return [["session", "s", 1], ["queue", "q", "s", {"state": state}],
            ["submit", "q", "a", spec("splitmix64")],
            ["submit", "q", "b", spec("pcg32")], ["drain", "q"],
            ["counters", "q"], ["result", "a", None], ["result", "b", None]]


DIGEST_ARGS = [
    ["smallcrush", SCALE, "splitmix64", 7, 0, 0.01, "reference"],
    ["smallcrush", SCALE, "splitmix64", 7, 0, 0.01, "accelerated"],
    ["crush", 0.5, "pcg32", 8, 3, 0.05, "reference"],
    ["bigcrush", 1.0, "randu", 2 ** 31 - 1, 1 << 40, 0.001, "accelerated"],
    ["smallcrush", SCALE, "splitmix64", 7, 0, 0.01, "reference",
     "ab" * 32],
    ["smallcrush", SCALE, "splitmix64", 7, 0, 0.01, "reference", "",
     "evalue"],
    ["smallcrush", SCALE, "splitmix64", 7, 0, 0.01, "accelerated",
     "cd" * 32, "evalue"],
]
# specs whose cells and admission keys are compared (backend auto
# resolves to reference on the CPU in both packages)
CELL_SPECS = [
    spec(), spec("pcg32", seed=99), spec(alpha=0.05), spec(scale=0.02),
    spec(backend="auto"), spec(backend="accelerated"),
    spec(inject=CORRUPT), spec(verdict_engine="evalue"),
    spec(policy="roundrobin"),
    {"battery": "crush", "generators": ["threefry", "msweyl"],
     "seeds": [3, 4], "scale": 0.0625, "offsets": [0, 4096]},
]
CLI_ARGS = ["--battery", "smallcrush", "--gen", "splitmix64,randu",
            "--scale", "0.03125", "--seed", "7", "--workers", "1"]
REFUSED = [["--serve-state", "d"], ["--serve-resubmit"],
           ["--serve-max-wait", "1"], ["--serve", "--campaign"],
           ["--serve", "--resize-at", "2:4"], ["--serve", "--ckpt", "x.ck"],
           ["--serve", "--inject", "plan.json"],
           ["--serve", "--serve-state", "d", "--campaign"]]
SUBMISSIONS = [{"battery": "smallcrush", "gen": "splitmix64", "seed": 7,
                "scale": SCALE},
               {"battery": "smallcrush", "gen": "randu", "seed": 7,
                "scale": SCALE},
               {"battery": "smallcrush", "gen": "pcg32,mwc", "seed": 3,
                "scale": SCALE}]


def random_results(rng, n_total, n):
    """``n`` of ``n_total`` test results drawn from ``rng``."""
    idx = sorted(rng.choice(n_total, size=n, replace=False).tolist())
    return {int(i): (float(rng.normal() * 10), float(rng.uniform(0.02, 0.98)))
            for i in idx}


def entry_cases(rng):
    """Cache entry cases: complete, partial decided (FAIL), partial
    undecided, evalue; results drawn from ``rng``."""
    full = random_results(rng, 10, 10)
    fail = {**random_results(rng, 10, 3), 4: (9.9, 1e-12)}
    return [{"results": full, "n_total": 10, "alpha": 0.01},
            {"results": fail, "n_total": 10, "alpha": 0.01},
            {"results": random_results(rng, 10, 4), "n_total": 10,
             "alpha": 0.05},
            {"results": random_results(rng, 106, 106), "n_total": 106,
             "alpha": 0.01, "engine": "evalue"}]


def _port_drive(ops, sessions=None):
    return drive_serve(ops, api, serve, faults, policies, sessions,
                       device="cpu")


def _entry(case):
    return CacheEntry.from_results(case["results"], case["n_total"],
                                   case["alpha"],
                                   engine=case.get("engine", "bonferroni"))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    ref_dir, port_dir = str(d / "ref"), str(d / "port")
    ref_ops, port_ops = scenarios(ref_dir), scenarios(port_dir)
    shared = {}
    port = {name: _port_drive(ops, shared)
            for name, ops in port_ops.items()}
    # what the reference reads of the port's: a daemon's state left
    # mid-batch (copied, so the port's own stays as it was), cache entries
    crash_for_ref = str(d / "port_crash_for_ref")
    shutil.copytree(os.path.join(port_dir, "crash"), crash_for_ref)
    cases = entry_cases(np.random.default_rng(RNG_SEED))
    port_entries = []
    for i, case in enumerate(cases):
        path = str(d / f"port_entry{i}.ck")
        _entry(case).save(path)
        port_entries.append(path)
    ref_entries = [str(d / f"ref_entry{i}.ck") for i in range(len(cases))]
    port_batch = os.path.join(port_dir, "two")
    ref_ops["resume_port"] = resume_ops(crash_for_ref)
    subs = str(d / "subs.json")
    with open(subs, "w") as f:
        json.dump(SUBMISSIONS, f)
    ref_cli_json = str(d / "ref_cli.json")
    ref_daemon = [str(d / "ref_daemon1.json"), str(d / "ref_daemon2.json")]
    ref_daemon_state = str(d / "ref_daemon_state")
    task = {
        "kind": "serve", "scenarios": ref_ops, "digests": DIGEST_ARGS,
        "cells": CELL_SPECS,
        "entries": [{**c, "results": {str(k): list(v)
                                      for k, v in c["results"].items()},
                     "path": p} for c, p in zip(cases, ref_entries)],
        "loads": port_entries,
        "cli": [CLI_ARGS + ["--serve", "--serve-state",
                            str(d / "ref_cli_state"), "--serve-resubmit",
                            "--json", ref_cli_json]]
        + [CLI_ARGS + argv for argv in REFUSED],
        "daemon": [["--submit", subs, "--state", ref_daemon_state,
                    "--workers", "1", "--json", path]
                   for path in ref_daemon]}
    batch_files = sorted(f for f in os.listdir(port_batch)
                         if f.startswith("batch-"))
    ref_run, ck_loads = run_reference(
        [task, {"kind": "ckpt", "load": [os.path.join(port_batch, f)
                                         for f in batch_files]}],
        str(d / "out"), devices=4)
    with open(ref_cli_json) as f:
        ref_run["cli_json"] = json.load(f)
    ref_run["daemon_json"] = []
    for path in ref_daemon:
        with open(path) as f:
            ref_run["daemon_json"].append(json.load(f))
    return {"ref": ref_run, "port": port, "dir": d, "ref_dir": ref_dir,
            "port_dir": port_dir, "cases": cases,
            "port_entries": port_entries, "ref_entries": ref_entries,
            "ck_loads": ck_loads, "batch_files": batch_files,
            "subs": subs, "ref_daemon_state": ref_daemon_state}


def ops_of(both, name):
    """(reference records, port records, the op list) of a scenario."""
    return (both["ref"]["scenarios"][name]["ops"],
            both["port"][name]["ops"], scenarios("")[name])


def rec(records, ops, kind, *names):
    """The records of the ops of ``kind`` (on ``names``), in order."""
    return [r for r, op in zip(records, ops)
            if op[0] == kind and all(n in op for n in names)]


def assert_run_records(ref, got, scale=SCALE, what=""):
    """Two ``_run_record``s: the same verdicts, rounds and tests, each
    (stat, p) within the parity contract."""
    entries = build_battery("smallcrush", scale, device="cpu")
    assert got["verdicts"] == ref["verdicts"], what
    assert got["rounds_run"] == ref["rounds_run"], what
    assert got["plan_rounds"] == ref["plan_rounds"], what
    assert got["named"] == ref["named"], what
    for g, rr in ref["results"].items():
        assert set(got["results"][g]) == set(rr), (what, g)
        for k, (s, p) in rr.items():
            e = entries[int(k)]
            assert_stat_p(e.kname, dict(e.params), (s, p),
                          tuple(got["results"][g][k]), f"{what} {g}")


# ---------------------------------------------- hold/release bug sweep

def test_manual_release_does_not_spend_driver_budget(both):
    ref, got, ops = ops_of(both, "runs")
    held = rec(got, ops, "run_held", "m")[0]
    release = rec(got, ops, "run_release", "m")[0]
    result = rec(got, ops, "run_result", "m")[0]
    assert held == [0]
    assert release == {"released": 1, "retries": 1, "driver_retries": 0}
    assert result["error"] == "RetryBudgetExhausted" and result["held"] == [0]
    assert (result["driver_retries"], result["retries_after"]) == (2, 3)
    for kind in ("run_held", "run_release", "run_result"):
        assert rec(got, ops, kind, "m") == rec(ref, ops, kind, "m"), kind


def test_stream_drives_hold_release_rounds(both):
    ref, got, ops = ops_of(both, "runs")
    out = rec(got, ops, "run_stream", "st")[0]
    assert out["done"] and not out["held"]
    assert out["driver_retries"] == 1 and out["states"][-1] == "done"
    assert out["verdict"] == stitch.PASS
    assert out == rec(ref, ops, "run_stream", "st")[0]


def test_cancel_is_sticky_after_completion(both):
    ref, got, ops = ops_of(both, "runs")
    assert rec(got, ops, "run_status", "c") == ["done", "cancelled"]
    assert rec(ref, ops, "run_status", "c") == ["done", "cancelled"]


# ---------------------------------------------------- cache primitives

def test_cell_digest_sensitivity_and_reference_digests(both):
    base = ("smallcrush", SCALE, "splitmix64", 7, 0, 0.01, "reference")
    d = cell_digest(*base)
    assert d == cell_digest(*base) and len(d) == 32
    for i in range(len(base)):
        other = list(base)
        other[i] = {0: "crush", 1: 0.5, 2: "pcg32", 3: 8, 4: 3,
                    5: 0.05, 6: "accelerated"}[i]
        assert cell_digest(*other) != d, f"field {i} not in the digest"
    assert cell_digest(*base, source_digest="ab") != d
    assert cell_digest(*base, engine="evalue") != d
    assert [cell_digest(*a) for a in DIGEST_ARGS] == both["ref"]["digests"]


def test_cache_entry_roundtrip(tmp_path):
    results = {i: (1.0, 0.5) for i in range(10)}
    entry = CacheEntry.from_results(results, 10, alpha=0.01)
    assert entry.complete and entry.decision == stitch.PASS
    path = str(tmp_path / "cell.ck")
    entry.save(path)
    back = CacheEntry.load(path)
    assert back.results == entry.results
    assert (back.decision, back.alpha, back.n_total, back.complete,
            back.engine) == (entry.decision, entry.alpha, entry.n_total,
                             entry.complete, "bonferroni")
    assert back.verdict().decision == stitch.PASS


def test_cache_entries_cross_packages_byte_for_byte(both):
    """The same results saved by either package give the same bytes; each
    package loads the other's entries (v2, the engine leaf included)."""
    for i, (case, ref_path, port_path) in enumerate(zip(
            both["cases"], both["ref_entries"], both["port_entries"])):
        with open(ref_path, "rb") as f, open(port_path, "rb") as g:
            assert f.read() == g.read(), i
        entry = _entry(case)
        back = CacheEntry.load(ref_path)
        assert back == entry, i
        loaded = both["ref"]["loads"][i]
        assert {int(k): tuple(v) for k, v in loaded["results"].items()} \
            == entry.results
        assert (loaded["decision"], loaded["alpha"], loaded["n_total"],
                loaded["complete"], loaded["engine"], loaded["version"]) \
            == (entry.decision, entry.alpha, entry.n_total, entry.complete,
                entry.engine, serve.CACHE_VERSION)
        made = both["ref"]["entries"][i]
        assert (made["decision"], made["complete"]) == (entry.decision,
                                                        entry.complete)
        assert made["serves"] == [entry.serves(False), entry.serves(True)]


def test_v1_entries_load_and_bad_versions_raise(tmp_path):
    from repro_torch.ckpt import io as ckpt_io
    path = str(tmp_path / "v1.ck")
    ckpt_io.save(path, [np.int64(1), np.asarray([0, 2], np.int32),
                        np.asarray([1.0, 2.0]), np.asarray([0.5, 0.25]),
                        np.int8(0), np.float64(0.01), np.int64(10),
                        np.int8(0)])
    e = CacheEntry.load(path)
    assert (e.version, e.engine, e.complete) == (1, "bonferroni", False)
    assert e.results == {0: (1.0, 0.5), 2: (2.0, 0.25)}
    ckpt_io.save(path, [np.int64(3), *[np.int8(0)] * 8])
    with pytest.raises(ValueError, match="version 3"):
        CacheEntry.load(path)
    ckpt_io.save(path, [np.int64(2)] * 5)
    with pytest.raises(ValueError, match="5 leaves"):
        CacheEntry.load(path)


def test_partial_entry_serves_only_decided_adaptive_clients():
    decided = CacheEntry.from_results({0: (9.9, 1e-12)}, 10, alpha=0.01)
    assert not decided.complete and decided.decision == stitch.FAIL
    assert decided.serves(stop_on_verdict=True)
    assert not decided.serves(stop_on_verdict=False)
    undecided = CacheEntry.from_results({0: (1.0, 0.5)}, 10, alpha=0.01)
    assert not undecided.serves(True) and not undecided.serves(False)


def test_cache_never_downgrades_complete_entries(tmp_path):
    cache = ResultCache(str(tmp_path / "cache"))
    full = CacheEntry.from_results({i: (1.0, 0.5) for i in range(10)},
                                   10, alpha=0.01)
    partial = CacheEntry.from_results({0: (9.9, 1e-12)}, 10, alpha=0.01)
    cache.put("d", full)
    cache.put("d", partial)
    assert cache.get("d").complete
    cold = ResultCache(str(tmp_path / "cache"))
    cold.put("d", partial)
    assert cold.get("d").complete
    assert (cold.hits, cold.misses) == (1, 0)
    assert ResultCache().get("nothing") is None


def test_demux_positions_inverts_the_merge():
    per_pos = [{0: (1.0, 0.1)}, {0: (2.0, 0.2)}, {0: (3.0, 0.3)}]
    out = stitch.demux_positions(per_pos, {"a": [2, 0], "b": [1]})
    assert out == {"a": [{0: (3.0, 0.3)}, {0: (1.0, 0.1)}],
                   "b": [{0: (2.0, 0.2)}]}


def test_admission_key_groups_compatible_specs(both):
    def mk(kw):
        return RunSpec(**spec_objects(kw, faults, policies))
    a, b = mk(spec("splitmix64")), mk(spec("pcg32", seed=99))
    cpu = "cpu"
    assert admission_key(a, cpu) == admission_key(b, cpu)
    assert admission_key(a, cpu) != admission_key(mk(spec(alpha=0.05)), cpu)
    assert admission_key(a, cpu) != admission_key(mk(spec(scale=0.02)), cpu)
    assert [c.digest for c in spec_cells(a, cpu)] != \
        [c.digest for c in spec_cells(b, cpu)]
    # auto resolves on the device: the CPU files it under reference, as
    # the reference does on the CPU
    assert admission_key(mk(spec(backend="auto")), cpu) \
        == admission_key(a, cpu)
    for kw, ref in zip(CELL_SPECS, both["ref"]["cells"]):
        s = mk(kw)
        assert [c.digest for c in spec_cells(s, cpu)] == ref["digests"], kw
        assert repr(admission_key(s, cpu)) == ref["key"], kw


def test_auto_backend_is_filed_under_the_device_it_resolves_to(monkeypatch):
    """On an H100 ``auto`` is the kernels: its cells are the accelerated
    backend's (the capability query stubbed, no card here)."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    auto = RunSpec("smallcrush", "splitmix64", seeds=(7,), scale=SCALE)
    acc = RunSpec("smallcrush", "splitmix64", seeds=(7,), scale=SCALE,
                  backend="accelerated")
    assert [c.digest for c in spec_cells(auto, "cuda")] == \
        [c.digest for c in spec_cells(acc, "cuda")] != \
        [c.digest for c in spec_cells(auto, "cpu")]
    assert admission_key(auto, "cuda")[3] == "accelerated"
    assert admission_key(auto, "cpu")[3] == "reference"


# ---------------------------------------------------- submission queue

def test_two_clients_share_one_dispatch_per_round(both):
    ref, got, ops = ops_of(both, "two_clients")
    counters = rec(got, ops, "counters")[0]
    assert counters["batches_formed"] == 1 and counters["traces"] == 1
    ra, rb = rec(got, ops, "result")
    assert counters["dispatch_rounds"] == ra["rounds_run"] == rb["rounds_run"]
    assert ra["verdicts"] == {"splitmix64": stitch.PASS}
    assert rb["verdicts"] == {"pcg32": stitch.PASS}
    assert ra["named"] == {"splitmix64": True}
    assert len(ra["results"]["splitmix64"]) == 10
    assert ra["results"]["splitmix64"] != rb["results"]["pcg32"]
    tickets = both["port"]["two_clients"]["tickets"]
    assert tickets["a"]["batch"] == tickets["b"]["batch"] == 0
    assert tickets == both["ref"]["scenarios"]["two_clients"]["tickets"]
    assert rec(got, ops, "counters") == rec(ref, ops, "counters")
    assert rec(got, ops, "stats") == rec(ref, ops, "stats")
    for r_ref, r_got in zip(rec(ref, ops, "result"), rec(got, ops, "result")):
        assert_run_records(r_ref, r_got, what="two clients")


def test_batch_of_two_tickets_is_the_two_generator_run(tmp_path):
    """A merged batch's per-ticket results are bitwise those of one
    two-generator ``RunSpec`` of the same generators (positions in
    digest order), and a duplicate ticket shares its twin's position."""
    queue = SubmissionQueue(PoolSession(n_workers=1, device="cpu"),
                            state_dir=str(tmp_path / "s"))
    gens = ("splitmix64", "pcg32")
    tickets = [queue.submit(RunSpec("smallcrush", g, seeds=(7,),
                                    scale=SCALE)) for g in gens]
    twin = queue.submit(RunSpec("smallcrush", "pcg32", seeds=(7,),
                                scale=SCALE))
    queue.drain()
    assert queue.batches_formed == 1
    assert twin._positions == tickets[1]._positions
    multi = PoolSession(n_workers=1, device="cpu").submit(RunSpec(
        "smallcrush", gens, seeds=(7,), scale=SCALE)).result()
    for g, t in zip(gens, tickets):
        assert t.result().results == multi.runs[g].results
        assert t.result().verdict == multi.runs[g].verdict
        assert t.result().report == multi.runs[g].report
    assert twin.result().results == tickets[1].result().results


def test_resubmission_served_from_cache_with_zero_dispatches(both):
    ref, got, ops = ops_of(both, "resubmit")
    submits = rec(got, ops, "submit")
    assert submits[1]["done"] and submits[1]["cache_hits"] == 1
    c1, c2 = rec(got, ops, "counters")
    assert c2["dispatch_rounds"] == c1["dispatch_rounds"]
    ra, rb = rec(got, ops, "result")
    assert ra["results"] == rb["results"]
    assert rec(got, ops, "stats")[0]["cache"]["hits"] >= 1
    for kind in ("submit", "counters", "stats"):
        assert rec(got, ops, kind) == rec(ref, ops, kind), kind


def test_concurrent_duplicates_dedup_into_one_position(both):
    ref, got, ops = ops_of(both, "duplicates")
    counters = rec(got, ops, "counters")[0]
    assert counters["batches_formed"] == 1 and counters["cache_len"] == 1
    ra, rb = rec(got, ops, "result")
    assert ra["results"] == rb["results"]
    assert rec(got, ops, "counters") == rec(ref, ops, "counters")


def test_daemon_restart_resumes_from_checkpoints(both):
    ref, got, ops = ops_of(both, "restart")
    before, after = rec(got, ops, "counters")
    res = rec(got, ops, "result")[0]
    assert res["verdicts"] == {"splitmix64": stitch.PASS}
    assert 0 < before["dispatch_rounds"]
    # smallcrush = 10 jobs = 10 rounds on one worker: the restarted daemon
    # ran only the rounds the first one had not finished
    assert before["dispatch_rounds"] + after["dispatch_rounds"] == 10
    assert res["plan_rounds"] == {"splitmix64": after["dispatch_rounds"]}
    assert rec(got, ops, "counters") == rec(ref, ops, "counters")
    assert_run_records(rec(ref, ops, "result")[0], res, what="restart")


def test_batch_checkpoints_cross_packages(both):
    """The two-client batch's checkpoint has the same name in both
    packages; each loads the other's, integer leaves equal, (stat, p)
    within the contract."""
    names = both["batch_files"]
    assert len(names) == 1
    assert names == sorted(f for f in os.listdir(
        os.path.join(both["ref_dir"], "two")) if f.startswith("batch-"))
    jobs = build_battery("smallcrush", SCALE, device="cpu")
    ref_ck = Checkpoint.load(os.path.join(both["ref_dir"], "two", names[0]))
    port_ck = Checkpoint.load(os.path.join(both["port_dir"], "two",
                                           names[0]))
    seen = both["ck_loads"]["loads"][0]
    for ck in (ref_ck, port_ck):
        assert ck.version == seen["version"] == 5
        assert ck.job_idx.dtype == seen["job_idx"].dtype
        assert ck.job_idx.tobytes() == seen["job_idx"].tobytes()
        assert [int(x) for x in ck.decisions] == seen["decisions"]
        assert (ck.rounds_run, ck.alpha, ck.engine) == (
            seen["rounds_run"], seen["alpha"], seen["engine"])
        assert [u.decode() for u in ck.source_uids] == seen["source_uids"]

    def rows(stats, ps):
        return [{int(j): (float(s), float(p))
                 for j, s, p in zip(ref_ck.job_idx, st, pv)}
                for st, pv in zip(stats, ps)]
    assert_job_results(rows(ref_ck.stats, ref_ck.ps),
                       rows(seen["stats"], seen["ps"]), jobs, "port file")
    assert_job_results(rows(ref_ck.stats, ref_ck.ps),
                       rows(port_ck.stats, port_ck.ps), jobs, "ref file")


def test_reference_state_dir_finishes_in_the_port_daemon(both, tmp_path):
    """A state directory the reference's daemon left after 3 steps
    resumes in the port's: only the 7 missing rounds run, with the
    reference's verdicts; the port's left the same way finishes in the
    reference's."""
    ref, got, ops = ops_of(both, "crash")
    assert rec(ref, ops, "counters") == rec(got, ops, "counters")
    assert rec(got, ops, "counters")[0]["dispatch_rounds"] == 3
    state = str(tmp_path / "state")
    shutil.copytree(os.path.join(both["ref_dir"], "crash"), state)
    out = _port_drive(resume_ops(state))
    r_ops = resume_ops(state)
    counters = rec(out["ops"], r_ops, "counters")[0]
    assert counters["dispatch_rounds"] == 7 and counters["batches_formed"] == 1
    back = both["ref"]["scenarios"]["resume_port"]["ops"]
    # the reference's daemon ran on the shared session, which had built
    # the two-generator runner already: compare all but runner builds
    (ref_counters,) = rec(back, r_ops, "counters")
    assert {**ref_counters, "traces": 1} == counters
    full = rec(both["ref"]["scenarios"]["two_clients"]["ops"],
               scenarios("")["two_clients"], "result")
    for r_full, r_port, r_ref in zip(full, rec(out["ops"], r_ops, "result"),
                                     rec(back, r_ops, "result")):
        assert r_port["plan_rounds"] == r_ref["plan_rounds"] \
            == {g: 7 for g in r_full["verdicts"]}
        for r in (r_port, r_ref):
            assert r["verdicts"] == r_full["verdicts"]
            assert set(r["results"]) == set(r_full["results"])
        assert_run_records(r_ref, r_port, what="resumed")


def test_max_wait_window_defers_admission(both):
    ref, got, ops = ops_of(both, "max_wait")
    assert rec(got, ops, "step")[0] is False
    first, last = rec(got, ops, "status")
    assert first["state"] == "queued"
    c1, c2 = rec(got, ops, "counters")
    assert c1["batches_formed"] == 0 and c2["batches_formed"] == 1
    assert last["state"] == DONE
    for kind in ("step", "status", "counters"):
        assert rec(got, ops, kind) == rec(ref, ops, kind), kind
    with pytest.raises(ValueError, match="max_wait"):
        SubmissionQueue(PoolSession(n_workers=1, device="cpu"),
                        max_wait=-1.0)


def test_queued_ticket_cancel(both):
    ref, got, ops = ops_of(both, "cancel")
    assert rec(got, ops, "cancel") == [True]
    assert rec(got, ops, "status")[0]["state"] == "cancelled"
    assert rec(got, ops, "step") == [False]
    res = rec(got, ops, "result")[0]
    assert res["error"] == "RuntimeError" and "cancelled" in res["message"]
    assert got == ref


def test_campaign_ticket_runs_phase_by_phase(both):
    ref, got, ops = ops_of(both, "campaign")
    assert rec(got, ops, "status")[0]["phases_done"] == 1
    res = rec(got, ops, "result")[0]
    assert res["survivors"] == 1 and res["knockouts"] == 0
    assert got == ref


def test_background_daemon_thread(both):
    ref, got, ops = ops_of(both, "thread")
    assert rec(got, ops, "start") == [True]
    assert rec(got, ops, "stop") == [False]
    ra, rb = rec(got, ops, "result")
    assert ra["verdicts"] == {"splitmix64": stitch.PASS}
    assert rb["verdicts"] == {"pcg32": stitch.PASS}
    for r_ref, r_got in zip(rec(ref, ops, "result"), rec(got, ops, "result")):
        assert r_got["verdicts"] == r_ref["verdicts"]
        for g, rr in r_ref["results"].items():
            entries = build_battery("smallcrush", SCALE, device="cpu")
            for k, (s, p) in rr.items():
                e = entries[int(k)]
                assert_stat_p(e.kname, dict(e.params), (s, p),
                              tuple(r_got["results"][g][k]), "thread")


def test_daemon_thread_serves_many_clients_and_stops(tmp_path):
    """Eight clients submitting from their own threads to one daemon
    thread: every ticket ends DONE with its generator's results, the
    repeats from the cache, and ``stop()`` joins the thread."""
    import sys
    session = PoolSession(n_workers=2, device="cpu")
    queue = SubmissionQueue(session, state_dir=str(tmp_path / "s"))
    gens = ["splitmix64", "pcg32", "xorshift64s", "lcg64"] * 2
    tickets, lock = {}, threading.Lock()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(i):
        t = queue.submit(RunSpec("smallcrush", gens[i], seeds=(7,),
                                 scale=SCALE))
        with lock:
            tickets[i] = t
    try:
        queue.start()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(gens))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
        results = {i: t.result(timeout=300) for i, t in tickets.items()}
    finally:
        sys.setswitchinterval(switch)
        queue.stop()
    assert not queue.serving and queue._thread is None
    assert all(t.state == DONE for t in tickets.values())
    solo = PoolSession(n_workers=1, device="cpu")
    for g in set(gens):
        want = solo.submit(RunSpec("smallcrush", g, seeds=(7,),
                                   scale=SCALE)).result().results
        for i, res in results.items():
            if gens[i] == g:
                assert res.results == want, g
    st = queue.stats()
    assert st["tickets"] == 8 and st["pending"] == 0
    assert st["cache"]["entries"] == 4


# ------------------------------------------ fault-domain terminal states

def test_budget_exhausted_batch_fails_every_ticket(both):
    ref, got, ops = ops_of(both, "exhausted")
    tickets = both["port"]["exhausted"]["tickets"]
    assert tickets["a"]["batch"] == tickets["b"]["batch"]
    for t in tickets.values():
        assert t["state"] == FAILED
        assert t["failure"]["held_jobs"] == [0]
        assert "retry budget exhausted" in t["failure"]["reason"]
    for st in rec(got, ops, "status"):
        assert st["failure"]["retries"] == 1
    for res in rec(got, ops, "result"):
        assert res["error"] == "RetryBudgetExhausted" and res["held"] == [0]
    assert got == ref
    assert tickets == both["ref"]["scenarios"]["exhausted"]["tickets"]


def test_failed_batch_does_not_poison_cache(both):
    ref, got, ops = ops_of(both, "no_poison")
    assert rec(got, ops, "status")[0]["state"] == FAILED
    assert not rec(got, ops, "submit", "b")[0]["done"]
    res = rec(got, ops, "result")[0]
    assert res["verdicts"] == {"splitmix64": stitch.PASS}
    assert len(res["results"]["splitmix64"]) == 10
    assert all(np.isfinite(p) for _s, p in res["results"]["splitmix64"]
               .values())
    for kind in ("status", "submit", "counters"):
        assert rec(got, ops, kind) == rec(ref, ops, kind), kind
    assert_run_records(rec(ref, ops, "result")[0], res, what="no poison")


def test_queue_inject_key_and_stats_health(both):
    clean = RunSpec("smallcrush", "splitmix64", seeds=(7,), scale=SCALE)
    chaos = RunSpec("smallcrush", "splitmix64", seeds=(7,), scale=SCALE,
                    inject=FaultPlan.from_dict(CORRUPT))
    assert admission_key(clean, "cpu") != admission_key(chaos, "cpu")
    ref, got, ops = ops_of(both, "health")
    st = rec(got, ops, "stats")[0]
    assert st["status"] == "ok" and st["workers"] >= 1
    assert got == ref


def test_degraded_daemon_keeps_serving(both):
    """``tests/test_faults.py::test_degraded_daemon_keeps_serving``: a
    queue whose 4-slot session is quarantined down by a flaky slot
    serves its ticket DONE, bitwise the fault-free run, and reports
    ``degraded``; the reference ends the same way."""
    ref, got, ops = ops_of(both, "degraded")
    clean = rec(got, ops, "run_result")[0]
    res = rec(got, ops, "result")[0]
    st = rec(got, ops, "stats")[0]
    assert both["port"]["degraded"]["tickets"]["a"]["state"] == DONE
    assert res["results"] == clean["results"]
    assert st["status"] == "degraded" and st["workers"] < 4
    assert rec(ref, ops, "stats") == [st]
    assert both["ref"]["scenarios"]["degraded"]["tickets"]["a"]["state"] \
        == DONE
    assert_run_records(rec(ref, ops, "result")[0], res, what="degraded")


# ------------------------------------------------------------ the CLIs

def test_cli_serve_matches_the_reference(both, tmp_path, capsys):
    path = str(tmp_path / "port.json")
    code = cli.main(CLI_ARGS + ["--serve", "--serve-state",
                                str(tmp_path / "state"), "--serve-resubmit",
                                "--json", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serve: 2 ticket(s) -> 1 batch(es)" in out
    assert "cache_hits=1 dispatches_added=0" in out
    ref = both["ref"]["cli_json"]
    assert code == both["ref"]["cli"][0] == 1        # randu is suspect
    with open(path) as f:
        got = json.load(f)
    assert set(got) == set(ref)
    assert set(got["serve"]) == set(ref["serve"])
    for key in ("batches", "dispatch_rounds", "cache", "traces",
                "resubmit", "tickets", "max_wait"):
        assert got["serve"][key] == ref["serve"][key], key
    assert got["serve"]["resubmit"]["dispatches_added"] == 0
    entries = build_battery("smallcrush", 0.03125, device="cpu")
    for gen, run in ref["runs"].items():
        mine = got["runs"][gen]
        assert mine["verdict"] == run["verdict"]
        for tr, tg in zip(run["tests"], mine["tests"]):
            e = entries[tr["index"]]
            assert_stat_p(e.kname, dict(e.params), (tr["stat"], tr["p"]),
                          (tg["stat"], tg["p"]), gen)


def test_cli_serve_refusals_match_the_reference(both, capsys):
    assert both["ref"]["cli"][1:] == [2] * len(REFUSED)
    for argv in REFUSED:
        with pytest.raises(SystemExit) as exc:
            cli.main(CLI_ARGS + argv + ["--device", "cpu"])
        assert exc.value.code == 2, argv
    capsys.readouterr()


def test_daemon_cli_matches_the_reference_and_shares_its_cache(
        both, tmp_path, capsys):
    """The daemon CLI twice on one state dir (the second run all from the
    cache: ``dispatch_rounds=0``), against the reference's two runs; then
    on a copy of the reference daemon's state dir: every ticket from the
    reference's cache."""
    state = str(tmp_path / "state")
    reports = []
    for i in range(2):
        path = str(tmp_path / f"d{i}.json")
        assert daemon.main(["--submit", both["subs"], "--state", state,
                            "--workers", "1", "--json", path,
                            "--device", "cpu"]) == 0
        with open(path) as f:
            reports.append(json.load(f))
    out = capsys.readouterr().out
    assert "dispatch_rounds=0" in out.splitlines()[-2]
    assert both["ref"]["daemon"] == [0, 0]
    for got, ref in zip(reports, both["ref"]["daemon_json"]):
        assert set(got) == set(ref)
        for key in ("workers", "max_wait", "tickets", "stats"):
            assert got[key] == ref[key], key
    assert reports[1]["stats"]["dispatch_rounds"] == 0
    assert reports[1]["stats"]["cache"]["hits"] == 4
    shared = str(tmp_path / "shared")
    shutil.copytree(both["ref_daemon_state"], shared)
    path = str(tmp_path / "shared.json")
    assert daemon.main(["--submit", both["subs"], "--state", shared,
                        "--json", path, "--device", "cpu"]) == 0
    with open(path) as f:
        rep = json.load(f)
    assert rep["stats"]["dispatch_rounds"] == 0
    assert [t["cache_hits"] for t in rep["tickets"]] == [1, 1, 2]
    assert [t["verdicts"] for t in rep["tickets"]] == \
        [t["verdicts"] for t in both["ref"]["daemon_json"][0]["tickets"]]
    capsys.readouterr()


def test_daemon_cli_wire_shape_and_errors(tmp_path):
    s = daemon.spec_from_dict({"battery": "crush", "gen": "pcg32, mwc",
                               "seed": 3, "scale": 0.5, "adaptive": True,
                               "retries": 5, "offset": 0})
    assert s.generators == ("pcg32", "mwc") and s.seeds == (3, 3)
    assert s.stop_on_verdict and s.retry.max_retries == 5
    assert s.offsets is None
    c = daemon.spec_from_dict({"kind": "campaign", "battery": "smallcrush",
                               "gen": ["splitmix64"], "streams": 2,
                               "waves": [0.125, 0.5]})
    assert c.n_streams == 2 and c.waves == (0.125, 0.5)
    with pytest.raises(ValueError, match="unknown submission field"):
        daemon.spec_from_dict({"battery": "smallcrush", "gen": "pcg32",
                               "sede": 1})
    with pytest.raises(ValueError, match="unknown submission kind"):
        daemon.spec_from_dict({"kind": "x", "battery": "smallcrush",
                               "gen": "pcg32"})
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        json.dump([], f)
    with pytest.raises(SystemExit) as exc:
        daemon.main(["--submit", empty, "--device", "cpu"])
    assert exc.value.code == 2


def test_entry_points_default_to_cuda(tmp_path):
    """Without a card, ``SubmissionQueue()``, the daemon CLI and
    ``run_battery`` not told to use the CPU raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SubmissionQueue()
    subs = str(tmp_path / "subs.json")
    with open(subs, "w") as f:
        json.dump(SUBMISSIONS[:1], f)
    with pytest.raises(RuntimeError, match="cuda"):
        daemon.main(["--submit", subs])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(CLI_ARGS + ["--serve"])
    with pytest.raises(RuntimeError, match="cuda"):
        run_battery("smallcrush", "splitmix64", 7, scale=SCALE)


def test_run_battery_is_one_submitted_spec():
    res = run_battery("smallcrush", "splitmix64", 7, "cpu", scale=SCALE,
                      n_workers=2)
    want = PoolSession(n_workers=1, device="cpu").submit(RunSpec(
        "smallcrush", "splitmix64", seeds=(7,), scale=SCALE)).result()
    assert res.results == want.results
    assert res.verdict == want.verdict


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_daemon_thread_on_the_card_equals_the_inline_drain(cuda, tmp_path):
    """On the card, with the kernels: a batch driven by the daemon thread
    (the session's device set there, the caller's stream) equals the same
    batch drained inline, bit for bit."""
    def run(thread):
        queue = SubmissionQueue(PoolSession(device=cuda),
                                state_dir=str(tmp_path / f"s{thread}"))
        specs = [RunSpec("smallcrush", g, seeds=(7,), scale=0.0625,
                         backend="accelerated")
                 for g in ("splitmix64", "randu", "mwc")]
        try:
            if thread:
                queue.start()
            tickets = [queue.submit(s) for s in specs]
            if not thread:
                queue.drain()
            return [t.result(timeout=300).results for t in tickets]
        finally:
            queue.stop()
    assert run(True) == run(False)
