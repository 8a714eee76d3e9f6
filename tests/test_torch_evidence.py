"""PyTorch port: the e-value verdict engine (``repro_torch.core.evidence``,
``stitch.VERDICT_ENGINES``) and ``--verdict-engine evalue`` against the
JAX reference.

The engine is host arithmetic in float64, transcribed from
``repro.core.evidence`` (imported here in-process: it needs no 64-bit
mode), so the same p-values give bitwise the same e-values and verdicts.
The reference CLI runs in ``test_torch_reference.py``'s subprocess; there
each test's p is the reference's float32 evaluation, so the port's
log-wealth is held to ``log_wealth_tolerance``, the sum of its tests'
bounds, while verdicts, rounds and ``--json`` keys must be identical.
"""
import json

import numpy as np
import pytest

from repro.core import evidence as ref_ev
from test_cli_json import PER_GEN_KEYS, RUN_KEYS, TEST_KEYS
from test_torch_reference import (assert_stat_p, log_wealth_tolerance,
                                  p_tolerance, run_reference)

from repro_torch.core import evidence, stitch
from repro_torch.core.api import Checkpoint, PoolSession, RunSpec
from repro_torch.core.battery import build_battery
from repro_torch.launch import battery as cli

SCALE = 0.0625
CLI_ARGS = ["--battery", "smallcrush", "--gen", "splitmix64,randu",
            "--scale", str(SCALE), "--seed", "7", "--verdict-engine",
            "evalue"]
CLI_CASES = {"plain": [], "adaptive": ["--adaptive"]}
EVIDENCE_KEYS = {"engine", "threshold", "runs"}


@pytest.fixture(scope="module")
def ref_cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_evalue")
    tasks, paths = [], {}
    for case, extra in CLI_CASES.items():
        paths[case] = str(d / f"{case}.json")
        tasks.append({"kind": "cli",
                      "argv": CLI_ARGS + extra + ["--json", paths[case]]})
    results = run_reference(tasks, str(d / "out"))
    out = {}
    for (case, path), res in zip(paths.items(), results):
        with open(path) as f:
            out[case] = {"exit_code": res["exit_code"], "json": json.load(f)}
    return out


def _ps(rng, n):
    """p-values over the whole range, both tails and the clamps."""
    ps = rng.random(n)
    ps[:8] = [0.0, 1e-320, 1e-30, 1e-7, 0.5, 1 - 1e-7, 1 - 1e-9, 1.0]
    return ps


# -- the engine, against the reference's own functions


@pytest.mark.parametrize("fn", ["two_sided_p", "log_kappa_evalue",
                                "kappa_calibrator", "log_mixture_evalue",
                                "mixture_calibrator", "wealth_from_log"])
def test_calibrators_bitwise_equal_reference(fn):
    rng = np.random.default_rng(len(fn))
    args = (rng.normal(0, 300, 64) if fn == "wealth_from_log"
            else _ps(rng, 256))
    ours, theirs = getattr(evidence, fn), getattr(ref_ev, fn)
    for x in args:
        assert ours(float(x)) == theirs(float(x)), (fn, x)
    for kappa in (0.1, 0.5, 0.9):
        for x in args[8:40]:
            if fn in ("log_kappa_evalue", "kappa_calibrator"):
                assert ours(float(x), kappa) == theirs(float(x), kappa)


@pytest.mark.parametrize("band", [0.0, 0.05])
@pytest.mark.parametrize("calibrator", ["mixture", "kappa"])
def test_evidence_verdict_bitwise_equal_reference(calibrator, band):
    """Whole verdicts on random result sets (null, skewed toward 0,
    partial, with invalid p-values) equal the reference's, field by
    field, trajectory included."""
    rng = np.random.default_rng(11)
    for trial in range(40):
        n_total = int(rng.integers(1, 40))
        k = int(rng.integers(0, n_total + 1))
        ps = rng.random(k) ** (1 + 3 * (trial % 3))
        if k and trial % 5 == 0:
            ps[0] = np.nan
        results = {int(i): (float(rng.normal()), float(p))
                   for i, p in zip(rng.permutation(n_total)[:k], ps)}
        alpha = float(rng.choice([0.001, 0.01, 0.05]))
        got = evidence.evidence_verdict(results, n_total, alpha, calibrator,
                                        0.4, band)
        want = ref_ev.evidence_verdict(results, n_total, alpha, calibrator,
                                       0.4, band)
        assert dataclasses_equal(got, want), trial
        assert got.trajectory == want.trajectory
        assert got.borderline == want.borderline
        assert str(got) == str(want)


def dataclasses_equal(a, b):
    return all(getattr(a, f) == getattr(b, f)
               for f in ("decision", "alpha", "threshold", "n_checked",
                         "n_total", "failed_tests", "log_wealth", "band",
                         "log_evalues"))


def test_engine_registry_and_mismatch_type():
    assert stitch.verdict_for("bonferroni") is stitch.sequential_verdict
    assert stitch.verdict_for("evalue") is evidence.evidence_verdict
    assert sorted(stitch.VERDICT_ENGINES) == ["bonferroni", "evalue"]
    with pytest.raises(KeyError, match="known"):
        stitch.verdict_for("nope")
    with pytest.raises(KeyError):
        RunSpec("smallcrush", verdict_engine="nope")
    assert stitch.VerdictEngineMismatch is evidence.VerdictEngineMismatch
    assert issubclass(stitch.VerdictEngineMismatch, ValueError)
    assert (evidence.PASS, evidence.FAIL, evidence.UNDECIDED) == \
        (stitch.PASS, stitch.FAIL, stitch.UNDECIDED)


def test_log_wealth_tolerance_bounds_its_parts():
    """Any p-values within each test's ``p_tolerance`` of the reference's
    move the log-wealth by less than ``log_wealth_tolerance``."""
    rng = np.random.default_rng(2)
    params = {"d": 64}
    for _ in range(30):
        n = int(rng.integers(1, 12))
        stats = rng.uniform(3800, 4400, n)
        ps = _ps(rng, max(n, 8))[rng.permutation(max(n, 8))[:n]]
        parts = [("serial2d", params, float(s), float(p))
                 for s, p in zip(stats, ps)]
        tol = log_wealth_tolerance(parts)
        want = sum(evidence.log_evalue(evidence.two_sided_p(p))
                   for _, _, _, p in parts)
        for _ in range(10):
            moved = [float(np.clip(p + rng.uniform(-1, 1)
                                   * p_tolerance(k, prm, s, p), 0, 1))
                     for k, prm, s, p in parts]
            got = sum(evidence.log_evalue(evidence.two_sided_p(p))
                      for p in moved)
            assert abs(got - want) <= tol


# -- the engine in the battery, transcribed from the reference's tests


def test_evalue_battery_pass_and_wealth_history():
    session = PoolSession(device="cpu")
    spec = RunSpec("smallcrush", "splitmix64", 3, scale=SCALE,
                   verdict_engine="evalue")
    handle = session.submit(spec)
    res = handle.result()
    v = res.verdict
    assert isinstance(v, evidence.EvidenceVerdict)
    assert v.decision == "PASS"
    assert v.wealth < 1.0 / spec.alpha
    assert len(handle.wealth_history[0]) == res.rounds_run > 0
    assert handle.wealth_history[0][-1] == pytest.approx(v.wealth)


def test_evalue_adaptive_randu_stops_early():
    spec = RunSpec("smallcrush", "randu", 7, scale=SCALE, policy="adaptive",
                   stop_on_verdict=True, verdict_engine="evalue")
    res = PoolSession(device="cpu").submit(spec).result()
    assert res.verdict.decision == "FAIL"
    assert res.rounds_run < res.plan_rounds
    assert res.verdict.wealth >= 1.0 / spec.alpha


def test_evalue_checkpoint_v5_records_wealth(tmp_path):
    ck = str(tmp_path / "wealth.ck")
    session = PoolSession(device="cpu")
    spec = RunSpec("smallcrush", "splitmix64", 3, scale=SCALE,
                   checkpoint_path=ck, verdict_engine="evalue")
    res = session.submit(spec).result()
    saved = Checkpoint.load(ck)
    assert saved.version == 5 and saved.engine == "evalue"
    assert saved.log_wealth is not None and saved.log_wealth.shape == (1,)
    assert float(saved.log_wealth[0]) == pytest.approx(
        res.verdict.log_wealth)
    res2 = session.submit(spec).result()
    assert res2.rounds_run == 0
    assert res2.verdict.log_wealth == pytest.approx(res.verdict.log_wealth)


# -- the CLI, against the reference's


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_evalue_matches_reference(ref_cli, tmp_path, case):
    """``--verdict-engine evalue`` (plain and ``--adaptive``) on the
    port's CLI against the reference CLI: the same exit code, ``--json``
    keys, verdicts, rounds and checked tests; each p within
    ``assert_stat_p``; each generator's log-wealth within the sum of its
    tests' bounds, and its trajectory as long as the reference's."""
    path = str(tmp_path / "port.json")
    code = cli.main(CLI_ARGS + CLI_CASES[case] + ["--device", "cpu",
                                                  "--json", path])
    with open(path) as f:
        got = json.load(f)
    want = ref_cli[case]["json"]
    assert code == ref_cli[case]["exit_code"] == 1
    assert set(got) == set(want) == RUN_KEYS | {"evidence"}
    for key in RUN_KEYS - {"wall_s", "runs"}:
        assert got[key] == want[key], key
    assert set(got["evidence"]) == EVIDENCE_KEYS
    assert got["evidence"]["engine"] == want["evidence"]["engine"]
    assert got["evidence"]["threshold"] == want["evidence"]["threshold"]
    entries = {e.index: e for e in build_battery("smallcrush", SCALE,
                                                 device="cpu")}
    for gen, run in got["runs"].items():
        exp = want["runs"][gen]
        assert set(run) == PER_GEN_KEYS
        for key in PER_GEN_KEYS - {"tests"}:
            assert run[key] == exp[key], (gen, key)
        parts = []
        for t, te in zip(run["tests"], exp["tests"]):
            assert set(t) == TEST_KEYS
            assert (t["p"] is None) == (te["p"] is None)
            if te["p"] is None:
                continue
            e = entries[t["index"]]
            assert_stat_p(e.kname, dict(e.params), (te["stat"], te["p"]),
                          (t["stat"], t["p"]), f"{gen} {t['name']}")
            parts.append((e.kname, dict(e.params), te["stat"], te["p"]))
        ev, ev_want = got["evidence"]["runs"][gen], \
            want["evidence"]["runs"][gen]
        assert set(ev) == set(ev_want) == {"wealth", "log_wealth",
                                           "trajectory"}
        tol = log_wealth_tolerance(parts)
        assert abs(ev["log_wealth"] - ev_want["log_wealth"]) <= tol, \
            (gen, ev["log_wealth"], ev_want["log_wealth"], tol)
        assert len(ev["trajectory"]) == len(ev_want["trajectory"]) == \
            run["tests_checked"]
    assert got["runs"]["splitmix64"]["verdict"] == "PASS"
    assert got["runs"]["randu"]["verdict"] == "FAIL"
    if case == "adaptive":
        assert got["runs"]["randu"]["tests_checked"] < got["plan_rounds"]
