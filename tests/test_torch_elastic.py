"""PyTorch port, elastic pool width (DESIGN.md §6): ``PoolSession.resize``,
``BatteryRun._sync_width``, checkpoints that resume at another width and
the CLI's ``--resize-at``, transcribed from ``tests/test_elastic.py`` and
held against the JAX reference.

The reference runs in ``test_torch_reference.py``'s subprocess (task
``elastic``), given 8 host devices in that subprocess's environment
only; both packages take the same steps (``drive_runs``). Rows and job
tables after a replan, resizes, runner builds per width, counts and
rounds are compared bitwise, verdicts exactly, ``(stat, p)`` within
``p_tolerance``; inside the port, a resized run and a checkpoint resumed
at another width give the fixed-width run's ``(stat, p)`` bit for bit.
"""
import json
import os

import numpy as np
import pytest

from test_torch_reference import (ATOL, RTOL, drive_runs, p_tolerance,
                                  run_reference)

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import api, faults, policies
from repro_torch.core.api import Checkpoint, PoolSession, RunSpec
from repro_torch.core.battery import build_battery, max_words
from repro_torch.core.policies import OverDecomposePolicy
from repro_torch.core.pool import _job_fn, stream_table
from repro_torch.core.scheduler import replan
from repro_torch.launch import battery as cli

SCALE = 0.0625
SINGLE = {"battery": "smallcrush", "generators": ["splitmix64"],
          "seeds": [7], "scale": SCALE}
FANOUT = dict(SINGLE, generators=["splitmix64", "randu"])
OVERDEC = dict(SINGLE, policy={"over_decompose": {"threshold": 0.05,
                                                  "max_parts": 4}})
# the CLI's resize: SmallCrush x0.0625 of two generators at W=4 is 3
# rounds, so both resizes land while rounds are pending
CLI_ARGS = ["--battery", "smallcrush", "--gen", "splitmix64,randu",
            "--scale", "0.0625", "--seed", "7", "--workers", "4",
            "--policy", "lpt", "--resize-at", "1:2,2:4", "--backend",
            "reference"]
CLI_RESIZES = [{"round": 1, "workers": 2}, {"round": 2, "workers": 4}]


def bounce(spec):
    """One run with the pool bouncing 8 -> 3 -> 8 mid-battery."""
    return {"spec": spec, "workers": 8,
            "steps": [["poll", 1], ["resize", 3], ["poll", 1], ["grow", 5],
                      ["result"]]}


def fixed(spec):
    return {"spec": spec, "workers": 8, "steps": [["result"]]}


def elastic_runs(d):
    """The runs of ``tests/elastic_scenario.py``, with their checkpoint
    files under ``d``: fixed W=8 against 8 -> 3 -> 8 for one generator, a
    fan-out and an over-decomposed table; the same bounce and a fixed run
    with checkpoints (for their bytes); a W=8 run with a checkpoint, two
    jobs knocked out of the file and resumed at W=4; its v2 form, less two
    more jobs, resumed at W=4. The runs share one session, so each
    (width, table, generator count) builds its runner once."""
    ck = os.path.join(d, "w8.ck")
    ck2 = os.path.join(d, "v2.ck")
    return [
        fixed(SINGLE), bounce(SINGLE), fixed(FANOUT), bounce(FANOUT),
        fixed(OVERDEC), bounce(OVERDEC),
        fixed(dict(SINGLE, checkpoint_path=os.path.join(d, "f.ck"))),
        bounce(dict(SINGLE, checkpoint_path=os.path.join(d, "b.ck"))),
        {"spec": dict(SINGLE, checkpoint_path=ck),
         "steps": [["result"], ["copy", ck + ".full"], ["drop", [2, 8]],
                   ["copy", ck + ".dropped"]]},
        {"spec": dict(SINGLE, checkpoint_path=ck), "width": 4, "steps": [["result"], ["v2", ck2, [1, 4]],
                               ["copy", ck + ".resumed"]]},
        {"spec": dict(SINGLE, checkpoint_path=ck2), "steps": [["result"]]},
    ]


RUN_NAMES = ["fixed1", "bounce1", "fixed2", "bounce2", "fixed_od",
             "bounce_od", "fixed_ck", "bounce_ck", "ck8", "ck4", "v2"]


def _port_runs(runs):
    return dict(zip(RUN_NAMES, drive_runs(runs, api, faults, policies,
                                          ckpt_io, device="cpu")))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's runs (one subprocess, 8 host devices) and the
    port's, on the CPU."""
    d = tmp_path_factory.mktemp("elastic")
    rd, pd = str(d / "ref"), str(d / "port")
    os.makedirs(rd)
    os.makedirs(pd)
    cli_json = str(d / "ref_cli.json")
    ck = os.path.join(rd, "w8.ck")
    task, cli_res = run_reference(
        [{"kind": "elastic", "runs": elastic_runs(rd),
          "load": [ck + ".full", ck + ".dropped", ck + ".resumed",
                   os.path.join(rd, "v2.ck")]},
         {"kind": "cli", "argv": CLI_ARGS + ["--json", cli_json]}],
        str(d / "out"), devices=8)
    with open(cli_json) as f:
        cli_res["json"] = json.load(f)
    ref = dict(zip(RUN_NAMES, task["runs"]))
    return {"ref": ref, "loads": task["loads"], "cli": cli_res,
            "port": _port_runs(elastic_runs(pd)), "rd": rd, "pd": pd}


def jobs_of(spec):
    """The port's job table of a run's spec (what job ids index)."""
    kw = dict(spec)
    if isinstance(kw.get("policy"), dict):
        kw["policy"] = OverDecomposePolicy(**kw["policy"]["over_decompose"])
    kw.pop("checkpoint_path", None)
    spec = RunSpec(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in kw.items()})
    return PoolSession(device="cpu")._compiled(spec).jobs


def assert_job_results(ref, got, jobs, what):
    """Job-space (stat, p) per generator: the same job ids, stat within
    the contract, p within ``p_tolerance`` of the job's family."""
    assert len(ref) == len(got), what
    for g, (rr, gg) in enumerate(zip(ref, got)):
        assert set(rr) == set(gg), f"{what} gen {g}: other jobs"
        for k, (s_ref, p_ref) in rr.items():
            s_got, p_got = gg[k]
            e = jobs[int(k)]
            np.testing.assert_allclose(s_got, s_ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} job {k} stat")
            tol = p_tolerance(e.kname, dict(e.params), s_ref, p_ref)
            assert abs(p_got - p_ref) <= tol, (what, k, p_got, p_ref, tol)


# -------------------------------------------------- empty-residual guards

def test_replan_of_nothing_returns_empty_plan():
    """All jobs done and a resize-triggered replan must complete."""
    plan = replan([], [1.0] * 10, 4)
    assert plan.rounds == 0
    assert plan.assignment.shape == (0, 4)
    assert plan.est_makespan == 0.0
    entries = build_battery("smallcrush", 0.125, device="cpu")
    for mode in ("roundrobin", "lpt", "adaptive", "over_decompose"):
        sub = replan([], [e.cost for e in entries], 3, mode,
                     entries=entries)
        assert sub.rounds == 0 and sub.assignment.shape == (0, 3)


def test_empty_residual_tables_do_not_raise():
    assert stream_table([]).shape == (0,)
    assert max_words([]) == 0
    assert OverDecomposePolicy().decompose([], 8) is None


# ------------------------------------------------------- resize validation

def test_resize_validates_width():
    """Width 0 is refused. A width above the visible devices is not
    (the reference's ``RuntimeError``): the port's slots share one
    device. The session stays usable."""
    session = PoolSession(n_workers=2, device="cpu")
    assert session.resize(session.n_workers) == 2            # no-op
    with pytest.raises(ValueError):
        session.resize(0)
    assert session.n_workers == 2
    assert session.resize(2 + 7) == 9
    res = session.submit(RunSpec("smallcrush", "splitmix64", 3,
                                 scale=SCALE)).result()
    assert res.rounds_run == 2                  # 10 jobs on 9 slots


def test_grow_shrink_sugar():
    session = PoolSession(n_workers=3, device="cpu")
    with pytest.raises(ValueError):
        session.shrink(3)                       # to zero
    assert session.n_workers == 3
    assert session.grow(2) == 5 and session.shrink() == 4


def test_resize_back_builds_nothing():
    """total_traces counts one runner build per new width and none on a
    return to a width already built."""
    session = PoolSession(n_workers=4, device="cpu")
    spec = RunSpec("smallcrush", "splitmix64", 7, scale=SCALE)
    session.submit(spec).result()
    assert session.total_traces == 1
    for w, want in ((2, 2), (4, 2), (2, 2), (5, 3)):
        session.resize(w)
        session.submit(spec).result()
        assert session.total_traces == want, w


# ----------------------------------------------------- idle-slot gating

def test_idle_slot_generation_is_gated(monkeypatch):
    """An idle slot (job -1) generates nothing: it returns (0, nan)
    without calling the generator; a real job is untouched."""
    from repro_torch.core import pool
    entries = build_battery("smallcrush", SCALE, device="cpu")
    calls = []
    real = pool.switch_block
    monkeypatch.setattr(pool, "switch_block",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    job = _job_fn(entries, "cpu")
    stat, p = job(-1, 0, 0).tolist()
    assert stat == 0.0 and np.isnan(p) and calls == []
    stat0, p0 = job(0, 7, 0).tolist()
    assert len(calls) == 1
    assert np.isfinite(stat0) and 0.0 <= p0 <= 1.0


# --------------------------------------------------- checkpoint layouts

def _toy_ckpt():
    idx = np.arange(4, dtype=np.int32)
    st = np.arange(4, dtype=np.float64)[None, :] + 1.0
    pv = np.full((1, 4), 0.5)
    return idx, st, pv


def test_checkpoint_v5_roundtrip_and_drop(tmp_path):
    path = str(tmp_path / "v5.ck")
    idx, st, pv = _toy_ckpt()
    Checkpoint(idx, st, pv, np.array([1], np.int8), rounds_run=3,
               alpha=0.05).save(path)
    ck = Checkpoint.load(path)
    assert ck.version == 5 and ck.rounds_run == 3 and ck.alpha == 0.05
    assert ck.engine == "bonferroni" and ck.log_wealth is None
    assert ck.n_generators == 1
    np.testing.assert_array_equal(ck.job_idx, idx)
    np.testing.assert_array_equal(ck.stats, st)
    assert list(ck.decisions) == [1]
    assert ck.results() == [{i: (float(st[0, i]), 0.5) for i in range(4)}]
    dropped = ck.drop([1, 2])
    assert list(dropped.job_idx) == [0, 3]
    assert dropped.stats.shape == (1, 2)
    assert dropped.decisions is None


def test_checkpoint_v1_v2_load_and_upgrade(tmp_path):
    idx, st, pv = _toy_ckpt()
    p1 = str(tmp_path / "v1.ck")
    ckpt_io.save(p1, [idx, st[0], pv[0]])
    c1 = Checkpoint.load(p1)
    assert c1.version == 1 and c1.decisions is None
    assert c1.stats.shape == (1, 4)
    p2 = str(tmp_path / "v2.ck")
    ckpt_io.save(p2, [idx, st, pv, np.array([2], np.int8), np.int64(5)])
    c2 = Checkpoint.load(p2)
    assert c2.version == 2 and c2.rounds_run == 5
    assert c2.alpha is None
    assert list(c2.decisions) == [2]
    c2.save(p2)
    assert Checkpoint.load(p2).version == 5
    assert len(ckpt_io.load_flat(p2)) == 10


def test_non_adaptive_resume_ignores_alpha_change(tmp_path):
    ck = str(tmp_path / "alpha.ck")
    session = PoolSession(n_workers=4, device="cpu")
    res1 = session.submit(RunSpec("smallcrush", "splitmix64", 3,
                                  scale=0.125,
                                  checkpoint_path=ck)).result()
    session.resize(2)
    res2 = session.submit(RunSpec("smallcrush", "splitmix64", 3,
                                  scale=0.125, checkpoint_path=ck,
                                  alpha=0.9)).result()
    assert res2.rounds_run == 0
    assert res2.results == res1.results


def test_adaptive_resume_of_plain_checkpoint_any_alpha(tmp_path):
    ck = str(tmp_path / "plain.ck")
    session = PoolSession(n_workers=4, device="cpu")
    res1 = session.submit(RunSpec("smallcrush", "splitmix64", 3,
                                  scale=0.125,
                                  checkpoint_path=ck)).result()
    session.resize(3)
    res2 = session.submit(RunSpec("smallcrush", "splitmix64", 3,
                                  scale=0.125, checkpoint_path=ck,
                                  stop_on_verdict=True,
                                  alpha=0.9)).result()
    assert res2.rounds_run == 0
    assert res2.results == res1.results
    assert res2.verdict.decided


def test_checkpoint_rejects_unknown_layouts(tmp_path):
    idx, st, pv = _toy_ckpt()
    bad_ver = str(tmp_path / "bad_ver.ck")
    ckpt_io.save(bad_ver, [np.int64(9), idx, st, pv,
                           np.zeros(0, np.int8), np.int64(0),
                           np.float64(0.01)])
    with pytest.raises(ValueError, match="version"):
        Checkpoint.load(bad_ver)
    bad_len = str(tmp_path / "bad_len.ck")
    ckpt_io.save(bad_len, [idx, st])
    with pytest.raises(ValueError, match="leaves"):
        Checkpoint.load(bad_len)


# ------------------------------------ multi-width, against the reference

@pytest.mark.parametrize("fix,bnc,spec", [("fixed1", "bounce1", SINGLE),
                                          ("fixed2", "bounce2", FANOUT),
                                          ("fixed_od", "bounce_od",
                                           OVERDEC)],
                         ids=["single", "fanout", "over_decompose"])
def test_resize_bitwise(both, fix, bnc, spec):
    """8 -> 3 -> 8 mid-battery: the port's stitched (stat, p) bitwise its
    fixed-width run's, job and test space; the reference's likewise;
    port against reference within tolerance, the same verdicts."""
    port, ref = both["port"], both["ref"]
    assert port[bnc]["job_results"] == port[fix]["job_results"]
    assert port[bnc]["results"] == port[fix]["results"]
    assert ref[bnc]["results"] == ref[fix]["results"]
    assert port[bnc]["verdicts"] == ref[bnc]["verdicts"] \
        == port[fix]["verdicts"]
    assert_job_results(ref[bnc]["job_results"], port[bnc]["job_results"],
                       jobs_of(spec), bnc)


@pytest.mark.parametrize("name", ["bounce1", "bounce2", "bounce_od"])
def test_replanned_rows_bitwise(both, name):
    """The rows each poll dispatched and the job table after each resize
    (the residual jobs replanned onto the new width) equal the
    reference's."""
    port, ref = both["port"][name], both["ref"][name]
    assert port["rows"] == ref["rows"]
    assert port["queues"] == ref["queues"]
    assert [len(r) for r in port["rows"]] == [8, 3]
    for key in ("rounds_run", "plan_rounds", "retries", "jobs_total"):
        assert port[key] == ref[key], key


def test_resize_builds_only_the_new_width(both):
    """8 -> 3 -> 8 after a fixed W=8 run on the same session: one runner
    built at 3, and growing back to 8 builds nothing; the reference's
    builds per width are the same."""
    assert both["port"]["bounce1"]["traces"] == [[3, 1], [8, 1]]
    for fix, bnc in (("fixed1", "bounce1"), ("fixed2", "bounce2"),
                     ("fixed_od", "bounce_od")):
        for side in ("port", "ref"):
            added = (sum(n for _, n in both[side][bnc]["traces"])
                     - sum(n for _, n in both[side][fix]["traces"]))
            assert added == 1, (side, bnc)
        assert both["port"][bnc]["traces"] == both["ref"][bnc]["traces"]


def test_w8_checkpoint_resumes_on_w4(both):
    """A checkpoint saved at W=8 with two jobs knocked out resumes at
    W=4: only the two run (one round), the results reconcile bitwise
    with the W=8 run's, and the file is v5, in both packages."""
    for side in ("port", "ref"):
        ck8, ck4 = both[side]["ck8"], both[side]["ck4"]
        assert ck4["jobs_total"] - ck4["jobs_done_at_submit"] == 2
        assert ck4["rounds_run"] == 1
        assert ck4["rows"] == [] and ck4["workers"] == 4
        assert ck4["results"] == ck8["results"], side
    assert both["port"]["ck4"]["verdicts"] == both["ref"]["ck4"]["verdicts"]
    assert_job_results(both["ref"]["ck4"]["job_results"],
                       both["port"]["ck4"]["job_results"], jobs_of(SINGLE),
                       "ck4")
    assert int(ckpt_io.load_flat(
        os.path.join(both["pd"], "w8.ck.resumed"))[0]) == 5
    assert both["loads"][2]["version"] == 5


def test_v2_checkpoint_upgrades_across_widths(both):
    for side in ("port", "ref"):
        assert both[side]["v2"]["results"] == both[side]["ck8"]["results"]
        assert both[side]["v2"]["rounds_run"] == 1
    assert len(ckpt_io.load_flat(os.path.join(both["pd"], "v2.ck"))) == 10
    assert both["loads"][3]["version"] == 5


def test_checkpoint_bytes_after_resize(both, tmp_path):
    """Checkpoint bytes: the port's file after an 8 -> 3 -> 8 run is
    bitwise its fixed-width run's; and each reference file (W=8, less two
    jobs, resumed at W=4, the upgraded v2) loaded and saved again by the
    port is the reference's file byte for byte, with the reference's job
    ids, decisions and rounds."""
    pd, rd = both["pd"], both["rd"]
    with open(os.path.join(pd, "b.ck"), "rb") as f:
        bounced = f.read()
    with open(os.path.join(pd, "f.ck"), "rb") as f:
        assert f.read() == bounced
    names = ["w8.ck.full", "w8.ck.dropped", "w8.ck.resumed", "v2.ck"]
    for name, want in zip(names, both["loads"]):
        src = os.path.join(rd, name)
        ck = Checkpoint.load(src)
        assert ck.job_idx.tolist() == want["job_idx"].tolist(), name
        assert ck.rounds_run == want["rounds_run"], name
        assert (None if ck.decisions is None
                else ck.decisions.tolist()) == want["decisions"], name
        np.testing.assert_array_equal(ck.ps, want["ps"])
        out = str(tmp_path / name)
        ck.save(out)
        with open(src, "rb") as f, open(out, "rb") as g:
            assert f.read() == g.read(), name


def test_port_resumes_the_reference_w8_checkpoint_at_w4(both, tmp_path):
    """The reference's W=8 file, less two jobs, resumed by the port at
    W=4: the port runs only those two jobs, in one round."""
    path = str(tmp_path / "ref_dropped.ck")
    with open(os.path.join(both["rd"], "w8.ck.dropped"), "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(data)
    handle = PoolSession(n_workers=4, device="cpu").submit(RunSpec(
        "smallcrush", "splitmix64", 7, scale=SCALE, checkpoint_path=path))
    assert handle.status()["jobs_done"] == 8
    res = handle.result()
    assert res.rounds_run == 1
    ref = both["ref"]["ck8"]["results"]["splitmix64"]
    assert {k: list(v) for k, v in res.results.items()
            if k not in (2, 8)} == {int(k): v for k, v in ref.items()
                                    if int(k) not in (2, 8)}


def test_cli_resize_at_matches_the_reference(both, tmp_path, capsys):
    """``--resize-at 1:2,2:4``: the same ``resizes`` list, launch width,
    rounds, retries, exit code, JSON keys and verdicts as the reference's
    CLI; (stat, p) within tolerance; and bitwise the port's fixed-width
    run."""
    ref = both["cli"]["json"]
    path = str(tmp_path / "port.json")
    code = cli.main(CLI_ARGS + ["--device", "cpu", "--json", path])
    with open(path) as f:
        got = json.load(f)
    assert code == both["cli"]["exit_code"]
    assert got["resizes"] == ref["resizes"] == CLI_RESIZES
    assert set(got) == set(ref)
    for key in ("workers", "rounds_run", "retries", "plan_rounds"):
        assert got[key] == ref[key], key
    entries = build_battery("smallcrush", SCALE, device="cpu")
    for gen, run in got["runs"].items():
        want = ref["runs"][gen]
        for key in ("verdict", "tests_checked", "failed_tests"):
            assert run[key] == want[key], (gen, key)
        for t, w in zip(run["tests"], want["tests"]):
            e = entries[t["index"]]
            np.testing.assert_allclose(t["stat"], w["stat"], rtol=RTOL,
                                       atol=ATOL)
            assert abs(t["p"] - w["p"]) <= p_tolerance(
                e.kname, dict(e.params), w["stat"], w["p"]), t["name"]
    fixed_path = str(tmp_path / "fixed.json")
    args = [a for a in CLI_ARGS if a not in ("--resize-at", "1:2,2:4")]
    assert cli.main(args + ["--device", "cpu", "--json", fixed_path]) == code
    with open(fixed_path) as f:
        fixed_rep = json.load(f)
    assert fixed_rep["resizes"] == []
    for gen, run in got["runs"].items():
        assert run["tests"] == fixed_rep["runs"][gen]["tests"]
    capsys.readouterr()


def test_cli_resize_at_argument_errors(capsys):
    """Malformed ``--resize-at`` values, widths below 1 and a campaign
    with ``--resize-at`` are usage errors (exit 2), as in the reference."""
    for bad in (["--resize-at", "2"], ["--resize-at", "a:b"],
                ["--resize-at", "2:0"],
                ["--campaign", "--resize-at", "1:2"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(["--battery", "smallcrush", "--scale", "0.0625",
                      "--device", "cpu"] + bad)
        assert exc.value.code == 2, bad
    capsys.readouterr()
