"""PyTorch port, the slice as a whole: job tables, policies, the pool's
rounds and the battery CLI against the JAX reference (which runs in
``test_torch_reference.py``'s subprocess), plus the port's import
hygiene and device rules.

Integer data (tables, bucket and stream ids, plans) is compared
bitwise; ``(stat, p)`` within the reference's tolerance
(``test_torch_reference.assert_stat_p``); verdicts must be identical.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from test_cli_json import PER_GEN_KEYS, RUN_KEYS, TEST_KEYS
from test_torch_reference import (REPO, assert_stat_p, combined_tolerance,
                                  p_tolerance, run_reference)

from repro_torch.core import pool, stitch
from repro_torch.core.api import PoolSession, RunSpec
from repro_torch.core.battery import (build_battery, entries_from_reference,
                                      split_entry)
from repro_torch.core.policies import get_policy
from repro_torch.core.scheduler import make_plan, replan
from repro_torch.launch import battery as cli
from repro_torch.launch.mesh import make_pool_mesh
from repro_torch.rng.sources import get_generator

TABLE_SPECS = [("smallcrush", 1.0), ("smallcrush", 0.0625), ("crush", 1.0),
               ("crush", 0.0625), ("bigcrush", 1.0), ("bigcrush", 0.0625),
               ("pairstream", 1.0)]
POOL = {"battery": "smallcrush", "scale": 0.0625,
        "generators": ["pcg32", "xorshift64s", "mwc"], "seeds": [3],
        "policy": "over_decompose", "backend": "reference"}
CLI_ARGS = ["--battery", "smallcrush", "--gen", "splitmix64,randu",
            "--scale", "0.0625", "--seed", "7", "--adaptive"]
# over-decomposed CLI runs (``--policy over_decompose``) at x0.0625, each
# with the family it must split and the verdicts: smallcrush splits
# coupon_d8_n4096 into two Stouffer-combined parts (under 60 s here);
# bigcrush splits the serial2d_*_n8192 tests, whose parts' p-values carry
# the reference's float32 gamma rounding (about 2 min here, most of it the
# reference's run)
SPLIT_CASES = {"smallcrush": ("coupon", {"splitmix64": "PASS",
                                         "randu": "FAIL"}),
               "bigcrush": ("serial2d", {"splitmix64": "FAIL",
                                         "randu": "FAIL"})}
SPLIT_GENS = ["splitmix64", "randu"]


def _split_args(battery):
    return ["--battery", battery, "--gen", ",".join(SPLIT_GENS), "--scale",
            "0.0625", "--seed", "7", "--policy", "over_decompose"]


GOLDEN = os.path.join(REPO, "src", "repro_torch", "golden",
                      "smallcrush_splitmix64_randu_s7_x0.0625_adaptive.json")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref_battery")
    cli_json = str(d / "cli.json")
    tables, pool_res, cli_res = run_reference(
        [{"kind": "tables", "specs": TABLE_SPECS},
         {"kind": "pool", **POOL},
         {"kind": "cli", "argv": CLI_ARGS + ["--json", cli_json]}],
        str(d / "out"))
    with open(cli_json) as f:
        cli_res["json"] = json.load(f)
    return {"tables": tables, "pool": pool_res, "cli": cli_res}


def _row(e):
    return [e.index, e.name, e.kname, [list(kv) for kv in e.params],
            e.n_words, e.cost, e.group, e.part, e.n_parts, e.backend]


@pytest.mark.parametrize("spec", range(len(TABLE_SPECS)))
def test_job_tables_bitwise(ref, spec):
    """build_battery, the over_decompose table, split_entry, bucket and
    stream tables and every policy's plan equal the reference's."""
    battery, scale = TABLE_SPECS[spec]
    want = ref["tables"][spec]
    entries = build_battery(battery, scale, device="cpu")
    assert [_row(e) for e in entries] == want["entries"]
    jobs = get_policy("over_decompose").decompose(entries) or entries
    assert [_row(j) for j in jobs] == want["over_decompose"]
    assert [[_row(s) for s in split_entry(e, parts, 100)]
            for e in entries for parts in (2, 3, 8)] == want["splits"]
    sizes, bids = pool.bucket_table(entries)
    assert sizes == want["bucket_sizes"]
    assert bids.tolist() == want["bucket_ids"]
    assert pool.stream_table(jobs).tolist() == want["stream_table"]
    assert pool.block_ratio(entries) == want["block_ratio"]
    for key, assignment in want["plans"].items():
        mode, w = key.split("/")
        plan = make_plan([e.cost for e in entries], int(w), mode,
                         entries=entries)
        assert plan.assignment.tolist() == assignment, key


def _spec(**kw):
    return RunSpec(POOL["battery"], tuple(POOL["generators"]),
                   seeds=tuple(POOL["seeds"]), scale=POOL["scale"],
                   policy=POOL["policy"], backend=POOL["backend"], **kw)


def _by_index(entries):
    return {e.index: e for e in entries}


def test_pool_rounds_match_reference(ref):
    """A three-generator, over-decomposed smallcrush through the port's
    PoolSession on the CPU: the same job table, the same (stat, p) for
    every job of every generator, the same verdicts."""
    want = ref["pool"]
    session = PoolSession(device="cpu")
    handle = session.submit(_spec())
    res = handle.result()
    jobs = handle._compiled.jobs
    assert [_row(j) for j in jobs] == want["jobs"]
    assert res.rounds_run == want["rounds_run"]
    for g, gen in enumerate(POOL["generators"]):
        got, exp = handle._results[g], want["job_results"][g]
        assert sorted(got) == sorted(int(k) for k in exp)
        for k, (s, p) in exp.items():
            j = jobs[int(k)]
            assert_stat_p(j.kname, dict(j.params), (s, p), got[int(k)],
                          f"{gen} job {k}")
        assert res.runs[gen].verdict.decision == want["verdicts"][gen]
    assert session.total_traces == 1


def test_reference_table_carried_across(ref):
    """The reference's job table, rebuilt in the port with
    entries_from_reference, scores the same words to the same
    (stat, p)."""
    want = ref["pool"]
    rows = [r[:9] for r in want["jobs"]]
    entries = entries_from_reference(rows, backend="accelerated")
    assert [_row(e)[:9] for e in entries] == rows
    runner = pool.make_fanout_runner(entries, make_pool_mesh(4, "cpu"))
    gen_ids = [get_generator(g).gen_id for g in POOL["generators"]]
    ids = list(range(len(entries)))
    ids += [-1] * (-len(ids) % 4)
    for r0 in range(0, len(ids), 4):
        row = np.asarray(ids[r0:r0 + 4], np.int32)
        stats, ps = runner(row, [3, 3, 3], gen_ids)
        for g in range(3):
            for w, j in enumerate(row):
                if j < 0:
                    assert stats[g, w] == 0 and np.isnan(ps[g, w])
                    continue
                e = entries[j]
                assert_stat_p(e.kname, dict(e.params),
                              want["job_results"][g][str(j)],
                              (stats[g, w], ps[g, w]), f"gen {g} job {j}")


def test_battery_cli_matches_reference(ref, tmp_path):
    """The slice end to end: the port's CLI (on the CPU) against the
    reference CLI, same flags. Same --json keys, verdicts, rounds and
    checked tests; every per-test p within tolerance; same exit code."""
    path = str(tmp_path / "port.json")
    code = cli.main(CLI_ARGS + ["--device", "cpu", "--json", path])
    with open(path) as f:
        got = json.load(f)
    want = ref["cli"]["json"]
    assert code == ref["cli"]["exit_code"] == 1
    assert set(got) == RUN_KEYS == set(want)
    entries = _by_index(build_battery("smallcrush", 0.0625, device="cpu"))
    for key in RUN_KEYS - {"wall_s", "runs"}:
        assert got[key] == want[key], key
    assert got["runs"].keys() == want["runs"].keys()
    for gen, run in got["runs"].items():
        exp = want["runs"][gen]
        assert set(run) == PER_GEN_KEYS
        for key in PER_GEN_KEYS - {"tests"}:
            assert run[key] == exp[key], (gen, key)
        for t, te in zip(run["tests"], exp["tests"]):
            assert set(t) == TEST_KEYS
            assert (t["index"], t["name"], t["suspect"]) == \
                   (te["index"], te["name"], te["suspect"])
            assert (t["p"] is None) == (te["p"] is None)
            if te["p"] is not None:
                e = entries[t["index"]]
                assert_stat_p(e.kname, dict(e.params), (te["stat"], te["p"]),
                              (t["stat"], t["p"]), f"{gen} {t['name']}")
    assert got["runs"]["splitmix64"]["verdict"] == "PASS"
    assert got["runs"]["randu"]["verdict"] == "FAIL"


def _ref_split(tmp_path_factory, battery):
    """The reference's over-decomposed CLI run of ``battery`` and, from a
    pool run of the same spec, its per-part (job) results."""
    d = tmp_path_factory.mktemp(f"ref_split_{battery}")
    cli_json = str(d / "cli.json")
    pool_res, cli_res = run_reference(
        [{"kind": "pool", "battery": battery, "scale": 0.0625,
          "generators": SPLIT_GENS, "seeds": [7], "policy": "over_decompose",
          "backend": "auto"},
         {"kind": "cli", "argv": _split_args(battery) + ["--json", cli_json]}],
        str(d / "out"))
    with open(cli_json) as f:
        cli_res["json"] = json.load(f)
    return {"battery": battery, "pool": pool_res, "cli": cli_res}


@pytest.fixture(scope="module")
def ref_split(tmp_path_factory):
    return _ref_split(tmp_path_factory, "smallcrush")


@pytest.fixture(scope="module")
def ref_split_bigcrush(tmp_path_factory):
    return _ref_split(tmp_path_factory, "bigcrush")


def _check_over_decomposed(ref_split, tmp_path):
    """The port's CLI under ``--policy over_decompose`` against the
    reference CLI: same verdicts, rounds, checked tests and exit code;
    every unsplit test's (stat, p) within ``assert_stat_p``, and every
    combined (stat, p) of a split test within ``combined_tolerance`` of
    its parts (the reference's part results, Stouffer)."""
    battery = ref_split["battery"]
    family, verdicts = SPLIT_CASES[battery]
    want = ref_split["cli"]["json"]
    pool_res = ref_split["pool"]
    path = str(tmp_path / "port.json")
    code = cli.main(_split_args(battery) + ["--device", "cpu", "--json",
                                            path])
    with open(path) as f:
        got = json.load(f)
    assert code == ref_split["cli"]["exit_code"]
    for key in RUN_KEYS - {"wall_s", "runs"}:
        assert got[key] == want[key], key
    jobs = [dict(zip(("index", "name", "kname", "params", "n_words", "cost",
                      "group", "part", "n_parts"), row[:9]))
            for row in pool_res["jobs"]]
    split = {j["group"] for j in jobs if j["n_parts"] > 1}
    assert any(j["kname"] == family for j in jobs if j["n_parts"] > 1), \
        f"over_decompose split no {family} test"
    entries = _by_index(build_battery(battery, 0.0625, device="cpu"))
    n_combined = 0
    for g, gen in enumerate(SPLIT_GENS):
        run, exp = got["runs"][gen], want["runs"][gen]
        assert pool_res["verdicts"][gen] == exp["verdict"]
        for key in PER_GEN_KEYS - {"tests"}:
            assert run[key] == exp[key], (gen, key)
        for t, te in zip(run["tests"], exp["tests"]):
            assert (t["index"], t["name"], t["suspect"]) == \
                   (te["index"], te["name"], te["suspect"])
            assert (t["p"] is None) == (te["p"] is None)
            if te["p"] is None:
                continue
            if t["index"] not in split:
                e = entries[t["index"]]
                assert_stat_p(e.kname, dict(e.params), (te["stat"], te["p"]),
                              (t["stat"], t["p"]), f"{gen} {t['name']}")
                continue
            parts = [(j["kname"], dict(map(tuple, j["params"])),
                      *pool_res["job_results"][g][str(j["index"])])
                     for j in jobs if j["group"] == t["index"]]
            assert len(parts) > 1
            # the pool run's parts fold to the reference CLI's value
            ref_stat, ref_p = stitch.combine_stouffer([p for *_, p in parts])
            assert (ref_stat, ref_p) == pytest.approx((te["stat"], te["p"]),
                                                      rel=1e-12, abs=1e-15)
            stat_tol, p_tol = combined_tolerance(stitch.combine_stouffer,
                                                 parts)
            assert abs(t["stat"] - te["stat"]) <= stat_tol, (gen, t, te)
            assert abs(t["p"] - te["p"]) <= p_tol, (gen, t, te)
            n_combined += 1
    assert n_combined >= len(SPLIT_GENS)
    assert {gen: got["runs"][gen]["verdict"] for gen in SPLIT_GENS} == verdicts


def test_over_decomposed_cli_matches_reference(ref_split, tmp_path):
    """smallcrush x0.0625, which splits coupon_d8_n4096: see
    ``_check_over_decomposed``."""
    _check_over_decomposed(ref_split, tmp_path)


def test_over_decomposed_bigcrush_matches_reference(ref_split_bigcrush,
                                                    tmp_path):
    """bigcrush x0.0625, which splits the serial2d_*_n8192 tests (4095
    degrees of freedom at d=64, the widest gamma tolerance): every
    Stouffer-combined serial2d (stat, p) within ``combined_tolerance``
    (``_check_over_decomposed``)."""
    _check_over_decomposed(ref_split_bigcrush, tmp_path)


@pytest.mark.parametrize("combine", ["stouffer", "fisher"])
def test_combined_tolerance_bounds_its_parts(combine):
    """``combined_tolerance`` holds every combination of parts that each
    lie within their own p tolerance, at serial2d d=64 (4095 degrees of
    freedom, the widest gamma tolerance) and at coupon. At serial2d it
    is wider than the bare contract (rtol 1e-5): the widening the
    over-decomposed parity case needs comes from the parts."""
    fn = stitch.COMBINERS[combine]
    rng = np.random.default_rng(11)
    for kname, params, dof in (("serial2d", {"n": 8192, "d": 64}, 4095),
                               ("coupon", {"n": 4096, "d": 8}, 29)):
        for n_parts in (2, 4):
            parts = [(kname, params, float(x), float(chi2.sf(x, dof)))
                     for x in rng.chisquare(dof, n_parts)]
            ps = np.array([p for *_, p in parts])
            tol = np.array([p_tolerance(*part) for part in parts])
            s0, p0 = fn(ps)
            stat_tol, p_tol = combined_tolerance(fn, parts)
            for _ in range(200):
                s, p = fn(np.clip(ps + rng.uniform(-1, 1, n_parts) * tol,
                                  0.0, 1.0))
                assert abs(s - s0) <= stat_tol and abs(p - p0) <= p_tol
            if kname == "serial2d":
                assert stat_tol > 1e-3 * abs(s0) and p_tol > 1e-4


def test_golden_is_the_reference_cli_output(ref):
    """src/repro_torch/golden holds the reference CLI's --json for the
    smallcrush acceptance run, so the card can check the port without
    jax. It must equal a fresh reference run (all but wall time).
    Regenerate by running ``python tests/test_torch_reference.py`` on a
    tasks file with this test's "cli" task and ``--json`` at GOLDEN."""
    with open(GOLDEN) as f:
        golden = json.load(f)
    want = dict(ref["cli"]["json"])
    golden.pop("wall_s")
    want.pop("wall_s")
    assert golden == want


def test_unported_flags_are_refused():
    """The serving flags (ported: ``tests/test_torch_serve.py``) are
    refused where the reference refuses them, never ignored: a
    serve-only flag without ``--serve``, and ``--serve`` with
    ``--campaign``, ``--resize-at``, ``--ckpt`` or ``--inject``."""
    for argv in (["--serve-state", "d"], ["--serve-resubmit"],
                 ["--serve-max-wait", "1"],
                 ["--serve-state", "d", "--serve-resubmit",
                  "--serve-max-wait", "1"],
                 ["--serve", "--campaign"], ["--serve", "--resize-at", "2:4"],
                 ["--serve", "--ckpt", "x.ck"],
                 ["--serve", "--inject", "plan.json"],
                 ["--serve", "--serve-state", "d", "--serve-max-wait", "1",
                  "--serve-resubmit", "--ckpt", "x.ck"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--device", "cpu"])
        assert exc.value.code == 2, argv


def test_entry_points_default_to_cuda():
    """Without a card, an entry point not told to use the CPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        PoolSession()
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--battery", "smallcrush", "--scale", "0.0625"])


def test_runspec_and_session_surface():
    spec = RunSpec("smallcrush", "randu", seeds=5, scale=0.0625,
                   policy="adaptive", stop_on_verdict=True)
    assert spec.generators == ("randu",) and spec.seeds == (5,)
    with pytest.raises(KeyError):
        RunSpec("tinycrush")
    with pytest.raises(KeyError):
        RunSpec("smallcrush", "nope")
    with pytest.raises(ValueError):
        RunSpec("smallcrush", ("pcg32", "randu"), seeds=(1, 2, 3))
    session = PoolSession(n_workers=3, device="cpu")
    handle = session.submit(spec)
    first = handle.poll()
    assert first["rounds_run"] == 1
    v = handle.verdict()
    assert v.decision == "FAIL"            # weight kills randu in round 1
    res = handle.result()
    assert res.verdict.decision == "FAIL" and handle.cancelled
    assert res.rounds_run < handle.plan_rounds
    assert session.cache_key(spec)[-1] == "reference"
    # a second submit of the same shape reuses the runner
    session.submit(spec).result()
    assert session.total_traces == 1
    assert replan([], [1.0], 3).rounds == 0


def test_port_imports_neither_jax_nor_repro():
    """Importing every repro_torch module leaves jax and repro out of
    sys.modules (checked in a fresh interpreter)."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
