"""PyTorch port: checkpoint v5 and resume (``repro_torch.ckpt.io``,
``core/api.py`` ``Checkpoint`` and ``BatteryRun``'s save/load) against
the JAX reference.

Byte identity of the files is checked in-process against
``repro.ckpt.io`` (which needs no 64-bit mode). Reference runs that
write or resume a checkpoint, and reference loads of checkpoint files,
run in ``test_torch_reference.py``'s subprocess (its ``ckpt`` task).
``(stat, p)`` are held to ``assert_stat_p``; verdicts, job ids, rounds
and every integer leaf must be identical.
"""
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro.ckpt import io as ref_io
from test_torch_reference import REPO, assert_stat_p, run_reference

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import stitch
from repro_torch.core.api import CKPT_VERSION, Checkpoint, PoolSession, RunSpec
from repro_torch.core.battery import build_battery
from repro_torch.launch import battery as cli
from repro_torch.rng.sources import GeneratorSource

SCALE = 0.0625
# the cross-package run: SmallCrush x0.0625, splitmix64 + randu, one
# worker (10 rounds), stopped after STOP rounds
SPEC = {"battery": "smallcrush", "generators": ["splitmix64", "randu"],
        "seeds": [7], "scale": SCALE, "backend": "reference"}
STOP = 4
# the same battery judged by the e-value engine with early stopping,
# stopped after EV_STOP rounds: its checkpoint carries decisions, the
# engine and log-wealth
EV_SPEC = dict(SPEC, policy="adaptive", stop_on_verdict=True,
               verdict_engine="evalue")
EV_STOP = 1


def _port_spec(spec, path=None):
    kw = dict(spec)
    kw["generators"] = tuple(kw["generators"])
    kw["seeds"] = tuple(kw["seeds"])
    return RunSpec(checkpoint_path=path, **kw)


def _toy():
    idx = np.arange(4, dtype=np.int32)
    st = np.array([[1.0, 2.0, 3.0, 4.0]])
    pv = np.full((1, 4), 0.5)
    return idx, st, pv


# the v1-v4 leaf layouts ``Checkpoint`` documents, as the reference's
# ckpt_io writes them
def _layouts():
    idx, st, pv = _toy()
    dec = np.array([2], np.int8)
    uids = np.asarray([b"gen:splitmix64"])
    return {
        1: [idx, st[0], pv[0]],
        2: [idx, st, pv, dec, np.int64(5)],
        3: [np.int64(3), idx, st, pv, dec, np.int64(6), np.float64(0.05)],
        4: [np.int64(4), idx, st, pv, np.zeros((0,), np.int8), np.int64(7),
            np.float64(np.nan), uids],
    }


@pytest.fixture(scope="module")
def xpkg(tmp_path_factory):
    """Checkpoints written by each package and resumed by the other, the
    v1-v4 fixtures, and the reference's loads of them."""
    d = tmp_path_factory.mktemp("ckpt")
    paths = {k: str(d / f"{k}.ck") for k in ("ref", "port", "ref_ev")}
    session = PoolSession(device="cpu")
    handle = session.submit(_port_spec(SPEC, paths["port"]))
    for _ in range(STOP):
        handle.poll()
    port_partial = Checkpoint.load(paths["port"])
    layouts = {}
    for version, leaves in _layouts().items():
        layouts[version] = str(d / f"v{version}.ck")
        ref_io.save(layouts[version], leaves)
    (res,) = run_reference([{
        "kind": "ckpt",
        "runs": [{"spec": SPEC, "path": None, "rounds": None},
                 {"spec": SPEC, "path": paths["ref"], "rounds": STOP},
                 {"spec": SPEC, "path": paths["port"], "rounds": None},
                 {"spec": EV_SPEC, "path": None, "rounds": None},
                 {"spec": EV_SPEC, "path": paths["ref_ev"],
                  "rounds": EV_STOP}],
        "load": [layouts[v] for v in sorted(layouts)] + [paths["ref"]]}],
        str(d / "out"))
    whole, _, ref_resume, ev_whole, _ = res["runs"]
    return {"paths": paths, "layouts": layouts, "whole": whole,
            "ref_resume": ref_resume, "ev_whole": ev_whole,
            "port_partial": port_partial,
            "loads": dict(zip(sorted(layouts), res["loads"])),
            "ref_load": res["loads"][-1]}


def _check_results(got, want_run, what):
    """Combined test-space results of a port run against the reference's
    uninterrupted run: same tests present, (stat, p) within tolerance."""
    entries = {e.index: e for e in build_battery("smallcrush", SCALE,
                                                 device="cpu")}
    for gen, res in got.items():
        want = want_run["results"][gen]
        assert sorted(res) == sorted(int(k) for k in want), (what, gen)
        for i, (stat, p) in res.items():
            e = entries[i]
            assert_stat_p(e.kname, dict(e.params), want[str(i)], (stat, p),
                          f"{what} {gen} test {i}")


# -- the file format


def _v5_leaves():
    rng = np.random.default_rng(3)
    return {
        "version": np.int64(CKPT_VERSION),
        "job_idx": rng.permutation(300).astype(np.int32),
        "stats": rng.normal(size=(2, 300)),
        "ps": np.where(rng.random((2, 300)) < 0.1, np.nan,
                       rng.random((2, 300))),
        "decisions": np.array([1, 2], np.int8),
        "decisions_absent": np.zeros((0,), np.int8),
        "rounds_run": np.int64(106),
        "alpha": np.float64(0.01),
        "alpha_absent": np.float64(np.nan),
        "source_uids": np.asarray([b"gen:splitmix64", b"gen:randu"]),
        "source_uids_absent": np.zeros((0,), "S1"),
        "engine": np.asarray([b"evalue"]),
        "log_wealth": np.array([-3.5, 41.25]),
        "log_wealth_absent": np.zeros((0,), np.float64),
    }


def _msgpack_values():
    """Every encoding width of each msgpack type the format can meet."""
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    lengths = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]
    return {
        "int": ints,
        "float": [0.0, -1.5, 1e300, float("inf")],
        "none_bool": [None, True, False],
        "str": ["x" * n for n in lengths],
        "bin": [b"y" * n for n in lengths],
        "array": [list(range(n)) for n in (0, 15, 16, 65536)],
        "map": [{str(i): i for i in range(n)} for n in (0, 15, 16, 65536)],
    }


@pytest.mark.parametrize("kind", sorted(_msgpack_values()))
def test_encoder_writes_msgpack_bytes(kind):
    """The port's encoder writes what ``msgpack.packb(...,
    use_bin_type=True)`` writes, at every width of each type, and its
    decoder reads it back (strings as bytes, as the reference reads)."""
    msgpack = pytest.importorskip("msgpack")
    for v in _msgpack_values()[kind]:
        blob = ckpt_io.packb(v)
        assert blob == msgpack.packb(v, use_bin_type=True), (kind, v)
        assert ckpt_io.unpackb(blob) == msgpack.unpackb(
            blob, raw=True, strict_map_key=False)


@pytest.mark.parametrize("kind", sorted(_v5_leaves()))
def test_io_is_byte_identical_per_v5_leaf_kind(tmp_path, kind):
    """For each leaf a v5 checkpoint holds, the port's ``ckpt/io.save``
    writes the reference's bytes, and each package reads the other's."""
    leaf = _v5_leaves()[kind]
    for leaves in ([leaf], [leaf, leaf, np.int64(0)]):
        ours, theirs = str(tmp_path / "port.ck"), str(tmp_path / "ref.ck")
        ckpt_io.save(ours, leaves)
        ref_io.save(theirs, leaves)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), kind
        for x, y in zip(ckpt_io.load_flat(theirs), ref_io.load_flat(ours)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


def test_whole_v5_file_is_byte_identical(tmp_path):
    leaves = list(_v5_leaves().values())
    ckpt_io.save(str(tmp_path / "a.ck"), leaves)
    ref_io.save(str(tmp_path / "b.ck"), leaves)
    assert (tmp_path / "a.ck").read_bytes() == (tmp_path / "b.ck").read_bytes()


def test_port_rewrites_a_reference_checkpoint_byte_for_byte(xpkg, tmp_path):
    """``Checkpoint.load`` then ``save`` in the port reproduces the file
    the reference's run wrote, byte for byte."""
    again = str(tmp_path / "again.ck")
    Checkpoint.load(xpkg["paths"]["ref"]).save(again)
    with open(again, "rb") as a, open(xpkg["paths"]["ref"], "rb") as b:
        assert a.read() == b.read()


def _fields(ck):
    return {"version": ck.version, "job_idx": ck.job_idx.tolist(),
            "stats": ck.stats.tolist(), "ps": ck.ps.tolist(),
            "decisions": (None if ck.decisions is None
                          else [int(d) for d in ck.decisions]),
            "rounds_run": ck.rounds_run, "alpha": ck.alpha,
            "source_uids": (None if ck.source_uids is None
                            else [u.decode() for u in ck.source_uids]),
            "engine": ck.engine,
            "log_wealth": (None if ck.log_wealth is None
                           else ck.log_wealth.tolist())}


def _ref_fields(loaded):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in loaded.items()}


@pytest.mark.parametrize("version", [1, 2, 3, 4])
def test_v1_to_v4_files_load_alike(xpkg, version):
    """Files in each documented v1-v4 layout, written by the reference's
    ckpt_io, load to the same ``Checkpoint`` in both packages."""
    got = _fields(Checkpoint.load(xpkg["layouts"][version]))
    assert got == _ref_fields(xpkg["loads"][version])
    assert got["version"] == version


def test_reference_v5_file_loads_alike(xpkg):
    assert _fields(Checkpoint.load(xpkg["paths"]["ref"])) == \
        _ref_fields(xpkg["ref_load"])


def test_unknown_layouts_are_refused(tmp_path):
    idx, st, pv = _toy()
    bad_ver = str(tmp_path / "bad_ver.ck")
    ckpt_io.save(bad_ver, [np.int64(9), idx, st, pv, np.zeros(0, np.int8),
                           np.int64(0), np.float64(0.01)])
    with pytest.raises(ValueError, match="version"):
        Checkpoint.load(bad_ver)
    bad_len = str(tmp_path / "bad_len.ck")
    ckpt_io.save(bad_len, [idx, st])
    with pytest.raises(ValueError, match="leaves"):
        Checkpoint.load(bad_len)


def test_io_works_without_msgpack(tmp_path):
    """The card's machine has no msgpack: every module of the port
    imports, and its IO and ``Checkpoint`` work, with the module
    blocked."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['msgpack'] = None\n"
        "import numpy as np\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.ckpt import io\n"
        "from repro_torch.core.api import Checkpoint\n"
        f"p = {str(tmp_path / 'x.ck')!r}\n"
        "Checkpoint(np.arange(3, dtype=np.int32), np.ones((2, 3)),\n"
        "           np.full((2, 3), 0.5), np.array([1, 0], np.int8), 4,\n"
        "           alpha=0.01, source_uids=np.asarray([b'gen:a', b'gen:b']),\n"
        "           engine='evalue', log_wealth=np.array([0.5, -1.0])).save(p)\n"
        "ck = Checkpoint.load(p)\n"
        "assert ck.engine == 'evalue' and ck.rounds_run == 4\n"
        "assert 'msgpack' not in [m for m in sys.modules if sys.modules[m]]\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- resume across packages


def test_reference_checkpoint_resumes_in_port(xpkg, tmp_path):
    """A v5 file the reference wrote after STOP rounds resumes in the
    port: only the missing jobs run, and the verdicts and (stat, p) are
    the reference's uninterrupted run's."""
    path = str(tmp_path / "from_ref.ck")
    shutil.copy(xpkg["paths"]["ref"], path)
    handle = PoolSession(device="cpu").submit(_port_spec(SPEC, path))
    status = handle.status()
    assert status["jobs_done"] == STOP
    res = handle.result()
    assert res.rounds_run == status["jobs_total"] - STOP
    assert {g: r.verdict.decision for g, r in res.runs.items()} == \
        xpkg["whole"]["verdicts"]
    _check_results({g: r.results for g, r in res.runs.items()},
                   xpkg["whole"], "reference file resumed in the port")


def test_port_checkpoint_resumes_in_reference(xpkg):
    """A v5 file the port wrote after STOP rounds resumes in the
    reference (its ``ckpt`` task): only the missing jobs run, and the
    verdicts are the uninterrupted run's."""
    partial = xpkg["port_partial"]
    assert partial.version == CKPT_VERSION
    assert len(partial.job_idx) == STOP
    assert [u.decode() for u in partial.source_uids] == \
        ["gen:splitmix64", "gen:randu"]
    resumed = xpkg["ref_resume"]
    assert resumed["jobs_done_at_submit"] == STOP
    assert resumed["rounds_run"] == 10 - STOP
    assert resumed["verdicts"] == xpkg["whole"]["verdicts"]
    entries = {e.index: e for e in build_battery("smallcrush", SCALE,
                                                 device="cpu")}
    for gen, res in resumed["results"].items():
        for i, sp in res.items():
            e = entries[int(i)]
            assert_stat_p(e.kname, dict(e.params),
                          xpkg["whole"]["results"][gen][i], sp,
                          f"port file resumed in the reference {gen} {i}")


def test_evalue_checkpoint_resumes_in_port_with_its_decisions(xpkg):
    """The reference's early-stopping e-value run, stopped after EV_STOP
    rounds, resumes in the port: the saved engine, decisions and rounds
    are adopted (the decisions cross-checked against the port's own
    recomputation), and the run ends at the reference's verdicts."""
    saved = Checkpoint.load(xpkg["paths"]["ref_ev"])
    assert saved.engine == "evalue" and saved.log_wealth is not None
    handle = PoolSession(device="cpu").submit(
        _port_spec(EV_SPEC, xpkg["paths"]["ref_ev"]))
    assert handle.rounds_run == EV_STOP
    res = handle.result()
    assert {g: r.verdict.decision for g, r in res.runs.items()} == \
        xpkg["ev_whole"]["verdicts"] == {"splitmix64": "PASS",
                                         "randu": "FAIL"}
    assert res.rounds_run == xpkg["ev_whole"]["rounds_run"]


# -- the resume rules, transcribed from the reference's tests


def test_checkpoint_resume_runs_only_missing(tmp_path):
    """save -> knock jobs out -> the restart re-runs only the missing
    ones and reconciles bitwise (``tests/test_api.py``)."""
    ck = str(tmp_path / "resume.ck")
    session = PoolSession(device="cpu")
    spec = RunSpec("smallcrush", "splitmix64", 11, scale=SCALE,
                   checkpoint_path=ck)
    res1 = session.submit(spec).result()
    assert res1.rounds_run > 0
    Checkpoint.load(ck).drop([2, 8]).save(ck)
    run2 = session.submit(spec)
    status = run2.status()
    assert status["jobs_total"] - status["jobs_done"] == 2
    res2 = run2.result()
    assert res2.rounds_run == -(-2 // session.n_workers)
    assert res2.results == res1.results
    assert session.total_traces == 1


def test_killed_run_resumes_to_the_same_bits(tmp_path):
    """A run abandoned after some rounds (its handle dropped, as a killed
    process leaves its file) and resumed gives bitwise the results, and
    the verdicts, of an uninterrupted run on the same device and
    backend."""
    session = PoolSession(device="cpu")
    whole = session.submit(_port_spec(SPEC)).result()
    ck = str(tmp_path / "killed.ck")
    handle = session.submit(_port_spec(SPEC, ck))
    for _ in range(3):
        handle.poll()
    del handle
    res = session.submit(_port_spec(SPEC, ck)).result()
    assert res.rounds_run == 10 - 3
    for gen, run in res.runs.items():
        assert run.results == whole.runs[gen].results, gen
        # a decided Bonferroni verdict keeps the look it was made at, so
        # only its decision and failed tests are compared
        assert run.verdict.decision == whole.runs[gen].verdict.decision
        assert run.verdict.failed_tests == whole.runs[gen].verdict.failed_tests


def _adaptive(path, **kw):
    return RunSpec("smallcrush", "splitmix64", 3, scale=SCALE,
                   policy="adaptive", stop_on_verdict=True,
                   checkpoint_path=path, **kw)


def test_resume_refuses_cross_engine_checkpoint(tmp_path):
    """A Bonferroni early-stopping checkpoint resumed under ``evalue`` is
    a typed refusal naming both engines and alphas; under its own engine
    it resumes with nothing to run and its round count
    (``tests/test_evidence.py``)."""
    ck = str(tmp_path / "engine.ck")
    session = PoolSession(device="cpu")
    spec = _adaptive(ck)
    session.submit(spec).result()
    cross = dataclasses.replace(spec, verdict_engine="evalue")
    with pytest.raises(stitch.VerdictEngineMismatch) as exc:
        session.submit(cross)
    msg = str(exc.value)
    assert "'bonferroni'" in msg and "'evalue'" in msg
    assert "alpha=0.01" in msg
    assert issubclass(stitch.VerdictEngineMismatch, ValueError)
    res = session.submit(spec).result()
    assert res.plan_rounds == 0
    assert res.rounds_run == 10
    assert res.verdict.decision == "PASS"


def test_resume_refuses_other_sources(tmp_path):
    """The file pins each position's source uid: the same shape with
    another generator refuses to resume."""
    ck = str(tmp_path / "uids.ck")
    session = PoolSession(device="cpu")
    session.submit(RunSpec("smallcrush", "splitmix64", 3, scale=SCALE,
                           checkpoint_path=ck)).poll()
    with pytest.raises(ValueError, match="gen:splitmix64"):
        session.submit(RunSpec("smallcrush", "pcg32", 3, scale=SCALE,
                               checkpoint_path=ck))


def test_runspec_sources_are_the_positions_generator_sources():
    """``sources`` and ``generators`` are two spellings of the positions;
    each position's uid is what a checkpoint pins. A ``file:`` spec is a
    captured bitstream, whose file must exist."""
    by_name = RunSpec("smallcrush", ("pcg32", "randu"), 3)
    by_source = RunSpec("smallcrush", sources=(GeneratorSource("pcg32"),
                                               "randu"), seeds=3)
    assert by_name.sources == by_source.sources
    assert by_source.generators == ("pcg32", "randu")
    assert [s.uid() for s in by_name.sources] == ["gen:pcg32", "gen:randu"]
    assert [s.digest() for s in by_name.sources] == ["pcg32", "randu"]
    with pytest.raises(FileNotFoundError):
        RunSpec("smallcrush", sources=("file:no_such_capture.npy",))
    with pytest.raises(KeyError):
        RunSpec("smallcrush", sources=("nope",))


def test_resume_refuses_a_job_beyond_the_table(tmp_path):
    """A file whose job ids do not fit the spec's job table (another
    battery or scale) is refused."""
    ck = str(tmp_path / "jobs.ck")
    idx, st, pv = _toy()
    Checkpoint(np.array([0, 57], np.int32), st[:, :2], pv[:, :2]).save(ck)
    with pytest.raises(ValueError, match="references job 57"):
        PoolSession(device="cpu").submit(
            RunSpec("smallcrush", "splitmix64", 3, scale=SCALE,
                    checkpoint_path=ck))


def test_resume_refuses_another_generator_count(tmp_path):
    ck = str(tmp_path / "count.ck")
    session = PoolSession(device="cpu")
    session.submit(RunSpec("smallcrush", ("splitmix64", "randu"), 9,
                           scale=SCALE, policy="adaptive",
                           stop_on_verdict=True, checkpoint_path=ck)).poll()
    with pytest.raises(ValueError, match="generator"):
        session.submit(_adaptive(ck))


def test_tampered_decisions_are_refused_with_engine_and_alphas(tmp_path):
    """Saved decisions that the saved results do not recompute to are
    refused; the message names the engine and both alphas."""
    ck = str(tmp_path / "tamper.ck")
    session = PoolSession(device="cpu")
    spec = _adaptive(ck)
    session.submit(spec).result()
    leaves = ckpt_io.load_flat(ck)
    dec = np.asarray(leaves[4], np.int8).copy()
    dec[0] = 2                                  # PASS -> FAIL code
    ckpt_io.save(ck, leaves[:4] + [dec] + leaves[5:])
    with pytest.raises(ValueError) as exc:
        session.submit(spec)
    msg = str(exc.value)
    assert "engine 'bonferroni'" in msg
    assert "checkpoint alpha=0.01" in msg and "at alpha=0.01" in msg


@pytest.mark.parametrize("stop_on_verdict,alpha,adopted", [
    (True, 0.01, True), (True, 0.05, False), (False, 0.01, False)])
def test_restored_state_adopted_only_under_stop_on_verdict_same_alpha(
        tmp_path, stop_on_verdict, alpha, adopted):
    """Saved decisions and ``rounds_run`` bind only an early-stopping run
    at the alpha they were made under; any other resume starts its round
    count at 0 and recomputes the verdicts from the results."""
    ck = str(tmp_path / "adopt.ck")
    session = PoolSession(device="cpu")
    first = session.submit(_adaptive(ck))
    for _ in range(3):
        first.poll()
    again = session.submit(RunSpec(
        "smallcrush", "splitmix64", 3, scale=SCALE, policy="adaptive",
        stop_on_verdict=stop_on_verdict, alpha=alpha, checkpoint_path=ck))
    assert again.rounds_run == (3 if adopted else 0)
    assert (again._restored_decisions is not None) == adopted
    assert again.status()["jobs_done"] == 3


def test_stream_and_cancel_save_progress(tmp_path):
    """``stream()`` yields one status per round; ``cancel()`` keeps and
    saves what ran, and a resume runs only the rest."""
    ck = str(tmp_path / "stream.ck")
    session = PoolSession(device="cpu")
    spec = RunSpec("smallcrush", "splitmix64", 5, scale=SCALE,
                   checkpoint_path=ck)
    handle = session.submit(spec)
    seen = []
    for status in handle.stream():
        seen.append(status["rounds_run"])
        if len(seen) == 2:
            assert handle.cancel() == 8
    assert seen == [1, 2]
    assert len(Checkpoint.load(ck).job_idx) == 2
    res = session.submit(spec).result()
    assert res.rounds_run == 8
    statuses = list(session.submit(spec).stream())
    assert statuses == []                       # nothing left to run


def test_cli_ckpt_rerun_prints_rounds_zero(tmp_path, capsys):
    """``--ckpt``: the same command run again resumes and runs nothing."""
    ck = str(tmp_path / "cli.ck")
    argv = ["--battery", "smallcrush", "--gen", "splitmix64", "--scale",
            str(SCALE), "--seed", "7", "--device", "cpu", "--ckpt", ck]
    assert cli.main(argv) == 0
    assert "rounds=10/10" in capsys.readouterr().out
    assert cli.main(argv) == 0
    assert "rounds=0/0" in capsys.readouterr().out
