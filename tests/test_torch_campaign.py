"""PyTorch port: generator-fleet campaigns (``core/campaign.py``,
``CampaignSpec``/``CampaignLedger``, the grid runner, ``wave_schedule``,
the campaign report and ``--campaign``) against the JAX reference, which
runs in ``test_torch_reference.py``'s subprocess (its ``campaign`` and
``cli`` tasks).

Transcribes the reference's own cases (``tests/test_campaign.py``).
Digests, ledger bytes, matrices, ``decided_phase``, rounds and runner
builds are compared exactly; e-value log-wealth within
``log_wealth_tolerance``; the CLI's ``campaign`` and ``evidence`` keys,
cells and exit codes identical.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.ckpt import io as ref_io
from test_torch_reference import log_wealth_tolerance, run_reference

from repro_torch.ckpt import io as ckpt_io
from repro_torch.core import pool, stitch
from repro_torch.core.api import (CELL_FAIL, CELL_PASS, CELL_UNDECIDED,
                                  CampaignLedger, CampaignSpec, PoolSession,
                                  RunSpec)
from repro_torch.core.battery import build_battery, max_words
from repro_torch.core.campaign import Campaign, default_span, screen
from repro_torch.core.scheduler import wave_makespan, wave_schedule
from repro_torch.launch import battery as cli
from repro_torch.rng import generators as G
from repro_torch.rng.sources import capture_generator, switch_block
from repro_torch.stats.tests import pairstream

SCALE = 0.0625
GENS8 = ("splitmix64", "msweyl", "threefry", "pcg32", "lcg64",
         "xorshift64s", "randu", "minstd")
ACCEPT = dict(battery="smallcrush", generators=GENS8, n_streams=4, seed=7,
              waves=(SCALE, SCALE))
MID = dict(battery="smallcrush", generators=("splitmix64", "randu"),
           n_streams=2, seed=7, waves=(SCALE,))
CONT = dict(battery="smallcrush", generators=("splitmix64", "pcg32"),
            n_streams=2, seed=11, waves=(SCALE,), stream_check=False,
            verdict_engine="evalue", continue_band=1e-4,
            max_continuations=1)
CLI_CAMPAIGN = ["--campaign", "--battery", "smallcrush", "--gen",
                "splitmix64,pcg32,randu", "--streams", "2", "--waves",
                str(SCALE), "--seed", "7", "--backend", "reference"]
ENGINES = ("bonferroni", "evalue")


def _digest_specs(cap):
    """The specs whose digests both packages must agree on."""
    base = dict(battery="smallcrush", generators=("splitmix64", "pcg32"),
                n_streams=2)
    return {
        "bonferroni": base,
        "evalue": dict(base, verdict_engine="evalue"),
        "evalue_band0": dict(base, verdict_engine="evalue",
                             continue_band=0.0, max_continuations=0),
        "captured": dict(battery="smallcrush",
                         sources=("splitmix64", f"file:{cap}"),
                         n_streams=2, seed=7, waves=(0.25, 1.0)),
        "over_decompose": dict(base, policy="over_decompose",
                               waves=(0.125, 0.5), alpha=0.05),
        "span": dict(base, span=1 << 16, stream_check=False, seed=99),
    }


def _json_spec(kw):
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in kw.items()}


def _ledger_edits():
    """(spec, replaced fields) of the ledgers both packages save."""
    gspec = dict(battery="smallcrush", generators=("splitmix64", "pcg32"),
                 n_streams=2)
    return [
        (gspec, {}),
        (gspec, {"decisions": [1, 2, 0, 1], "decided_phase": [1, 0, -1, 2],
                 "phases_done": 2}),
        (dict(gspec, verdict_engine="evalue"),
         {"log_wealth": [-1.5, 4.75, 0.0, -0.125], "continuations": 1,
          "phases_done": 3}),
        (dict(gspec, alpha=0.05, seed=3), {"alpha": None}),
    ]


def _port_ledger(spec_kw, edits):
    led = CampaignLedger.fresh(CampaignSpec(**spec_kw))
    for key, value in edits.items():
        old = getattr(led, key)
        setattr(led, key, np.asarray(value, old.dtype)
                if isinstance(old, np.ndarray) else value)
    return led


def _v1_v2_v3(d):
    """Ledger files in each layout, written by the port: v3 by
    ``save``, v1 and v2 as their leaf lists."""
    spec = CampaignSpec(**MID)
    led = CampaignLedger.fresh(spec)
    led.decisions[1] = CELL_FAIL
    led.decided_phase[1] = 0
    led.phases_done = 1
    v3 = str(d / "port_v3.ck")
    led.save(v3)
    leaves = ckpt_io.load_flat(v3)
    v2, v1 = str(d / "port_v2.ck"), str(d / "port_v1.ck")
    ckpt_io.save(v2, [np.int64(2)] + leaves[1:9])
    ckpt_io.save(v1, [np.int64(1)] + leaves[1:8])
    return {1: v1, 2: v2, 3: v3}


@pytest.fixture(scope="module")
def xref(tmp_path_factory):
    """The reference's digests, spans, ledgers, campaign runs (the 8x4
    acceptance, a campaign cut after its seam phase, the port's cut
    campaign resumed, the e-value continuation) and CLI campaigns, and
    the port's files those runs read."""
    d = tmp_path_factory.mktemp("campaign")
    cap = capture_generator("splitmix64", str(d / "cap.npy"), seed=7,
                            n_streams=16, stride=1 << 15, device="cpu")
    layouts = _v1_v2_v3(d)
    # the port's MID campaign cut after its first phase, for the
    # reference to resume
    port_mid = str(d / "port_mid.ck")
    Campaign(PoolSession(device="cpu"),
             CampaignSpec(**MID, ledger_path=port_mid)).run_next_phase()
    digests = _digest_specs(cap)
    ledgers = [{"spec": _json_spec(kw), "path": str(d / f"ref_led{i}.ck"),
                "set": edits}
               for i, (kw, edits) in enumerate(_ledger_edits())]
    runs = [
        {"spec": _json_spec(dict(ACCEPT, ledger_path=str(d / "r8x4.ck"))),
         "fresh": True},
        {"spec": _json_spec(dict(MID, ledger_path=str(d / "ref_mid.ck"))),
         "phases": 1},
        {"spec": _json_spec(dict(MID, ledger_path=port_mid))},
        {"spec": _json_spec(dict(CONT, ledger_path=str(d / "rcont.ck")))},
        {"spec": _json_spec(MID)},
    ]
    cli_json = {e: str(d / f"cli_{e}.json") for e in ENGINES}
    tasks = [{"kind": "campaign",
              "digests": [_json_spec(kw) for kw in digests.values()],
              "spans": [_json_spec(ACCEPT),
                        _json_spec(dict(ACCEPT, waves=(SCALE, 0.125)))],
              "ledgers": ledgers, "runs": runs,
              "loads": [{"path": layouts[v], "spec": _json_spec(MID)}
                        for v in (1, 2, 3)]}]
    tasks += [{"kind": "cli", "argv": CLI_CAMPAIGN + [
        "--verdict-engine", e, "--ledger", str(d / f"cli_{e}.ck"),
        "--json", cli_json[e]]} for e in ENGINES]
    camp, *clis = run_reference(tasks, str(d / "out"), timeout=900)
    for e, res in zip(ENGINES, clis):
        with open(cli_json[e]) as f:
            res["json"] = json.load(f)
    return {"dir": d, "cap": cap, "layouts": layouts, "port_mid": port_mid,
            "digests": dict(zip(digests, camp["digests"])),
            "spans": camp["spans"], "ledgers": ledgers,
            "runs": camp["runs"], "loads": camp["loads"],
            "cli": dict(zip(ENGINES, clis))}


def _ledger_fields(led):
    return {"version": led.version, "gen_ids": led.gen_ids.tolist(),
            "streams": led.streams.tolist(),
            "decisions": led.decisions.tolist(),
            "decided_phase": led.decided_phase.tolist(),
            "phases_done": led.phases_done, "alpha": led.alpha,
            "spec_digest": str(led.spec_digest),
            "source_uids": (None if led.source_uids is None
                            else [u.decode() for u in led.source_uids]),
            "log_wealth": (None if led.log_wealth is None
                           else led.log_wealth.tolist()),
            "engine": led.engine, "continuations": led.continuations}


# ------------------------------------------------------- offset machinery

def test_stream_offsets_grid():
    assert G.stream_offsets(4, 100).tolist() == [0, 100, 200, 300]
    with pytest.raises(ValueError):
        G.stream_offsets(0, 100)


def test_seam_offsets_straddle():
    # pair s reads [ (s+1)*span - n, (s+1)*span + n )
    assert G.seam_offsets(3, 1000, 64).tolist() == [936, 1936]
    assert G.seam_offsets(1, 1000, 64).size == 0
    with pytest.raises(ValueError):
        G.seam_offsets(3, 100, 200)        # seam block wider than span


def test_runspec_offsets_normalize_and_validate():
    spec = RunSpec("smallcrush", ("splitmix64", "pcg32"), 1,
                   offsets=(0, 4096))
    assert spec.offsets == (0, 4096)
    spec1 = RunSpec("smallcrush", ("splitmix64", "pcg32"), 1, offsets=64)
    assert spec1.offsets == (64, 64)            # broadcast
    assert RunSpec("smallcrush", "mwc", 1, offsets=0).offsets == (0,)
    with pytest.raises(ValueError):
        RunSpec("smallcrush", "mwc", 1, offsets=64)    # no jump-ahead
    with pytest.raises(ValueError):
        RunSpec("smallcrush", "splitmix64", 1, offsets=-1)
    with pytest.raises(ValueError):
        RunSpec("smallcrush", ("splitmix64", "pcg32"), 1,
                offsets=(1, 2, 3))


def test_grid_dispatch_offset_zero_matches_classic():
    """offsets=0 runs on the grid runner and gives the classic fan-out's
    results bitwise."""
    session = PoolSession(device="cpu")
    classic = session.submit(RunSpec(
        "smallcrush", ("splitmix64", "randu"), 7, scale=SCALE)).result()
    grid = session.submit(RunSpec(
        "smallcrush", ("splitmix64", "randu"), 7, scale=SCALE,
        offsets=0)).result()
    for gen in ("splitmix64", "randu"):
        assert grid.runs[gen].results == classic.runs[gen].results
    keys = session._compiled(RunSpec("smallcrush", "splitmix64", 7,
                                     scale=SCALE)).runners
    assert {k[2] for k in keys} == {False, True}       # both runners built


def test_grid_dispatch_offset_reads_substream():
    """A cell at offset o reads words [o, o + bucket) of each job's
    sequence: every job's result is its kernel on exactly those words."""
    off = 1 << 16
    session = PoolSession(device="cpu")
    a = session.submit(RunSpec("smallcrush", "splitmix64", 7, scale=SCALE,
                               offsets=0)).result()
    b = session.submit(RunSpec("smallcrush", "splitmix64", 7, scale=SCALE,
                               offsets=(off,))).result()
    assert a.results != b.results
    entries = build_battery("smallcrush", SCALE, device="cpu")
    streams = pool.stream_table(entries)
    for e in entries:
        bits = switch_block(0, 7, int(streams[e.index]),
                            pool.word_bucket(e.n_words), off, device="cpu")
        stat, p = e.kernel(bits)
        assert b.results[e.index] == (float(np.float32(stat)),
                                      float(np.float32(p)))


def test_padded_lanes_are_computed_once():
    """A grid round whose lanes repeat (a campaign's padding) runs each
    distinct lane's jobs once and hands every lane its results."""
    entries = build_battery("smallcrush", SCALE, device="cpu")
    calls = []
    job = pool._job_fn(entries, torch.device("cpu"))

    def counting(j, seed, gid, off=None):
        calls.append((j, seed, gid, off))
        return job(j, seed, gid, off)
    stats, ps = pool._round(counting, [0, 1], [7, 7, 7, 7], [0, 0, 3, 0],
                            [0, 64, 0, 0])
    assert len(calls) == 2 * 3
    np.testing.assert_array_equal(stats[0], stats[3])
    assert not np.array_equal(stats[0], stats[1])


# ------------------------------------------------------- pairstream family

def _words(seed, stream, n):
    return G.splitmix64_block(seed, stream, n, device="cpu")


def test_pairstream_null_is_calibrated():
    bits = _words(3, 5, 8192)
    for mode in ("corr", "hamcorr", "match", "shift"):
        _, p = pairstream(bits, n=4096, mode=mode)
        assert 1e-4 < float(p) < 1.0 - 1e-4, mode


def test_pairstream_catches_duplicated_stream():
    """Two halves holding the same words (a span-0 overlap) blow up the
    match mode."""
    half = _words(3, 5, 4096)
    _, p = pairstream(torch.cat([half, half]), n=4096, mode="match")
    assert float(p) < 1e-10


def test_pairstream_catches_off_by_k_seam():
    """Stream s+1 starting 2 words early is what the shift mode finds."""
    blk = _words(3, 5, 8194)
    _, p = pairstream(torch.cat([blk[:4096], blk[4094:8190]]), n=4096,
                      mode="shift")
    assert float(p) < 1e-10


def test_battery_pairstream_builds():
    entries = build_battery("pairstream", 0.25, device="cpu")
    assert len(entries) == 4
    assert len({e.n_words for e in entries}) == 1    # one seam alignment


# -------------------------------------------------------- wave planning

def test_wave_schedule_sorts_ascending():
    assert wave_schedule((1.0, 0.25, 0.5)) == [0.25, 0.5, 1.0]
    assert wave_schedule((0.25, 0.25)) == [0.25, 0.25]
    with pytest.raises(ValueError):
        wave_schedule(())
    with pytest.raises(ValueError):
        wave_schedule((0.5, -1.0))


def test_wave_makespan_models_batching():
    batched, per_cell = wave_makespan([1.0] * 10, 2, 16)
    assert per_cell == pytest.approx(batched * 16)
    assert wave_makespan([3.0, 1.0], 1, 0) == (4.0, 4.0)


# ---------------------------------------------------------- spec + ledger

def test_campaign_spec_validates():
    with pytest.raises(ValueError, match="COUNTER_BASED"):
        CampaignSpec("smallcrush", ("mwc",), n_streams=2)   # no jump-ahead
    with pytest.raises(ValueError, match="continuation"):
        CampaignSpec("smallcrush", ("mwc",), verdict_engine="evalue")
    assert CampaignSpec("smallcrush", ("mwc",)).n_cells == 1
    with pytest.raises(ValueError):
        CampaignSpec("smallcrush", ("splitmix64", "splitmix64"))
    with pytest.raises(ValueError):
        CampaignSpec("smallcrush", ("splitmix64",), waves=())
    with pytest.raises(ValueError):
        CampaignSpec("smallcrush", ())
    with pytest.raises(KeyError):
        CampaignSpec("megacrush", ("splitmix64",))
    with pytest.raises(KeyError):
        CampaignSpec("smallcrush", ("splitmix64",), backend="fast")
    for bad in (dict(n_streams=0), dict(alpha=1.0), dict(span=0),
                dict(continue_band=1.0), dict(max_continuations=-1)):
        with pytest.raises(ValueError):
            CampaignSpec("smallcrush", ("splitmix64",), **bad)
    spec = CampaignSpec("smallcrush", ("splitmix64", "pcg32"), n_streams=3,
                        waves=0.5)
    assert spec.n_cells == 6 and spec.waves == (0.5,)
    assert spec.cells[0] == ("splitmix64", 0)
    assert spec.cells[-1] == ("pcg32", 2)


def test_campaign_ledger_roundtrip(tmp_path):
    spec = CampaignSpec("smallcrush", ("splitmix64", "pcg32"), n_streams=2)
    led = CampaignLedger.fresh(spec)
    led.decisions[3] = CELL_FAIL
    led.decided_phase[3] = 1
    led.phases_done = 2
    path = str(tmp_path / "campaign.ck")
    led.save(path)
    back = CampaignLedger.load(path)
    assert back.matches(spec)
    assert back.phases_done == 2
    assert back.decisions.tolist() == led.decisions.tolist()
    assert back.decided_phase.tolist() == led.decided_phase.tolist()
    assert not back.matches(CampaignSpec(
        "smallcrush", ("splitmix64", "pcg32"), n_streams=3))
    assert not back.matches(CampaignSpec(
        "smallcrush", ("splitmix64", "pcg32"), n_streams=2, waves=(0.5,)))
    assert not back.matches(CampaignSpec(
        "smallcrush", ("splitmix64", "pcg32"), n_streams=2, seed=99))
    assert not back.matches(CampaignSpec(
        "smallcrush", ("splitmix64", "pcg32"), n_streams=2,
        verdict_engine="evalue"))
    bad = str(tmp_path / "bad.ck")
    ckpt_io.save(bad, ckpt_io.load_flat(path)[:5])
    with pytest.raises(ValueError, match="leaves"):
        CampaignLedger.load(bad)
    ckpt_io.save(bad, [np.int64(7)] + ckpt_io.load_flat(path)[1:])
    with pytest.raises(ValueError, match="version"):
        CampaignLedger.load(bad)


@pytest.mark.parametrize("kind", ["bonferroni", "evalue", "evalue_band0",
                                  "captured", "over_decompose", "span"])
def test_digest_equals_reference(xref, kind):
    """``CampaignSpec.digest()`` is the reference's for each kind of spec
    (the sha256 of the same ``repr``: policy signature, float waves and
    alpha, captured uids, the engine's knobs)."""
    kw = _digest_specs(xref["cap"])[kind]
    assert str(CampaignSpec(**kw).digest()) == xref["digests"][kind]


@pytest.mark.parametrize("which", [0, 1])
def test_default_span_equals_reference(xref, which):
    kw = ACCEPT if which == 0 else dict(ACCEPT, waves=(SCALE, 0.125))
    span = default_span(CampaignSpec(**kw))
    assert span == xref["spans"][which]
    assert span & (span - 1) == 0
    assert span >= max_words(build_battery("smallcrush", max(kw["waves"]),
                                           device="cpu"))


@pytest.mark.parametrize("which", range(len(_ledger_edits())))
def test_ledger_v3_bytes_equal_reference(xref, which, tmp_path):
    """The port's ``CampaignLedger.save`` writes the reference's file
    byte for byte, fresh and with decisions, wealth, continuations and an
    unrecorded alpha filled in; each package reads the other's."""
    kw, edits = _ledger_edits()[which]
    ours = str(tmp_path / "port.ck")
    _port_ledger(kw, edits).save(ours)
    theirs = xref["ledgers"][which]["path"]
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert _ledger_fields(CampaignLedger.load(theirs)) == \
        _ledger_fields(CampaignLedger.load(ours))


def _ledger_leaves():
    """Each kind of leaf a v3 ledger holds that a v5 checkpoint does not
    use in the same form."""
    return {
        "int8": np.array([0, 1, 2, -1], np.int8),
        "uids": np.asarray([b"gen:splitmix64", b"cap:c:0123456789abcdef"]),
        "uids_absent": np.zeros((0,), "S1"),
        "log_wealth_absent": np.zeros((0,), np.float64),
        "digest_uint64": np.uint64((1 << 64) - 3),
        "alpha_nan": np.float64(np.nan),
    }


@pytest.mark.parametrize("kind", sorted(_ledger_leaves()))
def test_ledger_leaf_kind_bytes_equal_reference_io(tmp_path, kind):
    """For each such leaf, ``ckpt/io.save`` writes ``repro.ckpt.io``'s
    bytes and each reads the other's."""
    leaf = _ledger_leaves()[kind]
    for leaves in ([leaf], [np.int64(3), leaf, leaf]):
        ours, theirs = str(tmp_path / "p.ck"), str(tmp_path / "r.ck")
        ckpt_io.save(ours, leaves)
        ref_io.save(theirs, leaves)
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), kind
        for x, y in zip(ckpt_io.load_flat(theirs), ref_io.load_flat(ours)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("version", [1, 2, 3])
def test_port_ledger_layouts_read_alike(xref, version):
    """v1, v2 and v3 files the port wrote load to the same ledger in both
    packages, and both match the spec they describe."""
    path = xref["layouts"][version]
    led = CampaignLedger.load(path)
    want = dict(xref["loads"][version - 1])
    assert want.pop("matches") is True
    assert _ledger_fields(led) == want
    assert led.version == version and led.matches(CampaignSpec(**MID))


# ------------------------------------------------- the acceptance campaign

def test_campaign_8x4_acceptance(xref, tmp_path):
    """8 generators x 4 sub-streams at SmallCrush x0.0625 in the
    reference's phases: the same matrix, decided phases, rounds and
    runner builds as the reference (at most one per phase; the two
    same-scale waves share one), randu knocked out before the last wave,
    the same ledger bytes; resuming the finished ledger runs 0 rounds and
    builds 0 runners."""
    ledger = str(tmp_path / "campaign.ck")
    session = PoolSession(device="cpu")
    spec = CampaignSpec(**ACCEPT, ledger_path=ledger)
    campaign = Campaign(session, spec)
    phases = campaign.phases()
    assert [p.name for p in phases] == ["streamcheck",
                                        f"x{SCALE:g}", f"x{SCALE:g}"]
    res = campaign.run()
    want = xref["runs"][0]
    assert res.decisions.tolist() == want["decisions"]
    assert res.decided_phase.tolist() == want["decided_phase"]
    assert res.phase_names == want["phase_names"]
    assert res.rounds_run == want["rounds_run"]
    assert campaign.span == want["span"]
    assert session.total_traces == want["traces"] == len(phases) - 1
    with open(ledger, "rb") as a, open(str(xref["dir"] / "r8x4.ck"),
                                       "rb") as b:
        assert a.read() == b.read()
    mat = res.matrix
    gidx = {g: i for i, g in enumerate(GENS8)}
    assert set(mat[gidx["randu"]].tolist()) == {CELL_FAIL}
    assert int(res.decided_phase.reshape(8, 4)[gidx["randu"]].max()) \
        < len(phases) - 1
    for good in ("splitmix64", "threefry", "pcg32", "lcg64"):
        assert set(mat[gidx[good]].tolist()) == {CELL_PASS}, good
    assert not np.any(mat == CELL_UNDECIDED)
    assert "campaign screening matrix" in res.report
    session2 = PoolSession(device="cpu")
    res2 = Campaign(session2, spec).run()
    assert res2.rounds_run == 0 and session2.total_traces == 0
    assert res2.decisions.tolist() == res.decisions.tolist()
    assert res2.decided_phase.tolist() == res.decided_phase.tolist()


def test_reference_ledger_resumed_by_port(xref, tmp_path):
    """The reference's ledger of a campaign cut after its seam phase
    resumes in the port to the reference's uninterrupted matrix, running
    only the remaining phase."""
    path = str(tmp_path / "mid.ck")
    shutil.copy(str(xref["dir"] / "ref_mid.ck"), path)
    cut, whole = xref["runs"][1], xref["runs"][4]
    res = Campaign(PoolSession(device="cpu"),
                   CampaignSpec(**MID, ledger_path=path)).run()
    assert res.decisions.tolist() == whole["decisions"]
    assert res.decided_phase.tolist() == whole["decided_phase"]
    assert res.rounds_run == whole["rounds_run"] - cut["rounds_run"] > 0


def test_port_ledger_resumed_by_reference(xref):
    """The port's ledger, cut after its seam phase, resumed by the
    reference: the reference's uninterrupted matrix, and the port's."""
    resumed, whole = xref["runs"][2], xref["runs"][4]
    assert resumed["decisions"] == whole["decisions"]
    assert resumed["decided_phase"] == whole["decided_phase"]
    assert resumed["ledger"]["phases_done"] == 2
    port = Campaign(PoolSession(device="cpu"), CampaignSpec(**MID)).run()
    assert port.decisions.tolist() == whole["decisions"]
    assert port.rounds_run == whole["rounds_run"]
    seams = xref["runs"][1]["rounds_run"]
    assert resumed["rounds_run"] == whole["rounds_run"] - seams > 0


def test_campaign_mid_run_resume(tmp_path):
    """A campaign interrupted between phases resumes at the next phase:
    decided cells stay decided, completed phases are not re-run."""
    ledger = str(tmp_path / "campaign.ck")
    spec = CampaignSpec(**MID, ledger_path=ledger)
    session = PoolSession(device="cpu")
    c1 = Campaign(session, spec)
    phases = c1.phases()
    c1._run_phase(0, phases[0])                  # stream check only
    c1.ledger.phases_done = 1
    c1._save_ledger()
    rounds_phase0 = c1.rounds_run
    assert np.all(np.asarray(c1.ledger.decisions).reshape(2, 2)[1]
                  == CELL_FAIL)                  # randu seam-knocked
    c2 = Campaign(session, spec)
    assert c2.ledger.phases_done == 1
    res = c2.run()
    wave_rounds = -(-10 // session.n_workers)
    assert 0 < res.rounds_run <= wave_rounds
    assert rounds_phase0 > 0
    assert set(res.matrix[0].tolist()) == {CELL_PASS}
    assert set(res.matrix[1].tolist()) == {CELL_FAIL}


class _Killed(Exception):
    pass


def test_campaign_killed_mid_phase_resumes_from_phase_checkpoint(tmp_path):
    """Killed after 3 rounds of the wave, the campaign resumes from
    ``<ledger>.phase1``: only the wave's missing rounds run, to the
    uninterrupted matrix, and the phase file goes once the ledger holds
    the phase."""
    whole = Campaign(PoolSession(device="cpu"), CampaignSpec(**MID)).run()
    ledger = str(tmp_path / "campaign.ck")
    spec = CampaignSpec(**MID, ledger_path=ledger)
    session = PoolSession(device="cpu")
    submit = session.submit

    def dying_submit(run_spec):
        handle = submit(run_spec)
        if run_spec.battery == "smallcrush":
            poll = handle.poll

            def dying_poll():
                if handle.rounds_run == 3:
                    raise _Killed()
                return poll()
            handle.poll = dying_poll
        return handle
    session.submit = dying_submit
    with pytest.raises(_Killed):
        Campaign(session, spec).run()
    assert os.path.exists(ledger + ".phase1")
    assert CampaignLedger.load(ledger).phases_done == 1
    res = Campaign(PoolSession(device="cpu"), spec).run()
    assert res.decisions.tolist() == whole.decisions.tolist()
    assert res.decided_phase.tolist() == whole.decided_phase.tolist()
    assert res.rounds_run == 10 - 3
    assert not os.path.exists(ledger + ".phase1")


def test_campaign_knockout_skips_later_phases():
    spec = CampaignSpec("smallcrush", ("splitmix64", "randu"), n_streams=2,
                        waves=(SCALE, 1.0))
    c = Campaign(PoolSession(device="cpu"), spec)
    c.ledger.decisions[2:] = CELL_FAIL           # knock out randu's cells
    wave = [p for p in c.phases() if p.offset_rule == "stream"][0]
    assert c._phase_cells(wave) == [(0,), (1,)]
    seam = c.phases()[0]
    assert seam.offset_rule == "seam"
    assert c._phase_cells(seam) == [(0, 1)]      # only the surviving pair


def test_screen_one_call():
    """No streams, no seam phase, one wave; mwc runs single-stream."""
    res = screen(CampaignSpec("smallcrush", ("splitmix64", "mwc"), seed=3,
                              waves=(SCALE,), stream_check=True),
                 PoolSession(device="cpu"))
    assert res.phase_names == [f"x{SCALE:g}"]    # n_streams=1: no seams
    assert res.decision("splitmix64", 0) == stitch.PASS
    assert res.decision("mwc", 0) in (stitch.PASS, stitch.FAIL)


def test_captured_campaign_equals_generator(tmp_path):
    """The stream grid and seam phase decide a capture's cells exactly
    as the generator cells of the same words, with the same rounds."""
    cap = capture_generator("splitmix64", str(tmp_path / "c.npy"), seed=7,
                            n_streams=16, stride=1 << 15, device="cpu")
    session = PoolSession(device="cpu")

    def run(src):
        return Campaign(session, CampaignSpec(
            "smallcrush", sources=(src,), n_streams=2, seed=7,
            waves=(SCALE,))).run()
    gen, got = run("splitmix64"), run(f"file:{cap}")
    assert got.phase_names == gen.phase_names == ["streamcheck",
                                                  f"x{SCALE:g}"]
    np.testing.assert_array_equal(got.decisions, gen.decisions)
    np.testing.assert_array_equal(got.decided_phase, gen.decided_phase)
    assert got.rounds_run == gen.rounds_run
    led = CampaignLedger.fresh(CampaignSpec(
        "smallcrush", sources=(f"file:{cap}",), n_streams=2))
    assert led.gen_ids.tolist() == [-1, -1]
    assert [u.decode()[:6] for u in led.source_uids] == ["cap:c:"] * 2


# ----------------------------------------------- e-values and continuation

def _log_wealth_tol(campaign, n_cells):
    """Per-cell log-wealth tolerance: ``log_wealth_tolerance`` over every
    stream phase's tests of the cell, from the port's results."""
    tol = np.zeros(n_cells)
    phases = campaign.phases()
    for rec in campaign.phase_log:
        phase = phases[rec["phase"]]
        if phase.offset_rule != "stream":
            continue
        entries = build_battery(phase.battery, phase.scale, device="cpu")
        for grp, res in zip(rec["groups"], rec["results"]):
            parts = [(entries[k].kname, dict(entries[k].params), s, p)
                     for k, (s, p) in res.items()]
            tol[grp[0]] += log_wealth_tolerance(parts)
    return tol


def test_evalue_continuation_matches_reference(xref, tmp_path):
    """The reference's borderline campaign (e-values, band 1e-4): the
    same phases with one continuation, decisions and decided phases,
    and each cell's log-wealth within its tolerance; the finished ledger
    resumes to 0 rounds."""
    spec = CampaignSpec(**CONT, ledger_path=str(tmp_path / "cont.ck"))
    campaign = Campaign(PoolSession(device="cpu"), spec)
    res = campaign.run()
    want = xref["runs"][3]
    assert res.phase_names == want["phase_names"] == [f"x{SCALE:g}",
                                                      "continue1"]
    assert res.continuations == want["continuations"] == 1
    assert res.decisions.tolist() == want["decisions"]
    assert res.decided_phase.tolist() == want["decided_phase"]
    assert res.rounds_run == want["rounds_run"]
    tol = _log_wealth_tol(campaign, spec.n_cells)
    for got, ref, t in zip(res.log_wealth, want["log_wealth"], tol):
        assert abs(got - ref) <= t, (got, ref, t)
    led = CampaignLedger.load(spec.ledger_path)
    assert led.engine == "evalue" and led.continuations == 1
    again = Campaign(PoolSession(device="cpu"), spec).run()
    assert again.rounds_run == 0
    np.testing.assert_array_equal(again.log_wealth, res.log_wealth)


@pytest.mark.parametrize("engine", ENGINES)
def test_campaign_cli_matches_reference(xref, engine, tmp_path, capsys):
    """``--campaign`` under each engine: the reference's JSON keys,
    ``campaign`` section, cells, decisions, phases and exit code, and
    under ``evalue`` its ``evidence`` section, log-wealth within
    tolerance; the same command again prints ``rounds=0``."""
    path = str(tmp_path / "camp.json")
    argv = CLI_CAMPAIGN + ["--verdict-engine", engine, "--ledger",
                           str(tmp_path / "camp.ck"), "--json", path,
                           "--device", "cpu"]
    code = cli.main(argv)
    want = xref["cli"][engine]
    assert code == want["exit_code"] == 0
    with open(path) as f:
        got = json.load(f)
    ref = want["json"]
    assert set(got) == set(ref)
    assert set(got["campaign"]) == set(ref["campaign"])
    for key in ("n_streams", "waves", "span", "phases", "stream_check",
                "survivors", "knockouts", "undecided", "cells"):
        assert got["campaign"][key] == ref["campaign"][key], key
    for key in ("battery", "policy", "backend", "backend_resolved",
                "alpha", "seed", "rounds_run", "workers"):
        assert got[key] == ref[key], key
    if engine == "evalue":
        assert set(got["evidence"]) == set(ref["evidence"])
        assert got["evidence"]["continuations"] == \
            ref["evidence"]["continuations"]
        assert got["evidence"]["threshold"] == ref["evidence"]["threshold"]
        spec = CampaignSpec("smallcrush", ("splitmix64", "pcg32", "randu"),
                            n_streams=2, seed=7, waves=(SCALE,),
                            backend="reference", verdict_engine="evalue")
        campaign = Campaign(PoolSession(device="cpu"), spec)
        campaign.run()
        tol = _log_wealth_tol(campaign, spec.n_cells)
        for a, b, t in zip(got["evidence"]["cells"],
                           ref["evidence"]["cells"], tol):
            assert (a["gen"], a["stream"]) == (b["gen"], b["stream"])
            assert abs(a["log_wealth"] - b["log_wealth"]) <= t
    else:
        assert "evidence" not in got
    capsys.readouterr()
    assert cli.main(argv) == 0
    assert "rounds=0 traces=0" in capsys.readouterr().out


# ---------------------------------------------------------- stitch report

def test_campaign_matrix_and_report():
    dec = [CELL_PASS, CELL_FAIL, CELL_UNDECIDED, CELL_PASS]
    mat = stitch.campaign_matrix(dec, 2, 2)
    assert mat.tolist() == [[1, 2], [0, 1]]
    rep = stitch.campaign_report(["alpha", "beta"], 2, dec,
                                 [1, 0, -1, 2], ["streamcheck", "x1", "x2"])
    assert "P@1" in rep and "F@0" in rep and "?" in rep
    assert "knocked out 1 cell(s)" in rep
    with pytest.raises(ValueError):
        stitch.campaign_matrix(dec, 3, 2)
    assert stitch.demux_positions(["a", "b", "c"], {"t1": [2, 0],
                                                    "t2": [1]}) == \
        {"t1": ["c", "a"], "t2": ["b"]}
