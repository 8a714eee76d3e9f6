"""PyTorch port: captured bitstreams and the bit-source layer
(``repro_torch.rng.sources``, ``core/pool.py``'s external runner,
``RunSpec.sources`` and the CLI's ``--source``/``--register``) against
the JAX reference, which runs in ``test_torch_reference.py``'s
subprocess (its ``captured``, ``campaign``, ``ckpt`` and ``cli`` tasks).

Transcribes the reference's own cases (``tests/test_sources.py``,
serving left out). Captures, uids, digests, offsets and checkpoint
files are compared bitwise; ``(stat, p)`` of a captured run within
``p_tolerance`` of the reference's and bitwise equal to the port's own
generator run of the same words; verdicts, JSON keys and exit codes
identical.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_reference import REPO, assert_stat_p, run_reference

from repro_torch.core import pool, stitch
from repro_torch.core.api import Checkpoint, PoolSession, RunSpec
from repro_torch.core.battery import build_battery
from repro_torch.launch import battery as cli
from repro_torch.launch.mesh import make_pool_mesh
from repro_torch.rng import generators as G
from repro_torch.rng.sources import (CapturedBitsError, CapturedSource,
                                     GeneratorSource, OffsetNotSupportedError,
                                     capture_generator, counter_based_names,
                                     get_generator, register_generator,
                                     registry_size, require_offsetable,
                                     resolve_source, switch_block,
                                     unregister_generator)

SCALE = 0.0625
SEED = 7
STRIDE = 1 << 15                     # words per captured stream shard
STOP = 4                             # rounds before a checkpoint is cut
# (n_streams, span) and (n_streams, span, n_words): valid grids, the
# largest offsets int64 holds, and each refusal of the reference
STREAM_CASES = [(4, 100), (1, 5), (3, 1 << 40), (2, (1 << 63) - 1),
                (4, 0), (0, 100), (4, 2 ** 62)]
SEAM_CASES = [(3, 1000, 64), (1, 1000, 64), (5, 1 << 20, 1 << 20),
              (3, -64, 64), (3, 1000, 0), (3, 100, 200), (4, 2 ** 62, 64)]


def _spec(src, seed=SEED, **kw):
    kw.setdefault("scale", SCALE)
    kw.setdefault("backend", "reference")
    return RunSpec("smallcrush", sources=(src,), seeds=(seed,), **kw)


def _capture_kw(d):
    return [dict(name="splitmix64", path=str(d / "ref" / "cap.npy"),
                 seed=SEED, n_streams=16, stride=STRIDE),
            dict(name="pcg32", path=str(d / "ref" / "raw.u32"), seed=3,
                 n_streams=1, stride=4096, fmt="u32")]


@pytest.fixture(scope="module")
def xref(tmp_path_factory):
    """The reference's captures, uids, captured runs, checkpoints and
    CLI run, and the port's files those runs read."""
    d = tmp_path_factory.mktemp("sources")
    (d / "ref").mkdir()
    # the port's capture (byte-equal to the reference's, tested below)
    # and a checkpoint of the port's run over it, cut after STOP rounds
    port_cap = capture_generator("splitmix64", str(d / "cap.npy"),
                                 seed=SEED, n_streams=16, stride=STRIDE,
                                 device="cpu")
    port_ck = str(d / "port.ck")
    handle = PoolSession(device="cpu").submit(
        _spec(f"file:{port_cap}", checkpoint_path=port_ck))
    for _ in range(STOP):
        handle.poll()
    shutil.copy(port_ck, str(d / "port_copy.ck"))
    ref_cap = str(d / "ref" / "cap.npy")
    ref_spec = {"battery": "smallcrush", "sources": [f"file:{ref_cap}"],
                "seeds": [SEED], "scale": SCALE, "backend": "reference"}
    mixed_json = str(d / "mixed_ref.json")
    tasks = [
        {"kind": "captured", "captures": _capture_kw(d),
         "sources": [f"file:{ref_cap}", f"file:{d / 'ref' / 'raw.u32'}:u32",
                     f"file:{ref_cap}:npy"]},
        {"kind": "ckpt", "runs": [
            {"spec": ref_spec, "path": None, "rounds": None},
            {"spec": ref_spec, "path": str(d / "ref.ck"), "rounds": STOP},
            {"spec": ref_spec, "path": str(d / "port_copy.ck"),
             "rounds": None}],
         "load": [port_ck]},
        {"kind": "cli", "argv": ["--battery", "smallcrush", "--gen", "randu",
                                 "--source", f"file:{ref_cap}", "--scale",
                                 str(SCALE), "--seed", str(SEED),
                                 "--backend", "reference", "--json",
                                 mixed_json]},
        {"kind": "campaign", "offsets": (
            [["stream", list(c)] for c in STREAM_CASES]
            + [["seam", list(c)] for c in SEAM_CASES])},
    ]
    captured, ckpt, mixed, offsets = run_reference(tasks, str(d / "out"))
    with open(mixed_json) as f:
        mixed["json"] = json.load(f)
    return {"dir": d, "port_cap": port_cap, "port_ck": port_ck,
            "ref_cap": ref_cap, "captured": captured, "ckpt": ckpt,
            "mixed": mixed, "offsets": offsets["offsets"]}


# ------------------------------------------------------------ offsets

@pytest.mark.parametrize("case", range(len(STREAM_CASES)))
def test_stream_offsets_equal_reference(xref, case):
    """``stream_offsets`` gives the reference's int64 offsets, or raises
    the reference's refusal (overflow, span, stream count)."""
    want = xref["offsets"][case]
    if "error" in want:
        with pytest.raises(ValueError) as exc:
            G.stream_offsets(*STREAM_CASES[case])
        assert str(exc.value) == want["error"]
    else:
        got = G.stream_offsets(*STREAM_CASES[case])
        assert got.dtype == np.int64 and got.tolist() == want["value"]


@pytest.mark.parametrize("case", range(len(SEAM_CASES)))
def test_seam_offsets_equal_reference(xref, case):
    want = xref["offsets"][len(STREAM_CASES) + case]
    if "error" in want:
        with pytest.raises(ValueError) as exc:
            G.seam_offsets(*SEAM_CASES[case])
        assert str(exc.value) == want["error"]
    else:
        got = G.seam_offsets(*SEAM_CASES[case])
        assert got.dtype == np.int64 and got.tolist() == want["value"]


@pytest.mark.parametrize("name", counter_based_names())
def test_block_offset_continuation(name):
    """A block at offset o is words [o, o+n) of a longer block, and two
    halves concatenate to the whole, for every counter-based generator
    (``switch_block``'s offset path; an offset of 0 is no offset)."""
    gid = get_generator(name).gen_id
    whole = switch_block(gid, SEED, 3, 700, None, device="cpu")
    assert torch.equal(switch_block(gid, SEED, 3, 700, 0, device="cpu"),
                       whole)
    assert torch.equal(switch_block(gid, SEED, 3, 200, 300, device="cpu"),
                       whole[300:500])
    head = switch_block(gid, SEED, 3, 350, None, device="cpu")
    tail = switch_block(gid, SEED, 3, 350, 350, device="cpu")
    assert torch.equal(torch.cat([head, tail]), whole)


def test_offset_convention_single_gate():
    """None and 0 pass the gate; a non-zero offset on mwc raises the same
    typed error from the gate, ``RunSpec`` and ``switch_block``."""
    mwc = GeneratorSource("mwc")
    require_offsetable(mwc, None)
    require_offsetable(mwc, 0)
    with pytest.raises(OffsetNotSupportedError):
        require_offsetable(mwc, 64)
    assert issubclass(OffsetNotSupportedError, ValueError)
    with pytest.raises(OffsetNotSupportedError):
        RunSpec("smallcrush", "mwc", seeds=(SEED,), scale=SCALE, offsets=64)
    with pytest.raises(OffsetNotSupportedError):
        switch_block(mwc.gen_id, SEED, 0, 8, 64, device="cpu")
    assert switch_block(mwc.gen_id, SEED, 0, 8, 0, device="cpu").shape == (8,)


# ------------------------------------------------------------ registry

def test_resolve_source_grammar(xref, tmp_path):
    src = resolve_source("splitmix64")
    assert isinstance(src, GeneratorSource) and not src.captured
    assert resolve_source(src) is src
    cap = resolve_source(f"file:{xref['port_cap']}")
    assert isinstance(cap, CapturedSource) and cap.captured
    assert cap.fmt == "npy" and cap.name == "cap:cap"
    assert (cap.n_streams, cap.stride) == (16, STRIDE)
    raw_path = str(tmp_path / "bits.dat")
    np.arange(8, dtype="<u4").tofile(raw_path)
    raw = resolve_source(f"file:{raw_path}:u32")
    assert isinstance(raw, CapturedSource) and raw.fmt == "u32"
    assert resolve_source(f"file:{raw_path}") == raw     # u32 by suffix
    with pytest.raises(FileNotFoundError):      # a bad suffix is path
        resolve_source(f"file:{xref['port_cap']}:bogus")
    with pytest.raises(TypeError):
        resolve_source(123)
    bad = str(tmp_path / "wide.npy")
    np.save(bad, np.zeros(4, np.uint64))
    with pytest.raises(ValueError, match="uint32"):
        CapturedSource(bad)


def test_counter_based_names_and_registry_order():
    """The built-ins in the reference's order; every one but mwc is
    counter-based, as the reference's registry says."""
    assert counter_based_names() == tuple(
        n for n in G.GENERATORS if n != "mwc")
    assert registry_size() == len(G.GENERATORS) == 9
    assert [get_generator(n).gen_id for n in G.GENERATORS] == list(range(9))


def test_duplicate_registration_is_hard_error():
    with pytest.raises(ValueError, match="already registered"):
        register_generator("splitmix64", G.splitmix64_block,
                           counter_based=True)
    with pytest.raises(TypeError):              # the declaration is required
        register_generator("nodecl", G.splitmix64_block)


def test_unregister_only_pops_the_last_lane():
    register_generator("tail_a", G.splitmix64_block, counter_based=True)
    register_generator("tail_b", G.splitmix64_block, counter_based=True)
    try:
        with pytest.raises(ValueError, match="most recently"):
            unregister_generator("tail_a")
    finally:
        unregister_generator("tail_b")
        unregister_generator("tail_a")
    with pytest.raises(KeyError):
        unregister_generator("tail_a")
    assert registry_size() == 9


def test_registered_generator_adds_one_runner():
    """A generator registered after a runner was built needs a wider
    registry: exactly one more runner; the built-in lanes keep theirs."""
    session = PoolSession(device="cpu")
    base = session.submit(_spec("splitmix64")).result()
    t0 = session.total_traces
    session.submit(_spec("pcg32")).result()
    assert session.total_traces == t0
    register_generator("ext_sm64", G.splitmix64_block, counter_based=True)
    try:
        ext = session.submit(_spec("ext_sm64")).result()
        assert session.total_traces == t0 + 1
        assert ext.results == base.results      # a clone of splitmix64
        session.submit(_spec("lcg64")).result()
        assert session.total_traces == t0 + 1
    finally:
        unregister_generator("ext_sm64")
    with pytest.raises(KeyError, match="re-registered"):
        _spec("ext_sm64")


# ------------------------------------------------------------ captures

@pytest.mark.parametrize("which", [0, 1])
def test_capture_is_byte_equal_to_reference(xref, which, tmp_path):
    """``capture_generator`` writes the reference's file, byte for byte:
    a 16-shard ``.npy`` of splitmix64 and a raw u32 stream of pcg32."""
    kw = dict(_capture_kw(xref["dir"])[which])
    ref_path = kw.pop("path")
    ours = capture_generator(path=str(tmp_path / os.path.basename(ref_path)),
                             device="cpu", **kw)
    with open(ours, "rb") as a, open(ref_path, "rb") as b:
        assert a.read() == b.read()


def test_uids_and_digests_equal_reference(xref):
    """Name, uid, digest, format and shape of each capture, as the
    reference reads them (a byte-equal file under the same stem has the
    same uid in both packages)."""
    d = xref["dir"]
    specs = [f"file:{xref['ref_cap']}", f"file:{d / 'ref' / 'raw.u32'}:u32",
             f"file:{xref['ref_cap']}:npy"]
    for spec, want in zip(specs, xref["captured"]["sources"]):
        src = resolve_source(spec)
        assert {"name": src.name, "uid": src.uid(), "digest": src.digest(),
                "fmt": src.fmt, "n_streams": src.n_streams,
                "stride": src.stride} == want
        assert want["uid"] == f"{want['name']}:{want['digest'][:16]}"
    assert resolve_source(f"file:{xref['port_cap']}").uid() == \
        xref["captured"]["sources"][0]["uid"]


def test_digest_follows_the_file_content(tmp_path):
    """The digest is cached per (size, mtime) and follows a rewrite."""
    path = str(tmp_path / "c.npy")
    np.save(path, np.arange(64, dtype=np.uint32))
    src = CapturedSource(path)
    first = src.digest()
    assert src.digest() == first
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))
    os.utime(path, ns=(1, 1))
    assert src.digest() != first


def test_captured_bounds_errors_are_typed(tmp_path):
    path = str(tmp_path / "tiny.npy")
    np.save(path, np.arange(8, dtype=np.uint32).reshape(2, 4))
    src = CapturedSource(path)
    np.testing.assert_array_equal(src.block(0, 1, 4, None, device="cpu"),
                                  np.arange(4, 8))
    with pytest.raises(CapturedBitsError, match="stream 0"):
        src.block(0, 0, 5, None, device="cpu")  # word range past the shard
    with pytest.raises(CapturedBitsError, match="stream 2"):
        src.block(0, 2, 1, None, device="cpu")  # shard index out of range
    raw = str(tmp_path / "words.u32")
    np.arange(16, dtype="<u4").tofile(raw)
    u32 = CapturedSource(raw, "u32")
    np.testing.assert_array_equal(u32.block(0, 0, 4, 4, device="cpu"),
                                  np.arange(4, 8))
    with pytest.raises(CapturedBitsError, match="stream 1"):
        u32.block(0, 1, 4, None, device="cpu")  # raw u32 is one stream
    assert issubclass(CapturedBitsError, ValueError)


def test_captured_words_keep_their_unsigned_value(tmp_path):
    """Words at or above 2^31 reach the kernels as the same unsigned
    value (zero extension of the 4-byte copy), through ``block`` and
    through the round's gather and the external runner."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(2, 1 << 16), dtype=np.uint64)
    words[0, :4] = [0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 0]
    words = words.astype(np.uint32)
    path = str(tmp_path / "top.npy")
    np.save(path, words)
    src = CapturedSource(path)
    got = src.block(0, 0, 1 << 16, device="cpu")
    assert got.dtype == torch.int64
    assert got.tolist() == words[0].astype(np.int64).tolist()
    assert int((got >= 1 << 31).sum()) > 1 << 14
    seen = []

    def record(bits):
        seen.append(bits.clone())
        return 0.0, 0.5
    entries = [dataclasses.replace(e, kernel=record)
               for e in build_battery("smallcrush", SCALE, device="cpu")[:2]]
    bits = pool.gather_captured_bits(entries, [0, 1], [(src, 0, 0)])
    pool.make_external_runner(entries, make_pool_mesh(2, "cpu"))([0, 1],
                                                                bits)
    assert len(seen) == 2
    for e, b in zip(entries, seen):
        nb = pool.word_bucket(e.n_words)
        assert b.dtype == torch.int64 and b.shape == (nb,)
        assert b.tolist() == words[e.index, :nb].astype(np.int64).tolist()


def test_gather_mirrors_the_job_function(xref):
    """Each slot's block is its job's bucket from its stream id, idle
    slots read nothing, and a repeated lane is read once."""
    src = resolve_source(f"file:{xref['port_cap']}")
    entries = build_battery("smallcrush", SCALE, device="cpu")
    sizes, bids = pool.bucket_table(entries)
    row = [3, -1, 7]
    bits = pool.gather_captured_bits(entries, row, [(src, 1, 64),
                                                    (src, 2, 64),
                                                    (src, 1, 128)])
    assert bits.lane_of == [0, 0, 1]            # the seed is ignored
    assert len(bits.spans) == 2 and bits.spans[0][1] is None
    for u, off in ((0, 64), (1, 128)):
        for j, span in zip(row, bits.spans[u]):
            if j < 0:
                continue
            start, nb = span
            assert nb == sizes[bids[j]]
            want = src.words(pool.stream_table(entries)[j], nb, off)
            got = bits.words[start:start + nb].numpy().view(np.uint32)
            np.testing.assert_array_equal(got, want)
    assert bits.nbytes == 4 * 2 * sum(sizes[bids[j]] for j in row if j >= 0)


# ------------------------------------------------------------ runs

def test_captured_battery_bitwise_equals_generator(xref):
    """A capture of splitmix64's words scores the generator's (stat, p)
    bit for bit, alone and beside a generator position."""
    session = PoolSession(device="cpu")
    gen = session.submit(_spec("splitmix64")).result()
    cap = session.submit(_spec(f"file:{xref['port_cap']}")).result()
    assert cap.results == gen.results
    assert cap.verdict.decision == gen.verdict.decision == stitch.PASS
    mixed = session.submit(RunSpec(
        "smallcrush", sources=("randu", f"file:{xref['port_cap']}"),
        seeds=(SEED,), scale=SCALE, backend="reference")).result()
    assert mixed.runs["cap:cap"].results == gen.results
    assert mixed.runs["randu"].verdict.decision == stitch.FAIL


def test_captured_battery_at_offsets_equals_grid_runner(xref):
    """Sub-stream offsets read the same words from a capture as from the
    generator: the external runner and the grid runner agree bitwise."""
    session = PoolSession(device="cpu")
    for off in (0, 1 << 12):
        gen = session.submit(_spec("splitmix64", offsets=(off,))).result()
        cap = session.submit(_spec(f"file:{xref['port_cap']}",
                                   offsets=(off,))).result()
        assert cap.results == gen.results, off


def test_captured_battery_matches_reference(xref):
    """The port's captured SmallCrush x0.0625 against the reference's:
    (stat, p) within p_tolerance, the same verdict."""
    res = PoolSession(device="cpu").submit(
        _spec(f"file:{xref['ref_cap']}")).result()
    want = xref["ckpt"]["runs"][0]
    entries = build_battery("smallcrush", SCALE, device="cpu")
    assert {int(k) for k in want["results"]["cap:cap"]} == set(res.results)
    for k, (s_ref, p_ref) in want["results"]["cap:cap"].items():
        e = entries[int(k)]
        assert_stat_p(e.kname, dict(e.params), (s_ref, p_ref),
                      res.results[int(k)], e.name)
    assert res.verdict.decision == want["verdicts"]["cap:cap"]


def test_mixed_cli_matches_reference(xref, tmp_path, capsys):
    """``--gen randu --source file:...``: the same JSON keys (``sources``
    included), uids, verdicts and exit code as the reference's CLI."""
    path = str(tmp_path / "mixed.json")
    code = cli.main(["--battery", "smallcrush", "--gen", "randu", "--source",
                     f"file:{xref['ref_cap']}", "--scale", str(SCALE),
                     "--seed", str(SEED), "--backend", "reference",
                     "--json", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "captured_rounds=" in out and "h2d_bytes=" in out
    with open(path) as f:
        got = json.load(f)
    want = xref["mixed"]["json"]
    assert code == xref["mixed"]["exit_code"] == 1
    assert set(got) == set(want)
    assert got["sources"] == want["sources"]
    assert got["sources"][0]["uid"].startswith("cap:cap:")
    for gen in ("randu", "cap:cap"):
        for key in ("verdict", "tests_checked", "failed_tests", "suspects"):
            assert got["runs"][gen][key] == want["runs"][gen][key], (gen, key)
        assert set(got["runs"][gen]) == set(want["runs"][gen])


# ------------------------------------------------------------ checkpoints

def test_reference_captured_checkpoint_resumes_in_port(xref, tmp_path):
    """The reference's v5 file of a captured run (uid ``cap:...``) resumes
    in the port against the port's byte-equal capture of the same stem:
    only the missing jobs run, and the result is the uninterrupted
    reference run's."""
    path = str(tmp_path / "from_ref.ck")
    shutil.copy(str(xref["dir"] / "ref.ck"), path)
    ck = Checkpoint.load(path)
    assert [u.decode() for u in ck.source_uids] == [
        xref["captured"]["sources"][0]["uid"]]
    handle = PoolSession(device="cpu").submit(
        _spec(f"file:{xref['port_cap']}", checkpoint_path=path))
    assert handle.status()["jobs_done"] == STOP
    res = handle.result()
    assert res.rounds_run == 10 - STOP
    entries = build_battery("smallcrush", SCALE, device="cpu")
    for k, (s_ref, p_ref) in xref["ckpt"]["runs"][0]["results"][
            "cap:cap"].items():
        e = entries[int(k)]
        assert_stat_p(e.kname, dict(e.params), (s_ref, p_ref),
                      res.results[int(k)], e.name)


def test_port_captured_checkpoint_resumes_in_reference(xref):
    """The port's file loads alike in the reference (uid included), and
    the reference resumed it: only the missing jobs ran."""
    loaded = xref["ckpt"]["loads"][0]
    ck = Checkpoint.load(xref["port_ck"])
    assert loaded["source_uids"] == [u.decode() for u in ck.source_uids]
    assert loaded["job_idx"].tolist() == ck.job_idx.tolist()
    assert loaded["rounds_run"] == ck.rounds_run
    resumed = xref["ckpt"]["runs"][2]
    assert resumed["jobs_done_at_submit"] == STOP
    assert resumed["rounds_run"] == 10 - STOP
    assert resumed["verdicts"] == {"cap:cap": "PASS"}


def test_checkpoint_refuses_a_modified_copy(xref, tmp_path):
    """A checkpoint written against one capture refuses a copy of it with
    one byte changed, under the same stem: its own file and the
    reference's."""
    mod_dir = tmp_path / "mod"
    mod_dir.mkdir()
    mod = str(mod_dir / "cap.npy")
    data = bytearray(open(xref["port_cap"], "rb").read())
    data[-1] ^= 0xFF
    with open(mod, "wb") as f:
        f.write(bytes(data))
    for src_ck in (xref["port_ck"], str(xref["dir"] / "ref.ck")):
        ck = str(tmp_path / "run.ck")
        shutil.copy(src_ck, ck)
        with pytest.raises(ValueError, match="re-captured"):
            PoolSession(device="cpu").submit(
                _spec(f"file:{mod}", checkpoint_path=ck))


# ------------------------------------------------------------ CLI hooks

def register_clone():
    """A ``--register`` hook: splitmix64's torch block function under a
    new name."""
    register_generator("hooked_sm64", G.splitmix64_block,
                       counter_based=True)


def test_register_hook_with_a_torch_generator(tmp_path, capsys):
    """``--register MOD:FN`` runs the hook before names resolve, so its
    generator is a ``--gen`` name; its results are splitmix64's."""
    args = ["--battery", "smallcrush", "--scale", str(SCALE), "--seed",
            str(SEED), "--backend", "reference", "--device", "cpu"]
    try:
        code = cli.main(args + ["--gen", "hooked_sm64", "--register",
                                "test_torch_sources:register_clone",
                                "--json", str(tmp_path / "a.json")])
    finally:
        unregister_generator("hooked_sm64")
    assert code == 0
    cli.main(args + ["--json", str(tmp_path / "b.json")])
    with open(tmp_path / "a.json") as f:
        a = json.load(f)["runs"]["hooked_sm64"]["tests"]
    with open(tmp_path / "b.json") as f:
        b = json.load(f)["runs"]["splitmix64"]["tests"]
    assert a == b
    for bad in ("nocolon", "no_such_module_x:fn",
                "test_torch_sources:no_such_fn"):
        with pytest.raises(SystemExit) as exc:
            cli.main(args + ["--register", bad])
        assert exc.value.code == 2, bad
    capsys.readouterr()


def test_port_and_chip_scripts_import_no_jax_repro_or_msgpack():
    """Every module of repro_torch and every chip_*.py script imports,
    in a fresh interpreter where jax, jaxlib, repro and msgpack cannot
    be imported at all."""
    code = (
        "import glob, importlib, importlib.util, os, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "sys.path[:0] = ['src', 'tests']\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "scripts = sorted(glob.glob('chip_*.py'))\n"
        "assert 'chip_smoke.py' in scripts, scripts\n"
        "for path in scripts:\n"
        "    spec = importlib.util.spec_from_file_location("
        "'s_' + os.path.basename(path)[:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(scripts)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_run_on_the_card_equals_the_generator(cuda, tmp_path):
    """On the card, with the kernels: a capture written by the card's
    generator scores the generator's (stat, p) bit for bit."""
    path = capture_generator("splitmix64", str(tmp_path / "cap.npy"),
                             seed=SEED, n_streams=16, stride=STRIDE)
    session = PoolSession(device=cuda)
    kw = dict(backend="accelerated")
    gen = session.submit(_spec("splitmix64", **kw)).result()
    handle = session.submit(_spec(f"file:{path}", **kw))
    cap = handle.result()
    assert cap.results == gen.results
    assert handle.captured_rounds == 10 and handle.bytes_to_device > 0
