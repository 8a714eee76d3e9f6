"""PyTorch port: the pool's whole-plan runner (``make_batch_runner``) and
the stock-TestU01 baseline (``run_sequential``) against the JAX
reference (run in ``test_torch_reference.py``'s subprocess), and against
the port's own round runner, bitwise."""
import dataclasses

import numpy as np
import pytest

from test_torch_reference import assert_stat_p, run_reference

from repro_torch.core import pool
from repro_torch.core.battery import build_battery
from repro_torch.core.scheduler import make_plan
from repro_torch.launch.mesh import make_pool_mesh
from repro_torch.rng.sources import get_generator

TASK = {"battery": "smallcrush", "scale": 0.0625, "seed": 3,
        "generator": "pcg32"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    (res,) = run_reference([{"kind": "sequential", **TASK}],
                           str(tmp_path_factory.mktemp("ref_seq")))
    return res


@pytest.fixture(scope="module")
def entries():
    return build_battery(TASK["battery"], TASK["scale"], device="cpu")


def _gid():
    return get_generator(TASK["generator"]).gen_id


def test_run_sequential_matches_reference(ref, entries):
    stats, ps = pool.run_sequential(entries, TASK["seed"], _gid(),
                                    device="cpu")
    assert stats.shape == ps.shape == (len(entries),)
    for e in entries:
        assert_stat_p(e.kname, dict(e.params),
                      (ref["stats"][e.index], ref["ps"][e.index]),
                      (stats[e.index], ps[e.index]), e.name)


def test_batch_runner_matches_reference(ref, entries):
    """One worker, the LPT plan: the same plan, and each (round, slot)
    result within tolerance of the reference's."""
    plan = make_plan([e.cost for e in entries], 1, "lpt").assignment
    assert np.asarray(plan).tolist() == ref["plan"]
    runner = pool.make_batch_runner(entries, make_pool_mesh(1, "cpu"))
    stats, ps = runner(plan, TASK["seed"], _gid())
    assert stats.shape == ps.shape == np.asarray(plan).shape
    for (r, w), j in np.ndenumerate(np.asarray(plan)):
        e = entries[int(j)]
        assert_stat_p(e.kname, dict(e.params),
                      (ref["batch_stats"][r, w], ref["batch_ps"][r, w]),
                      (stats[r, w], ps[r, w]), e.name)


def test_batch_runner_equals_round_runner(entries):
    """A whole plan in one call gives bitwise each round's results, idle
    slots (job -1) included."""
    mesh = make_pool_mesh(3, "cpu")
    plan = np.asarray(make_plan([e.cost for e in entries], 3,
                                "lpt").assignment)
    stats, ps = pool.make_batch_runner(entries, mesh)(plan, 5, _gid())
    by_round = pool.make_round_runner(entries, mesh)
    for r, row in enumerate(plan):
        st, pv = by_round(row, 5, _gid())
        np.testing.assert_array_equal(stats[r], st)
        np.testing.assert_array_equal(ps[r], pv)
    seq_st, seq_ps = pool.run_sequential(entries, 5, _gid(), device="cpu")
    for (r, w), j in np.ndenumerate(plan):
        if j >= 0:
            assert (stats[r, w], ps[r, w]) == (seq_st[j], seq_ps[j])


def test_sequential_cache_is_bounded():
    """Equal tables reuse one job function; the cache keeps the newest
    32 tables."""
    pool._SEQ_RUNNERS.clear()
    e = build_battery("smallcrush", 0.0625, device="cpu")[0]
    # 33 structurally different one-test tables (the block length is
    # part of the signature)
    tables = [[dataclasses.replace(e, n_words=e.n_words + k)]
              for k in range(33)]
    for t in tables:
        pool.run_sequential(t, 1, _gid(), device="cpu")
    assert len(pool._SEQ_RUNNERS) == 32
    kept = pool._SEQ_RUNNERS.copy()
    pool.run_sequential([dataclasses.replace(e, n_words=e.n_words + 32)], 1,
                        _gid(), device="cpu")
    assert pool._SEQ_RUNNERS == kept             # a hit: nothing evicted
    pool.run_sequential(tables[0], 1, _gid(), device="cpu")
    assert len(pool._SEQ_RUNNERS) == 32 and pool._SEQ_RUNNERS != kept
