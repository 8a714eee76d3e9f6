"""The port's static-analysis suite (``repro_torch.analysis``, DESIGN.md
§9), the twin of tests/test_analysis.py's three layers, on the CPU and
the standard library only:

  1. every bad fixture in tests/torch_analysis_fixtures/ (the twins of
     the reference's JAX-specific fixtures, RPA1xx, RPA302 and RPA303,
     and the syncs the card showed) fires EXACTLY its rule code, and
     every good fixture fires nothing;
  2. the port's tree is clean under ``--strict`` with the port's (empty)
     baseline, and its inline suppressions are enumerated;
  3. mutation tests on the port's real sources: dropping the resolved
     backend from the session keys fires RPA201 naming ``backend``, an
     unclassified RunSpec field fires RPA202, an unquarantined LM module
     fires RPA501, and histogram bins past a block's shared memory fire
     RPA303;

plus the baseline lifecycle and parity with the reference analyzer on
its 19 JAX-free fixtures (RPA2xx, RPA301, RPA4xx, RPA5xx), read from
tests/analysis_fixtures/ and mounted under ``src/repro_torch``. The
reference's ``repro.analysis`` imports no JAX, so it runs in-process.
"""
import os
import re

import pytest

from repro.analysis import Project as RefProject
from repro.analysis import run_analysis as ref_run_analysis
from repro_torch.analysis import Baseline, Project, run_analysis
from repro_torch.analysis.registry import rules
from repro_torch.analysis.rules.kernels import SMEM_BUDGET_BYTES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_analysis_fixtures")
REF_FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")

# single-file fixtures are mounted here: a src path (so module-name
# mapping works) outside every hot-path module
MOUNT = "src/repro_torch/fixtures/snippet.py"
REF_MOUNT = "src/repro/fixtures/snippet.py"
BASELINE = ".repro-torch-analysis-baseline.json"

# the reference fixtures with no JAX in them: the port's analyzer must
# read them as the reference's does
PARITY_PREFIXES = ("RPA2", "RPA301", "RPA4", "RPA5")


def _entries(root):
    return sorted(n for n in os.listdir(root)
                  if n.endswith(".py")
                  or os.path.isdir(os.path.join(root, n)))


def _read_tree(full):
    files = {}
    for dirpath, _dirs, fnames in os.walk(full):
        for fname in fnames:
            fpath = os.path.join(dirpath, fname)
            rel = os.path.relpath(fpath, full).replace(os.sep, "/")
            with open(fpath, encoding="utf-8") as f:
                files[rel] = f.read()
    return files


def _project_for(name):
    """Mount a torch fixture as a virtual Project (the CLI's code path)."""
    full = os.path.join(FIXTURES, name)
    if os.path.isdir(full):
        return Project(_read_tree(full))
    with open(full, encoding="utf-8") as f:
        return Project({MOUNT: f.read()})


def _codes(name):
    result = run_analysis(_project_for(name))
    assert not result.syntax_errors, f"{name} does not parse"
    return sorted({f.code for f in result.findings})


def _intended(name):
    m = re.match(r"(RPA\d{3})_", name)
    assert m, f"fixture {name!r} must be named RPAnnn_*"
    return m.group(1)


BAD = [n for n in _entries(FIXTURES) if "_bad" in n]
GOOD = [n for n in _entries(FIXTURES) if "_good" in n]
PARITY = [n for n in _entries(REF_FIXTURES)
          if n.startswith(PARITY_PREFIXES)]


def test_corpus_shape():
    """The twins of the reference's 15 JAX-specific fixtures are all
    here, each names a registered code, and the parity set is the
    reference's 19 JAX-free fixtures."""
    twins = {"RPA101_assert_bad.py", "RPA101_bad.py", "RPA101_good.py",
             "RPA102_bad.py", "RPA102_noqa_good.py", "RPA102_np_bad.py",
             "RPA103_bad.py", "RPA103_good.py", "RPA106_bad.py",
             "RPA106_good.py", "RPA302_bad", "RPA302_good", "RPA303_bad",
             "RPA303_good", "RPA303_unbounded_bad"}
    assert twins <= set(BAD + GOOD), sorted(twins - set(BAD + GOOD))
    known = {r.code for r in rules()}
    for n in BAD + GOOD:
        assert _intended(n) in known, n
    assert len(PARITY) == 19, PARITY


@pytest.mark.parametrize("name", BAD)
def test_bad_fixture_fires_exactly_its_code(name):
    assert _codes(name) == [_intended(name)], name


@pytest.mark.parametrize("name", GOOD)
def test_good_fixture_is_clean(name):
    assert _codes(name) == [], name


def test_noqa_fixture_is_suppressed_not_silent():
    """The RPA102 noqa fixture would fire without its suppression."""
    result = run_analysis(_project_for("RPA102_noqa_good.py"))
    assert [f.code for f in result.suppressed] == ["RPA102"]
    src = _project_for("RPA102_noqa_good.py").source(MOUNT)
    stripped = src.replace("  # repro: noqa RPA102", "")
    bare = run_analysis(Project({MOUNT: stripped}))
    assert [f.code for f in bare.findings] == ["RPA102"]


# ---------------------------------------------------------------------------
# parity with the reference analyzer on its JAX-free fixtures

def _to_port(text):
    """``repro.x`` and ``from repro import`` -> the port's package."""
    return re.sub(r"\brepro(?=\.|\s+import\b)", "repro_torch", text)


def _port_project_for(name):
    full = os.path.join(REF_FIXTURES, name)
    if os.path.isdir(full):
        return Project({re.sub(r"^src/repro/", "src/repro_torch/", p):
                        _to_port(s) for p, s in _read_tree(full).items()})
    with open(full, encoding="utf-8") as f:
        return Project({MOUNT: f.read()})


def _ref_project_for(name):
    full = os.path.join(REF_FIXTURES, name)
    if os.path.isdir(full):
        return RefProject(_read_tree(full))
    with open(full, encoding="utf-8") as f:
        return RefProject({REF_MOUNT: f.read()})


@pytest.mark.parametrize("name", PARITY)
def test_reference_fixture_parity(name):
    """The same codes at the same lines (and, for trees, the same
    modules) as the reference's analyzer on the original fixture."""
    def located(result):
        return sorted((f.code, re.sub(r"^src/[^/]+/", "", f.path), f.line)
                      for f in result.findings)
    ref = located(ref_run_analysis(_ref_project_for(name)))
    port = located(run_analysis(_port_project_for(name)))
    assert port == ref, name
    assert bool(ref) == ("_bad" in name), (name, ref)


# ---------------------------------------------------------------------------
# the port's tree: clean modulo the (empty) port baseline

@pytest.fixture(scope="module")
def tree():
    return Project.from_tree(REPO)


def test_port_tree_is_clean_modulo_baseline(tree):
    baseline = Baseline.load(os.path.join(REPO, BASELINE))
    assert baseline.entries == set()
    result = run_analysis(tree, baseline)
    assert result.files_scanned > 50
    assert all(p.startswith("src/repro_torch/") for p in tree.paths())
    assert not result.syntax_errors, result.syntax_errors
    assert result.findings == [], "\n".join(
        str(f) for f in result.findings)
    assert result.clean(strict=True), result.stale_baseline


def test_port_suppressions_are_enumerated(tree):
    """Inline suppressions on the port's tree are listed here, so a new
    one is a conscious decision with a test diff."""
    result = run_analysis(tree)
    suppressed = sorted((f.code, f.path) for f in result.suppressed)
    k = "src/repro_torch/kernels/"
    assert suppressed == sorted(
        [("RPA102", "src/repro_torch/core/pool.py")] * 5
        + [("RPA102", k + "histogram/ref.py"), ("RPA102", k + "mwc/ref.py")]
        + [("RPA102", "src/repro_torch/rng/generators.py")] * 2
        + [("RPA102", "src/repro_torch/stats/special.py")]
        + [("RPA102", "src/repro_torch/stats/tests.py")] * 3
        + [("RPA103", "src/repro_torch/core/pool.py")] * 2
        + [("RPA103", k + "build.py")]
        + [("RPA103", k + "gf2_rank/kernel.py")] * 2
        + [("RPA103", k + "histogram/kernel.py")] * 3
        + [("RPA103", k + "mwc/kernel.py")] * 2
        + [("RPA103", "src/repro_torch/stats/backends.py")])


def test_port_kernels_shared_memory(tree):
    """Every CUDA kernel's shared memory is statically known and fits:
    the numbers chip_smoke.py holds to ptxas and the card."""
    from repro_torch.analysis.rules.kernels import shared_memory
    got = {k.name: (k.static_bytes, k.dynamic, k.total_bytes)
           for k in shared_memory(tree)}
    assert got == {
        "hist_onchip": (16, True, 16 + 4 * 56 * 1024),
        "hist_global": (16, False, 16),
        "gf2_rank32": (4 * 128 * 33, False, 4 * 128 * 33),
        "mwc_words": (0, True, 4 * 128 * 65),
        # the flash-attention directory's launches are bounded by its
        # largest annotation: the backward's 214,784 B (fa_bwd.cuh)
        "fa_fwd": (0, True, 214784),
        "fa_wgmma": (0, True, 214784),
        "fa_bwd_dot": (0, False, 0),
        "fa_bwd_dkdv": (0, True, 214784),
        "fa_bwd_dq": (0, True, 214784),
    }
    assert all(total <= SMEM_BUDGET_BYTES for _, _, total in got.values())


# ---------------------------------------------------------------------------
# mutation tests on the port's real sources

def _mutated(tree, path, pairs):
    files = dict(tree.files)
    src = files[path]
    for old, new in pairs:
        assert old in src, f"mutation anchor drifted in {path}: {old!r}"
        src = src.replace(old, new)
    files[path] = src
    return Project(files)


def test_mutation_dropping_resolved_backend_fires_rpa201(tree):
    """Deleting ``self._backend(spec)`` from both session keys re-opens
    the reference's PR 4 bug class; the rule follows the helper into its
    ``spec.backend`` read on the consumer side, so RPA201 names
    ``backend``."""
    api = "src/repro_torch/core/api.py"
    project = _mutated(tree, api, [
        ("policy.signature(), self._backend(spec))", "policy.signature())"),
        ("policy.signature(),\n                self._backend(spec))",
         "policy.signature())")])
    hits = [f for f in run_analysis(project, codes=["RPA201"]).findings
            if f.path == api]
    assert hits, "RPA201 did not catch the dropped backend key field"
    assert all("backend" in f.message for f in hits)
    assert run_analysis(tree, codes=["RPA201"]).findings == []


def test_mutation_unclassified_runspec_field_fires_rpa202(tree):
    project = _mutated(tree, "src/repro_torch/core/api.py", [
        ("alpha: float = 0.01  # repro: runtime-arg",
         "alpha: float = 0.01")])
    assert any(f.code == "RPA202" and "alpha" in f.message
               for f in run_analysis(project, codes=["RPA202"]).findings)


def test_mutation_unquarantined_lm_module_fires_rpa501(tree):
    path = "src/repro_torch/models/lm.py"
    files = dict(tree.files)
    head, _, rest = files[path].partition("\n")
    assert "repro: quarantine" in head
    files[path] = rest
    result = run_analysis(Project(files), codes=["RPA501"])
    assert [f.path for f in result.findings] == [path]


def test_mutation_histogram_bins_past_shared_memory_fire_rpa303(tree):
    """COPY_MAX_BINS is the histogram launcher's vmem-bound: 1,024 more
    bins take its copies route past a block's opt-in limit."""
    project = _mutated(tree, "src/repro_torch/kernels/histogram/kernel.py",
                       [("COPY_MAX_BINS = 56 * 1024", "COPY_MAX_BINS = "
                                                      "57 * 1024")])
    hits = run_analysis(project, codes=["RPA303"]).findings
    assert [(f.path, "hist_onchip" in f.message) for f in hits] == [
        ("src/repro_torch/kernels/histogram/histogram.cu", True)]
    assert str(16 + 4 * 57 * 1024) in hits[0].message


def test_baseline_grandfathers_then_goes_stale():
    """A baselined finding is not actionable; fixing it strands a stale
    entry that --strict rejects (the baseline may only shrink)."""
    bad = _project_for("RPA103_bad.py")
    first = run_analysis(bad)
    assert len(first.findings) == 1
    baseline = Baseline({f.key() for f in first.findings})
    grandfathered = run_analysis(bad, baseline)
    assert grandfathered.findings == []
    assert len(grandfathered.baselined) == 1
    assert grandfathered.clean(strict=True)
    fixed = run_analysis(_project_for("RPA103_good.py"), baseline)
    assert fixed.findings == []
    assert len(fixed.stale_baseline) == 1
    assert fixed.clean(strict=False)
    assert not fixed.clean(strict=True)
