"""Golden-key tests for ``python -m repro_torch.analysis --json``, the
twin of tests/test_analysis_cli.py: the port's gate writes the
reference's report keys, its catalog is the reference's 14 codes and
names, its exit codes are the reference's, and it runs where torch,
numpy, jax, repro and msgpack cannot be imported. Tests write only
under ``tmp_path``."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro.analysis import Project as RefProject
from repro.analysis import run_analysis as ref_run_analysis
from repro.analysis.registry import rules as ref_rules
from repro_torch.analysis import Project, run_analysis
from repro_torch.analysis.registry import rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOP_KEYS = {"version", "strict", "clean", "files_scanned", "rules",
            "findings", "baselined", "suppressed", "stale_baseline",
            "counts"}
RULE_KEYS = {"code", "name", "summary"}
FINDING_KEYS = {"code", "rule", "path", "line", "col", "message"}
COUNT_KEYS = {"findings", "baselined", "suppressed", "stale_baseline",
              "by_code"}
REF_BASELINE = ".repro-analysis-baseline.json"
PORT_BASELINE = ".repro-torch-analysis-baseline.json"


def _run(args, cwd=REPO, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], env=env, cwd=cwd, capture_output=True,
                          text=True, timeout=300)


@pytest.fixture(scope="module")
def strict_report(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("analysis") / "report.json")
    p = _run(["--json", path, "--strict"])
    assert os.path.exists(path), (
        f"analyzer wrote no json report (exit {p.returncode}):\n"
        f"{p.stdout[-2000:]}\n{p.stderr[-2000:]}")
    with open(path) as f:
        return p.returncode, json.load(f)


def test_strict_gate_is_clean(strict_report):
    code, rep = strict_report
    assert code == 0, rep.get("findings")
    assert rep["clean"] is True and rep["strict"] is True
    assert rep["findings"] == [] and rep["stale_baseline"] == []


def test_json_golden_keys(strict_report):
    """The report's keys are the golden ones, which are the reference's
    (its analyzer, in-process, on a fixture with a finding)."""
    _, rep = strict_report
    assert set(rep) == TOP_KEYS
    assert rep["version"] == 1
    assert rep["files_scanned"] > 50
    for rule in rep["rules"]:
        assert set(rule) == RULE_KEYS
    for finding in (rep["findings"] + rep["baselined"]
                    + rep["suppressed"]):
        assert set(finding) == FINDING_KEYS
    assert set(rep["counts"]) == COUNT_KEYS
    src = "import numpy as np\nnp.int64(1)\n"
    ref = ref_run_analysis(RefProject({"src/repro/x.py": src})).to_json()
    port = run_analysis(Project({"src/repro_torch/x.py": src})).to_json()
    assert set(port) == set(ref) == TOP_KEYS
    assert set(port["counts"]) == set(ref["counts"])
    assert {k for r in port["rules"] for k in r} \
        == {k for r in ref["rules"] for k in r}


def test_rule_catalog_is_the_references(strict_report):
    """The reference's 14 codes under the reference's names, in order;
    the summaries say what each checks in the port."""
    _, rep = strict_report
    want = [(r.code, r.name) for r in ref_rules()]
    assert len(want) == 14
    assert [(r.code, r.name) for r in rules()] == want
    assert [(r["code"], r["name"]) for r in rep["rules"]] == want


def test_suppressed_findings_are_reported(strict_report):
    """Suppressions stay visible in the machine report, each on a line
    that carries its noqa."""
    _, rep = strict_report
    assert rep["counts"]["suppressed"] == len(rep["suppressed"]) == 24
    for f in rep["suppressed"]:
        with open(os.path.join(REPO, f["path"])) as src:
            line = src.read().splitlines()[f["line"] - 1]
        assert f"repro: noqa {f['code']}" in line, (f, line)


def test_list_rules_and_exit_codes(tmp_path):
    p = _run(["--list-rules"])
    assert p.returncode == 0
    listed = [line.split()[:2] for line in p.stdout.splitlines()]
    assert listed == [[r.code, r.name] for r in ref_rules()]
    # a root without src/repro_torch is a usage error, not a false pass
    p = _run(["--root", str(tmp_path)])
    assert p.returncode == 2
    assert "src/repro_torch" in p.stderr
    assert os.listdir(tmp_path) == []


def test_imports_without_torch_numpy_jax_repro_or_msgpack():
    """The analyzer is stdlib only: it imports and gates the tree in an
    interpreter where those packages cannot be imported."""
    code = (
        "import sys\n"
        "for name in ('torch', 'numpy', 'jax', 'jaxlib', 'repro', "
        "'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.analysis.cli import main\n"
        "import repro_torch.analysis.rules\n"
        f"rc = main(['--strict', '--root', {REPO!r}])\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'repro', 'msgpack') "
        "and sys.modules[n] is not None)\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src")),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "0 finding(s)" in p.stdout


def test_main_module_import_runs_nothing():
    """``import repro_torch.analysis.__main__`` (what an import walk of
    the package does) neither runs the CLI nor exits."""
    code = ("import repro_torch.analysis.__main__ as m\n"
            "assert callable(m.main)\n"
            "print('imported')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ,
                                PYTHONPATH=os.path.join(REPO, "src")),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout == "imported\n"


def test_write_baseline_leaves_the_references(tmp_path):
    """``--write-baseline`` writes the port's own file; the reference's
    baseline stays byte for byte what it was."""
    shutil.copytree(os.path.join(REPO, "src", "repro_torch"),
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build",
                                                  "golden"))
    shutil.copy(os.path.join(REPO, REF_BASELINE), tmp_path / REF_BASELINE)
    before = (tmp_path / REF_BASELINE).read_bytes()
    p = _run(["--root", str(tmp_path), "--write-baseline"], cwd=tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    assert (tmp_path / REF_BASELINE).read_bytes() == before
    with open(tmp_path / PORT_BASELINE) as f:
        assert json.load(f) == {"findings": [], "version": 1}
    with open(os.path.join(REPO, PORT_BASELINE)) as f:
        assert json.load(f) == {"findings": [], "version": 1}


def test_chip_smoke_holds_the_references_catalog():
    """chip_smoke.py (which imports nothing of the reference) checks the
    gate's report against these keys and rules: they are the
    reference's."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_consts", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.ANALYSIS_KEYS == TOP_KEYS
    assert mod.ANALYSIS_RULES == {r.code: r.name for r in ref_rules()}
