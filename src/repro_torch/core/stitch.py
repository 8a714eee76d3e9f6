"""superstitch: fold per-(round, worker) results into the battery
report, the Bonferroni-sequential verdict engine, the registry of
verdict engines, and a campaign's decision matrix and report
(``repro/core/stitch.py``).

Over-decomposed tests are folded back per group (Stouffer or Fisher);
suspicious p-values are flagged with TestU01's two-sided convention.
``sequential_verdict`` is valid at every interim look, which is what
lets the adaptive policy cancel a failed generator after any round;
``VERDICT_ENGINES`` names it and the e-value engine
(``core/evidence.py``) that ``RunSpec.verdict_engine`` picks from."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
from scipy import special as sps

from repro_torch.core import evidence


SUSPECT_P = 1e-4
_P_FLOOR = 1e-15


def combine_stouffer(ps) -> tuple:
    """(stat, p): Z = sum(Phi^-1(1-p_i)) / sqrt(m), p = 1 - Phi(Z).
    Direction-preserving — p near 0 AND p near 1 both survive the fold,
    which the two-sided suspect rule needs."""
    ps = np.clip(np.asarray(ps, np.float64), _P_FLOOR, 1.0 - 1e-12)
    z = sps.ndtri(1.0 - ps)
    stat = float(z.sum() / np.sqrt(len(ps)))
    return stat, float(sps.ndtr(-stat))


def combine_fisher(ps) -> tuple:
    """(stat, p): stat = -2 sum(ln p_i) ~ chi2_{2m}; small-p sensitive."""
    ps = np.clip(np.asarray(ps, np.float64), _P_FLOOR, 1.0)
    stat = float(-2.0 * np.log(ps).sum())
    return stat, float(sps.gammaincc(len(ps), stat / 2.0))


COMBINERS = {"stouffer": combine_stouffer, "fisher": combine_fisher}


def fold(plan_assignment: np.ndarray, stats: np.ndarray, ps: np.ndarray,
         results: Dict[int, tuple] | None = None) -> Dict[int, tuple]:
    """Merge one round-set into {test_index: (stat, p)}."""
    results = dict(results or {})
    a = np.asarray(plan_assignment)
    for (r, w), idx in np.ndenumerate(a):
        if idx >= 0:
            results[int(idx)] = (float(stats[r, w]), float(ps[r, w]))
    return results


def missing(results: Dict[int, tuple], n_tests: int) -> List[int]:
    """Jobs with no / invalid results -> the HELD set (paper: condor hold)."""
    out = []
    for i in range(n_tests):
        if i not in results:
            out.append(i)
            continue
        stat, p = results[i]
        if not (np.isfinite(stat) and np.isfinite(p) and 0.0 <= p <= 1.0):
            out.append(i)
    return out


def fold_groups(job_results: Dict[int, tuple], jobs,
                combine: str = "stouffer") -> Dict[int, tuple]:
    """Map job-space results back to test-space: {entry.group: (stat, p)}.

    Unsplit jobs pass through untouched (bitwise — no combine applied), so
    non-decomposing policies see exactly the classic fold. A group with any
    missing/invalid sub-result stays missing (the whole test is HELD)."""
    groups: Dict[int, list] = {}
    for j in jobs:
        groups.setdefault(j.group, []).append(j)
    fold_fn = COMBINERS[combine]
    out: Dict[int, tuple] = {}
    for g, js in groups.items():
        if len(js) == 1 and js[0].n_parts == 1:
            if js[0].index in job_results:
                out[g] = job_results[js[0].index]
            continue
        ps = []
        ok = True
        for j in sorted(js, key=lambda j: j.part):
            sp = job_results.get(j.index)
            if sp is None or not np.isfinite(sp[1]):
                ok = False
                break
            ps.append(sp[1])
        if ok:
            out[g] = fold_fn(ps)
    return out


def demux_positions(per_position, groups: Dict) -> Dict:
    """Split a merged multi-generator dispatch by member: ``groups`` maps
    each member to the positions its own spec contributed, and the
    result maps it to ``[per_position[p] for p in its positions]``."""
    return {member: [per_position[int(p)] for p in positions]
            for member, positions in groups.items()}


# ---------------------------------------------------------------------------
# sequential verdict engine (adaptive early stopping, DESIGN.md §4)

PASS, FAIL, UNDECIDED = "PASS", "FAIL", "UNDECIDED"


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Outcome of one interim (or final) look at a generator's results.

    ``decision`` is FAIL the moment any completed test crosses the
    Bonferroni boundary, PASS only once every test has completed without
    a crossing, UNDECIDED otherwise. ``threshold`` is the per-test,
    per-tail rejection boundary actually applied."""
    decision: str                   # PASS | FAIL | UNDECIDED
    alpha: float                    # configured family-wise error rate
    threshold: float                # per-test per-tail boundary
    n_checked: int                  # tests with a valid result so far
    n_total: int                    # battery size (test space)
    failed_tests: Tuple[int, ...]   # test indices past the boundary

    @property
    def decided(self) -> bool:
        """True once the decision is PASS or FAIL (never revisited)."""
        return self.decision != UNDECIDED

    def __str__(self):
        return (f"{self.decision} (alpha={self.alpha:g}, "
                f"{self.n_checked}/{self.n_total} tests checked, "
                f"{len(self.failed_tests)} past boundary)")


def sequential_verdict(results: Dict[int, tuple], n_total: int,
                       alpha: float = 0.01) -> Verdict:
    """Interim verdict over the completed subset of an ``n_total``-test
    battery, valid after every round.

    The spending rule is Bonferroni-sequential: each of the ``n_total``
    tests is granted ``alpha / n_total`` of the family-wise budget
    (``alpha / 2n`` per tail — TestU01's suspect rule is two-sided), and
    a test's share is spent when its result lands, in whatever order the
    schedule delivers it. Because every test's boundary is fixed up
    front, the rejection decision is invariant to execution order and to
    WHEN you look — stopping at the first crossing spends exactly the
    budget of the tests examined so far, so the false-FAIL rate of the
    stopped battery is bounded by ``alpha`` regardless of how the
    adaptive policy reorders or truncates the schedule."""
    if n_total <= 0:
        raise ValueError("n_total must be positive")
    thr = alpha / (2.0 * n_total)
    failed = []
    n_checked = 0
    for i, (stat, p) in results.items():
        if not (np.isfinite(p) and 0.0 <= p <= 1.0):
            continue
        n_checked += 1
        if p < thr or p > 1.0 - thr:
            failed.append(int(i))
    if failed:
        decision = FAIL
    elif n_checked >= n_total:
        decision = PASS
    else:
        decision = UNDECIDED
    return Verdict(decision, float(alpha), float(thr), n_checked,
                   int(n_total), tuple(sorted(failed)))


# Re-exported so the verdict surface lives in one module: the e-value
# engine itself is implemented in repro_torch.core.evidence.
EvidenceVerdict = evidence.EvidenceVerdict
evidence_verdict = evidence.evidence_verdict
VerdictEngineMismatch = evidence.VerdictEngineMismatch

#: The verdict engines ``RunSpec(verdict_engine=...)`` selects from. Every
#: engine shares the ``(results, n_total, alpha=...)`` call shape and
#: returns a Verdict-shaped object (``decision`` / ``decided`` /
#: ``n_checked`` / ``failed_tests``).
VERDICT_ENGINES = {
    "bonferroni": sequential_verdict,
    "evalue": evidence_verdict,
}


def verdict_for(engine: str):
    """The verdict engine callable registered under ``engine``; raises
    ``KeyError`` naming the known engines for anything else."""
    try:
        return VERDICT_ENGINES[engine]
    except KeyError:
        raise KeyError(f"unknown verdict engine {engine!r}; known: "
                       f"{sorted(VERDICT_ENGINES)}") from None


# ---------------------------------------------------------------------------
# campaign matrix + summary report (DESIGN.md §8)

_CELL_GLYPH = {0: "?", 1: "P", 2: "F"}     # api.CELL_UNDECIDED/PASS/FAIL


def campaign_matrix(decisions, n_generators: int,
                    n_streams: int) -> np.ndarray:
    """The cell-ordered decision vector as the (generators, streams)
    matrix (cell order is generator-major, as ``CampaignSpec.cells``)."""
    d = np.asarray(decisions, np.int8)
    if d.size != n_generators * n_streams:
        raise ValueError(f"{d.size} cell decisions for a "
                         f"{n_generators} x {n_streams} grid")
    return d.reshape(n_generators, n_streams)


def campaign_report(generators, n_streams: int, decisions,
                    decided_phase, phase_names) -> str:
    """The campaign's superstitch: the PASS/FAIL/UNDECIDED matrix (rows
    generators, columns sub-streams; a decided cell shows its glyph and
    the phase that decided it) and the knockouts per phase."""
    generators = list(generators)
    mat = campaign_matrix(decisions, len(generators), n_streams)
    phase = np.asarray(decided_phase, np.int8).reshape(len(generators),
                                                      n_streams)
    lines = [
        "========= campaign screening matrix =========",
        f"grid: {len(generators)} generator(s) x {n_streams} stream(s)   "
        f"phases: {', '.join(phase_names)}",
        "-" * 46,
        "generator      | " + " ".join(f"s{s:<3d}" for s in range(n_streams)),
    ]
    for g, gen in enumerate(generators):
        cells = []
        for s in range(n_streams):
            glyph = _CELL_GLYPH[int(mat[g, s])]
            tag = f"{glyph}@{int(phase[g, s])}" if mat[g, s] else f"{glyph}  "
            cells.append(f"{tag:4s}")
        lines.append(f"{gen:14s} | " + " ".join(cells))
    lines.append("-" * 46)
    n_pass = int(np.sum(mat == 1))
    n_fail = int(np.sum(mat == 2))
    n_open = int(np.sum(mat == 0))
    lines.append(f"cells: {mat.size}  pass: {n_pass}  fail: {n_fail}  "
                 f"undecided: {n_open}")
    for p, name in enumerate(phase_names):
        knocked = int(np.sum((phase == p) & (mat == 2)))
        if knocked:
            lines.append(f"  phase {p} ({name}): knocked out {knocked} "
                         f"cell(s)")
    return "\n".join(lines)


def report(entries, results: Dict[int, tuple], gen_name: str,
           seed: int) -> str:
    """The classic battery text report: one line per test with its
    (stat, p), MISSING/HELD and SUSPECT flags (TestU01's two-sided
    convention), and the suspect-count verdict footer."""
    lines = [
        "========= CondorJAX battery results =========",
        f"generator: {gen_name}    seed: {seed}",
        f"tests: {len(entries)}",
        "-" * 46,
    ]
    n_suspect = 0
    for e in entries:
        stat, p = results.get(e.index, (float("nan"), float("nan")))
        flag = ""
        if not np.isfinite(p):
            flag = "   <-- MISSING/HELD"
        elif p < SUSPECT_P or p > 1 - SUSPECT_P:
            flag = "   <-- SUSPECT"
            n_suspect += 1
        lines.append(f"[{e.index:3d}] {e.name:32s} stat={stat:12.4f} "
                     f"p={p:10.3e}{flag}")
    lines.append("-" * 46)
    lines.append(f"suspect p-values: {n_suspect} "
                 f"({'FAIL' if n_suspect else 'pass'})")
    return "\n".join(lines)
