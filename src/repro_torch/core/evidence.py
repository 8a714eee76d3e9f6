"""Anytime-valid e-value verdicts: calibrators, wealth, and the
``evalue`` verdict engine (DESIGN.md §13), transcribed whole from
``repro/core/evidence.py`` (the port imports nothing of the reference).

The Bonferroni-sequential engine in :mod:`repro_torch.core.stitch`
splits its error budget up front and can only answer PASS/FAIL/UNDECIDED against a
fixed p-value boundary.  This module implements the second engine the
battery/campaign stack can select via ``RunSpec(verdict_engine=...)``:
each test's p-value is *calibrated* into an e-value (a nonnegative
statistic with expectation at most 1 under the null), e-values multiply
into a battery-level wealth process, and by Ville's inequality

    P( sup_t  W_t >= 1/alpha )  <=  alpha

rejecting whenever wealth crosses ``1/alpha`` is valid at every data-
independent stopping time — and stays valid if a borderline campaign
cell is *re-opened* later (optional continuation), which the Bonferroni
engine cannot offer.

Two calibrator families are provided:

* the power family ``e_kappa(p) = kappa * p**(kappa - 1)`` for
  ``kappa`` in (0, 1), and
* the mixture calibrator ``F(p) = (1 - p + p*ln p) / (p * (ln p)**2)``,
  the closed form of ``integral_0^1 e_kappa(p) dkappa``, which needs no
  tuning parameter and dominates every single ``kappa`` up to a
  logarithmic factor.

Battery p-values follow TestU01's two-sided suspect rule, so raw
p-values are folded through :func:`two_sided_p` before calibration —
``min(1, 2*min(p, 1-p))`` is exactly uniform when ``p`` is, keeping the
unit-mean guarantee.  All wealth arithmetic is done in log space so a
catastrophic p-value (randu at Crush scale can reach 1e-300) cannot
overflow float64.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

# Decision labels — kept textually identical to stitch's so the two
# engines are drop-in interchangeable (test_evidence pins the equality;
# importing stitch here would be circular, stitch re-exports us).
PASS, FAIL, UNDECIDED = "PASS", "FAIL", "UNDECIDED"

#: Calibrator names accepted by :func:`log_evalue` / :func:`evidence_verdict`.
CALIBRATORS = ("kappa", "mixture")

# p-values are clamped here before taking logs: below this float64 has
# no headroom anyway and the e-value is astronomically past any boundary.
_P_FLOOR = 1e-300
# Above 1 - _P_CEIL_GAP the mixture's 0/0 form cancels catastrophically
# in floats; the calibrator is continuous there so we return its p -> 1
# limit of 1/2 instead.
_P_CEIL_GAP = 1e-6
# exp() overflow guard for wealth reported in linear space.
_LOG_WEALTH_CAP = 700.0


class VerdictEngineMismatch(ValueError):
    """Raised when persisted run state (checkpoint or campaign ledger)
    recorded under one verdict engine is resumed by a spec that selects
    a different engine — the two engines' decisions are not comparable,
    so the resume is refused rather than silently re-judged."""


def two_sided_p(p: float) -> float:
    """Fold a raw battery p-value through TestU01's two-sided suspect
    rule: ``min(1, 2 * min(p, 1 - p))``.

    If ``p`` is uniform on (0, 1) the folded value is uniform too, so
    calibrating the folded p-value preserves the unit-mean e-value
    guarantee while flagging both tails, exactly like the Bonferroni
    engine's symmetric boundary.
    """
    p = float(p)
    if not (0.0 <= p <= 1.0) or not math.isfinite(p):
        raise ValueError(f"p-value out of [0, 1]: {p!r}")
    return min(1.0, 2.0 * min(p, 1.0 - p))


def kappa_calibrator(p: float, kappa: float = 0.5) -> float:
    """The power-family calibrator ``e_kappa(p) = kappa * p**(kappa-1)``
    for ``kappa`` in (0, 1); ``integral_0^1 e_kappa(p) dp = 1`` exactly,
    so ``e_kappa(U)`` has unit mean under the null."""
    return math.exp(log_kappa_evalue(p, kappa))


def log_kappa_evalue(p: float, kappa: float = 0.5) -> float:
    """``log e_kappa(p)`` computed directly in log space —
    ``log(kappa) + (kappa - 1) * log(p)`` — so tiny p-values never
    overflow the linear form."""
    if not (0.0 < kappa < 1.0):
        raise ValueError(f"kappa must lie in (0, 1), got {kappa!r}")
    p = _clamp_p(p)
    return math.log(kappa) + (kappa - 1.0) * math.log(p)


def mixture_calibrator(p: float) -> float:
    """The mixture calibrator ``F(p) = (1 - p + p*ln p)/(p * (ln p)**2)``,
    i.e. ``integral_0^1 kappa * p**(kappa-1) dkappa`` in closed form;
    parameter-free, unit mean, with ``F(p) -> 1/2`` as ``p -> 1``."""
    return math.exp(log_mixture_evalue(p))


def log_mixture_evalue(p: float) -> float:
    """``log F(p)`` for the mixture calibrator, stable down to the
    p-value floor: for small ``p`` the numerator tends to 1 and the
    log splits into ``-log p - 2 log(-log p)``; near ``p = 1`` the 0/0
    form is replaced by its limit ``log(1/2)``."""
    p = _clamp_p(p)
    if p >= 1.0 - _P_CEIL_GAP:
        return math.log(0.5)
    lp = math.log(p)
    return math.log(1.0 - p + p * lp) - lp - 2.0 * math.log(-lp)


def log_evalue(p: float, calibrator: str = "mixture",
               kappa: float = 0.5) -> float:
    """Calibrate one (already uniform-under-null) p-value into a log
    e-value under the named calibrator.  Callers feeding raw two-sided
    battery p-values should fold them through :func:`two_sided_p`
    first — :func:`evidence_verdict` does so."""
    if calibrator == "mixture":
        return log_mixture_evalue(p)
    if calibrator == "kappa":
        return log_kappa_evalue(p, kappa)
    raise KeyError(
        f"unknown calibrator {calibrator!r}; known: {list(CALIBRATORS)}")


def combine_log_wealth(parts) -> float:
    """Merge independent log-wealth contributions into one e-process by
    summation (e-values compose by product).  Plain float addition, so
    the merge commutes and associates — the property tests pin this."""
    return float(sum(float(x) for x in parts))


def wealth_from_log(log_wealth: float) -> float:
    """Linear-space wealth ``exp(log_wealth)``, capped so a catastrophic
    test cannot overflow float64 in reports; decisions always compare in
    log space and never go through this cap."""
    return math.exp(min(float(log_wealth), _LOG_WEALTH_CAP))


def battery_log_evalues(results: Dict[int, Tuple[float, float]],
                        calibrator: str = "mixture",
                        kappa: float = 0.5) -> Dict[int, float]:
    """Per-test log e-values for a battery result dict mapping test
    index to ``(statistic, p_value)``.  Non-finite or out-of-range
    p-values are skipped (same gate as the Bonferroni engine) so a
    corrupted worker result cannot poison the wealth product."""
    out: Dict[int, float] = {}
    for idx, (_stat, p) in results.items():
        p = float(p)
        if not np.isfinite(p) or p < 0.0 or p > 1.0:
            continue
        out[int(idx)] = log_evalue(two_sided_p(p), calibrator, kappa)
    return out


def _clamp_p(p: float) -> float:
    p = float(p)
    if not (0.0 <= p <= 1.0) or not math.isfinite(p):
        raise ValueError(f"p-value out of [0, 1]: {p!r}")
    return min(max(p, _P_FLOOR), 1.0)


@dataclasses.dataclass(frozen=True)
class EvidenceVerdict:
    """Anytime-valid battery verdict — duck-compatible with
    :class:`repro_torch.core.stitch.Verdict` (same ``decision`` / ``alpha`` /
    ``n_checked`` / ``n_total`` / ``failed_tests`` / ``decided``
    surface) plus the evidence trail: accumulated ``log_wealth``, the
    Ville boundary ``threshold = 1/alpha`` it is judged against, the
    continuation ``band``, and the per-test log e-values that compose
    the wealth trajectory."""

    decision: str
    alpha: float
    threshold: float            # Ville wealth boundary, 1/alpha
    n_checked: int
    n_total: int
    failed_tests: Tuple[int, ...]
    log_wealth: float = 0.0
    band: float = 0.0
    log_evalues: Tuple[Tuple[int, float], ...] = ()

    @property
    def decided(self) -> bool:
        """True once the verdict is PASS or FAIL."""
        return self.decision != UNDECIDED

    @property
    def wealth(self) -> float:
        """Accumulated wealth in linear space (overflow-capped); the
        run FAILs when this reaches ``threshold = 1/alpha``."""
        return wealth_from_log(self.log_wealth)

    @property
    def borderline(self) -> bool:
        """True when the battery completed UNDECIDED inside the
        continuation band ``[band/alpha, 1/alpha)`` — the campaign layer
        re-opens such cells in the next wave instead of force-deciding
        them."""
        if self.band <= 0.0 or self.decision != UNDECIDED:
            return False
        return (self.n_checked >= self.n_total
                and self.log_wealth >= _log_band_floor(self.alpha, self.band))

    @property
    def trajectory(self) -> Tuple[float, ...]:
        """Cumulative wealth after each checked test, in ascending test
        index order — the canonical (order-invariant) trajectory that
        the CLI serialises under ``--json``."""
        out: List[float] = []
        acc = 0.0
        for _idx, le in self.log_evalues:
            acc += le
            out.append(wealth_from_log(acc))
        return tuple(out)

    def __str__(self) -> str:
        """Render like stitch's Verdict but with the wealth level, e.g.
        ``FAIL (alpha=0.01, wealth=3.2e+05 vs 100, 12/96 tests
        checked)``."""
        return (f"{self.decision} (alpha={self.alpha:g}, "
                f"wealth={self.wealth:.3g} vs {self.threshold:g}, "
                f"{self.n_checked}/{self.n_total} tests checked)")


def _log_band_floor(alpha: float, band: float) -> float:
    """Log-wealth at the bottom of the continuation band,
    ``log(band / alpha)``."""
    return math.log(band) + math.log(1.0 / alpha)


def evidence_verdict(results: Dict[int, Tuple[float, float]],
                     n_total: int, alpha: float = 0.01,
                     calibrator: str = "mixture", kappa: float = 0.5,
                     band: float = 0.0) -> EvidenceVerdict:
    """The ``evalue`` verdict engine: calibrate each completed test's
    p-value into an e-value, multiply into wealth, and judge it against
    Ville's boundary ``1/alpha``.

    FAIL as soon as wealth reaches ``1/alpha`` (anytime-valid, so the
    battery may stop immediately); PASS only when all ``n_total`` tests
    completed below the boundary — unless ``band > 0`` and the final
    wealth sits inside ``[band/alpha, 1/alpha)``, in which case the
    verdict stays UNDECIDED (borderline) so the campaign layer can
    re-open the cell with fresh stream words.  ``failed_tests`` lists
    tests whose *single* e-value clears the boundary on its own.

    The verdict is a pure function of the completed result *set* —
    independent of arrival order — which is what makes checkpoint resume
    recompute the identical decision.
    """
    if n_total <= 0:
        raise ValueError(f"n_total must be positive, got {n_total}")
    if not (0.0 < alpha < 1.0):
        raise ValueError(f"alpha must lie in (0, 1), got {alpha!r}")
    if not (0.0 <= band < 1.0):
        raise ValueError(f"band must lie in [0, 1), got {band!r}")
    per_test = battery_log_evalues(results, calibrator, kappa)
    log_thr = math.log(1.0 / alpha)
    log_wealth = combine_log_wealth(per_test.values())
    failed = tuple(sorted(i for i, le in per_test.items() if le >= log_thr))
    n_checked = len(per_test)
    if log_wealth >= log_thr:
        decision = FAIL
    elif n_checked >= int(n_total):
        if band > 0.0 and log_wealth >= _log_band_floor(alpha, band):
            decision = UNDECIDED        # borderline: continuation material
        else:
            decision = PASS
    else:
        decision = UNDECIDED
    return EvidenceVerdict(
        decision, float(alpha), 1.0 / float(alpha), n_checked,
        int(n_total), failed, log_wealth, float(band),
        tuple(sorted(per_test.items())))
