"""repro_torch.analysis — repo-aware static analysis for the port
(``repro/analysis``, DESIGN.md §9).

The port's speed and its parity with the reference rest on invariants
that no test run sees by itself: a round loop that never waits on the
card except for its one result copy, runner caches keyed on every field
that shapes a runner, kernels whose shared memory fits a block, wire
layouts whose readers accept what their writers write. This package
checks them with a tool: a stdlib-``ast`` analyzer (no third-party
dependency; it imports neither torch, numpy nor the reference), with the
reference's rule registry, its 14 stable finding codes, inline
suppressions, a baseline file and a ``python -m repro_torch.analysis``
CLI that serves as a gate.

Rule families (one module per family under ``repro_torch.analysis.rules``):

  RPA1xx  host-sync hazards in the round hot path — Python control flow
          on a tensor, host syncs (``.item()``/``.cpu()``/``float()``/
          ``np.*``/boolean masks/host-to-device copies), hot-path code
          mutating module state, fault injection inside the hot path
  RPA2xx  cache-key audit — every ``RunSpec`` field that runner and
          job-table construction read must appear in the session's keys
          (followed through ``self.<method>(spec)`` helpers)
  RPA3xx  kernel contracts — backend registry closure, integer-dtype
          pins of reductions in the kernels' modules, each CUDA kernel's
          shared memory statically bounded and within a block's opt-in
          limit on sm_90 (``SMEM_BUDGET_BYTES``)
  RPA4xx  registry/version closure — ``counter_based`` declarations,
          checkpoint/ledger/cache writer layouts matched by reader
          upgrade paths
  RPA5xx  import-graph reachability — modules unreachable from the
          battery system carry an explicit quarantine annotation

Inline controls (scanned from source comments, never executed):

  ``# repro: noqa RPA123``             suppress that code on this line
  ``# repro: quarantine -- reason``    (first lines of a module) exempt
                                       a dead seed module from analysis
  ``# repro: runtime-arg``             classify a ``RunSpec`` field as a
                                       runtime argument, not a key field
  ``# repro: vmem-bound <const>``      bound a kernel's dynamic shared
                                       memory, in 4-byte words
  ``# repro: fault-boundary``          a hot-path function that is the
                                       host-side fault-injection boundary

Typical use::

    PYTHONPATH=src python -m repro_torch.analysis --strict --json report.json
"""
from repro_torch.analysis.driver import run_analysis  # noqa: F401
from repro_torch.analysis.model import Baseline, Finding  # noqa: F401
from repro_torch.analysis.project import Project  # noqa: F401
from repro_torch.analysis.registry import (  # noqa: F401
    RULES, get_rule, register, rules)
