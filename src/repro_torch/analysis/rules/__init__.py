"""Rule families. Importing this package registers every rule.

One module per family (the code prefix is the family), as in
``repro/analysis/rules``:

  trace.py             RPA1xx  host-sync hazards in the round hot path
  cachekey.py          RPA2xx  RunSpec -> runner/job-table key audit
  kernels.py           RPA3xx  backend registry + CUDA kernel contracts
  registry_closure.py  RPA4xx  counter_based + wire-version closure
  reach.py             RPA5xx  import-graph reachability / quarantine
"""
from repro_torch.analysis.rules import cachekey  # noqa: F401
from repro_torch.analysis.rules import kernels  # noqa: F401
from repro_torch.analysis.rules import reach  # noqa: F401
from repro_torch.analysis.rules import registry_closure  # noqa: F401
from repro_torch.analysis.rules import trace  # noqa: F401
