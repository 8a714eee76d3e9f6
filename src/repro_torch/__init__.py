"""repro_torch — the battery pool in PyTorch, with hand-written CUDA
kernels for the NVIDIA H100 (``sm_90a``).

A module-for-module port of ``repro`` (the JAX package, which stays the
reference): the same generators bit for bit, the same test families and
p-value machinery, the same job tables, schedule policies, verdicts and
``--json`` report. Words are carried in ``int64`` tensors (see
``common/ints.py``). Entry points run on ``cuda`` unless the caller asks
for the CPU, where every kernel wrapper takes its plain PyTorch version.

Nothing here imports ``jax`` or ``repro``: the package runs on a machine
without either.
"""
