"""GOOD: the host-side fault boundary in a hot-path module carries
`# repro: fault-boundary` on its def line (no RPA106)."""
import numpy as np


def inject_round_faults(injector, round_idx, row, arrays):  # repro: fault-boundary
    return injector.apply_round(round_idx, np.asarray(row), arrays)
