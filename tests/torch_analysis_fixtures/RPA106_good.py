"""GOOD: fault injection stays at the host-side runner boundary — the
compiled round function is pure, and the injector perturbs the results
after they reached the host (no RPA106)."""
import torch

from repro_torch.core.faults import FaultInjector


@torch.compile
def round_fn(row):
    return torch.sqrt(row)


def dispatch(plan, round_idx, row, arrays):
    out = round_fn(row)
    injector = FaultInjector(plan)
    events, resize_to = injector.apply_round(round_idx, row, arrays)
    return out, events, resize_to
