"""BAD: fault-injection API called inside a structurally hot (compiled)
function — the perturbation would land before the round's results reach
the host, where the replay cannot see it (fires RPA106)."""
import torch

from repro_torch.core.faults import FaultInjector


@torch.compile
def round_fn(row, arrays, plan, round_idx):
    injector = FaultInjector(plan)
    events, resize_to = injector.apply_round(round_idx, row, arrays)
    return arrays
