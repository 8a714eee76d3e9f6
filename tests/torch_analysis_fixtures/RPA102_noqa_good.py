"""GOOD (by suppression): an intentional host read of a tensor.

The float() below is deliberate — the value is needed on the host under
this fixture's contract — and carries the analyzer's inline
suppression, so the file reports no findings.
"""
import torch


@torch.compile
def baked(x):
    c = float(torch.ones((), device=x.device) * 2.0)  # repro: noqa RPA102
    return x * c
