"""Plain PyTorch version of the GF(2) rank kernel (the battery's own
implementation, ``stats/tests.py::gf2_rank32``)."""
from repro_torch.stats.tests import gf2_rank32


def gf2_rank_ref(mats):
    """(M, 32) words (int64 in [0, 2^32)) -> (M,) int32 ranks."""
    return gf2_rank32(mats)
