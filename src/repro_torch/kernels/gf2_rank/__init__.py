"""Bit-packed GF(2) rank (port of ``repro/kernels/gf2_rank``)."""
