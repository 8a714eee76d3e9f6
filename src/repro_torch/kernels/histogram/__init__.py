"""Fused bin-count (port of ``repro/kernels/histogram``)."""
