"""The LM stack's dense serving path (port of ``repro/models``): plain
functions on tensors over a parameter dict that keeps the reference's
keys, shapes and stacked ``units`` layout."""
