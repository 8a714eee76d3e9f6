"""Hand-written CUDA kernels for Hopper (``sm_90a``), one directory each.

Every kernel directory holds the ``.cu`` source, ``kernel.py`` (the
ctypes launcher, which counts its launches), ``ops.py`` (the public
wrapper with the reference's padding rule: the kernel for a CUDA
tensor, the plain version for a CPU tensor) and ``ref.py`` (the plain
PyTorch version). ``build.py`` compiles the sources on first use.
"""
