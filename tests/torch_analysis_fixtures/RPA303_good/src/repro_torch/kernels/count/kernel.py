"""GOOD: the launcher bounds the kernel's dynamic shared memory (k bins,
at most MAX_BINS words), so the working set is statically known."""
MAX_BINS = 1 << 12


def launch_args(x_ptr, n, out_ptr, k, stream):
    if not 0 < k <= MAX_BINS:
        raise ValueError(f"k={k} out of range")
    # repro: vmem-bound repro_torch.kernels.count.kernel.MAX_BINS
    return (x_ptr, n, out_ptr, k, stream)
