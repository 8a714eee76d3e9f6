"""BAD: the kernel's dynamic shared memory (k bins) has no static bound:
no literal arithmetic and no vmem-bound annotation on the launcher."""


def launch_args(x_ptr, n, out_ptr, k, stream):
    return (x_ptr, n, out_ptr, k, stream)
