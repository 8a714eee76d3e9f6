"""Test families, p-value machinery and the kernel backend registry."""
