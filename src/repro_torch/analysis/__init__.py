"""Static checks over the port (counterpart of ``repro/analysis``): so far
the kernel-layer lint, ``lint_kernels``."""
