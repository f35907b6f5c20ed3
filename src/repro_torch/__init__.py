"""PyTorch/CUDA port of the ``repro`` HPCG solver package.

The JAX package ``repro`` is the reference; this package mirrors its module
and function names so a reader finds each counterpart.  Plain tensor code is
PyTorch; every kernel the reference wrote in Pallas for the TPU is a CUDA C++
kernel for Hopper (``sm_90a``) under ``repro_torch/kernels/csrc/``, built at
first use and bound with ``ctypes``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, where every kernel wrapper takes its plain PyTorch version.
"""
