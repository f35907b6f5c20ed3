"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and
the dispatch between them (counterpart of ``repro.kernels``).  Importing
this package builds and loads nothing; the first launch on the card does."""
