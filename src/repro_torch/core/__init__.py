"""The solver core: stencil operators, HPCG problems, method definitions and
the local operator (counterpart of ``repro.core``)."""
