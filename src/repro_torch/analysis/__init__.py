"""Static checks over the port (counterpart of ``repro/analysis``): the
kernel-layer lint ``lint_kernels``, the MethodDef AST lint ``lint_methods``
and ``python -m repro_torch.analysis --lint-only``, which runs both with the
registry sweep."""
