"""Contract checks over the port (counterpart of ``repro/analysis``): the
kernel-layer lint ``lint_kernels``, the MethodDef AST lint ``lint_methods``,
the op log of a step ``oplog`` (the counterpart of ``hlo.py``), the
collective and donation audit ``audit``, and ``python -m
repro_torch.analysis``, which runs them with the registry sweep."""
