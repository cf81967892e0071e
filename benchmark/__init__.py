"""The benchmark of the PyTorch/CUDA port (``msnets_tpu_torch``).

``BENCHMARK.json`` at the repository root names the cells; ``run.py`` runs
one. Everything a cell needs is found by name under this folder: its
configuration (``configs/``), its traffic mix (``traffic/``), the limits of
its correctness check (``checks/``) and each per-layer metric's reader
(``metrics/`` names the reader in ``readers/``). The plain reference
(``reference/``) and the operation and byte counts (``counts/``) import
nothing of the port. See ``README.md``.
"""
