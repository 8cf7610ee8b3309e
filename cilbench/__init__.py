"""The benchmark of the PyTorch/CUDA port (``*_torch``): cells, metrics and
the yardstick that judges them.  ``python -m cilbench.run --workload NAME
--seed N --seconds S --trace 0|1`` runs one cell; see README.md."""
