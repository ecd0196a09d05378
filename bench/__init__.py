"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``bench/run.py`` is the command; ``harness.py`` runs one cell; the
yardstick (inputs, weights, arithmetic, trace readers, the plain reference
and the comparison) lives here, beside the cells' data files, so that a
change to the program cannot move it. See ``README.md``.
"""
