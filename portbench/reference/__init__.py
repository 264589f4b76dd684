"""Plain float64 references of the spectra the benchmark's cells time.

Each function takes the benchmark's own snapshot (a dict of tensors made
by :mod:`portbench.snapshot`) and a grid size, and works out the
deposit, the transform and the shells again from their definitions.
Nothing here imports the program.  A cell names its reference as
``module:function`` under this package.
"""
