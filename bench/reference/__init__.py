"""Plain references that decide ``correct``: PyTorch and NumPy only.

Nothing under this package imports JAX, the JAX package, or anything of
the port under test (``repro_torch``), and nothing here takes an array
that the port made except to judge it.
"""
