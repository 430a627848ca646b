"""The plain reference that decides a run's `correct`.

Python integers and NumPy only.  Nothing here imports the program
(`lasso_tpu_torch`), the JAX package or JAX, and nothing here takes a value
the program derived: the lookups and the evaluation point are made again
from the seed (`benchmark.traffic`), the Pedersen generators are derived
again from their label, and the program's outputs (its densified tables,
its commitments and its proof, handed over as plain integers and point
bytes) are only judged.

The curve, field, ChaCha and transcript code is a frozen copy of the host
code that the Lasso reference (a16z/Lasso, arkworks' curve25519 and the
merlin crate) defines, written out again here in plain Python.
"""
