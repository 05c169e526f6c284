"""Studies a user runs by hand (JAX counterpart: benchmarks/): the
restart scaling over a mesh of processes and its collective inventory
(scaling.py)."""
