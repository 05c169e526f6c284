"""The JAX package's examples on the port (JAX counterpart: examples/):
boolean least squares, maxcut, circle packing, secondary-user
beamforming and scenario serving.  Each module builds its problem with
`problem(qt)` from whichever package module is passed in, and runs the
example's chain with `main(device=None, ...)`, which prints the JAX
example's lines and returns every printed number.  device=None is the
current CUDA device (float32), as the handler's default; device="cpu" runs
on the CPU (float64).  Run one as

    python -m qcqp_tpu_torch.examples.boolean_least_squares
"""
