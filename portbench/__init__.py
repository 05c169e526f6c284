"""portbench: the benchmark of qcqp_tpu_torch on NVIDIA H100s (README.md)."""
