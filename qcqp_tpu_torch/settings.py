"""Method-constant registry (JAX counterpart: qcqp_tpu/settings.py).

The same method constants as the JAX package, so a caller can switch
packages without renaming anything; the port runs all of them.
"""

RANDOM = "random"
SDR = "sdr"
SPECTRAL = "spectral"

suggest_methods = [RANDOM, SDR, SPECTRAL]

COORD_DESCENT = "coord-descent"
ADMM = "admm"
DCCP = "dccp"
IPOPT = "ipopt"

improve_methods = [COORD_DESCENT, ADMM, DCCP, IPOPT]
