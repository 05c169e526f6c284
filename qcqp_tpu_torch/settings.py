"""Method-constant registry (JAX counterpart: qcqp_tpu/settings.py).

The same method constants as the JAX package, so a caller can switch
packages without renaming anything.  Which of them the PyTorch port runs
today is decided in api.py and parallel/restarts.py; the others raise
NotImplementedError naming the ROADMAP item that ports them.
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

# ROADMAP.md Queue 1 items that port the methods outside this package's
# current slice; used in the NotImplementedError messages.
NOT_PORTED = {
    SPECTRAL: "ROADMAP.md Queue 1 item 6 (SDP: the spectral suggest)",
    IPOPT: "ROADMAP.md Queue 1 item 9 (NLP)",
}


def not_ported(method: str) -> NotImplementedError:
    return NotImplementedError(
        f"method {method!r} is not ported to qcqp_tpu_torch yet: "
        f"{NOT_PORTED[method]}")
