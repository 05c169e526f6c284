"""qcqp_tpu_torch — the Suggest-and-Improve framework for nonconvex QCQPs in
PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(JAX counterpart: qcqp_tpu/__init__.py).

A port of the `qcqp_tpu` package, which stays the reference.  It runs the
restart-parallel pipeline on one device: canonicalize (complex variables
included), the RANDOM, SDR and SPECTRAL suggests (the SDP solver of
solvers/sdp.py, with the Jacobi eigh kernel K5 on its psd_method="vec"
projection), then the improves two-phase coordinate descent (kernels K1
and K2 on CUDA), consensus ADMM (K3), penalty CCP, the DCCP improve (K4),
and the augmented-Lagrangian IPOPT improve, and the best-point reduction;
the scenario serving path (parallel/scenarios.py: the threaded
problem bank of native/, stacked instances, one K1 launch over the whole
scenario x restart grid); and the multi-process run, one process per
device (parallel/launch.py: torch.distributed; restarts, scenarios and
constraints sharded over a mesh of processes, parallel/mesh.py and
mesh2d.py); and the tooling: replay traces, a profiler hook and a timer
(diagnostics.py), the JAX package's examples (examples/) and its
scaling study (benchmarks/scaling.py).  The package imports torch and
never jax.  Forms land on the current CUDA device unless the caller
names another (device="cpu"), and without a card naming none raises;
dtypes are explicit (float64 on the CPU, float32 on CUDA by default),
since torch has no global x64 switch.
"""

from .settings import (
    RANDOM, SDR, SPECTRAL, COORD_DESCENT, ADMM, DCCP, IPOPT,
    suggest_methods, improve_methods,
)
from .core import QCQPForm, make_form
from .expressions import (
    Variable, Problem, Minimize, Maximize, Constraint,
    square, sum_squares, quad_form, power, quad_over_lin, matrix_frac,
    sum_entries, mul_elemwise, reshape, canonicalize,
)
from .api import QCQP, enable_file_log
from .parallel.restarts import solve_restarts
from .solvers.sdp import (
    InfeasibleRelaxationError, UnboundedRelaxationError,
)
from .complexvar import (
    ComplexVariable, abs2, sum_abs2, cquad_form, real, imag, conj,
)


__version__ = "0.1.0"

__all__ = [
    "QCQP", "QCQPForm", "make_form", "enable_file_log", "solve_restarts",
    "RANDOM", "SDR", "SPECTRAL", "COORD_DESCENT", "ADMM", "DCCP", "IPOPT",
    "suggest_methods", "improve_methods",
    "Variable", "Problem", "Minimize", "Maximize", "Constraint",
    "square", "sum_squares", "quad_form", "power", "quad_over_lin",
    "matrix_frac", "sum_entries", "mul_elemwise", "reshape", "canonicalize",
    "InfeasibleRelaxationError", "UnboundedRelaxationError",
    "ComplexVariable", "abs2", "sum_abs2", "cquad_form", "real", "imag",
    "conj",
]
