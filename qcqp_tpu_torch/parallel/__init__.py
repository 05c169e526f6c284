"""Restart and scenario parallelism, on one device or over a mesh of
processes (JAX counterpart: qcqp_tpu/parallel/__init__.py); the
multi-process runtime is parallel/launch.py."""

from .restarts import (  # noqa: F401
    make_mesh, best_point, suggest_batch, improve_chain, solve_restarts,
)
from .mesh import Mesh, admm_phase1_sharded  # noqa: F401
from .mesh2d import (make_mesh_2d, improve_admm_2d,  # noqa: F401
                     solve_restarts_2d)
from .scenarios import (stack_forms, solve_scenarios,  # noqa: F401
                        solve_scenarios_sharded)
