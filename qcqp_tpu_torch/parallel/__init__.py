"""Restart and scenario parallelism on one device (JAX counterpart:
qcqp_tpu/parallel/__init__.py).  The JAX package's mesh entry points
(make_mesh, admm_phase1_sharded, make_mesh_2d, improve_admm_2d,
solve_restarts_2d) wait for the distributed module; solve_scenarios_sharded
and solve_restarts(mesh=...) raise until then."""

from .restarts import (  # noqa: F401
    best_point, suggest_batch, improve_chain, solve_restarts,
)
from .scenarios import (stack_forms, solve_scenarios,  # noqa: F401
                        solve_scenarios_sharded)
