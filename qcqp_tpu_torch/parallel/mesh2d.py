"""2-D mesh program: restarts x constraints sharded over a grid of processes
(JAX counterpart: qcqp_tpu/parallel/mesh2d.py).

Combines the two parallel dimensions the math exposes (SURVEY.md section
2c): the restart axis (each suggest -> improve chain independent) shards
over one mesh axis, and the m per-constraint ADMM projections (the
reference's `TODO: parallel x/u-updates`, qcqp/qcqp.py:234) over the
other.  Per iteration the only traffic is one all_reduce of the local
consensus partial sums over the constraint axis; restarts never
communicate until the final best-point reduction over the restart axis.

Use when m is large enough that one device's projections are the
bottleneck (thousands of constraints) while restart fan-out is still
wanted: an (nr, nc) mesh gives each process R / nr restarts x m / nc
constraints.

Semantics match solvers/admm.improve_admm_batch (phase 1 feasibility
consensus, phase 2 objective consensus with best-point tracking,
reference: qcqp/qcqp.py:195-285) over a rank's restarts, each restart
frozen once its own loop would stop, and each loop running while any
restart of the rank's block runs, as the JAX package's while_loop over a
shard does.  The projections are the plain kernels/projection.
project_onecons, as in the JAX package (no Pallas kernel there).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .. import settings as s
from ..core import QCQPForm, better_batch, max_violation_batch
from ..kernels.projection import project_onecons
from ..solvers.admm import auto_rho
from .mesh import Mesh, block, local_constraints
from .restarts import candidate, pick_across, suggest_batch


def make_mesh_2d(nr: int, nc: int, ranks: Optional[Sequence[int]] = None,
                 r_axis: str = "r", c_axis: str = "c") -> Mesh:
    """An (nr, nc) mesh named (r_axis, c_axis) over the first nr x nc
    ranks of the world (or over `ranks`), with one process group along
    each axis.  Raises ValueError with fewer processes."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if nr * nc > world:
        raise ValueError(f"need {nr * nc} processes, have {world}")
    return Mesh([(r_axis, nr), (c_axis, nc)], ranks)


def _admm_2d_local(form: QCQPForm, xs: torch.Tensor, mesh: Mesh,
                   c_axis: str, rho=None, num_iters: int = 1000,
                   viol_lim: float = 1e4, tol: float = 1e-2,
                   phase1: bool = True, proj_tol: float = 1e-6,
                   better_tol: float = 1e-4):
    """This rank's restarts xs (Rl, n) against its block of the
    constraints, the consensus summed over `c_axis`."""
    eigh, rcon, eqcon, w = local_constraints(form, mesh, c_axis)
    if rho is None:
        rho = auto_rho(form)
    rho = torch.as_tensor(rho, dtype=form.dtype, device=form.device)
    m_true, n = form.m, form.n
    Rl, ml = xs.shape[0], rcon.shape[0]
    wcol = w.to(xs.dtype)[None, :, None]                     # (1, ml, 1)

    def proj_all(vs):
        """vs (Rl, ml, n) -> projections; padded rows pass through."""
        proj = project_onecons(vs, eigh.lam, eigh.Q, eigh.qhat, rcon, eqcon,
                               proj_tol)
        return torch.where(w[None, :, None], proj, vs)

    def local_sum(xs_c, us_c):
        return (wcol * (xs_c - us_c)).sum(1)                  # (Rl, n)

    def run_phase1(z0):
        """Feasibility consensus (reference: qcqp/qcqp.py:195-212)."""
        z = z0
        xs_c = z0[:, None, :].expand(Rl, ml, n).clone()
        us_c = torch.zeros_like(xs_c)
        t = 0
        while t < num_iters:
            v = max_violation_batch(form, z)
            if not bool(v.max() >= tol):                 # NaN stops, as jnp
                break
            alive = (v >= tol)[:, None]
            zn = mesh.all_reduce_sum(local_sum(xs_c, us_c), c_axis) / m_true
            proj = proj_all(zn[:, None, :] + us_c)
            usn = us_c + zn[:, None, :] - proj
            z = torch.where(alive, zn, z)
            xs_c = torch.where(alive[:, :, None], proj, xs_c)
            us_c = torch.where(alive[:, :, None], usn, us_c)
            t += 1
        return z

    def run_phase2(z0):
        """Objective consensus (reference: qcqp/qcqp.py:215-251)."""
        P0, q0 = form.P[0], form.q[0]
        lhs = 2.0 * (P0 + rho * m_true * torch.eye(n, dtype=z0.dtype,
                                                   device=z0.device))
        chol = torch.linalg.cholesky(lhs)
        xs_c = z0[:, None, :].expand(Rl, ml, n).clone()
        us_c = torch.zeros_like(xs_c)
        z, last_z, bestx = z0, z0, z0
        done = torch.zeros(Rl, dtype=torch.bool, device=z0.device)
        t = 0
        while t < num_iters and not bool(done.all()):
            rhs = (2.0 * rho * mesh.all_reduce_sum(local_sum(xs_c, us_c),
                                                   c_axis) - q0[None, :])
            zn = torch.cholesky_solve(rhs.T, chol).T
            proj = proj_all(zn[:, None, :] + us_c)
            usn = us_c + zn[:, None, :] - proj
            converged = (t > 0) & (torch.linalg.vector_norm(
                last_z - zn, dim=1) < tol)
            diverged = max_violation_batch(form, zn) > viol_lim
            take = ~(converged | diverged) & ~done
            bestx = torch.where(take[:, None],
                                better_batch(form, zn, bestx, better_tol),
                                bestx)
            upd = (~done)[:, None]
            z = torch.where(upd, zn, z)
            xs_c = torch.where(upd[:, :, None], proj, xs_c)
            us_c = torch.where(upd[:, :, None], usn, us_c)
            last_z = torch.where(upd, zn, last_z)
            done = done | converged | diverged
            t += 1
        return bestx

    z = xs
    if phase1:
        z = better_batch(form, z, run_phase1(z), better_tol)
    return better_batch(form, z, run_phase2(z), better_tol)


def _local_rows(R: int, mesh: Mesh, r_axis: str):
    nr = mesh.shape[r_axis]
    if R % nr:
        raise ValueError(f"R={R} not a multiple of the restart mesh axis "
                         f"{nr}")
    return block(R, nr, mesh.index(r_axis))


def improve_admm_2d(form: QCQPForm, xs: torch.Tensor, mesh: Mesh,
                    r_axis: str = "r", c_axis: str = "c", rho=None,
                    num_iters: int = 1000, viol_lim: float = 1e4,
                    tol: float = 1e-2, phase1: bool = True,
                    proj_tol: float = 1e-6, better_tol: float = 1e-4):
    """ADMM improve of a restart batch on a 2-D mesh.

    xs: the whole (R, n) batch, the same on every rank; R must divide by
    the restart axis' size (the caller pads; ValueError otherwise).  Each
    rank improves its block of R / nr restarts against its m / nc
    constraints.  Returns the improved (R, n) batch on every rank (one
    all_gather over r_axis; the JAX package returns it sharded over
    r_axis as one global array)."""
    lo, hi = _local_rows(xs.shape[0], mesh, r_axis)
    out = _admm_2d_local(form, xs[lo:hi], mesh, c_axis, rho, num_iters,
                         viol_lim, tol, phase1, proj_tol, better_tol)
    return mesh.all_gather(out, r_axis).reshape(xs.shape)


def solve_restarts_2d(form: QCQPForm, num_restarts: int,
                      generator: Optional[torch.Generator], mesh: Mesh,
                      r_axis: str = "r", c_axis: str = "c",
                      suggest: str = s.RANDOM, better_tol: float = 1e-4,
                      **kwargs):
    """Full 2-D pipeline: suggest -> 2-D sharded ADMM -> best point.

    Every rank draws the whole padded batch (num_restarts rounded up to a
    multiple of the restart axis) from its generator (the same seed on
    every rank; default seed 0) and keeps its block.  Returns (x_best,
    f_best, viol_best), the same on every rank."""
    nr = mesh.shape[r_axis]
    num_padded = -(-num_restarts // nr) * nr
    if generator is None:
        generator = torch.Generator(device=form.device).manual_seed(0)
    xs = suggest_batch(form, num_padded, generator, suggest)
    lo, hi = _local_rows(num_padded, mesh, r_axis)
    out = _admm_2d_local(form, xs[lo:hi], mesh, c_axis,
                         better_tol=better_tol, **kwargs)
    return pick_across(candidate(form, out, better_tol), mesh, r_axis,
                       num_padded)
