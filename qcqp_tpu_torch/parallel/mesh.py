"""A mesh of processes with named axes, its collectives, and the
constraint-sharded feasibility ADMM (JAX counterpart:
qcqp_tpu/parallel/mesh.py, with jax.sharding.Mesh).

The JAX package lays its mesh over devices and lets shard_map and GSPMD
place the collectives.  The port runs one process per device
(torch.distributed), so a `Mesh` is a grid of the world's ranks with
named axes: this rank's coordinate on each axis and one process group
along each axis, over which the collectives are explicit
(`all_reduce_sum`, `all_gather`, `broadcast`).  A mesh made without a
process group is this process alone (every axis of size 1), where each
collective returns its input.  Each collective that runs counts its
call and its payload's bytes by kind (`Mesh.calls`, `Mesh.bytes`), the
port's collective inventory (the JAX package reads it from the compiled
HLO: benchmarks/scaling.py).

Under gloo the payload of a collective on a CUDA tensor goes through host
memory: gloo reduces and gathers host tensors (it has no all_gather of
CUDA tensors).  NCCL takes the CUDA tensors as they are, on the rank's
own card (`_staged` refuses any other).

The second parallel dimension the math exposes (SURVEY.md section 2c):
the m per-constraint ADMM projections are independent, so constraints
shard across processes and only the consensus z-update communicates, one
all_reduce of the local (sum x_i - sum u_i) partial sums per iteration:
the answer to the reference's `TODO: parallel x/u-updates` (reference:
qcqp/qcqp.py:234) where one device's projections are not enough (m in
the thousands).
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core import QCQPForm, max_violation
from ..kernels.projection import ConstraintEigh, project_onecons


class Mesh:
    """A grid of the world's ranks with named axes.

    axes: (name, size) pairs, or a dict, in mesh order (the JAX Mesh's
    `shape`).  ranks: the ranks that make the grid, in row-major order
    (default: the first prod(sizes) ranks of the world, as the JAX
    package takes the first devices).  Every process of the world builds
    the same mesh, in the same order as its other meshes: each axis' groups
    are made with dist.new_group, which every rank must call.
    """

    def __init__(self, axes, ranks: Optional[Sequence[int]] = None):
        self.shape = collections.OrderedDict(
            axes.items() if isinstance(axes, dict) else axes)
        names, sizes = list(self.shape), list(self.shape.values())
        size = math.prod(sizes)
        world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        ranks = list(range(size)) if ranks is None else [int(r)
                                                          for r in ranks]
        if len(ranks) != size or len(set(ranks)) != size:
            raise ValueError(f"a mesh of shape {dict(self.shape)} needs "
                             f"{size} distinct ranks, got {ranks}")
        if size > world or max(ranks) >= world:
            raise ValueError(f"need {size} processes, have {world}")
        self.grid = np.array(ranks).reshape(sizes)
        where = np.argwhere(self.grid == self.rank)
        self.coords = (dict(zip(names, (int(c) for c in where[0])))
                       if len(where) else None)
        # per collective kind: calls, and the bytes of the payload this
        # rank passes in (numel x element size, before any staging)
        self.calls = collections.Counter()
        self.bytes = collections.Counter()
        self._groups, self._lines = {}, {}
        if not dist.is_initialized():
            return
        for i, name in enumerate(names):
            for line in np.moveaxis(self.grid, i, -1).reshape(-1, sizes[i]):
                line = line.tolist()
                group = _new_group(line, world)
                if self.rank in line:
                    self._groups[name], self._lines[name] = group, line
        everyone = self.grid.ravel().tolist()
        group = _new_group(everyone, world)
        if self.rank in everyone:
            self._groups[None], self._lines[None] = group, everyone

    @property
    def axis_names(self):
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(self.grid.size)

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis`."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in this mesh "
                             f"({self.grid.ravel().tolist()})")
        return self.coords[axis]

    def _group(self, axis):
        self.index(self.axis_names[0])          # raises outside the mesh
        return self._groups.get(axis), self._lines.get(axis)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of t over the ranks along `axis` (JAX: lax.psum)."""
        group, _ = self._group(axis)
        if group is None:
            return t
        self._count("all_reduce", t)
        buf, back = _staged(t.contiguous().clone(), group)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return back(buf)

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """t of every rank along `axis`, stacked in the axis' order:
        (size, *t.shape).  Every rank passes the same shape."""
        group, line = self._group(axis)
        if group is None:
            return t[None]
        self._count("all_gather", t)
        buf, back = _staged(t.contiguous(), group)
        parts = [torch.empty_like(buf) for _ in line]
        dist.all_gather(parts, buf, group=group)
        # group rank k is global rank get_global_rank(group, k); put each
        # part at that rank's place on the axis
        order = [line.index(_global_rank(group, k)) for k in range(len(line))]
        out = [None] * len(line)
        for k, part in zip(order, parts):
            out[k] = part
        return back(torch.stack(out))

    def broadcast(self, t: torch.Tensor, axis: Optional[str] = None
                  ) -> torch.Tensor:
        """t of the first rank along `axis` (None: of the mesh's first
        rank to the whole mesh), on every rank."""
        group, line = self._group(axis)
        if group is None:
            return t
        self._count("broadcast", t)
        buf, back = _staged(t.contiguous().clone(), group)
        dist.broadcast(buf, src=line[0], group=group)
        return back(buf)

    def __repr__(self):
        return f"Mesh({dict(self.shape)}, ranks={self.grid.ravel().tolist()})"


def _new_group(ranks, world):
    if sorted(ranks) == list(range(world)):
        return dist.group.WORLD
    return dist.new_group(ranks)


def _global_rank(group, k):
    if group is dist.group.WORLD:
        return k
    return dist.get_global_rank(group, k)


def _staged(t: torch.Tensor, group):
    """(buffer, back): the tensor a collective of `group` works on, and the
    map of its result back to t's device.  Under gloo a CUDA tensor goes
    through host memory; NCCL takes it as it is, and it must lie on the
    card launch.initialize bound the rank's communicators to: anything
    else raises, nothing is copied."""
    from .launch import bound_device
    backend = dist.get_backend(group)
    if t.is_cuda and backend == "gloo":
        return t.cpu(), lambda b: b.to(t.device)
    card = bound_device()
    if backend == "nccl" and card is not None and t.device != card:
        raise ValueError(f"an NCCL collective of a tensor on {t.device}; "
                         f"this rank's card is {card}")
    return t, lambda b: b


def block(total: int, parts: int, i: int):
    """[lo, hi) of part i when `total` rows split into `parts` contiguous
    blocks, the first total % parts of them one row longer
    (torch.tensor_split's split)."""
    q, rem = divmod(total, parts)
    lo = i * q + min(i, rem)
    return lo, lo + q + (i < rem)


def _pad_constraints(form: QCQPForm, mult: int):
    """Pad the constraint axis to a multiple of `mult` with trivially
    satisfied dummy rows, ||x||^2 <= 1e6 (the projection's fast path).
    Returns the padded form and the mask of the real rows."""
    m, n = form.m, form.n
    m_pad = -(-m // mult) * mult
    mask = torch.ones(m_pad, dtype=torch.bool, device=form.device)
    if m_pad == m:
        return form, mask
    extra = m_pad - m
    mask[m:] = False
    eye = torch.eye(n, dtype=form.dtype, device=form.device)
    return QCQPForm(
        torch.cat([form.P, eye.expand(extra, n, n)]),
        torch.cat([form.q, form.q.new_zeros((extra, n))]),
        torch.cat([form.r, form.r.new_full((extra,), -1e6)]),
        torch.cat([form.is_eq, form.is_eq.new_zeros(extra)])), mask


def local_constraints(form: QCQPForm, mesh: Mesh, axis: str):
    """This rank's block of the constraints, padded to a multiple of the
    axis size: (eigh of its rows (kernels/projection.ConstraintEigh),
    their r, is_eq and real-row mask).  Each rank decomposes only its own
    rows."""
    padded, mask = _pad_constraints(form, mesh.shape[axis])
    lo, hi = block(padded.m, mesh.shape[axis], mesh.index(axis))
    P, q = padded.P[1 + lo:1 + hi], padded.q[1 + lo:1 + hi]
    lam, Q = torch.linalg.eigh(P)
    eigh = ConstraintEigh(lam, Q, torch.einsum("mij,mi->mj", Q, q))
    return eigh, padded.r[1 + lo:1 + hi], padded.is_eq[lo:hi], mask[lo:hi]


def admm_phase1_sharded(form: QCQPForm, x0, mesh: Mesh, axis: str = "c",
                        tol: float = 1e-2, num_iters: int = 1000,
                        proj_tol: float = 1e-6):
    """Feasibility consensus ADMM of one point x0 (n,) with the constraint
    axis sharded over `axis`.

    Semantics match solvers/admm.admm_phase1; communication is one
    all_reduce per iteration for the consensus mean.  The stopping test
    reads the whole (unpadded) form, which every rank holds, at the
    consensus point, which every rank of the axis holds bit for bit.
    Returns z (n,) on every rank."""
    eigh, r, is_eq, mask = local_constraints(form, mesh, axis)
    ml, n = r.shape[0], form.n
    xs = x0.expand(ml, n).clone()
    us = torch.zeros_like(xs)
    w = mask[:, None].to(x0.dtype)
    z, t = x0, 0
    while t < num_iters and bool(max_violation(form, z) >= tol):
        z = mesh.all_reduce_sum((w * (xs - us)).sum(0), axis) / form.m
        proj = project_onecons(z + us, eigh.lam, eigh.Q, eigh.qhat, r,
                               is_eq, proj_tol)
        xs = torch.where(mask[:, None], proj, z[None, :])
        us = us + z - xs
        t += 1
    return z
