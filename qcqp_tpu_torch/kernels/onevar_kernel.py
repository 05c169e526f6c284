"""K2: the fused phase-1 coordinate update, one coordinate's slack bisection
for a restart batch (JAX counterpart: qcqp_tpu/kernels/onevar_pallas.py).

`phase1_coordinate_update` is the wrapper: on CUDA float32 tensors it
launches the hand-written kernel in `csrc/onevar_phase1.cu`; on CPU tensors
it runs `phase1_coordinate_update_ref`, the plain PyTorch version of the
same function.  A CUDA tensor the kernel does not take raises; nothing falls
back from the GPU to the plain version.

The plain helpers here (`canon_leq`, `g_form`, `feas_matrix_from_canon`,
`feasible_point_from_canon`, `feasible_point_rows`,
`feasible_point_rows_split`, `bisect_accept`) mirror the JAX functions of
the same names operation by operation, on the (rows, R) layout with
restarts on the last axis.  K1's plain version (cd_sweep_kernel.py) builds
on them, as the JAX mega-kernel builds on onevar_pallas.

One deviation, shared by the CUDA kernel: a lane leaves the bisection when
its own bracket is closed (`(score > 0).any()` below).  The Pallas loop
stops on the tile's `max(score) > 0`, which a NaN lane would stop for the
whole tile; for every lane without NaN the results are the same.
"""

from __future__ import annotations

import functools

import torch

from . import _build

DEFAULT_TOL = 1e-4
REL_SLACK_TOL = 1.0 / 16.0

_INF = float("inf")
_NAN = float("nan")


def canon_leq(p, q, c, tol):
    """_canon_leq: the membership form of {p x^2 + q x + c <= 0} per row.
    Returns (base, sgn, a, b, es, cand), each shaped like p."""
    D = q * q - 4.0 * p * c
    rD = torch.sqrt(torch.clamp_min(D, 0.0))
    two_p = torch.where(p.abs() > tol, 2.0 * p, torch.ones_like(p))
    lo = (-q - rD) / two_p
    hi = (-q + rD) / two_p
    xlin = -c / torch.where(q.abs() > tol, q, torch.ones_like(q))
    ninf = torch.full_like(p, -_INF)
    pinf = torch.full_like(p, _INF)
    nan = torch.full_like(p, _NAN)

    pos, neg = p > tol, p < -tol
    Dge = D >= 0
    qpos, qneg = q > tol, q < -tol
    lin = ~pos & ~neg

    base = (neg | (lin & ~qpos & ~qneg)).to(p.dtype)
    interval = (pos & Dge) | (lin & (qpos | qneg))
    complement = neg & Dge
    one, zero = torch.ones_like(p), torch.zeros_like(p)
    sgn = torch.where(interval, one, torch.where(complement, -one, zero))
    es = torch.where(complement, -one, one)
    a = torch.where(pos & Dge, lo,
                    torch.where(lin & qneg, xlin,
                                torch.where(complement, hi, ninf)))
    b = torch.where(pos & Dge, hi,
                    torch.where(lin & qpos, xlin,
                                torch.where(complement, lo, pinf)))
    a = torch.where(torch.isfinite(a), a - es * 5e-7 * (1.0 + a.abs()), a)
    b = torch.where(torch.isfinite(b), b + es * 5e-7 * (1.0 + b.abs()), b)
    cand = torch.where(pos & Dge, lo,
                       torch.where(neg & Dge, lo,
                                   torch.where(lin & qneg, xlin, nan)))
    return base, sgn, a, b, es, cand


def neutralize(block, mask):
    """Rows where mask is false accept everything (base 1, sgn 0); the
    bounds and the candidate stay as they are."""
    base, sgn, a, b, es, cand = block
    return (torch.where(mask, base, torch.ones_like(base)),
            torch.where(mask, sgn, torch.zeros_like(sgn)), a, b, es, cand)


def g_form(base, sgn, a, b):
    """_g_form: feasibility against row j is s_j * max(a2_j - x, x - b2_j)
    <= 0."""
    s = torch.where(sgn < -0.5, -torch.ones_like(sgn), torch.ones_like(sgn))
    nosgn = sgn.abs() < 0.5
    empty = (base < 0.5) & nosgn
    full = (base > 0.5) & nosgn
    a2 = torch.where(empty, _INF, torch.where(full, -_INF, a))
    b2 = torch.where(empty, -_INF, torch.where(full, _INF, b))
    return s, a2, b2


def feas_matrix_from_canon(blocks, cands):
    """Feasibility (0/1, shaped like cands (C, R)) of each candidate against
    every canonical row of `blocks` (each tuple's tensors (k_i, R))."""
    cf = torch.clamp(cands, -3.0e38, 3.0e38)
    parts = [g_form(base, sgn, a, b) for (base, sgn, a, b, _, _) in blocks]
    s = torch.cat([t[0] for t in parts])
    a2 = torch.cat([t[1] for t in parts])
    b2 = torch.cat([t[2] for t in parts])
    if s.shape[0]:
        x = cf[:, None, :]
        gj = s[None] * torch.maximum(a2[None] - x, x - b2[None])
        g = gj.amax(dim=1)          # NaN-propagating, like the JAX fold
    else:
        g = torch.full_like(cands, -_INF)
    return ((g <= 0.0) & ~torch.isnan(cands) & ~torch.isnan(g)).to(
        cands.dtype)


def _pick(cands, idx):
    return torch.gather(cands, 0, idx[None, :])[0]


def feasible_point_from_canon(blocks, xk):
    """_feasible_point_from_canon: (witness (R,), exists (R,))."""
    R = xk.shape[0]
    ninf = torch.full((1, R), -_INF, dtype=xk.dtype, device=xk.device)
    cands = torch.cat([blk[5] for blk in blocks] + [ninf], dim=0)
    feas = feas_matrix_from_canon(blocks, cands)
    exists = feas.amax(dim=0) > 0.5
    dist = torch.where(feas > 0.5, (cands - xk[None, :]).abs(), _INF)
    dist = torch.where(torch.isnan(dist), _INF, dist)
    any_fin = dist.amin(dim=0) < _INF
    idx = torch.where(any_fin, torch.argmin(dist, dim=0),
                      torch.argmin(1.0 - feas, dim=0))
    return _pick(cands, idx), exists


def feasible_point_rows(p, q, r, eq, act, xk, s, tol):
    """feasible_point_rows: generic equality mask eq (m, R)."""
    sb = s[None, :]
    blk1 = neutralize(canon_leq(p, q, r - sb, tol), act > 0)
    blk2 = canon_leq(-p, -q, -r - sb, tol)
    base2, sgn2, a2, b2, es2, cand2 = neutralize(blk2, eq > 0)
    cand2 = torch.where(eq > 0, cand2, _NAN)
    blk2 = neutralize((base2, sgn2, a2, b2, es2, cand2), act > 0)
    return feasible_point_from_canon([blk1, blk2], xk)


def feasible_point_rows_split(p, q, r, act, p2, q2, r2, act2, xk, s, tol):
    """feasible_point_rows_split: the E equality rows pre-gathered into
    (p2, q2, r2, act2) (E, R), or None when E == 0."""
    sb = s[None, :]
    blocks = [neutralize(canon_leq(p, q, r - sb, tol), act > 0)]
    if p2 is not None:
        blocks.append(neutralize(canon_leq(-p2, -q2, -r2 - sb, tol),
                                 act2 > 0))
    return feasible_point_from_canon(blocks, xk)


def tally(total, count):
    """total + count for the plain versions' work counters: count is a
    device tensor, so the sum stays on the device (no host read a step);
    a total left on another card by an earlier run follows count's."""
    if isinstance(total, torch.Tensor) and total.device != count.device:
        total = total.to(count.device)
    return total + count


def bisect_accept(feasible_point, xk, viol, tol, viol_tol, n_bisect,
                  viol_of, rel=REL_SLACK_TOL, warm=None):
    """_bisect_accept for a batch of lanes.  Returns (v, (wlo, whi)): v is
    the accepted coordinate value (xk where not accepted), (wlo, whi) the
    lane's final bracket for the next sweep's warm start.  Adds the probes
    it makes, summed over lanes, to `bisect_accept.probes` (a tensor after
    the first call), from which chip_smoke.py counts the kernels' work."""
    es_cold = viol - viol_tol

    def gap_tgt(ss):
        return tol + rel * torch.clamp_min(ss, 0.0)

    if warm is None:
        ss = torch.full_like(xk, -tol)
        es = es_cold
        wflag = torch.zeros_like(xk)
    else:
        wlo, whi = warm
        hi_ok = torch.isfinite(whi) & (whi < es_cold)
        es = torch.where(hi_ok,
                         torch.minimum(es_cold, whi * (1.0 + rel) + tol),
                         es_cold)
        lo_ok = torch.isfinite(wlo) & (wlo > 0.0) & ~torch.isfinite(whi)
        ss = torch.where(lo_ok,
                         torch.clamp_min(wlo * (1.0 - rel) - tol, -tol),
                         torch.full_like(xk, -tol))
        ss = torch.clamp_min(torch.minimum(ss, es - 1.0 * gap_tgt(ss)), -tol)
        wflag = (ss > -tol).to(xk.dtype)

    bx, bs = xk, viol
    found = torch.zeros_like(xk)
    for _ in range(n_bisect):
        esc = torch.where((found < 0.5) & (es < es_cold), 1.0, -1.0).to(
            xk.dtype)
        live = torch.maximum(es - ss - gap_tgt(ss), esc) > 0.0
        if not bool(live.any()):
            break
        need_esc = ((es - ss) <= gap_tgt(ss)) & (found < 0.5) & (es < es_cold)
        es = torch.where(need_esc, es_cold, es)
        do = (es - ss) > gap_tgt(ss)
        sm = 0.501 * ss + 0.499 * es
        bisect_accept.probes = tally(bisect_accept.probes, do.sum())
        xi, exists = feasible_point(sm)
        take = do & exists
        g = viol_of(xi)
        s_up = torch.where(torch.isfinite(xi) & ~torch.isnan(g),
                           torch.minimum(g, sm), sm)
        ss = torch.where(do & ~exists, sm, ss)
        reset = take & (wflag > 0.5)
        ss = torch.where(reset, -tol, ss)
        wflag = torch.where(reset, 0.0, wflag)
        es = torch.where(take, s_up, es)
        bx = torch.where(take, xi, bx)
        bs = torch.where(take, s_up, bs)
        found = torch.maximum(found, take.to(xk.dtype))

    accept = (found > 0.5) & (bs < viol) & torch.isfinite(bx)
    return (torch.where(accept, bx, xk),
            (ss, torch.where(accept, bs, _INF)))


bisect_accept.probes = 0


def _viol_of_generic(p, q, r, eq, act):
    def viol_of(v):
        vb = v[None, :]
        val = (p * vb + q) * vb + r
        vv = torch.where(eq > 0.5, val.abs(), torch.clamp_min(val, 0.0))
        return torch.where(act > 0.5, vv, 0.0).amax(dim=0)
    return viol_of


def viol_of_split(p, q, r, act, p2, q2, r2, act2):
    """_phase1_kernel_split.viol_of: the positive side of every row, and
    the negative side of the E equality rows."""
    def viol_of(v):
        vb = v[None, :]
        val = (p * vb + q) * vb + r
        w = torch.where(act > 0.5, torch.clamp_min(val, 0.0), 0.0)
        w = w.amax(dim=0) if w.shape[0] else torch.zeros_like(v)
        if p2 is not None:
            val2 = (p2 * vb + q2) * vb + r2
            w2 = torch.where(act2 > 0.5, torch.clamp_min(-val2, 0.0), 0.0)
            w = torch.maximum(w, w2.amax(dim=0))
        return w
    return viol_of


def _gather_eq(eq_idx, *rows):
    idx = torch.as_tensor(eq_idx, dtype=torch.long, device=rows[0].device)
    return tuple(t.index_select(0, idx) for t in rows)


def phase1_coordinate_update_ref(p, q, r, is_eq, active, xk, viol,
                                 tol=DEFAULT_TOL, viol_tol=1e-2, n_bisect=40,
                                 eq_idx=None):
    """Plain PyTorch version of K2, in the dtype of its inputs.
    p, q, r, is_eq, active (m, R); xk, viol (R,).  Returns v (R,)."""
    dt = p.dtype
    act = active.to(dt)
    if eq_idx is None:
        eq = is_eq.to(dt)

        def feasible_point(s):
            return feasible_point_rows(p, q, r, eq, act, xk, s, tol)
        viol_of = _viol_of_generic(p, q, r, eq, act)
    else:
        if len(eq_idx):
            p2, q2, r2, act2 = _gather_eq(eq_idx, p, q, r, act)
        else:
            p2 = q2 = r2 = act2 = None

        def feasible_point(s):
            return feasible_point_rows_split(p, q, r, act, p2, q2, r2, act2,
                                             xk, s, tol)
        viol_of = viol_of_split(p, q, r, act, p2, q2, r2, act2)
    return bisect_accept(feasible_point, xk, viol, tol, viol_tol, n_bisect,
                         viol_of)[0]


def _check_cuda(name, tensors, shapes):
    """Float32 CUDA tensors of the given shapes, contiguous, all on one
    card: the kernel launches on that card, and a tensor on another is
    refused, not copied over."""
    for t, shape in zip(tensors, shapes):
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 CUDA "
                            f"tensors, got {t.dtype} on {t.device}")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on {tensors[0].device} and "
                             f"{t.device}; the kernel takes one card's")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _ptr(t):
    return None if t is None else t.data_ptr()


# K2's launch geometry (csrc/onevar_phase1.cu): one warp per restart, each
# with its staged inputs and canonical rows in its slice of the block's
# dynamic shared memory, or of a global scratch where a slice exceeds it.
SMEM_BLOCK_MAX = 232448        # bytes a block may opt in to on the H100
MAX_WARPS = 4                  # restarts a block (kMaxWarps in the source)


def launch_geometry(m, e, split, R=None, sms=None):
    """(warps a block, floats a warp, shared bytes a block, global rows)
    for K2 at m rows and E equality rows.  A warp holds p, q, r, act (and
    eq in the generic variant), m floats each, and four canonical fields
    of its rows (m + E split, 2m generic).  Up to MAX_WARPS warps within
    SMEM_BLOCK_MAX; given R and the card's SM count, fewer, so that a
    small batch spreads over the SMs.  Where one warp's slice exceeds
    SMEM_BLOCK_MAX, the slices live in a global scratch (global rows
    True, no shared memory) and the kernel runs the same code on it."""
    rows = m + e if split else 2 * m
    warp_floats = (4 if split else 5) * m + 4 * rows
    per_warp = 4 * warp_floats
    gmem = per_warp > SMEM_BLOCK_MAX
    warps = MAX_WARPS if gmem or per_warp == 0 else \
        min(MAX_WARPS, SMEM_BLOCK_MAX // per_warp)
    if R is not None and sms:
        warps = max(1, min(warps, R // sms))
    return warps, warp_floats, 0 if gmem else warps * per_warp, gmem


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _eq_index(eq_idx, m, device):
    """The equality rows as the int32 device list K2 reads them through,
    made once per (pattern, device)."""
    if any(not 0 <= i < m for i in eq_idx):
        raise ValueError(f"phase1_coordinate_update: eq_idx {eq_idx} has "
                         f"rows outside [0, {m})")
    return torch.tensor(eq_idx, dtype=torch.int32, device=device)


def phase1_coordinate_update(p, q, r, is_eq, active, xk, viol,
                             tol=DEFAULT_TOL, viol_tol=1e-2, n_bisect=40,
                             eq_idx=None):
    """Fused phase-1 coordinate solve for a restart batch.

    p, q, r, is_eq, active: (m, R); xk, viol: (R,).  Returns v (R,).  Any R
    (the kernel's ragged last block has fewer warps) and any m.  eq_idx:
    optional static tuple of the equality rows; when given, `is_eq` is
    ignored and the reversed rows of inequality constraints are skipped
    structurally.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (float32 only, counted in `phase1_coordinate_update.launches`).
    """
    if not p.is_cuda:
        return phase1_coordinate_update_ref(p, q, r, is_eq, active, xk, viol,
                                            tol, viol_tol, n_bisect, eq_idx)
    m, R = p.shape
    dev = p.device
    act = active.to(torch.float32).contiguous()
    split = eq_idx is not None
    if split:
        eq_idx = tuple(int(i) for i in eq_idx)
        e, eq = len(eq_idx), None
        idx = _eq_index(eq_idx, m, dev) if e else None
    else:
        e, idx = 0, None
        eq = is_eq.to(torch.float32).contiguous()
    ins = [p, q, r, act] + ([] if split else [eq])
    _check_cuda("phase1_coordinate_update", ins + [xk, viol],
                [(m, R)] * len(ins) + [(R,), (R,)])
    warps, warp_floats, _, gmem = launch_geometry(m, e, split, R,
                                                  _sm_count(dev))
    v = torch.empty(R, dtype=torch.float32, device=dev)
    rows = (torch.empty((R, warp_floats), dtype=torch.float32, device=dev)
            if gmem else None)
    lib = _build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.qk_phase1_update(
            _ptr(p), _ptr(q), _ptr(r), _ptr(eq), _ptr(act), _ptr(idx), e,
            _ptr(xk), _ptr(viol), _ptr(v), _ptr(rows), m, R, float(tol),
            float(viol_tol), int(n_bisect), int(split), warps, warp_floats,
            stream)
    _build.check(rc, "qk_phase1_update")
    phase1_coordinate_update.launches += 1
    return v


phase1_coordinate_update.launches = 0
