"""Hooks a test hands a run (`measure(..., hooks=["portbench.tests.hooks:
name"])`), called first in every rank: `tiny` shrinks every cell to a
size the CPU runs in seconds; `five_solves` makes the window hold five
solves; `control` puts the control of `correct` in the program's place;
the others plant one fault each in the program's timed path, which the
comparison has to catch."""


from portbench.harness import spec

TINY = {"n": 8, "m": 4}


def _patch_cell(change):
    """Every Cell made from now on passes through change(cell)."""
    base = spec.Cell.__init__

    def init(self, name, bench=None):
        base(self, name, bench)
        change(self)
    spec.Cell.__init__ = init


def tiny():
    """Every configuration at n = 8 (4 constraints), the DCCP cell at
    n = 64 (16 constraints), 64 restarts a rank, 2 CD sweeps or 20 x 5
    CCP trips."""

    def change(self):
        cfg = dict(self.config)
        for k in TINY:
            if k in cfg:
                cfg[k] = TINY[k]
        self.config = cfg
        mix = dict(self.mix, restarts=64 * self.chips)
        args = dict(mix.get("improve_args", {}))
        if "num_iters" in args:
            args["num_iters"] = 2
        if mix["improve"] == "dccp":
            # below n of about 64 the CCP improves on none of the starts
            cfg.update(n=64, m=16)
            args.update(max_iter=20, inner_iters=5)
        mix["improve_args"] = args
        self.mix = mix
    _patch_cell(change)


def five_solves():
    """The window holds five solves, whatever its length."""
    from portbench.harness import window
    window.more = lambda elapsed, count, seconds: count < 5


def control():
    """The control of `correct`: the reference with TF32 on in the
    program's place (its form, its draw, its improve and its best point,
    across the ranks over the default process group), and no warm-up
    solve.  Where TF32 exists (a card) it is not correct."""
    import torch
    from qcqp_tpu_torch import convert
    from qcqp_tpu_torch.parallel import restarts
    from portbench.harness import rank
    from portbench.reference import problem as ref

    def form_from_numpy(P, q, r, is_eq, device=None, dtype=None):
        return ref.make_form((P, q, r, is_eq), dtype, device)

    def solve_restarts(form, R, generator, suggest, improve, mesh=None,
                       **args):
        mix = {"suggest": suggest, "improve": improve, "restarts": R,
               "improve_args": args}
        if mesh is None:
            rank_world, gather = (0, 1), lambda cand: [cand]
        else:
            import torch.distributed as dist
            rank_world = (dist.get_rank(), dist.get_world_size())

            def gather(cand):
                out = [None] * rank_world[1]
                dist.all_gather_object(out, cand)
                return out
        (_, f, v, x), _ = rank.reference_best(
            mix, form, generator.initial_seed(), rank_world, gather,
            tf32=True)
        return (torch.as_tensor(x), torch.tensor(f, dtype=torch.float64),
                torch.tensor(v, dtype=torch.float64))

    convert.form_from_numpy = form_from_numpy
    restarts.solve_restarts = solve_restarts

    def change(self):
        self.mix = dict(self.mix, warmup_solves=0)
    _patch_cell(change)


def _restarts():
    from qcqp_tpu_torch.parallel import restarts
    return restarts


def unchanged():
    """The improve returns its starts unchanged."""
    r = _restarts()
    r.improve_chain = lambda form, xs, methods, **kw: xs


def half():
    """The best point is taken over the first half of the batch only."""
    r = _restarts()
    best = r.best_point
    r.best_point = lambda form, xs, tol=1e-4: best(
        form, xs[:max(1, xs.shape[0] // 2)], tol)


def no_exchange():
    """Each rank answers its own block's best point: the all_gather is
    left out."""
    r = _restarts()
    r.pick_across = lambda cand, mesh, axis, total: (cand[3:], cand[1],
                                                     cand[2])


def altered():
    """The answer's point is altered where it is produced, its (f, v)
    kept."""
    r = _restarts()
    best = r.best_point

    def altered_best(form, xs, tol=1e-4):
        x, f, v = best(form, xs, tol)
        return x + 0.25, f, v
    r.best_point = altered_best




def jax_in_check():
    """The reference's comparison loads a module named jax (a stand-in,
    not the library) after the window."""
    import sys
    import types
    from portbench.harness import compare
    gaps = compare.answer_gaps

    def answer_gaps(answer, best):
        sys.modules.setdefault("jax", types.ModuleType("jax"))
        return gaps(answer, best)
    compare.answer_gaps = answer_gaps
