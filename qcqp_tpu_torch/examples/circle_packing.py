"""Circle packing: maximize the common radius of n non-overlapping circles
in a box (JAX counterpart: examples/circle_packing.py).

Mirrors the reference example (reference: examples/circle_packing.py),
including the matplotlib rendering (reference: circle_packing.py:39-48),
which is written to a PNG only when main() is given a path.
Run: python -m qcqp_tpu_torch.examples.circle_packing [out.png]
"""

import sys

import numpy as np

import qcqp_tpu_torch

n = 5  # circles to pack
B = 10.0


def problem(qt):
    """The example's Problem, built with the package module `qt`."""
    X = qt.Variable(2, n)
    r = qt.Variable()
    obj = qt.Maximize(r)
    cons = [X >= r, X <= B - r, r >= 0]
    for i in range(n):
        for j in range(i + 1, n):
            cons.append(qt.square(2 * r) <= qt.sum_squares(X[:, i] - X[:, j]))
    return qt.Problem(obj, cons)


def main(png=None, device=None, generator=None) -> dict:
    """Run the example's chain (and render the last point to `png` when
    given); returns every printed number, and the handler ("qcqp") with its
    device and dtype."""
    qt = qcqp_tpu_torch
    prob = problem(qt)
    r, X = prob.variables()                 # in order of first use
    qcqp = qt.QCQP(prob, device=device)
    if generator is not None:
        qcqp.generator = generator
    out = {"qcqp": qcqp, "device": str(qcqp.device),
           "dtype": str(qcqp.qcqp_form.dtype)}

    qcqp.suggest(qt.SDR)
    out["sdr_bound"] = qcqp.sdr_bound
    print("Upper bound from the Shor relaxation: %.3f" % qcqp.sdr_bound)

    out["cd"] = f_cd, v_cd = qcqp.improve(qt.COORD_DESCENT)
    print("coord-descent    f=%.3f  maxviol=%.3f" % (f_cd, v_cd))

    qcqp.suggest(qt.SDR)
    out["dccp"] = f_dccp, v_dccp = qcqp.improve(qt.DCCP)
    print("penalty-CCP      f=%.3f  maxviol=%.3f" % (f_dccp, v_dccp))

    qcqp.suggest(qt.SDR)
    out["admm"] = f_admm, v_admm = qcqp.improve(qt.ADMM)
    print("consensus-ADMM   f=%.3f  maxviol=%.3f" % (f_admm, v_admm))

    if png is not None:
        plot_packing(np.asarray(X.value), float(r.value), B, png)
    return out


def plot_packing(centers, radius, box, path):
    """Render the packing (reference: examples/circle_packing.py:39-48),
    written to a PNG so it runs headless."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib unavailable; skipping plot")
        return
    fig, ax = plt.subplots(figsize=(5, 5))
    for k in range(centers.shape[1]):
        ax.add_patch(plt.Circle(centers[:, k], radius,
                                fill=False, edgecolor="C0"))
    ax.add_patch(plt.Rectangle((0, 0), box, box, fill=False,
                               edgecolor="k", linewidth=1.5))
    ax.set_xlim(-0.5, box + 0.5)
    ax.set_ylim(-0.5, box + 0.5)
    ax.set_aspect("equal")
    ax.set_title("r = %.3f" % radius)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote %s" % path)


if __name__ == "__main__":
    main(png=sys.argv[1] if len(sys.argv) > 1 else None)
