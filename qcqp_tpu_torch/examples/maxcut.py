"""MAXCUT:  maximize 0.25 (sum(W) - x^T W x)  s.t.  x_i^2 == 1
(JAX counterpart: examples/maxcut.py).

Mirrors the reference example (reference: examples/maxcut.py).
Run: python -m qcqp_tpu_torch.examples.maxcut
"""

import numpy as np

import qcqp_tpu_torch

n = 25


def problem(qt):
    """The example's Problem, built with the package module `qt`."""
    np.random.seed(1)

    # Erdos-Renyi-ish adjacency matrix
    p = 0.2
    W = np.random.uniform(low=0.0, high=1.0, size=(n, n))
    for i in range(n):
        W[i, i] = 1
        for j in range(i + 1, n):
            W[j, i] = W[i, j]
    W = (W < p).astype(float)

    x = qt.Variable(n)
    obj = 0.25 * (qt.sum_entries(W) - qt.quad_form(x, W))
    cons = [qt.square(x) == 1]
    return qt.Problem(qt.Maximize(obj), cons)


def main(device=None, generator=None) -> dict:
    """Run the example's chain; returns every printed number, and the
    handler ("qcqp") with its device and dtype."""
    qt = qcqp_tpu_torch
    qcqp = qt.QCQP(problem(qt), device=device)
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
    out["dccp"] = f_dccp, v_dccp = qcqp.improve(qt.DCCP, tau=1)
    print("penalty-CCP      f=%.3f  maxviol=%.3f" % (f_dccp, v_dccp))

    qcqp.suggest(qt.SDR)
    out["admm"] = f_admm, v_admm = qcqp.improve(qt.ADMM)
    print("consensus-ADMM   f=%.3f  maxviol=%.3f" % (f_admm, v_admm))
    return out


if __name__ == "__main__":
    main()
