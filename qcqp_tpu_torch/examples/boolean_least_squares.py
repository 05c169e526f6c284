"""Boolean least squares:  minimize ||Ax - b||^2  s.t.  x_i^2 == 1
(JAX counterpart: examples/boolean_least_squares.py).

Mirrors the reference example (reference: examples/boolean_least_squares.py):
same problem, same method chains, plus the batched multi-restart solve the
reference lacks.  Run: python -m qcqp_tpu_torch.examples.boolean_least_squares
"""

import numpy as np

import qcqp_tpu_torch

n, m = 10, 15


def problem(qt):
    """The example's Problem, built with the package module `qt`."""
    np.random.seed(1)
    A = np.random.randn(m, n)
    b = np.random.randn(m, 1).ravel()
    x = qt.Variable(n)
    obj = qt.sum_squares(A @ x - b)
    cons = [qt.square(x) == 1]
    return qt.Problem(qt.Minimize(obj), cons)


def main(device=None, generator=None) -> dict:
    """Run the example's chain; returns every printed number, and the
    handler ("qcqp") with its device and dtype."""
    qt = qcqp_tpu_torch
    qcqp = qt.QCQP(problem(qt), device=device)
    if generator is not None:
        qcqp.generator = generator
    out = {"qcqp": qcqp, "device": str(qcqp.device),
           "dtype": str(qcqp.qcqp_form.dtype)}

    # Gaussian-round a candidate from the Shor relaxation
    qcqp.suggest(qt.SDR)
    out["sdr_bound"] = qcqp.sdr_bound
    print("Lower bound from the Shor relaxation: %.3f" % qcqp.sdr_bound)

    out["cd"] = f_cd, v_cd = qcqp.improve(qt.COORD_DESCENT)
    print("coord-descent    f=%.3f  maxviol=%.3f" % (f_cd, v_cd))

    # the handler keeps the relaxation solution around, so this only
    # re-samples
    qcqp.suggest(qt.SDR)
    out["dccp"] = f_dccp, v_dccp = qcqp.improve(qt.DCCP)
    print("penalty-CCP      f=%.3f  maxviol=%.3f" % (f_dccp, v_dccp))
    out["dccp_cd"] = f_dccp, v_dccp = qcqp.improve(qt.COORD_DESCENT,
                                                   phase1=False)
    print("penalty-CCP then coord-descent   f=%.3f  maxviol=%.3f"
          % (f_dccp, v_dccp))

    qcqp.suggest(qt.SDR)
    qcqp.improve(qt.COORD_DESCENT)
    out["cd_admm"] = f_admm, v_admm = qcqp.improve(qt.ADMM, phase1=False)
    print("coord-descent then consensus-ADMM   f=%.3f  maxviol=%.3f"
          % (f_admm, v_admm))

    # 256 SDR-sampled restarts in one batched solve
    out["best_of_256"] = f_best, v_best = qcqp.solve(
        num_restarts=256, suggest=qt.SDR, improve=qt.COORD_DESCENT)
    print("Best of 256 parallel restarts: objective %.3f, violation %.3f"
          % (f_best, v_best))
    return out


if __name__ == "__main__":
    main()
