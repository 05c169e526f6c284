"""Secondary user multicast beamforming
(JAX counterpart: examples/secondary_user_beamforming.py).

  minimize ||x||^2
  s.t.     |h_i^H x|^2 >= tau   (nonconvex)
           |g_i^H x|^2 <= eta
with complex data realified to R^{2n}.  Mirrors the reference example
(reference: examples/secondary_user_beamforming.py).
Run: python -m qcqp_tpu_torch.examples.secondary_user_beamforming
"""

import numpy as np

import qcqp_tpu_torch

n = 20
m = 5
l = 2

tau = 20.0
eta = 2.0


def problem(qt):
    """The example's Problem, built with the package module `qt`."""
    np.random.seed(1)
    HR = np.random.randn(m, n)
    HI = np.random.randn(m, n)
    A = np.hstack((HR, HI))
    B = np.hstack((-HI, HR))

    GR = np.random.randn(l, n)
    GI = np.random.randn(l, n)
    C = np.hstack((GR, GI))
    D = np.hstack((-GI, GR))

    x = qt.Variable(2 * n)
    obj = qt.Minimize(qt.sum_squares(x))
    cons = [
        qt.square(A @ x) + qt.square(B @ x) >= tau,
        qt.square(C @ x) + qt.square(D @ x) <= eta,
    ]
    return qt.Problem(obj, cons)


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
    print("Lower bound from the Shor relaxation: %.3f" % qcqp.sdr_bound)

    out["dccp"] = f_dccp, v_dccp = qcqp.improve(qt.DCCP)
    print("penalty-CCP      f=%.3f  maxviol=%.3f" % (f_dccp, v_dccp))

    qcqp.suggest(qt.SDR)
    out["cd"] = f, v = qcqp.improve(qt.COORD_DESCENT)
    print("coord-descent    f=%.3f  maxviol=%.3f" % (f, v))
    out["cd_admm"] = f, v = qcqp.improve(qt.ADMM, rho=np.sqrt(m + l))
    print("coord-descent then consensus-ADMM   f=%.3f  maxviol=%.3f" % (f, v))
    out["cd_admm_cd"] = f, v = qcqp.improve(qt.COORD_DESCENT, phase1=False)
    print("Coordinate descent + ADMM + coordinate descent: "
          "objective %.3f, violation %.3f" % (f, v))
    return out


if __name__ == "__main__":
    main()
