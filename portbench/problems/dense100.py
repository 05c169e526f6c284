"""dense100: the dense random QCQP of this project's headline bench
(bench.py:make_problem, the same draws): P_i = (A_i + A_i') / 2 and q_i
with Gaussian entries scaled by 1/sqrt(n), r_i standard normal, for the
objective and m constraints, each an equality with probability
config["eq_share"] (the rest <= 0), all from config["instance_seed"]."""

import numpy as np


def make(config):
    n, m = int(config["n"]), int(config["m"])
    rng = np.random.default_rng(int(config["instance_seed"]))
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    return P, q, r, rng.random(m) < float(config["eq_share"])
