// Shared device helpers of the two coordinate-descent kernels
// (onevar_phase1.cu, cd_sweep.cu): the per-lane arithmetic of
// qcqp_tpu/kernels/onevar_pallas.py, written once as __device__ functions.
//
//   canon_row      _canon_leq (:40-102) + the caller's inactive-row
//                  neutralization + _g_form (:105-128)
//   member         one candidate's column of feas_matrix_from_canon (:131-158)
//   bisect_accept  _bisect_accept (:246-391)
//
// Both kernels run a restart on a warp and keep its canonical rows in the
// warp's slice of shared memory (a RowStore with R = 1); every lane calls
// bisect_accept with the same values, and its probe is warp-collective
// (warp_common.cuh holds the collective pieces, the witness among them).
//
// Numerics follow the JAX code operation by operation:
//   * nmax/nmin propagate NaN like jnp.maximum/jnp.minimum (fmaxf/fminf
//     would return the non-NaN operand, and the feasibility fold and the
//     distance selections rely on NaN propagating);
//   * argmin is a scan in the JAX candidate order with a strict `<`, which
//     keeps jnp.argmin's first-minimum tie-break;
//   * the constants (0.501/0.499 midpoint, 5e-7 slop, 3e38 clip) are the
//     same float32 values;
//   * the library is built with -fmad=false and without fast math, so no
//     multiply-add is contracted and sqrtf and division stay IEEE.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace qk {

#define QK_INF CUDART_INF_F
#define QK_NAN CUDART_NAN_F

// REL_SLACK_TOL of onevar_pallas.py:243.
constexpr float kRel = 1.0f / 16.0f;

__device__ __forceinline__ float nmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? QK_NAN : (a > b ? a : b);
}

__device__ __forceinline__ float nmin(float a, float b) {
  return (isnan(a) || isnan(b)) ? QK_NAN : (a < b ? a : b);
}

// One canonical row of p x^2 + q x + c <= 0 (onevar_pallas._canon_leq).
struct CanonRow {
  float s, a2, b2;  // signed-gap membership: feasible iff s*max(a2-x, x-b2) <= 0
  float a, b, es;   // slop-folded bounds and slop sign, for phase-2 candidates
  float cand;       // left-endpoint candidate (NaN when none)
};

__device__ __forceinline__ CanonRow canon_row(float p, float q, float c,
                                              float tol, bool active) {
  const float D = q * q - 4.0f * p * c;
  const float rD = sqrtf(nmax(D, 0.0f));
  const float two_p = fabsf(p) > tol ? 2.0f * p : 1.0f;
  const float lo = (-q - rD) / two_p;
  const float hi = (-q + rD) / two_p;
  const float xlin = -c / (fabsf(q) > tol ? q : 1.0f);

  const bool pos = p > tol, neg = p < -tol, Dge = D >= 0.0f;
  const bool qpos = q > tol, qneg = q < -tol;
  const bool lin = !pos && !neg;
  const bool interval = (pos && Dge) || (lin && (qpos || qneg));
  const bool complement = neg && Dge;
  float base = (neg || (lin && !qpos && !qneg)) ? 1.0f : 0.0f;
  float sgn = interval ? 1.0f : (complement ? -1.0f : 0.0f);
  const float es = complement ? -1.0f : 1.0f;
  float a = (pos && Dge) ? lo
            : ((lin && qneg) ? xlin : (complement ? hi : -QK_INF));
  float b = (pos && Dge) ? hi
            : ((lin && qpos) ? xlin : (complement ? lo : QK_INF));
  // the ~4-ulp tangency slop folded into the bounds (:96-97)
  if (isfinite(a)) a = a - es * 5e-7f * (1.0f + fabsf(a));
  if (isfinite(b)) b = b + es * 5e-7f * (1.0f + fabsf(b));

  CanonRow row;
  row.cand = (pos && Dge) ? lo
             : ((neg && Dge) ? lo : ((lin && qneg) ? xlin : QK_NAN));
  row.a = a;
  row.b = b;
  row.es = es;
  if (!active) {  // inactive rows accept everything (base 1, sgn 0)
    base = 1.0f;
    sgn = 0.0f;
  }
  // _g_form
  row.s = sgn < -0.5f ? -1.0f : 1.0f;
  const bool nosgn = fabsf(sgn) < 0.5f;
  const bool empty = (base < 0.5f) && nosgn;
  const bool full = (base > 0.5f) && nosgn;
  row.a2 = empty ? QK_INF : (full ? -QK_INF : a);
  row.b2 = empty ? -QK_INF : (full ? QK_INF : b);
  return row;
}

// Per-restart view of the (field, row) store: field f of row j at
// base[(f * nr + j) * R]; `base` already points at the restart's rows.
struct RowStore {
  float* base;
  int nr;
  int R;
  __device__ __forceinline__ float& at(int f, int j) const {
    return base[((size_t)f * nr + j) * R];
  }
};

// Fields: the membership triple, then the candidates.  Phase 1 keeps one
// candidate per row (the left endpoint, F_C1); phase 2 keeps the two
// un-shifted bounds (F_C1 = a, F_C2 = b).
enum { F_S = 0, F_A2 = 1, F_B2 = 2, F_C1 = 3, F_C2 = 4 };

__device__ __forceinline__ void store_member(const RowStore& st, int j,
                                             const CanonRow& row) {
  st.at(F_S, j) = row.s;
  st.at(F_A2, j) = row.a2;
  st.at(F_B2, j) = row.b2;
}

// Is candidate c feasible against every stored row?  The JAX fold takes the
// NaN-propagating max of s_j*max(a2_j - x, x - b2_j) over all rows and
// accepts when it is <= 0; the first row whose gap is > 0 or NaN decides
// the answer, so the scan stops there.
__device__ __forceinline__ bool member(float c, const RowStore& st) {
  if (isnan(c)) return false;
  const float cf = fminf(fmaxf(c, -3.0e38f), 3.0e38f);  // c is not NaN
  for (int j = 0; j < st.nr; ++j) {
    const float gj =
        st.at(F_S, j) * nmax(st.at(F_A2, j) - cf, cf - st.at(F_B2, j));
    if (!(gj <= 0.0f)) return false;
  }
  return true;
}

__device__ __forceinline__ float gap_tgt(float ss, float tol, float rel) {
  return tol + rel * nmax(ss, 0.0f);
}

// _bisect_accept for one lane.  Probe provides
//   bool probe(float s, float xk, float& xi)   witness at slack s
//   float viol_of(float v)                     restriction violation at v
// The JAX loop runs while any lane of its tile is live; a lane that is not
// live is left unchanged by the body, so a loop per restart gives the same
// per-lane result.  With warm == true, (wlo, whi) carry the lane's bracket
// in and out (the accepted slack, or +inf, in whi).
template <class Probe>
__device__ float bisect_accept(Probe& pr, float xk, float viol, float tol,
                               float viol_tol, int n_bisect, float rel,
                               bool warm, float& wlo, float& whi) {
  const float es_cold = viol - viol_tol;
  float ss, es, wflag = 0.0f;
  if (!warm) {
    ss = -tol;
    es = es_cold;
  } else {
    // the warm window as coded at onevar_pallas.py:312-325
    const bool hi_ok = isfinite(whi) && (whi < es_cold);
    es = hi_ok ? nmin(es_cold, whi * (1.0f + rel) + tol) : es_cold;
    const bool lo_ok = isfinite(wlo) && (wlo > 0.0f) && !isfinite(whi);
    ss = lo_ok ? nmax(-tol, wlo * (1.0f - rel) - tol) : -tol;
    ss = nmax(-tol, nmin(ss, es - 1.0f * gap_tgt(ss, tol, rel)));
    wflag = ss > -tol ? 1.0f : 0.0f;
  }
  float bx = xk, bs = viol, found = 0.0f;
  for (int it = 0; it < n_bisect; ++it) {
    const float esc = (found < 0.5f && es < es_cold) ? 1.0f : -1.0f;
    if (!(nmax(es - ss - gap_tgt(ss, tol, rel), esc) > 0.0f)) break;
    if ((es - ss) <= gap_tgt(ss, tol, rel) && found < 0.5f && es < es_cold)
      es = es_cold;  // escalate an exhausted warm window
    if (!((es - ss) > gap_tgt(ss, tol, rel))) continue;
    const float sm = 0.501f * ss + 0.499f * es;
    float xi;
    if (!pr.probe(sm, xk, xi)) {
      ss = sm;
      continue;
    }
    const float g = pr.viol_of(xi);
    const float s_up = (isfinite(xi) && !isnan(g)) ? nmin(g, sm) : sm;
    if (wflag > 0.5f) {  // stale-floor reset
      ss = -tol;
      wflag = 0.0f;
    }
    es = s_up;
    bx = xi;
    bs = s_up;
    found = 1.0f;
  }
  const bool accept = found > 0.5f && bs < viol && isfinite(bx);
  wlo = ss;
  whi = accept ? bs : QK_INF;
  return accept ? bx : xk;
}

}  // namespace qk
