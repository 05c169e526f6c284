// Warp-collective pieces of the two kernels that run one restart on one
// warp (cd_sweep.cu: K1, onevar_phase1.cu: K2).  Each restart's canonical
// rows sit in its warp's RowStore (onevar_common.cuh) with R = 1, lane l
// owning rows j = l (mod 32).
//
//   warp_nmax      the NaN-propagating max over the warp (the values are
//                  >= 0 or NaN, so the order of the fold does not matter)
//   warp_argmin    the lexicographic minimum of (value, distance, index)
//                  over the warp: the sequential scans' first-minimum rule
//   warp_witness   _feasible_point_from_canon (onevar_pallas.py:161-184)
//                  with the candidates spread over lanes
//
// Every lane leaves each of them with the same bits, so the callers'
// control flow around the shuffles stays uniform.
#pragma once

#include <climits>

#include "onevar_common.cuh"

namespace qk {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_nmax(float w) {
  for (int off = 16; off > 0; off >>= 1)
    w = nmax(w, __shfl_xor_sync(kFull, w, off));
  return w;
}

// The lexicographic minimum of (val, d, idx) over the warp, carrying c.
// idx is unique, so every lane ends with the same winner.
__device__ __forceinline__ bool lex_before(float v1, float d1, int i1,
                                           float v2, float d2, int i2) {
  return v1 < v2 || (v1 == v2 && (d1 < d2 || (d1 == d2 && i1 < i2)));
}

__device__ __forceinline__ void warp_argmin(float& val, float& d, int& idx,
                                            float& c) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, val, off);
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    const float oc = __shfl_xor_sync(kFull, c, off);
    if (lex_before(ov, od, oi, val, d, idx)) {
      val = ov;
      d = od;
      idx = oi;
      c = oc;
    }
  }
}

// The phase-1 witness of the rows in st (visible to every lane): the
// candidates F_C1 of rows 0..nr-1, then -inf; the feasible one nearest xk,
// the lowest index on ties (a NaN distance counts as +inf); if no feasible
// one has a finite distance, the first feasible one.  Each candidate is
// tested against every row (all lanes read the same row: a broadcast).
// Returns whether any candidate is feasible; with none, xi is candidate 0.
__device__ __forceinline__ bool warp_witness(const RowStore& st, float xk,
                                             int lane, float& xi) {
  const int nr = st.nr;
  float val = QK_INF, d = QK_INF, c = 0.0f;
  int idx = INT_MAX;
  for (int t = lane; t <= nr; t += 32) {
    const float cv = t < nr ? st.at(F_C1, t) : -QK_INF;
    if (!member(cv, st)) continue;
    float dd = fabsf(cv - xk);
    if (isnan(dd)) dd = QK_INF;
    if (idx == INT_MAX || dd < d) {
      val = 0.0f;
      d = dd;
      idx = t;
      c = cv;
    }
  }
  warp_argmin(val, d, idx, c);
  if (idx == INT_MAX) {  // none feasible: candidate 0, unused
    xi = nr > 0 ? st.at(F_C1, 0) : -QK_INF;
    return false;
  }
  xi = c;
  return true;
}

}  // namespace qk
