// K1: the whole two-phase coordinate-descent improve of a restart batch in
// one launch.
//
// Replaces qcqp_tpu/kernels/cd_sweep_pallas.py two_phase_sweeps /
// phase1_sweeps (`_two_phase_kernel`, `_phase1_sweep_kernel`), and the
// batched call that jax.vmap makes of them over a scenario axis
// (qcqp_tpu/parallel/scenarios.py).  Contract: S stacked forms of one
// shape, each P as Pt (n, n, m+1) with Pt[a, b, i] = P[i, a, b] (P
// symmetric), q as qt (n, m+1), r (m+1,), its static equality pattern as a
// row mask eqmask (m,) and its indices eq_idx (E_max,), of which the first
// e_cnt are used; x (S, R, n) is the restart batch, updated in place.  One
// form is the case S = 1.
//
// Per restart, in the order of the JAX code:
//   phase 1  sweeps while viol >= viol_tol and the last sweep changed
//            something; F refreshed from scratch per sweep; per coordinate
//            the restriction (t2, t1, t0) from Gk = P[:, k, :] x and F, the
//            warm-bracket slack bisection (bisect_accept), the closed-form
//            F update;
//   gate     a restart enters phase 2 only if its violation is < viol_tol;
//   phase 2  the slack is fixed at the entry violation; per coordinate the
//            candidate argmin over the vertex, the un-shifted bounds and
//            +-inf; the restart stops after n consecutive non-moves.
//
// Design.  One warp per restart, up to 4 a block, and no __syncthreads:
// warps never wait on each other, and a ragged last block drops whole
// warps.  Each restart stops on its own state (the Pallas loops stop on
// tile reductions; a stopped lane is left unchanged by the JAX loop bodies,
// so the per-restart result is the same).  Inside the warp:
//   * rows over lanes: lane l owns constraint rows i = l (mod 32) of the
//     m+1 rows (F refresh, restriction, F update, violation) and canonical
//     rows j = l (mod 32) of the m+E rows.  Every float sum in K1 runs
//     along one row (its y, its Gk, its F), so a lane computes each of its
//     rows whole, in the plain version's order, and the bits are kept;
//   * the maxes (violations) and the membership "any" are warp reductions,
//     whose order does not matter (the values are >= 0 or NaN);
//   * the two argmins (the phase-1 witness, the phase-2 select) spread the
//     candidates over lanes, each tested against every canonical row (all
//     lanes read the same row: a broadcast), then one lexicographic warp
//     minimum of (value, distance, index), which is the sequential scans'
//     first-minimum tie-break;
//   * the bisection's and the sweeps' scalars are the same in every lane
//     (they come out of butterfly reductions), so control flow around every
//     shuffle is uniform and onevar_common.cuh's bisect_accept runs as it
//     is;
//   * state in the warp's slice of dynamic shared memory: x, the warm
//     brackets, F, t2, t1, t0 and the five canonical fields (3n + 4(m+1) +
//     5(m+E) floats; 3.3 KB at n = 100, m = 50, E = 22).  No global scratch.
// P is read through Pt, so a warp's 32 rows of one (k, j) are 32 adjacent
// words; at the bench shape all of Pt (2 MB) stays in the 50 MB L2.
// Scenarios: blockIdx.y is the scenario and each warp offsets into its own
// scenario's form, so a lane's arithmetic is the one of a single-form
// launch and the bits are those of S separate launches (a scenario's
// ragged last block drops whole warps).  The offset pointers and the
// scenario's E live in registers, where a single form's come from the
// kernel's parameters: at the 48-register cap ptxas spills more (216
// against 136 bytes of spill loads), and a first design that kept the
// offsets in every launch slowed the single-form launch by 5% on an
// H100.  So S = 1 runs the same kernel instantiated with the offsets
// folded away (kStacked false), whose code ptxas reports as the
// single-form kernel's.  The scenarios' forms stream through L2 a few at
// a time (S = 132 forms of 2 MB do not fit in it together).
//
// What bounds it on the H100: latency, not the float rate.  Each restart
// reads Pt from L2 twice a sweep (the F refresh and the n restrictions:
// 2 (m+1) n^2 floats), and a lane's row sums wait on those loads a few at
// a time; each probe scans its candidates against the rows (about
// (m+E)^2 / 32 row tests a lane).  Up to 40 warps an SM hide part of it.
// Tensor cores stay out: an mma sum does not keep the rows' order of
// additions.
#include <climits>
#include <cstdint>

#include "onevar_common.cuh"
#include "warp_common.cuh"

using namespace qk;

namespace {

// Restarts a block.  Blocks of 4 warps, at most 48 registers a thread (10
// blocks, 40 warps an SM): a block frees its slot when its slowest restart
// ends, so small blocks lose less to restarts of unequal length.
constexpr int kMaxWarps = 4;

struct WarpRestart {
  const float* Pt;      // (n, n, m+1)
  const float* qt;      // (n, m+1)
  const float* r;       // (m+1,)
  const float* eqmask;  // (m,) 1 for '==' rows
  const int* eq_idx;    // (E,)
  int n, m, e, k1, lane;
  float tol;
  float* x;     // shared (n)
  float* warm;  // shared (2n): the bracket (lo, hi) of each coordinate
  float* F;     // shared (m+1), and t2, t1, t0 likewise
  float* t2;
  float* t1;
  float* t0;
  RowStore st;  // shared, m + E rows (R = 1)
  int k;        // current coordinate

  // _make_ctx.refresh_F: f_i = x^T P_i x + q_i^T x + r_i.  A lane takes
  // its rows two at a time (i and i + 32) for two independent chains.
  __device__ void refresh_F() {
    __syncwarp();  // x is final
    for (int i = lane; i <= m; i += 64) {
      const int i2 = i + 32 <= m ? i + 32 : i;
      float s = 0.0f, s2 = 0.0f;
      for (int a = 0; a < n; ++a) {
        const float* pa = Pt + (size_t)a * n * k1;
        float y = 0.0f, y2 = 0.0f;
        for (int b = 0; b < n; ++b) {
          const float xb = x[b];
          y += pa[b * k1 + i] * xb;
          y2 += pa[b * k1 + i2] * xb;
        }
        s += x[a] * y;
        s2 += x[a] * y2;
      }
      float qx = 0.0f, qx2 = 0.0f;
      for (int a = 0; a < n; ++a) {
        qx += qt[a * k1 + i] * x[a];
        qx2 += qt[a * k1 + i2] * x[a];
      }
      F[i] = s + qx + r[i];
      if (i2 != i) F[i2] = s2 + qx2 + r[i2];
    }
  }

  __device__ float viol_row(int i) const {  // row i >= 1 of viols_from_F
    const float val = F[i];
    return eqmask[i - 1] > 0.5f ? fabsf(val) : nmax(val, 0.0f);
  }

  __device__ bool active(int i) const {
    return t2[i] != 0.0f || t1[i] != 0.0f;
  }

  // max over rows with initial 0 (cd_sweep_pallas.py:189, :276); with
  // gated == true only the rows active at the current coordinate
  __device__ float max_viol(bool gated) const {
    float w = 0.0f;
    for (int i = lane; i <= m; i += 32)
      if (i > 0) w = nmax(w, (!gated || active(i)) ? viol_row(i) : 0.0f);
    return warp_nmax(w);
  }

  __device__ void row_terms(int i, float Gk, float xk) {
    const float p = Pt[((size_t)k * n + k) * k1 + i];
    const float qk = qt[k * k1 + i];
    t2[i] = p;
    t1[i] = 2.0f * (Gk - p * xk) + qk;
    t0[i] = F[i] - xk * (2.0f * Gk + qk) + p * (xk * xk);
  }

  // _make_ctx.restriction: t2, t1, t0 of every row; returns xk.
  __device__ float restriction(int kk) {
    __syncwarp();  // the previous coordinate's readers are done
    k = kk;
    const float xk = x[k];
    const float* pk = Pt + (size_t)k * n * k1;
    for (int i = lane; i <= m; i += 64) {
      const int i2 = i + 32 <= m ? i + 32 : i;
      float G = 0.0f, G2 = 0.0f;
      for (int j = 0; j < n; ++j) {
        const float xj = x[j];
        G += pk[j * k1 + i] * xj;
        G2 += pk[j * k1 + i2] * xj;
      }
      row_terms(i, G, xk);
      if (i2 != i) row_terms(i2, G2, xk);
    }
    __syncwarp();  // every row visible to the warp
    return xk;
  }

  // Canonicalize rows [0, m) (constraints 1..m) and [m, m+E) (reversed
  // equality rows) at slack s, lane j of each 32.  phase1 == true stores
  // phase 1's left endpoints in F_C1; otherwise phase 2's un-shifted
  // bounds in F_C1/F_C2.
  __device__ void canon_all(float s, bool phase1) {
    for (int j = lane; j < m + e; j += 32) {
      const bool rev = j >= m;
      const int i = rev ? 1 + eq_idx[j - m] : 1 + j;
      const float p = t2[i], qq = t1[i], c = t0[i];
      const CanonRow row = rev ? canon_row(-p, -qq, -c - s, tol, active(i))
                               : canon_row(p, qq, c - s, tol, active(i));
      store_member(st, j, row);
      if (phase1) {
        st.at(F_C1, j) = row.cand;
      } else {
        // cd_sweep_pallas.py:227-230: candidates on the true boundary
        const float at = row.a + row.es * 5e-7f * (1.0f + fabsf(row.a));
        const float bt = row.b - row.es * 5e-7f * (1.0f + fabsf(row.b));
        st.at(F_C1, j) = fabsf(row.a) < QK_INF ? at : QK_NAN;
        st.at(F_C2, j) = fabsf(row.b) < QK_INF ? bt : QK_NAN;
      }
    }
    __syncwarp();  // the rows visible to every lane's scan
  }

  // Probe interface of bisect_accept (_phase1_loop's feasible_point and
  // viol_of): the witness of the rows at slack s (warp_witness).
  __device__ bool probe(float s, float xk, float& xi) {
    __syncwarp();  // the previous probe's scans are done
    canon_all(s, true);
    return warp_witness(st, xk, lane, xi);
  }

  // The positive side of every row and the negative side of the E
  // equality rows, over the canonical rows' lanes.
  __device__ float viol_of(float v) const {
    float w = 0.0f;
    for (int j = lane; j < m + e; j += 32) {
      const bool rev = j >= m;
      const int i = rev ? 1 + eq_idx[j - m] : 1 + j;
      const float val = (t2[i] * v + t1[i]) * v + t0[i];
      w = nmax(w, active(i) ? nmax(rev ? -val : val, 0.0f) : 0.0f);
    }
    return warp_nmax(w);
  }

  // closed-form F update and the move itself
  __device__ void apply(float v) {
    __syncwarp();  // every lane has read x[k] and the warm bracket
    for (int i = lane; i <= m; i += 32)
      F[i] = t2[i] * (v * v) + t1[i] * v + t0[i];
    if (lane == 0) x[k] = v;
  }

  // _phase1_loop
  __device__ void phase1(int num_iters, float viol_tol, int n_bisect) {
    for (int j = lane; j < 2 * n; j += 32) warm[j] = QK_INF;
    float viol_last = QK_INF;
    bool changed = true;
    for (int t = 0; t < num_iters; ++t) {
      if (!(viol_last >= viol_tol && changed)) break;
      refresh_F();  // drift control
      bool changed_new = false;
      for (int kk = 0; kk < n; ++kk) {
        const float xk = restriction(kk);
        const float viol = max_viol(true);
        float wlo = warm[2 * kk];
        float whi = warm[2 * kk + 1];
        const float v = bisect_accept(*this, xk, viol, tol, viol_tol,
                                      n_bisect, kRel, true, wlo, whi);
        if (v != xk) changed_new = true;
        apply(v);
        if (lane == 0) {
          warm[2 * kk] = wlo;
          warm[2 * kk + 1] = whi;
        }
      }
      viol_last = max_viol(false);
      changed = changed_new;
    }
  }

  // Phase 2's candidate t: the vertex, then per block (constraint rows,
  // equality rows) its a candidates and its b candidates, then -inf, +inf.
  __device__ float candidate(int t, float p0, float q0) const {
    if (t == 0) return p0 > 0.0f ? -q0 / (2.0f * p0) : QK_NAN;
    t -= 1;
    if (t < 2 * m) return t < m ? st.at(F_C1, t) : st.at(F_C2, t - m);
    t -= 2 * m;
    if (t < 2 * e)
      return t < e ? st.at(F_C1, m + t) : st.at(F_C2, m + t - e);
    return t == 2 * e ? -QK_INF : QK_INF;
  }

  // _phase2_select for the current coordinate: returns v, sets any_feas.
  // The minimum value wins (== ties, so -0 ties +0), then the smallest
  // distance, then the lowest index; when that distance is not finite,
  // the lowest index with the minimum value, which the same order gives.
  __device__ float select(float xk, bool& any_feas) const {
    const float p0 = t2[0], q0 = t1[0], r0 = t0[0];
    const int C = 2 * (m + e) + 3;
    float bv = QK_INF, bd = QK_INF, bc = 0.0f;
    int bi = INT_MAX;
    bool feas = false;
    for (int t = lane; t < C; t += 32) {
      const float c = candidate(t, p0, q0);
      const bool f = member(c, st);
      feas = feas || f;
      float val;
      if (fabsf(c) == QK_INF) {
        const float sgn_c = c > 0.0f ? 1.0f : -1.0f;
        val = p0 != 0.0f ? (p0 > 0.0f ? QK_INF : -QK_INF)
              : (q0 != 0.0f ? (q0 > 0.0f ? sgn_c : -sgn_c) * QK_INF : r0);
      } else {
        val = (p0 * c + q0) * c + r0;
      }
      if (!(f && !isnan(val))) val = QK_INF;
      float d = fabsf(c - xk);
      if (isnan(d)) d = QK_INF;
      if (lex_before(val, d, t, bv, bd, bi)) {
        bv = val;
        bd = d;
        bi = t;
        bc = c;
      }
    }
    warp_argmin(bv, bd, bi, bc);
    any_feas = __any_sync(kFull, feas);
    return bc;
  }

  // _phase2_loop
  __device__ void phase2(int num_iters, float viol_tol) {
    refresh_F();
    const float slack = max_viol(false);
    if (!(slack < viol_tol)) return;  // gated: the counter starts at n
    int counter = 0;
    for (int t = 0; t < num_iters && counter < n; ++t) {
      if (t > 0) refresh_F();  // drift control (t == 0: F is fresh)
      // once counter >= n no move is accepted, so x is final
      for (int kk = 0; kk < n && counter < n; ++kk) {
        const float xk = restriction(kk);
        canon_all(slack, false);
        bool any_feas;
        const float v = select(xk, any_feas);
        const bool accept = any_feas && fabsf(v - xk) > tol &&
                            fabsf(v) < QK_INF && !isnan(v);
        counter = accept ? 0 : counter + 1;
        apply(accept ? v : xk);
      }
    }
  }
};

template <bool kStacked>
__global__ void __launch_bounds__(32 * kMaxWarps, 10)
cd_sweep_kernel(const float* Pt, const float* qt, const float* r,
                const float* eqmask, const int* eq_idx, const int* e_cnt,
                int e_max, float* x, int n, int m, int R, int num_iters,
                float tol, float viol_tol, int n_bisect, int phase1,
                int phase2, int warp_floats) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rid = blockIdx.x * (blockDim.x >> 5) + warp;
  if (rid >= R) return;  // a whole warp
  const int k1 = m + 1;
  const size_t sc = kStacked ? blockIdx.y : 0;  // the warp's scenario
  const int e = kStacked ? e_cnt[sc] : e_max;    // e_cnt[0] when S = 1
  float* s = smem + (size_t)warp * warp_floats;
  WarpRestart W{Pt + sc * n * n * k1, qt + sc * n * k1, r + sc * k1,
                eqmask + sc * m, eq_idx + sc * e_max, n, m, e, k1, lane, tol,
                s,
                s + n,
                s + 3 * n,
                s + 3 * n + k1,
                s + 3 * n + 2 * k1,
                s + 3 * n + 3 * k1,
                RowStore{s + 3 * n + 4 * k1, m + e, 1},
                0};
  float* xg = x + (sc * R + rid) * n;
  for (int j = lane; j < n; j += 32) W.x[j] = xg[j];
  if (phase1) W.phase1(num_iters, viol_tol, n_bisect);
  if (phase2) W.phase2(num_iters, viol_tol);
  __syncwarp();
  for (int j = lane; j < n; j += 32) xg[j] = W.x[j];
}

}  // namespace

// S stacked forms (Pt, qt, r, eqmask at strides n n (m+1), n (m+1), m+1
// and m; eq_idx at stride e_max, e_cnt (S,) of them used, each <= e_max,
// and e_cnt[0] == e_max when S = 1), x (S, R, n), S <= 65,535 (the grid's
// y).  `warps` restarts a block, `warp_floats` (>= 3n + 4(m+1) +
// 5(m+e_max)) shared floats a warp; the wrapper chooses both
// (cd_sweep_kernel.launch_geometry at E_max and S R restarts).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// geometry the kernel does not take.  Offsets inside one form's Pt and qt
// are int (b * k1 + i < n (m+1)); a form's base and a restart's x are
// size_t.  A warp state that fits a block (3n + 9m < 58,112 floats)
// keeps n (m+1) near 3.2e7 at most, and the check below refuses the rest.
extern "C" int qk_cd_sweeps(const float* Pt, const float* qt, const float* r,
                            const float* eqmask, const int* eq_idx,
                            const int* e_cnt, int e_max, float* x, int n,
                            int m, int S, int R, int num_iters, float tol,
                            float viol_tol, int n_bisect, int phase1,
                            int phase2, int warps, int warp_floats,
                            void* stream) {
  if (warps < 1 || warps > kMaxWarps || S < 0 || S > 65535 || R < 0 ||
      warp_floats < 3 * n + 4 * (m + 1) + 5 * (m + e_max) ||
      (long long)n * (m + 1) > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0 || R == 0) return 0;
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  auto* kernel = S == 1 ? cd_sweep_kernel<false> : cd_sweep_kernel<true>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((R + warps - 1) / warps, S);  // a row of blocks a scenario
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, 32 * warps, smem, s>>>(
      Pt, qt, r, eqmask, eq_idx, e_cnt, e_max, x, n, m, R, num_iters, tol,
      viol_tol, n_bisect, phase1, phase2, warp_floats);
  return static_cast<int>(cudaGetLastError());
}
