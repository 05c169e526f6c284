// K2: one coordinate's phase-1 slack bisection for a restart batch.
//
// Replaces qcqp_tpu/kernels/onevar_pallas.py:502 phase1_coordinate_update:
// `_phase1_kernel` (:394, a generic equality mask eq) and
// `_phase1_kernel_split` (:418, a static equality pattern).  Contract: p,
// q, r, act (and eq) are (m, R) row-major; in the split variant eq_idx
// (E,) lists the equality rows, which the kernel reads in place; xk and
// viol are (R,); the output v (R,) is the accepted coordinate value, or xk
// where no move is accepted.
//
// Canonical rows: generic, rows [0, m) are p x^2 + q x + r - s <= 0 and
// rows [m, 2m) the reversed side of the '==' rows (feasible_point_rows,
// onevar_pallas.py:187-213); split, rows [0, m) are every row's positive
// side and rows [m, m+E) the reversed side of the E equality rows
// (feasible_point_rows_split, :216-240).
//
// Design.  One warp per restart, up to kMaxWarps a block; a ragged last
// block drops whole warps.
//   * Inputs read once a launch: before any warp can exit, the block
//     stages its restarts' entries of p, q, r, act (and eq) into each
//     warp's slice of dynamic shared memory (entry j of the block's
//     adjacent restarts lies in adjacent words of the (m, R) layout), then
//     meets its only barrier.  Every probe and every viol_of reads shared
//     memory after that.
//   * Rows over lanes: lane l canonicalizes rows j = l (mod 32) at each
//     probe and writes the four fields it keeps (s, a2, b2 and the
//     candidate) into the warp's slice.
//   * The witness spreads the candidates over lanes, tests each against
//     every row (a broadcast) and takes one lexicographic warp minimum
//     (warp_witness); viol_of folds rows over lanes and ends in warp_nmax.
//     Both leave every lane with the same bits, so onevar_common.cuh's
//     bisect_accept runs unchanged in all 32 lanes with uniform control
//     flow.
//   * Where one warp's slice exceeds the 227 KB a block may hold (m above
//     about 4,400), the same code keeps it in a per-restart global scratch
//     (the kShared = false instantiation).
//
// What bounds it on the H100: the member scans, latency rather than the
// float rate.  A probe tests (rows + 1) candidates against up to `rows`
// rows (about five float operations each; a scan stops at the first row a
// candidate fails), after a canonicalization of about 25 operations a row.
// At rows <= 32 a probe is one canonicalization per lane and about one
// candidate per lane, so each probe is a short chain of dependent shared
// loads and shuffles; 40 warps an SM (10 blocks of 4) hide part of it.
#include <cstdint>

#include "onevar_common.cuh"
#include "warp_common.cuh"

using namespace qk;

namespace {

// Restarts a block (launch_geometry in kernels/onevar_kernel.py).
constexpr int kMaxWarps = 4;
constexpr size_t kSmemBlockMax = 232448;  // bytes a block may opt in to

// One restart on one warp.  p, q, r, act (and eq) point at the restart's
// staged rows (m floats each); st holds its canonical rows.
template <bool kSplit>
struct WarpProbe {
  const float *p, *q, *r, *act, *eq;
  const int* eq_idx;  // (E,), split only
  int m, lane;
  float tol;
  RowStore st;  // nr = m + E (split) or 2m (generic), R = 1

  __device__ bool probe(float s, float xk, float& xi) {
    __syncwarp();  // the previous probe's scans are done
    for (int j = lane; j < st.nr; j += 32) {
      const bool rev = j >= m;
      const int i = !rev ? j : (kSplit ? eq_idx[j - m] : j - m);
      const float pi = p[i], qi = q[i], ri = r[i];
      const bool a = act[i] > 0.0f;
      if (!rev) {
        const CanonRow row = canon_row(pi, qi, ri - s, tol, a);
        store_member(st, j, row);
        st.at(F_C1, j) = row.cand;
      } else if (kSplit) {
        const CanonRow row = canon_row(-pi, -qi, -ri - s, tol, a);
        store_member(st, j, row);
        st.at(F_C1, j) = row.cand;
      } else {  // the generic reversed row: neutral unless i is '=='
        const bool e = eq[i] > 0.0f;
        const CanonRow row = canon_row(-pi, -qi, -ri - s, tol, a && e);
        store_member(st, j, row);
        st.at(F_C1, j) = e ? row.cand : QK_NAN;
      }
    }
    __syncwarp();  // the rows visible to every lane's scan
    return warp_witness(st, xk, lane, xi);
  }

  // The restriction's violation at x: _phase1_kernel.viol_of (generic:
  // |val| on '==' rows) or _phase1_kernel_split.viol_of (the positive side
  // of every row, the negative side of the E equality rows).  Starting the
  // fold at 0 equals jnp.max over the rows, whose values are >= 0 or NaN.
  __device__ float viol_of(float x) const {
    float w = 0.0f;
    const int nr = kSplit ? st.nr : m;
    for (int j = lane; j < nr; j += 32) {
      const bool rev = kSplit && j >= m;
      const int i = rev ? eq_idx[j - m] : j;
      const float val = (p[i] * x + q[i]) * x + r[i];
      float vv;
      if (kSplit)
        vv = nmax(rev ? -val : val, 0.0f);
      else
        vv = eq[i] > 0.5f ? fabsf(val) : nmax(val, 0.0f);
      w = nmax(w, act[i] > 0.5f ? vv : 0.0f);
    }
    return warp_nmax(w);
  }
};

// The slice of one warp: the staged fields (p, q, r, act[, eq]), m floats
// each, then the four canonical fields of its rows.
template <bool kSplit, bool kShared>
__global__ void __launch_bounds__(32 * kMaxWarps, 10)
phase1_kernel(const float* p, const float* q, const float* r,
              const float* eq, const float* act, const int* eq_idx, int e,
              const float* xk, const float* viol, float* v,
              float* rows_gmem, int m, int R, float tol, float viol_tol,
              int n_bisect, int warp_floats) {
  extern __shared__ float smem[];
  constexpr int kFields = kSplit ? 4 : 5;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rid0 = blockIdx.x * warps;
  float* block =
      kShared ? smem : rows_gmem + (size_t)rid0 * (size_t)warp_floats;

  // Stage the block's columns: thread t takes restart rid0 + t % warps of
  // (field, row) t / warps, so adjacent threads read adjacent words.
  const int cols = min(warps, R - rid0);
  for (int t = threadIdx.x; t < kFields * m * warps; t += blockDim.x) {
    const int w = t % warps, fj = t / warps;
    if (w >= cols) continue;
    const int f = fj / m, j = fj - f * m;
    const float* src =
        f == 0 ? p : f == 1 ? q : f == 2 ? r : f == 3 ? act : eq;
    block[(size_t)w * warp_floats + fj] = src[(size_t)j * R + rid0 + w];
  }
  __syncthreads();  // the only barrier: no warp has exited before it

  const int rid = rid0 + warp;
  if (rid >= R) return;  // a whole warp
  float* s = block + (size_t)warp * warp_floats;
  const int nr = kSplit ? m + e : 2 * m;
  WarpProbe<kSplit> pr{s, s + m, s + 2 * m, s + 3 * m,
                       kSplit ? nullptr : s + 4 * m, eq_idx, m, lane, tol,
                       RowStore{s + kFields * m, nr, 1}};
  float wlo = 0.0f, whi = 0.0f;
  const float out = bisect_accept(pr, xk[rid], viol[rid], tol, viol_tol,
                                  n_bisect, kRel, false, wlo, whi);
  if (lane == 0) v[rid] = out;
}

template <bool kSplit, bool kShared>
int launch(const float* p, const float* q, const float* r, const float* eq,
           const float* act, const int* eq_idx, int e, const float* xk,
           const float* viol, float* v, float* rows_gmem, int m, int R,
           float tol, float viol_tol, int n_bisect, int warps,
           int warp_floats, cudaStream_t s) {
  auto kernel = phase1_kernel<kSplit, kShared>;
  const size_t smem =
      kShared ? (size_t)warps * warp_floats * sizeof(float) : 0;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (R + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, smem, s>>>(p, q, r, eq, act, eq_idx, e, xk,
                                          viol, v, rows_gmem, m, R, tol,
                                          viol_tol, n_bisect, warp_floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `warps` restarts a block and `warp_floats` (>= 4m + 4(m+E) split, 13m
// generic) floats a restart; the wrapper chooses both
// (onevar_kernel.launch_geometry).  rows_gmem is null when the block's
// slices fit its shared memory; otherwise it is a (R, warp_floats) scratch
// that holds them.  eq and eq_idx are the generic and the split variant's
// (the other may be null).  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int qk_phase1_update(const float* p, const float* q,
                                const float* r, const float* eq,
                                const float* act, const int* eq_idx, int e,
                                const float* xk, const float* viol, float* v,
                                float* rows_gmem, int m, int R, float tol,
                                float viol_tol, int n_bisect, int split,
                                int warps, int warp_floats, void* stream) {
  const int need = split ? 8 * m + 4 * e : 13 * m;
  if (warps < 1 || warps > kMaxWarps || warp_floats < need || m < 0 ||
      e < 0 || (!split && m > 0 && eq == nullptr) ||
      (split && e > 0 && eq_idx == nullptr) ||
      (rows_gmem == nullptr &&
       (size_t)warps * warp_floats * sizeof(float) > kSmemBlockMax))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (split)
    return rows_gmem ? launch<true, false>(p, q, r, eq, act, eq_idx, e, xk,
                                           viol, v, rows_gmem, m, R, tol,
                                           viol_tol, n_bisect, warps,
                                           warp_floats, s)
                     : launch<true, true>(p, q, r, eq, act, eq_idx, e, xk,
                                          viol, v, rows_gmem, m, R, tol,
                                          viol_tol, n_bisect, warps,
                                          warp_floats, s);
  return rows_gmem ? launch<false, false>(p, q, r, eq, act, eq_idx, e, xk,
                                          viol, v, rows_gmem, m, R, tol,
                                          viol_tol, n_bisect, warps,
                                          warp_floats, s)
                   : launch<false, true>(p, q, r, eq, act, eq_idx, e, xk,
                                         viol, v, rows_gmem, m, R, tol,
                                         viol_tol, n_bisect, warps,
                                         warp_floats, s);
}
