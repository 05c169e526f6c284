// K4: the whole penalty-CCP improve of a restart batch in one launch.
//
// Replaces qcqp_tpu/kernels/ccp_pallas.py `_ccp_improve` (the pallas_call
// at :488 of the kernel `_ccp_kernel` with `_hinge_prox_tile`, run by
// improve_ccp_fused).  Contract (kernels/ccp_kernel.py, CCPFusedData): rows
// permuted equality-first, row 0 the objective; per row i the eigenvectors
// V (m+1, n, n) and their transposes VT, the eigenvalues lam0 and the
// shifted, clipped lam1, the rotated linear terms qhat and the natural q
// (m+1, n); the diagonal shift, r and eq (m+1,); the starts x0 (R, n), R a
// multiple of 64; the output (R, n); global scratch xs, us (R, 1+m+E, n),
// xkh (R, m+1, n), qm (R, E, n), rm (R, E), laid out tile by tile; and,
// unless null, trips (R / 64, 2): the outer steps and inner trips each
// tile ran, from which the work it did is counted.
//
// Per tile of 64 restarts, in lockstep (all gates are per tile, as in the
// Pallas kernel):
//   outer    up to max_iter penalty steps, the body skipped once every lane
//            has finished: rho = rho0 max(1, sqrt(tau)); the duals us are
//            zeroed at step 0 (every step without warm); z = z_prev = xk;
//            the inner loop; the linearization at z, whose rotated copies
//            give the exit's violation; finished = stalled & (viol <
//            viol_exit_tol | tau >= 0.999 tau_max); tau = min(mu tau,
//            tau_max).  The linearization at z is the next step's at xk.
//   inner    at least once, then while any lane's residual > inner_tol:
//            the objective prox in row 0's eigenbasis, the positive hinges
//            (rotate z - u_i in, prox, rotate out), the negative hinges of
//            the equality rows (diagonal, lam = shift_i), the consensus
//            mean over 2m + 1 blocks with the m - E inert blocks in closed
//            form, the dual updates and the residual.
//   hinge    n_newton safeguarded Newton trips on the multiplier with
//            closed-interval acceptance and the log-space midpoint; the
//            result is v when g(v) <= 0, the full step when g >= 0 there,
//            and only otherwise the multiplier's, so a lane with either
//            skips the trips (same bits).
//
// Design: one block per tile, blockDim (32, W) with W = 64 / LPW warps
// (LPW = 2: 32 warps), and a warp owns whole lanes: warp w holds the lanes
// w, w + W, ..., all n eigencoordinates of each, thread t the coordinates
// j = t + 32 c of the groups c < cpt of 32 (NP = 32 cpt is n rounded up to
// 32, cpt <= CPT).  So every sum, rotation, Newton trip and consensus
// update of a lane stays in its warp, and the only block-wide barriers are
// the tile's gates: one per outer step (has every lane finished?) and two
// per inner trip (any residual NaN, any above inner_tol).
//   sums      in the plain version's order (`_tree_sum`: the tree 16, 8,
//             4, 2, 1 in each group of 32, then the groups in order), all
//             in shuffles: the four trees of a slab of 4 groups share 6
//             (`lred`; float addition is commutative, so every thread gets
//             the tree's value), 1 more per group brings them in order.
//   rotations one thread per output element, summed over k in order from
//             the warp's own rows of z or of a staging array in shared
//             memory (a broadcast, four k at a time) times row k of V or
//             VT through the read-only path, shared by the warp's 2 lanes.
//   memory    z, the previous z and the staging rows in shared memory
//             (3 x 64 x NP floats: 96 KB at NP = 128), a warp ordering its
//             threads with __syncwarp; the block banks in the global
//             scratch, each thread touching only its own elements; the
//             lane scalars (tau, rho, |xk|^2, finished) and the consensus
//             sum in registers, the same in every thread of a lane's warp.
//
// What bounds it on the H100: the work is floating-point operations (each
// inner trip rotates 2 (m + 1) times per restart, 2 n^2 each), 2.7 ms at
// n = 100, m = 50, R = 128 over the whole 60 x 10 schedule, not counting
// the Newton trips, which only some lanes need.  This kernel
// runs at a small share of that: one block per tile keeps 2 of the 132 SMs
// busy at R = 128 (at R = 10,240 the 160 tiles run in two waves), and on
// its SM an inner trip is mostly the rotations' unfused multiply-adds and
// V loads, then the Newton trips (two IEEE divisions a coordinate).  A
// tile split over a thread-block cluster is the next design.
//
// Numerics follow the JAX code operation by operation: -fmad=false, IEEE
// division and sqrtf; den == 0 -> 1e-30; `inside` is false for NaN; nmax
// and nmin propagate NaN like jnp.maximum / jnp.minimum.
//
// Two instantiations, one per source so that nvcc builds them side by
// side: CPT = 4 (n <= 128, ccp_narrow.cu, which holds the C entry) and
// CPT = 8 (n <= 256, ccp_wide.cu).
#pragma once

#include <cstdint>

#include "onevar_common.cuh"

namespace qk {

constexpr int kCcpTile = 64;      // restarts per tile
constexpr int kCcpLanesPerWarp = 2;  // 32 warps a block
constexpr int kCptNarrow = 4;     // n <= 128
constexpr int kCptWide = 8;       // n <= 256, the widest n K4 takes

struct CcpArgs {
  const float* V;
  const float* VT;
  const float* lam0;
  const float* lam1;
  const float* qhat;
  const float* q;
  const float* shift;
  const float* r;
  const float* eq;
  const float* x0;
  float* out;
  float* xs;
  float* us;
  float* xkh;
  float* qm;
  float* rm;
  int* trips;  // (R / 64, 2): outer steps run, inner trips run; or null
  int n, m, E, R, max_iter, inner_iters, warm, n_newton;
  float tau0, mu, tau_max, tau_sat, rho0, stall_tol, inner_tol,
      viol_exit_tol;
};

// The launch of the CPT = 8 instantiation (ccp_wide.cu).
int ccp_launch_wide(const CcpArgs& a, cudaStream_t s);

}  // namespace qk

namespace {

using namespace qk;

constexpr int L = kCcpTile;
constexpr int LPW = kCcpLanesPerWarp;
constexpr unsigned kFull = 0xffffffffu;

template <int CPT>
struct Tile {
  static_assert(CPT % 4 == 0, "lred reduces slabs of 4 groups of 32");
  static constexpr int W = L / LPW;  // warps (blockDim.y)
  const CcpArgs a;
  int t, w, NP, cpt, B, tile;
  float* zs;   // (64, NP) shared: z
  float* zps;  // (64, NP) shared: the previous z
  float* st;   // (64, NP) shared: staging rows of the rotations
  float tau[LPW], rho[LPW], nxk2[LPW];
  bool fin[LPW];

  __device__ int lane(int i) const { return w + W * i; }
  __device__ int col(int c) const { return t + 32 * c; }
  // col(c) < n; false for every c >= cpt as well (32 cpt = NP >= n)
  __device__ bool jv(int c) const { return col(c) < a.n; }
  __device__ int sidx(int i, int c) const { return lane(i) * NP + col(c); }
  // element (lane i, col c) of block b of the (tile, B, 64, n) banks
  __device__ size_t bank(int b, int i, int c) const {
    return (((size_t)tile * B + b) * L + lane(i)) * a.n + col(c);
  }
  __device__ size_t lin(int k, int i, int c) const {  // (tile, m+1, 64, n)
    return (((size_t)tile * (a.m + 1) + k) * L + lane(i)) * a.n + col(c);
  }
  __device__ size_t qmi(int e, int i, int c) const {  // (tile, E, 64, n)
    return (((size_t)tile * a.E + e) * L + lane(i)) * a.n + col(c);
  }
  __device__ size_t rmi(int e, int i) const {  // (tile, E, 64)
    return ((size_t)tile * a.E + e) * L + lane(i);
  }
  __device__ size_t row(int i, int c) const {  // (R, n)
    return ((size_t)tile * L + lane(i)) * a.n + col(c);
  }
  __device__ float cj(const float* p, int k, int c) const {  // p[k][col c]
    return jv(c) ? __ldg(p + (size_t)k * a.n + col(c)) : 0.0f;
  }

  template <bool MAX>
  __device__ static float op(float x, float y) {
    return MAX ? nmax(x, y) : x + y;
  }

  // The sum (MAX = false) or maximum (MAX = true, of values >= 0) over j of
  // one lane's v, padded coordinates 0, in _tree_sum's order: the tree
  // (16, 8, 4, 2, 1) in each group of 32, then the groups in order.  The
  // four trees of a slab of 4 groups run at once: level 16 sends groups
  // 0, 1 to the warp's lower half and 2, 3 to its upper half, level 8 one
  // group to each quarter, levels 4, 2, 1 are a butterfly in each quarter
  // of 8 threads.  Float addition is commutative, so every thread of a
  // quarter ends with the tree's value at position 0.  Every thread of the
  // warp gets the result.
  template <bool MAX>
  __device__ float lred(const float (&v)[CPT]) const {
    const bool b4 = t & 16, b3 = t & 8;
    float acc = 0.0f;
#pragma unroll
    for (int h = 0; h < CPT / 4; ++h) {
      if (4 * h >= cpt) break;
      float x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = jv(4 * h + q) ? v[4 * h + q] : 0.0f;
      const float r0 = __shfl_xor_sync(kFull, b4 ? x[0] : x[2], 16);
      const float r1 = __shfl_xor_sync(kFull, b4 ? x[1] : x[3], 16);
      const float y0 = op<MAX>(b4 ? x[2] : x[0], r0);
      const float y1 = op<MAX>(b4 ? x[3] : x[1], r1);
      const float r = __shfl_xor_sync(kFull, b3 ? y0 : y1, 8);
      float z = op<MAX>(b3 ? y1 : y0, r);
#pragma unroll
      for (int l = 4; l >= 1; l >>= 1)
        z = op<MAX>(z, __shfl_xor_sync(kFull, z, l));
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (4 * h + g >= cpt) break;
        const float gz = __shfl_sync(kFull, z, 8 * g);
        acc = h == 0 && g == 0 ? gz : op<MAX>(acc, gz);
      }
    }
    return acc;
  }
  __device__ float lsum(const float (&v)[CPT]) const { return lred<false>(v); }
  __device__ float lmax(const float (&v)[CPT]) const { return lred<true>(v); }

  // o[i][c] += s[i] * M[k][col c]
  __device__ void axpy(float (&o)[LPW][CPT], const float (&mk)[CPT],
                       const float (&s)[LPW]) const {
#pragma unroll
    for (int i = 0; i < LPW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] = o[i][c] + s[i] * mk[c];
  }
  __device__ void load_row(const float* __restrict__ M, int k,
                           float (&mk)[CPT]) const {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      mk[c] = jv(c) ? __ldg(M + (size_t)k * a.n + col(c)) : 0.0f;
  }

  // o[i][c] = sum_k src[lane i][k] M[k][col c], in order over k (M is
  // n x n); 0 off n.  src is this warp's rows of a (64, NP) shared array.
  __device__ void rot(const float* src, const float* __restrict__ M,
                      float (&o)[LPW][CPT]) const {
    const int n = a.n;
#pragma unroll
    for (int i = 0; i < LPW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] = 0.0f;
    int k = 0;
    for (; k + 4 <= n; k += 4) {
      float4 s4[LPW];
#pragma unroll
      for (int i = 0; i < LPW; ++i)
        s4[i] = *reinterpret_cast<const float4*>(src + lane(i) * NP + k);
      float mk[CPT], s[LPW];
      load_row(M, k, mk);
#pragma unroll
      for (int i = 0; i < LPW; ++i) s[i] = s4[i].x;
      axpy(o, mk, s);
      load_row(M, k + 1, mk);
#pragma unroll
      for (int i = 0; i < LPW; ++i) s[i] = s4[i].y;
      axpy(o, mk, s);
      load_row(M, k + 2, mk);
#pragma unroll
      for (int i = 0; i < LPW; ++i) s[i] = s4[i].z;
      axpy(o, mk, s);
      load_row(M, k + 3, mk);
#pragma unroll
      for (int i = 0; i < LPW; ++i) s[i] = s4[i].w;
      axpy(o, mk, s);
    }
    for (; k < n; ++k) {
      float mk[CPT], s[LPW];
      load_row(M, k, mk);
#pragma unroll
      for (int i = 0; i < LPW; ++i) s[i] = src[lane(i) * NP + k];
      axpy(o, mk, s);
    }
#pragma unroll
    for (int i = 0; i < LPW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (!jv(c)) o[i][c] = 0.0f;
  }

  // Stage v in this warp's rows of st and rotate it by M.
  __device__ void rot_staged(const float (&v)[LPW][CPT], const float* M,
                             float (&o)[LPW][CPT]) const {
    __syncwarp();  // the warp's earlier readers of st are done
#pragma unroll
    for (int i = 0; i < LPW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c < cpt) st[sidx(i, c)] = jv(c) ? v[i][c] : 0.0f;
    __syncwarp();
    rot(st, M, o);
  }

  // The hinge prox of one block for every lane of the warp, in its
  // eigencoordinates: vh, lam, qt, rb in; the prox point out
  // (ccp_pallas.py:70-115).
  __device__ void hinge(const float (&vh)[LPW][CPT], const float (&lam)[CPT],
                        const float (&qt)[LPW][CPT], const float (&rb)[LPW],
                        float (&x_out)[LPW][CPT]) const {
    float s[LPW], e[LPW], nu[LPW];
    unsigned at_v = 0, at_full = 0;  // g_v <= 0, g_full >= 0, per lane
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
      const float wt = tau[i], rh = rho[i];
      float gv[CPT], gf[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float den = rh + (2.0f * wt) * lam[c];
        den = den == 0.0f ? 1e-30f : den;
        const float xf = (rh * vh[i][c] - wt * qt[i][c]) / den;
        gv[c] = (lam[c] * vh[i][c] + qt[i][c]) * vh[i][c];
        gf[c] = (lam[c] * xf + qt[i][c]) * xf;
      }
      if (lsum(gv) + rb[i] <= 0.0f) at_v |= 1u << i;
      if (lsum(gf) + rb[i] >= 0.0f) at_full |= 1u << i;
      s[i] = 0.0f;
      e[i] = wt;
      nu[i] = 0.5f * wt;
    }
    // nu is used only by a lane with neither g_v <= 0 nor g_full >= 0: the
    // other lanes skip the trips (the same in every thread of the warp)
    const unsigned done = at_v | at_full;
    const int trips = done == (1u << LPW) - 1u ? 0 : a.n_newton;
    for (int trip = 0; trip < trips; ++trip) {
#pragma unroll
      for (int i = 0; i < LPW; ++i) {
        if (done >> i & 1u) continue;
        const float rh = rho[i];
        float p0[CPT], p1[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float den = rh + (2.0f * nu[i]) * lam[c];
          den = den == 0.0f ? 1e-30f : den;
          const float x = (rh * vh[i][c] - nu[i] * qt[i][c]) / den;
          const float lam2 = 2.0f * lam[c];
          const float g0 = qt[i][c] + lam2 * vh[i][c];
          p0[c] = (lam[c] * x + qt[i][c]) * x;
          p1[c] = ((lam2 * x + qt[i][c]) * g0) / (den * den);
        }
        const float g = lsum(p0) + rb[i];
        const float dg = (-rh) * lsum(p1);
        if (g > 0.0f) s[i] = nu[i];
        if (g <= 0.0f) e[i] = nu[i];
        const float cand = nu[i] - g / dg;
        const bool inside = (cand >= s[i]) && (cand <= e[i]);
        const float mid = s[i] > 0.0f ? sqrtf(s[i] * e[i])
                                      : e[i] * (1.0f / 1024.0f);
        nu[i] = inside ? cand : mid;
      }
    }
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
      const float rh = rho[i];
      const float at = (at_full >> i & 1u) ? tau[i] : nu[i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float den = rh + (2.0f * at) * lam[c];
        den = den == 0.0f ? 1e-30f : den;
        const float x = (rh * vh[i][c] - at * qt[i][c]) / den;
        x_out[i][c] = (at_v >> i & 1u) ? vh[i][c] : x;
      }
    }
  }

  // The per-outer caches at z (in zs): xkh, qm, rm, |z|^2 (into nxk2);
  // with want_viol, the violation from the rotated copies.
  __device__ void linearize(bool want_viol, float (&viol)[LPW]) {
    const int n = a.n;
#pragma unroll
    for (int i = 0; i < LPW; ++i) viol[i] = 0.0f;
    __syncwarp();  // the warp's writes of zs are visible to its rotations
    for (int k = 0; k <= a.m; ++k) {
      float x[LPW][CPT];
      rot(zs, a.V + (size_t)k * n * n, x);
#pragma unroll
      for (int i = 0; i < LPW; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (jv(c)) a.xkh[lin(k, i, c)] = x[i][c];
      if (k == 0 || !want_viol) continue;
      float l0[CPT], qh[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        l0[c] = cj(a.lam0, k, c);
        qh[c] = cj(a.qhat, k, c);
      }
      const bool eqk = a.eq[k] > 0.5f;
      const float rk = a.r[k];
#pragma unroll
      for (int i = 0; i < LPW; ++i) {
        float f[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          f[c] = (l0[c] * x[i][c] + qh[c]) * x[i][c];
        const float fv = lsum(f) + rk;
        viol[i] = nmax(viol[i], eqk ? fabsf(fv) : nmax(fv, 0.0f));
      }
    }
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
      float f[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float z = c < cpt ? zs[sidx(i, c)] : 0.0f;
        f[c] = z * z;
      }
      nxk2[i] = lsum(f);
    }
    for (int e = 0; e < a.E; ++e) {
      const int k = 1 + e;
      float l1[CPT], qn[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        l1[c] = cj(a.lam1, k, c);
        qn[c] = cj(a.q, k, c);
      }
      float tv[LPW][CPT], tt[LPW][CPT], back[LPW][CPT];
#pragma unroll
      for (int i = 0; i < LPW; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float xh = jv(c) ? a.xkh[lin(k, i, c)] : 0.0f;
          tv[i][c] = l1[c] * xh;
          tt[i][c] = tv[i][c] * xh;
        }
      rot_staged(tv, a.VT + (size_t)k * n * n, back);
#pragma unroll
      for (int i = 0; i < LPW; ++i) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (jv(c))
            a.qm[qmi(e, i, c)] = (-qn[c]) - 2.0f * back[i][c];
        const float sum_tt = lsum(tt[i]);
        if (t == 0) a.rm[rmi(e, i)] = (-a.r[k]) + sum_tt;
      }
    }
    __syncwarp();  // rm, written by thread 0, is read by the whole warp
  }

  // One consensus trip of the warp's lanes; returns the residuals.
  __device__ void inner_step(float (&res)[LPW]) {
    const int n = a.n, m = a.m;
    float S[LPW][CPT], v[LPW][CPT], vh[LPW][CPT], xb[LPW][CPT];
    // z - u of block b, 0 off n
    auto z_minus_u = [&](int b) {
#pragma unroll
      for (int i = 0; i < LPW; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          v[i][c] = jv(c) ? zs[sidx(i, c)] - a.us[bank(b, i, c)] : 0.0f;
    };
    // xs of block b = xb; the consensus sum S += xb + u in bank order (the
    // first block sets it)
    auto gather = [&](int b) {
#pragma unroll
      for (int i = 0; i < LPW; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const float u = jv(c) ? a.us[bank(b, i, c)] : 0.0f;
          if (jv(c)) a.xs[bank(b, i, c)] = xb[i][c];
          S[i][c] = b == 0 ? xb[i][c] + u : S[i][c] + (xb[i][c] + u);
        }
    };
    // the objective block (bank row 0)
    z_minus_u(0);
    rot_staged(v, a.V, vh);
    {
      const float sh2 = 2.0f * a.shift[0];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float qh = cj(a.qhat, 0, c);
        const float l1 = cj(a.lam1, 0, c);
#pragma unroll
        for (int i = 0; i < LPW; ++i) {
          const float xk = jv(c) ? a.xkh[lin(0, i, c)] : 0.0f;
          const float qt0 = qh - sh2 * xk;
          v[i][c] = (rho[i] * vh[i][c] - qt0) / (rho[i] + 2.0f * l1);
        }
      }
    }
    rot_staged(v, a.VT, xb);
    gather(0);
    // the positive hinges (bank rows 1..m)
    for (int k = 1; k <= m; ++k) {
      const size_t off = (size_t)k * n * n;
      z_minus_u(k);
      rot_staged(v, a.V + off, vh);
      const float sh = a.shift[k], rk = a.r[k];
      float lam[CPT], qt[LPW][CPT], rb[LPW];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float qh = cj(a.qhat, k, c);
        lam[c] = cj(a.lam1, k, c);
#pragma unroll
        for (int i = 0; i < LPW; ++i) {
          const float xk = jv(c) ? a.xkh[lin(k, i, c)] : 0.0f;
          qt[i][c] = qh - (2.0f * sh) * xk;
        }
      }
#pragma unroll
      for (int i = 0; i < LPW; ++i) rb[i] = rk + sh * nxk2[i];
      hinge(vh, lam, qt, rb, v);
      rot_staged(v, a.VT + off, xb);
      gather(k);
    }
    // the negative hinges of the equality rows (bank rows m+1..): diagonal
    for (int e = 0; e < a.E; ++e) {
      const int b = m + 1 + e;
      const float sh = a.shift[1 + e];
      float lam[CPT], qt[LPW][CPT], rb[LPW];
      z_minus_u(b);
#pragma unroll
      for (int c = 0; c < CPT; ++c) lam[c] = sh;
#pragma unroll
      for (int i = 0; i < LPW; ++i) {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          qt[i][c] = jv(c) ? a.qm[qmi(e, i, c)] : 0.0f;
        rb[i] = a.rm[rmi(e, i)];
      }
      hinge(v, lam, qt, rb, xb);
      gather(b);
    }
    // the inert blocks add z each; the mean is over 2m + 1 blocks
    const float n_inert = (float)(m - a.E), btot = (float)(2 * m + 1);
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
      float mx0[CPT], mx1[CPT], mx2[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        mx0[c] = mx1[c] = mx2[c] = 0.0f;
        v[i][c] = 0.0f;
        if (c >= cpt) continue;
        const float z = zs[sidx(i, c)];
        const float zn = (S[i][c] + n_inert * z) / btot;
        float pr = 0.0f;
        if (jv(c)) {
          for (int b = 0; b < B; ++b) {
            const size_t o = bank(b, i, c);
            const float d = a.xs[o] - zn;
            a.us[o] = a.us[o] + d;
            pr = nmax(pr, fabsf(d));
          }
        }
        if (m > a.E) pr = nmax(pr, fabsf((2.0f * z - zps[sidx(i, c)]) - zn));
        mx0[c] = pr;
        mx1[c] = fabsf(zn - z);
        mx2[c] = fabsf(zn);
        v[i][c] = zn;
      }
      res[i] = nmax(lmax(mx0), lmax(mx1)) / (1.0f + lmax(mx2));
    }
    // each thread reads and writes only its own elements of zs and zps here
#pragma unroll
    for (int i = 0; i < LPW; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        if (c < cpt) {
          zps[sidx(i, c)] = zs[sidx(i, c)];
          zs[sidx(i, c)] = jv(c) ? v[i][c] : 0.0f;
        }
  }
};

template <int CPT>
__global__ void __launch_bounds__(32 * (L / LPW)) ccp_kernel(CcpArgs a) {
  extern __shared__ float sm[];
  Tile<CPT> T{a};
  T.t = threadIdx.x;
  T.w = threadIdx.y;
  T.NP = (a.n + 31) / 32 * 32;
  T.cpt = T.NP / 32;
  T.B = 1 + a.m + a.E;
  T.tile = blockIdx.x;
  T.zs = sm;
  T.zps = sm + L * T.NP;
  T.st = sm + 2 * L * T.NP;

#pragma unroll
  for (int i = 0; i < LPW; ++i) {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      if (c >= T.cpt) continue;
      const float x = T.jv(c) ? a.x0[T.row(i, c)] : 0.0f;
      T.zs[T.sidx(i, c)] = x;
      if (T.jv(c)) a.out[T.row(i, c)] = x;
    }
    T.tau[i] = a.tau0;
    T.fin[i] = false;
  }

  float viol[LPW], nxk2_old[LPW];
  int n_outer = 0, n_inner = 0;
  for (int it = 0; it < a.max_iter; ++it) {
    bool mine = false;
#pragma unroll
    for (int i = 0; i < LPW; ++i) mine = mine || !T.fin[i];
    if (!__syncthreads_or(mine)) break;  // the whole tile has finished
    ++n_outer;
#pragma unroll
    for (int i = 0; i < LPW; ++i)
      T.rho[i] = a.rho0 * nmax(1.0f, sqrtf(T.tau[i]));
    if (it == 0) T.linearize(false, viol);
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        if (c >= T.cpt) continue;
        if (T.jv(c) && (it == 0 || !a.warm))
          for (int b = 0; b < T.B; ++b) a.us[T.bank(b, i, c)] = 0.0f;
        T.zps[T.sidx(i, c)] = T.zs[T.sidx(i, c)];
      }
      nxk2_old[i] = T.nxk2[i];
    }

    for (int t = 0; t < a.inner_iters; ++t) {
      float res[LPW];
      T.inner_step(res);
      ++n_inner;
      bool gt = false, nan = false;
#pragma unroll
      for (int i = 0; i < LPW; ++i) {
        gt = gt || res[i] > a.inner_tol;
        nan = nan || isnan(res[i]);
      }
      // jnp.max(res) > inner_tol: false once any lane's residual is NaN
      const bool any_nan = __syncthreads_or(nan);
      const bool any_gt = __syncthreads_or(gt);
      if (any_nan || !any_gt) break;
    }

    T.linearize(true, viol);
#pragma unroll
    for (int i = 0; i < LPW; ++i) {
      float dz[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dz[c] = 0.0f;
        if (c >= T.cpt) continue;
        const float z = T.zs[T.sidx(i, c)];
        const float d = z - (T.jv(c) ? a.out[T.row(i, c)] : 0.0f);
        dz[c] = d * d;
        if (T.jv(c)) a.out[T.row(i, c)] = z;
      }
      const float dzs = T.lsum(dz);
      const float tau = T.tau[i];
      const bool stalled =
          sqrtf(dzs) < a.stall_tol * (1.0f + sqrtf(nxk2_old[i]));
      const bool feas = viol[i] < a.viol_exit_tol;
      T.fin[i] = stalled && (feas || tau >= a.tau_sat);
      T.tau[i] = nmin(tau * a.mu, a.tau_max);
    }
  }
  if (a.trips != nullptr && T.t == 0 && T.w == 0) {
    a.trips[2 * T.tile] = n_outer;
    a.trips[2 * T.tile + 1] = n_inner;
  }
}

template <int CPT>
int launch(const CcpArgs& a, cudaStream_t s) {
  const int NP = (a.n + 31) / 32 * 32;
  const dim3 block(32, L / LPW);
  const size_t smem = (size_t)3 * L * NP * sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        ccp_kernel<CPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ccp_kernel<CPT><<<a.R / L, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
