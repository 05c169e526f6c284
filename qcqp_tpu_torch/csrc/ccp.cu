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
//            closed-interval acceptance and the log-space midpoint.
//
// Design: one block per tile, blockDim (NP, 64 / LPT): thread (j, g) owns
// eigencoordinate j (NP is n rounded up to 32) of the LPT lanes g, g + 64 /
// LPT, ...  A rotation is one thread per output element, summed over k in
// order from a (64, NP) row staged in shared memory (read as a broadcast)
// times a row of V or VT (32 neighbouring words per warp).  Sums over j are
// block reductions: a shuffle tree in each warp of 32 coordinates, then the
// warps in order (double buffered, one __syncthreads each).  z, the
// previous z and the staging row live in shared memory (3 x 64 x NP floats:
// 96 KB at NP = 128); the block banks in the global scratch, each thread
// touching only its own elements.  Lane scalars (tau, rho, |xk|^2, the
// finished flags) sit in shared memory, written by thread j = 0 of the
// lane's group.
//
// What bounds it on the H100: the work is floating-point operations (each
// inner trip rotates 2 (m + 1) times per restart, 2 n^2 each), 3.5 ms at
// n = 100, m = 50, R = 128 over the whole 60 x 10 schedule; but this
// simple kernel is held back by latency: every inner trip is a chain of
// about 650 block-wide barriers (n_newton + 1 reductions per hinge block,
// two per staged rotation), and ptxas keeps the lane arrays in local
// memory (32 registers, about 3 KB of spills at 8 lanes a thread).  On an
// H100 (700 W) it took 5.06 s at R = 128 (2 blocks on 2 of the 132 SMs)
// and 9.73 s at R = 10,240 (160 blocks, two waves).  Next: a warp per lane
// group, so that the sums are shuffles without block barriers, and a tile
// split over a thread-block cluster.
//
// Numerics follow the JAX code operation by operation: -fmad=false, IEEE
// division and sqrtf; den == 0 -> 1e-30; `inside` is false for NaN; nmax
// and nmin propagate NaN like jnp.maximum / jnp.minimum.
#include <cstdint>

#include "onevar_common.cuh"

using namespace qk;

namespace {

constexpr int L = 64;  // restarts per tile

struct Args {
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

template <int LPT>
struct Tile {
  static constexpr int LG = L / LPT;  // lane groups (blockDim.y)
  const Args& a;
  int j, g, NP, W, B, tile, flip;
  bool jv;        // j < n
  float* zs;      // (64, NP) shared: z
  float* zps;     // (64, NP) shared: the previous z
  float* st;      // (64, NP) shared: staging row of a rotation
  float* red;     // (2, 64, W, 3) shared: reduction partials
  float* tau_s;   // (64,) shared lane scalars
  float* rho_s;
  float* nxk2_s;
  float* live_s;  // 1 - finished

  __device__ int lane(int i) const { return g + LG * i; }
  __device__ int sidx(int i) const { return lane(i) * NP + j; }
  // element (l, j) of block b of the (tile, B, 64, n) banks
  __device__ size_t bank(int b, int i) const {
    return (((size_t)tile * B + b) * L + lane(i)) * a.n + j;
  }
  __device__ size_t lin(int c, int i) const {  // (tile, m+1, 64, n)
    return (((size_t)tile * (a.m + 1) + c) * L + lane(i)) * a.n + j;
  }
  __device__ size_t qmi(int jj, int i) const {  // (tile, E, 64, n)
    return (((size_t)tile * a.E + jj) * L + lane(i)) * a.n + j;
  }
  __device__ size_t rmi(int jj, int i) const {  // (tile, E, 64)
    return ((size_t)tile * a.E + jj) * L + lane(i);
  }
  __device__ size_t row(int i) const {  // (R, n)
    return ((size_t)tile * L + lane(i)) * a.n + j;
  }
  __device__ float cj(const float* p, int c) const {  // p[c][j], 0 off n
    return jv ? p[(size_t)c * a.n + j] : 0.0f;
  }

  // K sums (MAX = false) or maxima (MAX = true, of values >= 0) over j of
  // v[k][i] for every lane; padded coordinates contribute 0.
  template <int K, bool MAX>
  __device__ void reduce(float (&v)[K][LPT]) {
    const int ln = j & 31, w = j >> 5;
    float* buf = red + flip * (L * W * 3);
    flip ^= 1;
    for (int i = 0; i < LPT; ++i) {
      for (int k = 0; k < K; ++k) {
        float x = jv ? v[k][i] : 0.0f;
        for (int h = 16; h >= 1; h >>= 1) {
          const float y = __shfl_down_sync(0xffffffffu, x, h);
          x = MAX ? nmax(x, y) : x + y;
        }
        if (ln == 0) buf[(lane(i) * W + w) * 3 + k] = x;
      }
    }
    __syncthreads();
    for (int i = 0; i < LPT; ++i) {
      for (int k = 0; k < K; ++k) {
        const float* p = buf + lane(i) * W * 3 + k;
        float acc = p[0];
        for (int u = 1; u < W; ++u) acc = MAX ? nmax(acc, p[u * 3])
                                              : acc + p[u * 3];
        v[k][i] = acc;
      }
    }
  }

  // o[i] = sum_k src[lane i][k] M[k][j], in order over k (M is n x n).
  __device__ void rot(const float* src, const float* M, float (&o)[LPT]) {
    for (int i = 0; i < LPT; ++i) o[i] = 0.0f;
    if (!jv) return;
    for (int k = 0; k < a.n; ++k) {
      const float mk = M[(size_t)k * a.n + j];
      for (int i = 0; i < LPT; ++i) o[i] = o[i] + src[lane(i) * NP + k] * mk;
    }
  }

  // Stage v in st and rotate it by M.
  __device__ void rot_staged(const float (&v)[LPT], const float* M,
                             float (&o)[LPT]) {
    __syncthreads();  // earlier readers of st are done
    for (int i = 0; i < LPT; ++i) st[sidx(i)] = jv ? v[i] : 0.0f;
    __syncthreads();
    rot(st, M, o);
  }

  // The hinge prox of one block for every lane, in its eigencoordinates:
  // vh, qt, rb in; the prox point out (ccp_pallas.py:70-115).
  __device__ void hinge(const float (&vh)[LPT], float lam,
                        const float (&qt)[LPT], const float (&rb)[LPT],
                        float (&x_out)[LPT]) {
    const float lam2 = 2.0f * lam;
    float gg[2][LPT], s[LPT], e[LPT], nu[LPT];
    for (int i = 0; i < LPT; ++i) {
      const float w = tau_s[lane(i)], rho = rho_s[lane(i)];
      float den = rho + (2.0f * w) * lam;
      den = den == 0.0f ? 1e-30f : den;
      const float xf = (rho * vh[i] - w * qt[i]) / den;
      gg[0][i] = (lam * vh[i] + qt[i]) * vh[i];
      gg[1][i] = (lam * xf + qt[i]) * xf;
      s[i] = 0.0f;
      e[i] = w;
      nu[i] = 0.5f * w;
    }
    reduce<2, false>(gg);
    unsigned at_v = 0, at_full = 0;  // g_v <= 0, g_full >= 0, per lane
    for (int i = 0; i < LPT; ++i) {
      if (gg[0][i] + rb[i] <= 0.0f) at_v |= 1u << i;
      if (gg[1][i] + rb[i] >= 0.0f) at_full |= 1u << i;
    }
    for (int trip = 0; trip < a.n_newton; ++trip) {
      float pd[2][LPT];
      for (int i = 0; i < LPT; ++i) {
        const float rho = rho_s[lane(i)];
        float den = rho + (2.0f * nu[i]) * lam;
        den = den == 0.0f ? 1e-30f : den;
        const float x = (rho * vh[i] - nu[i] * qt[i]) / den;
        const float g0 = qt[i] + lam2 * vh[i];
        pd[0][i] = (lam * x + qt[i]) * x;
        pd[1][i] = ((lam2 * x + qt[i]) * g0) / (den * den);
      }
      reduce<2, false>(pd);
      for (int i = 0; i < LPT; ++i) {
        const float g = pd[0][i] + rb[i];
        const float dg = (-rho_s[lane(i)]) * pd[1][i];
        if (g > 0.0f) s[i] = nu[i];
        if (g <= 0.0f) e[i] = nu[i];
        const float cand = nu[i] - g / dg;
        const bool inside = (cand >= s[i]) && (cand <= e[i]);
        const float mid = s[i] > 0.0f ? sqrtf(s[i] * e[i])
                                      : e[i] * (1.0f / 1024.0f);
        nu[i] = inside ? cand : mid;
      }
    }
    for (int i = 0; i < LPT; ++i) {
      const float rho = rho_s[lane(i)];
      const float at = (at_full >> i & 1u) ? tau_s[lane(i)] : nu[i];
      float den = rho + (2.0f * at) * lam;
      den = den == 0.0f ? 1e-30f : den;
      const float x = (rho * vh[i] - at * qt[i]) / den;
      x_out[i] = (at_v >> i & 1u) ? vh[i] : x;
    }
  }

  // The per-outer caches at z (in zs): xkh, qm, rm, |z|^2 (into nxk2_s);
  // with want_viol, the violation from the rotated copies.
  __device__ void linearize(bool want_viol, float (&viol)[LPT]) {
    const int n = a.n;
    for (int i = 0; i < LPT; ++i) viol[i] = 0.0f;
    for (int c = 0; c <= a.m; ++c) {
      float x[LPT];
      rot(zs, a.V + (size_t)c * n * n, x);
      if (jv)
        for (int i = 0; i < LPT; ++i) a.xkh[lin(c, i)] = x[i];
      if (c == 0 || !want_viol) continue;
      const float l0 = cj(a.lam0, c), qh = cj(a.qhat, c);
      float f[1][LPT];
      for (int i = 0; i < LPT; ++i) f[0][i] = (l0 * x[i] + qh) * x[i];
      reduce<1, false>(f);
      const bool eqc = a.eq[c] > 0.5f;
      for (int i = 0; i < LPT; ++i) {
        const float fv = f[0][i] + a.r[c];
        viol[i] = nmax(viol[i], eqc ? fabsf(fv) : nmax(fv, 0.0f));
      }
    }
    float f[1][LPT];
    for (int i = 0; i < LPT; ++i) {
      const float z = zs[sidx(i)];
      f[0][i] = z * z;
    }
    reduce<1, false>(f);
    if (j == 0)
      for (int i = 0; i < LPT; ++i) nxk2_s[lane(i)] = f[0][i];
    for (int jj = 0; jj < a.E; ++jj) {
      const int c = 1 + jj;
      const float l1 = cj(a.lam1, c), qn = cj(a.q, c);
      float t[LPT], back[LPT], tt[1][LPT];
      for (int i = 0; i < LPT; ++i) {
        const float xh = jv ? a.xkh[lin(c, i)] : 0.0f;
        t[i] = l1 * xh;
        tt[0][i] = t[i] * xh;
      }
      rot_staged(t, a.VT + (size_t)c * n * n, back);
      if (jv)
        for (int i = 0; i < LPT; ++i)
          a.qm[qmi(jj, i)] = (-qn) - 2.0f * back[i];
      reduce<1, false>(tt);
      if (j == 0)
        for (int i = 0; i < LPT; ++i)
          a.rm[rmi(jj, i)] = (-a.r[c]) + tt[0][i];
    }
  }

  // One consensus trip of every lane; returns the residuals.
  __device__ void inner_step(float (&res)[LPT]) {
    const int n = a.n, m = a.m;
    float S[LPT], v[LPT], vh[LPT], xb[LPT];
    // the objective block (bank row 0)
    for (int i = 0; i < LPT; ++i)
      v[i] = zs[sidx(i)] - (jv ? a.us[bank(0, i)] : 0.0f);
    rot_staged(v, a.V, vh);
    {
      const float qh = cj(a.qhat, 0), l1 = cj(a.lam1, 0);
      const float sh2 = 2.0f * a.shift[0];
      for (int i = 0; i < LPT; ++i) {
        const float rho = rho_s[lane(i)];
        const float qt0 = qh - sh2 * (jv ? a.xkh[lin(0, i)] : 0.0f);
        v[i] = (rho * vh[i] - qt0) / (rho + 2.0f * l1);
      }
    }
    rot_staged(v, a.VT, xb);
    for (int i = 0; i < LPT; ++i) {
      const float u = jv ? a.us[bank(0, i)] : 0.0f;
      if (jv) a.xs[bank(0, i)] = xb[i];
      S[i] = xb[i] + u;
    }
    // the positive hinges (bank rows 1..m)
    for (int c = 1; c <= m; ++c) {
      const size_t off = (size_t)c * n * n;
      for (int i = 0; i < LPT; ++i)
        v[i] = zs[sidx(i)] - (jv ? a.us[bank(c, i)] : 0.0f);
      rot_staged(v, a.V + off, vh);
      const float sh = a.shift[c], qh = cj(a.qhat, c), rc = a.r[c];
      float qt[LPT], rb[LPT];
      for (int i = 0; i < LPT; ++i) {
        qt[i] = qh - (2.0f * sh) * (jv ? a.xkh[lin(c, i)] : 0.0f);
        rb[i] = rc + sh * nxk2_s[lane(i)];
      }
      hinge(vh, cj(a.lam1, c), qt, rb, v);
      rot_staged(v, a.VT + off, xb);
      for (int i = 0; i < LPT; ++i) {
        const float u = jv ? a.us[bank(c, i)] : 0.0f;
        if (jv) a.xs[bank(c, i)] = xb[i];
        S[i] = S[i] + (xb[i] + u);
      }
    }
    // the negative hinges of the equality rows (bank rows m+1..): diagonal
    for (int jj = 0; jj < a.E; ++jj) {
      const int b = m + 1 + jj;
      float qt[LPT], rb[LPT];
      for (int i = 0; i < LPT; ++i) {
        v[i] = zs[sidx(i)] - (jv ? a.us[bank(b, i)] : 0.0f);
        qt[i] = jv ? a.qm[qmi(jj, i)] : 0.0f;
        rb[i] = a.rm[rmi(jj, i)];
      }
      hinge(v, a.shift[1 + jj], qt, rb, xb);
      for (int i = 0; i < LPT; ++i) {
        const float u = jv ? a.us[bank(b, i)] : 0.0f;
        if (jv) a.xs[bank(b, i)] = xb[i];
        S[i] = S[i] + (xb[i] + u);
      }
    }
    // the inert blocks add z each; the mean is over 2m + 1 blocks
    const float n_inert = (float)(m - a.E), btot = (float)(2 * m + 1);
    float mx[3][LPT];
    for (int i = 0; i < LPT; ++i) {
      const float z = zs[sidx(i)];
      const float zn = (S[i] + n_inert * z) / btot;
      float pr = 0.0f;
      if (jv) {
        for (int b = 0; b < B; ++b) {
          const float d = a.xs[bank(b, i)] - zn;
          a.us[bank(b, i)] = a.us[bank(b, i)] + d;
          pr = nmax(pr, fabsf(d));
        }
      }
      if (m > a.E) pr = nmax(pr, fabsf((2.0f * z - zps[sidx(i)]) - zn));
      mx[0][i] = pr;
      mx[1][i] = fabsf(zn - z);
      mx[2][i] = fabsf(zn);
      v[i] = zn;
    }
    reduce<3, true>(mx);
    for (int i = 0; i < LPT; ++i)
      res[i] = nmax(mx[0][i], mx[1][i]) / (1.0f + mx[2][i]);
    __syncthreads();  // every read of zs and zps in this trip is done
    for (int i = 0; i < LPT; ++i) {
      zps[sidx(i)] = zs[sidx(i)];
      zs[sidx(i)] = jv ? v[i] : 0.0f;
    }
  }
};

template <int LPT>
__global__ void __launch_bounds__(1024) ccp_kernel(Args a) {
  extern __shared__ float sm[];
  Tile<LPT> T{a};
  T.j = threadIdx.x;
  T.g = threadIdx.y;
  T.NP = blockDim.x;
  T.W = blockDim.x >> 5;
  T.B = 1 + a.m + a.E;
  T.tile = blockIdx.x;
  T.flip = 0;
  T.jv = T.j < a.n;
  T.zs = sm;
  T.zps = sm + L * T.NP;
  T.st = sm + 2 * L * T.NP;
  T.red = sm + 3 * L * T.NP;
  T.tau_s = T.red + 2 * L * T.W * 3;
  T.rho_s = T.tau_s + L;
  T.nxk2_s = T.rho_s + L;
  T.live_s = T.nxk2_s + L;

  for (int i = 0; i < LPT; ++i) {
    const float x = T.jv ? a.x0[T.row(i)] : 0.0f;
    T.zs[T.sidx(i)] = x;
    if (T.jv) a.out[T.row(i)] = x;
  }
  if (T.j == 0)
    for (int i = 0; i < LPT; ++i) {
      T.tau_s[T.lane(i)] = a.tau0;
      T.live_s[T.lane(i)] = 1.0f;
    }
  __syncthreads();

  float viol[LPT], nxk2_old[LPT];
  int n_outer = 0, n_inner = 0;
  for (int it = 0; it < a.max_iter; ++it) {
    bool mine = false;
    for (int i = 0; i < LPT; ++i) mine = mine || T.live_s[T.lane(i)] > 0.5f;
    if (!__syncthreads_or(mine)) break;  // the whole tile has finished
    ++n_outer;
    if (T.j == 0)
      for (int i = 0; i < LPT; ++i) {
        const float tau = T.tau_s[T.lane(i)];
        T.rho_s[T.lane(i)] = a.rho0 * nmax(1.0f, sqrtf(tau));
      }
    if (it == 0) T.linearize(false, viol);
    for (int i = 0; i < LPT; ++i) {
      if (T.jv && (it == 0 || !a.warm))
        for (int b = 0; b < T.B; ++b) a.us[T.bank(b, i)] = 0.0f;
      T.zps[T.sidx(i)] = T.zs[T.sidx(i)];
    }
    __syncthreads();
    for (int i = 0; i < LPT; ++i) nxk2_old[i] = T.nxk2_s[T.lane(i)];

    for (int t = 0; t < a.inner_iters; ++t) {
      float res[LPT];
      T.inner_step(res);
      ++n_inner;
      bool gt = false, nan = false;
      for (int i = 0; i < LPT; ++i) {
        gt = gt || res[i] > a.inner_tol;
        nan = nan || isnan(res[i]);
      }
      // jnp.max(res) > inner_tol: false once any lane's residual is NaN
      const bool any_nan = __syncthreads_or(nan);
      const bool any_gt = __syncthreads_or(gt);
      if (any_nan || !any_gt) break;
    }

    __syncthreads();
    T.linearize(true, viol);
    float dz[1][LPT];
    for (int i = 0; i < LPT; ++i) {
      const float d = T.zs[T.sidx(i)] - (T.jv ? a.out[T.row(i)] : 0.0f);
      dz[0][i] = d * d;
    }
    T.template reduce<1, false>(dz);
    for (int i = 0; i < LPT; ++i) {
      if (T.jv) a.out[T.row(i)] = T.zs[T.sidx(i)];
    }
    if (T.j == 0)
      for (int i = 0; i < LPT; ++i) {
        const int l = T.lane(i);
        const float tau = T.tau_s[l];
        const bool stalled =
            sqrtf(dz[0][i]) < a.stall_tol * (1.0f + sqrtf(nxk2_old[i]));
        const bool feas = viol[i] < a.viol_exit_tol;
        const bool fin = stalled && (feas || tau >= a.tau_sat);
        T.tau_s[l] = nmin(tau * a.mu, a.tau_max);
        T.live_s[l] = 1.0f - (fin ? 1.0f : 0.0f);
      }
    __syncthreads();
  }
  if (a.trips != nullptr && T.j == 0 && T.g == 0) {
    a.trips[2 * T.tile] = n_outer;
    a.trips[2 * T.tile + 1] = n_inner;
  }
}

template <int LPT>
int launch(const Args& a, cudaStream_t s) {
  const int NP = (a.n + 31) / 32 * 32;
  const dim3 block(NP, L / LPT);
  const size_t smem =
      (size_t)(3 * L * NP + 2 * L * (NP / 32) * 3 + 4 * L) * sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        ccp_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ccp_kernel<LPT><<<a.R / L, block, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The raw penalty-CCP improve of R restarts (R a multiple of 64, n <= 256).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int qk_ccp_improve(
    const float* V, const float* VT, const float* lam0, const float* lam1,
    const float* qhat, const float* q, const float* shift, const float* r,
    const float* eq, const float* x0, float* out, float* xs, float* us,
    float* xkh, float* qm, float* rm, int* trips, int n, int m, int E,
    int R,
    int max_iter, int inner_iters, int warm, int n_newton, float tau0,
    float mu, float tau_max, float tau_sat, float rho0, float stall_tol,
    float inner_tol, float viol_exit_tol, void* stream) {
  if (n < 1 || n > 256 || m < 0 || E < 0 || E > m || R < 0 || R % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  Args a{V, VT, lam0, lam1, qhat, q, shift, r, eq, x0, out, xs, us, xkh,
         qm, rm, trips, n, m, E, R, max_iter, inner_iters, warm, n_newton,
         tau0, mu, tau_max, tau_sat, rho0, stall_tol, inner_tol,
         viol_exit_tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n <= 128 ? launch<8>(a, s) : launch<16>(a, s);
}
