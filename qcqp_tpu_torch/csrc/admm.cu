// K3: one whole consensus-ADMM phase of a restart batch in one launch.
//
// Replaces qcqp_tpu/kernels/admm_pallas.py `_call_phase` (the kernels
// `_admm_phase1_kernel` and `_admm_phase2_kernel`, run by
// improve_admm_fused).  Contract (kernels/admm_kernel.py, ADMMFusedData):
// per constraint i the eigenvectors Q (m, n, n) and their transposes QT,
// eigenvalues lam and rotated linear terms qhat (m, n), r, eq (1 for '=='),
// lmax, lmin (m,); the phase-2 z-update matrix W = inv(2 (P0 + rho m I))
// and P0 (n, n), q0 (n,); the starts x0 (R, n); the output (R, n); a
// scratch xh, uh (R, m, n) each.
//
// Per restart, in the order of the JAX code:
//   init     xh_i = x0 Q_i, uh_i = 0; the start's violation from xh;
//   phase 1  while viol >= tol: z = sum_i (xh_i - uh_i) Q_i^T / m, then
//            project every constraint at z (below) and keep its violation;
//   phase 2  while not done: z = (2 rho sum_i (xh_i - uh_i) Q_i^T - q0) W,
//            project, then the convergence / divergence breaks and the
//            bucketised best-point tracker (qcqp.py:241-250);
//   project  zh = z Q_i, vh = zh + uh_i; the inequality fast path when
//            f_i(vh) <= 0; else the secular root: the bracket from lmax,
//            lmin, 10 doublings and three x1024 jumps when need_dbl, the
//            bracket tightened at nu = 0, then nw safeguarded Newton trips;
//            xh_i = xhat(nu), uh_i += zh - xh_i.
//
// Design.  One block holds a tile of T = 2 restarts and one thread per
// eigencoordinate j (blockDim = n rounded up to 32, n <= 1024).
// Thread j computes coordinate j of every product in its own registers, by
// an in-order loop over k: zh_j = sum_k z_k Q_i[k][j] reads a row of Q,
// the consensus sum reads a row of QT, rhs W and z P0 read rows of W and
// P0, so a warp's loads are always 32 neighbouring words.  z, the row of
// xh_i - uh_i and rhs are staged in shared memory, from where every thread
// reads them as broadcasts.  The sums over j (f_i, phi and phi' of the
// Newton trips, |dz|^2, the objective) are block reductions: a shuffle tree
// in each warp, the warp sums added in order from shared memory (double
// buffered, so one __syncthreads per reduction).  xh and uh live in the
// global scratch, each thread touching only its own coordinate.  All
// branches around a reduction depend only on reduced values, so they are
// uniform over the block.  Every gate is per restart, as in the JAX
// kernel: a restart that has stopped is left unchanged, and the block
// leaves its iteration loop when every restart of its tile has stopped.
//
// What bounds it on the H100: reading Q.  Q and QT are m n^2 4 B each (2 MB
// at n = 100, m = 50), read once each per iteration by every tile, so they
// are served from the 50 MB L2, not shared memory (227 KB).  A tile of T
// restarts shares each load of Q among T restarts, which divides that L2
// traffic by T; the other cost is the chain of block reductions (about
// m (2 + nw) per iteration), whose latency more blocks per SM hide.  T is
// fixed at compile time.  On an H100 (700 W) at n = 100, m = 50,
// R = 1,024, 50 iterations, phase 1 took 58, 33, 61 and 125 ms at T = 1,
// 2, 4 and 8: __launch_bounds__(1024) caps a thread at 64 registers, so the
// larger tiles spill.
//
// Numerics follow the JAX code operation by operation: -fmad=false, IEEE
// division and sqrtf; den == 0 -> 1e-30; `inside` is false for NaN; nmax
// and nmin propagate NaN like jnp.maximum / jnp.minimum.
#include <cstdint>

#include "onevar_common.cuh"

using namespace qk;

namespace {

struct Args {
  const float* Q;
  const float* QT;
  const float* lam;
  const float* qhat;
  const float* r;
  const float* eq;
  const float* lmax;
  const float* lmin;
  const float* W;
  const float* P0;
  const float* q0;
  const float* x0;
  float* out;
  float* xh;
  float* uh;
  int n, m, R, num_iters, need_dbl, nw;
  float tol, viol_lim, better_tol, rho, r0;
};

constexpr int T = 2;  // restarts per block

struct Block {
  const Args& a;
  int j, NP, W;
  bool jv;         // j < n
  float* zs;       // (T, NP) shared: the current z of each restart
  float* ds;       // (T, NP) shared: staging row
  float* red;      // (2, W, 3T) shared: reduction partials
  int flip;
  bool valid[T];   // tile slot holds a restart
  size_t base[T];  // offset of the slot's restart in the (R, m, n) scratch

  __device__ float* XH(int t, int i) const {
    return a.xh + base[t] + (size_t)i * a.n + j;
  }
  __device__ float* UH(int t, int i) const {
    return a.uh + base[t] + (size_t)i * a.n + j;
  }

  // K sums over j of v (padded lanes contribute 0); every thread gets them.
  template <int K>
  __device__ void sum(float (&v)[K]) {
    const int lane = j & 31, w = j >> 5;
    float* buf = red + flip * (W * 3 * T);
    flip ^= 1;
    for (int k = 0; k < K; ++k) {
      float x = jv ? v[k] : 0.0f;
      x = x + __shfl_down_sync(0xffffffffu, x, 16);
      x = x + __shfl_down_sync(0xffffffffu, x, 8);
      x = x + __shfl_down_sync(0xffffffffu, x, 4);
      x = x + __shfl_down_sync(0xffffffffu, x, 2);
      x = x + __shfl_down_sync(0xffffffffu, x, 1);
      if (lane == 0) buf[w * K + k] = x;
    }
    __syncthreads();
    for (int k = 0; k < K; ++k) {
      float acc = buf[k];
      for (int u = 1; u < W; ++u) acc = acc + buf[u * K + k];
      v[k] = acc;
    }
  }

  // out[t] = sum_k src[t][k] M[k][j], in order over k (M is n x n).
  __device__ void rowvec(const float* src, const float* M, float (&out)[T]) {
    for (int t = 0; t < T; ++t) out[t] = 0.0f;
    if (!jv) return;
    for (int k = 0; k < a.n; ++k) {
      const float mk = M[(size_t)k * a.n + j];
      for (int t = 0; t < T; ++t) out[t] = out[t] + src[t * NP + k] * mk;
    }
  }

  __device__ float viol_of(int i, float f) const {
    return a.eq[i] > 0.5f ? fabsf(f) : nmax(f, 0.0f);
  }

  // sum_i (xh_i - uh_i) Q_i^T at coordinate j, the per-i products added in
  // order over i.
  __device__ void consensus(float (&tot)[T]) {
    for (int t = 0; t < T; ++t) tot[t] = 0.0f;
    for (int i = 0; i < a.m; ++i) {
      __syncthreads();  // earlier readers of ds are done
      for (int t = 0; t < T; ++t)
        ds[t * NP + j] =
            (valid[t] && jv) ? *XH(t, i) - *UH(t, i) : 0.0f;
      __syncthreads();
      float s[T];
      rowvec(ds, a.QT + (size_t)i * a.n * a.n, s);
      for (int t = 0; t < T; ++t) tot[t] = tot[t] + s[t];
    }
  }

  // Stage z in shared memory for the products that read all of it.
  __device__ void put_z(const float (&z)[T]) {
    __syncthreads();
    for (int t = 0; t < T; ++t) zs[t * NP + j] = jv ? z[t] : 0.0f;
    __syncthreads();
  }

  // Rotate the starts (in zs) into every eigenbasis; the start's violation.
  __device__ void init(float (&viol)[T]) {
    for (int t = 0; t < T; ++t) viol[t] = 0.0f;
    for (int i = 0; i < a.m; ++i) {
      float x[T], f[T];
      rowvec(zs, a.Q + (size_t)i * a.n * a.n, x);
      const float lam = jv ? a.lam[i * a.n + j] : 0.0f;
      const float qh = jv ? a.qhat[i * a.n + j] : 0.0f;
      for (int t = 0; t < T; ++t) {
        if (valid[t] && jv) {
          *XH(t, i) = x[t];
          *UH(t, i) = 0.0f;
        }
        f[t] = (lam * x[t] + qh) * x[t];
      }
      sum(f);
      for (int t = 0; t < T; ++t)
        viol[t] = nmax(viol[t], viol_of(i, f[t] + a.r[i]));
    }
  }

  // Project every constraint at z (in zs), updating the live restarts'
  // xh, uh; viol gets the max violation of z.
  __device__ void project_all(const bool (&live)[T], float (&viol)[T]) {
    for (int t = 0; t < T; ++t) viol[t] = 0.0f;
    for (int i = 0; i < a.m; ++i) {
      float zh[T], f[T], vh[T], uh[T], fv[T];
      rowvec(zs, a.Q + (size_t)i * a.n * a.n, zh);
      const float lam = jv ? a.lam[i * a.n + j] : 0.0f;
      const float qh = jv ? a.qhat[i * a.n + j] : 0.0f;
      const float lam2 = 2.0f * lam;
      const float ri = a.r[i];
      const bool eqi = a.eq[i] > 0.5f;
      for (int t = 0; t < T; ++t) f[t] = (lam * zh[t] + qh) * zh[t];
      sum(f);
      for (int t = 0; t < T; ++t) {
        viol[t] = nmax(viol[t], viol_of(i, f[t] + ri));
        uh[t] = (valid[t] && jv) ? *UH(t, i) : 0.0f;
        vh[t] = zh[t] + uh[t];
        fv[t] = (lam * vh[t] + qh) * vh[t];
      }
      sum(fv);
      bool skip[T], any_work = false;
      for (int t = 0; t < T; ++t) {
        fv[t] = fv[t] + ri;
        skip[t] = !eqi && fv[t] <= 0.0f;  // fast path (utilities.py:157)
        any_work = any_work || (live[t] && !skip[t]);
      }
      float xc[T];
      for (int t = 0; t < T; ++t) xc[t] = vh[t];
      if (any_work) {
        const float lmx = a.lmax[i], lmn = a.lmin[i];
        const bool s_bnd = lmx > 0.0f, e_bnd = lmn < 0.0f;
        float s[T], e[T], nu[T];
        for (int t = 0; t < T; ++t) {
          s[t] = s_bnd ? -1.0f / lmx : -1.0f;
          e[t] = e_bnd ? -1.0f / lmn : 1.0f;
        }
        // phi at one nu per restart (xhat by division, as xhat_of)
        auto phi = [&](const float (&at)[T], float (&p)[T]) {
          for (int t = 0; t < T; ++t) {
            float den = 2.0f * (1.0f + at[t] * lam);
            den = den == 0.0f ? 1e-30f : den;
            const float x = (2.0f * vh[t] - at[t] * qh) / den;
            p[t] = (lam * x + qh) * x;
          }
          sum(p);
          for (int t = 0; t < T; ++t) p[t] = p[t] + ri;
        };
        if (a.need_dbl) {
          for (int trip = 0; trip < 13; ++trip) {
            const float fac = trip < 10 ? 2.0f : 1024.0f;
            float p[T];
            if (!s_bnd) {
              phi(s, p);
              for (int t = 0; t < T; ++t)
                if (!skip[t] && p[t] <= 0.0f) s[t] = s[t] * fac;
            }
            if (!e_bnd) {
              phi(e, p);
              for (int t = 0; t < T; ++t)
                if (!skip[t] && p[t] >= 0.0f) e[t] = e[t] * fac;
            }
          }
        }
        float g0[T];
        for (int t = 0; t < T; ++t) {
          g0[t] = qh + lam2 * vh[t];
          if (fv[t] > 0.0f) s[t] = nmax(s[t], 0.0f);
          if (fv[t] < 0.0f) e[t] = nmin(e[t], 0.0f);
          nu[t] = 0.5f * (s[t] + e[t]);
        }
        for (int w = 0; w < a.nw; ++w) {
          float pd[2 * T];
          for (int t = 0; t < T; ++t) {
            float den = 2.0f * (1.0f + nu[t] * lam);
            den = den == 0.0f ? 1e-30f : den;
            const float inv = 1.0f / den;
            const float x = (2.0f * vh[t] - nu[t] * qh) * inv;
            pd[t] = (lam * x + qh) * x;
            pd[T + t] = (lam2 * x + qh) * g0[t] * inv * inv;
          }
          sum(pd);
          for (int t = 0; t < T; ++t) {
            const float p = pd[t] + ri;
            const float dp = -2.0f * pd[T + t];
            if (p >= 0.0f) s[t] = nu[t];
            if (p <= 0.0f) e[t] = nu[t];
            const float cand = nu[t] - p / dp;
            const bool inside = (cand > s[t]) && (cand < e[t]);
            nu[t] = inside ? cand : 0.5f * (s[t] + e[t]);
          }
        }
        for (int t = 0; t < T; ++t) {
          float den = 2.0f * (1.0f + nu[t] * lam);
          den = den == 0.0f ? 1e-30f : den;
          if (!skip[t]) xc[t] = (2.0f * vh[t] - nu[t] * qh) / den;
        }
      }
      for (int t = 0; t < T; ++t) {
        if (live[t] && jv) {
          *XH(t, i) = xc[t];
          *UH(t, i) = uh[t] + zh[t] - xc[t];
        }
      }
    }
  }

  // The objective at z (in zs), with |z - z_last|^2: (f, dz2).
  __device__ void objective(const float (&z)[T], const float (&zl)[T],
                            float (&f)[T], float (&dz2)[T]) {
    float Pz[T], v[3 * T];
    rowvec(zs, a.P0, Pz);
    const float q0 = jv ? a.q0[j] : 0.0f;
    for (int t = 0; t < T; ++t) {
      const float dz = z[t] - zl[t];
      v[t] = z[t] * Pz[t];
      v[T + t] = q0 * z[t];
      v[2 * T + t] = dz * dz;
    }
    sum(v);
    for (int t = 0; t < T; ++t) {
      f[t] = (v[t] + v[T + t]) + a.r0;
      dz2[t] = v[2 * T + t];
    }
  }
};

// __launch_bounds__(1024): every n <= 1024 launches (at most 64 registers a
// thread; ptxas reports the spills, if any).
template <int PHASE>
__global__ void __launch_bounds__(1024) admm_phase_kernel(Args a) {
  extern __shared__ float sm[];
  Block B{a};
  B.j = threadIdx.x;
  B.NP = blockDim.x;
  B.W = blockDim.x >> 5;
  B.jv = B.j < a.n;
  B.zs = sm;
  B.ds = sm + T * B.NP;
  B.red = sm + 2 * T * B.NP;
  B.flip = 0;
  float z[T];
  for (int t = 0; t < T; ++t) {
    const int rid = blockIdx.x * T + t;
    B.valid[t] = rid < a.R;
    B.base[t] = (size_t)(B.valid[t] ? rid : 0) * a.m * a.n;
    z[t] = (B.valid[t] && B.jv) ? a.x0[(size_t)rid * a.n + B.j] : 0.0f;
  }
  B.put_z(z);
  float viol[T];
  B.init(viol);
  bool live[T];

  if (PHASE == 1) {
    for (int it = 0; it < a.num_iters; ++it) {
      bool any = false;
      for (int t = 0; t < T; ++t) {
        live[t] = B.valid[t] && viol[t] >= a.tol;
        any = any || live[t];
      }
      if (!any) break;
      float tot[T];
      B.consensus(tot);
      for (int t = 0; t < T; ++t)
        if (live[t]) z[t] = tot[t] / (float)a.m;
      B.put_z(z);
      float vn[T];
      B.project_all(live, vn);
      for (int t = 0; t < T; ++t)
        if (live[t]) viol[t] = vn[t];
    }
  } else {
    float zl[T], best[T], bb[T], bf[T], dz2[T];
    bool done[T];
    B.objective(z, z, bf, dz2);
    for (int t = 0; t < T; ++t) {
      zl[t] = z[t];
      best[t] = z[t];
      bb[t] = floorf(viol[t] / a.better_tol);
      done[t] = !B.valid[t];
    }
    const float two_rho = 2.0f * a.rho;
    const float q0 = B.jv ? a.q0[B.j] : 0.0f;
    for (int it = 0; it < a.num_iters; ++it) {
      bool any = false;
      for (int t = 0; t < T; ++t) {
        live[t] = !done[t];
        any = any || live[t];
      }
      if (!any) break;
      float tot[T], zn[T];
      B.consensus(tot);
      __syncthreads();
      for (int t = 0; t < T; ++t)
        B.ds[t * B.NP + B.j] = B.jv ? two_rho * tot[t] - q0 : 0.0f;
      __syncthreads();
      B.rowvec(B.ds, a.W, zn);
      for (int t = 0; t < T; ++t)
        if (live[t]) z[t] = zn[t];
      B.put_z(z);
      float vn[T], f[T];
      B.project_all(live, vn);
      B.objective(z, zl, f, dz2);
      for (int t = 0; t < T; ++t) {
        // the breaks fire before the tracker absorbs z (qcqp.py:241-250)
        const bool conv = it > 0 && sqrtf(dz2[t]) < a.tol;
        const float b = floorf(vn[t] / a.better_tol);
        const bool div = vn[t] > a.viol_lim;
        const bool stop = conv || div;
        const bool win = live[t] && !stop &&
                         (b < bb[t] || (b == bb[t] && f[t] < bf[t]));
        if (win) {
          best[t] = z[t];
          bb[t] = b;
          bf[t] = f[t];
        }
        if (live[t] && stop) done[t] = true;
        if (live[t]) zl[t] = z[t];
      }
    }
    for (int t = 0; t < T; ++t) z[t] = best[t];
  }
  for (int t = 0; t < T; ++t) {
    const int rid = blockIdx.x * T + t;
    if (B.valid[t] && B.jv) a.out[(size_t)rid * a.n + B.j] = z[t];
  }
}

int launch(const Args& a, int phase, cudaStream_t s) {
  const int NP = (a.n + 31) / 32 * 32;
  const int blocks = (a.R + T - 1) / T;
  const size_t smem = (size_t)(2 * T * NP + 2 * (NP / 32) * 3 * T) *
                      sizeof(float);
  if (blocks == 0) return 0;
  auto kernel = phase == 1 ? admm_phase_kernel<1> : admm_phase_kernel<2>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, NP, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One ADMM phase (1 or 2) of R restarts.  xh, uh: (R, m, n) scratch each.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape the kernel does not take.
extern "C" int qk_admm_phase(const float* Q, const float* QT,
                             const float* lam, const float* qhat,
                             const float* r, const float* eq,
                             const float* lmax, const float* lmin,
                             const float* W, const float* P0,
                             const float* q0, const float* x0, float* out,
                             float* xh, float* uh, int n, int m, int R,
                             int phase, int num_iters, float tol,
                             float viol_lim, float better_tol, float rho,
                             float r0, int need_dbl, int nw, void* stream) {
  if (n < 1 || n > 1024 || m < 1 || (phase != 1 && phase != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{Q, QT, lam, qhat, r, eq, lmax, lmin, W, P0, q0, x0, out, xh, uh,
         n, m, R, num_iters, need_dbl, nw, tol, viol_lim, better_tol, rho,
         r0};
  return launch(a, phase, static_cast<cudaStream_t>(stream));
}
