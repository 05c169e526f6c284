// K3: one whole consensus-ADMM phase of a restart batch in one launch.
//
// Replaces qcqp_tpu/kernels/admm_pallas.py `_call_phase` (the kernels
// `_admm_phase1_kernel` and `_admm_phase2_kernel`, run by
// improve_admm_fused).  Contract (kernels/admm_kernel.py, ADMMFusedData):
// per constraint i the eigenvectors Q (m, n, n), eigenvalues lam and
// rotated linear terms qhat (m, n), r, eq (1 for '=='), lmax, lmin (m,);
// the phase-2 z-update matrix W = inv(2 (P0 + rho m I)) and P0 (n, n), q0
// (n,); the starts x0 (R, n); the output (R, n); a scratch uh (R, m, n).
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
// Design.
//   * One warp per restart, coordinates over lanes: lane l owns the
//     eigencoordinates j = l + 32c, c < C = ceil(n / 32).  A sum over j is
//     C trees of tree32's shape (the shuffle-down tree of `_tree_sum`) and
//     the C chunk sums added in order; the trees of one sum, or of the two
//     sums of a Newton trip, share one transposed butterfly (tree_many).
//     No block barrier sits inside a sum, a Newton trip or a doubling trip,
//     and every branch around a shuffle depends only on the warp's own
//     restart.
//   * The block's restarts walk one sequence of staged slabs: per iteration
//     Q_0 ... Q_{m-1} (phase 2: W first and P0 last).  Each slab is copied
//     once per block into shared memory by cp.async (4-byte copies, so any
//     n: a row of Q_i starts on 16 bytes only when 4 divides n), double-
//     buffered, so the next slab is in flight while the warps work on this
//     one.  Each step opens with the only block barrier of the kernel,
//     __syncthreads_or, after which the previous slab's buffer is free and
//     this one is visible; at an iteration's first step its OR says whether
//     any restart of the block is still live.  A warp whose restart has
//     stopped only takes its part in the copies.
//   * The consensus fused into the projection loop: after projecting
//     constraint i, a live warp forms d_i = xh_i - uh_i (in registers: xh_i
//     is the new xhat and uh_i = vh - xhat, as uh + zh == zh + uh) and adds
//     d_i Q_i^T to its running total, reading the same slab by columns.
//     Nothing touches xh, uh between a projection and the next consensus,
//     and a restart that is not live never becomes live again, so this is
//     the JAX code's consensus; xh is never stored, and the global scratch
//     holds uh alone.
//   * The slab's row stride S is n rounded up to 4, then to 4 mod 8: the
//     row product (zh_j = sum_k z_k Q[k][j]) reads a row with lanes on
//     neighbouring words, and the column product (sum_k d_k Q[j][k]) reads
//     four k of a lane's own row as one float4, eight rows a quarter-warp
//     in eight distinct bank groups.
//   * Two storages (template parameter C).  C > 0, n <= 32 C <= 160: the
//     whole Q_i is one slab (2 n S floats double-buffered) and a lane keeps
//     its C coordinates of the product, lam_i and qhat_i in registers.
//     C == 0, any n <= 1024: Q_i is streamed as K-row chunks of Q (for
//     zh = z Q_i) and then K-column chunks of Q, stored transposed (for
//     d Q_i^T), each sum keeping its order over k; the product lives in
//     shared memory too.
//   * z, the product's operand (d_i or rhs), the running total and z_last
//     are kept in the warp's slice of shared memory (np floats each); every
//     lane reads z and the operand as broadcasts, four at a time.
//
// What bounds it on the H100: instruction issue.  Under -fmad=false every
// term of a product is a multiply and an add, plus a shared load per
// coordinate chunk (a quarter of one in the column product), and the
// padded chunk of n = 100 (4 of 32 lanes used) issues as a full one; the
// Newton trips add the trees and an IEEE division per coordinate.  At 94
// registers a thread a block of 16 warps fills an SM.  L2 traffic is one
// copy of each slab per block and iteration, not per restart.
//
// Numerics follow the JAX code operation by operation: -fmad=false, IEEE
// division and sqrtf; den == 0 -> 1e-30; `inside` is false for NaN; nmax
// and nmin propagate NaN like jnp.maximum / jnp.minimum.
#pragma once

#include "onevar_common.cuh"

namespace qk3 {

using qk::nmax;
using qk::nmin;

constexpr int kMaxWarps = 16;             // restarts a block
constexpr int kWholeMaxC = 5;             // whole-slab storage for n <= 160
constexpr size_t kSmemBlockMax = 232448;  // bytes a block may opt in to
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* Q;
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
  float* uh;
  int n, m, R, num_iters, need_dbl, nw;
  float tol, viol_lim, better_tol, rho, r0;
  int warps;  // restarts a block
  int K;      // rows of a staged slab: n for the whole Q_i, else a chunk
};

// The block's shared memory: two slabs of slab_floats(n, K), kTail floats
// that the padded lanes' row reads may touch past the last row, then a
// slice of warp_floats(n, whole) per warp: z, the product operand, the
// total and z_last, np floats each (C == 0: also the product).
constexpr int kTail = 32;
// The row stride S of a slab: n rounded up to 4, then to 4 mod 8, so that a
// row starts on 16 bytes and eight lanes' float4 reads of eight rows fall
// in distinct banks.
__host__ __device__ inline int stride_of(int n) {
  const int s = (n + 3) / 4 * 4;
  return (s / 4) % 2 ? s : s + 4;
}
__host__ __device__ inline int np_of(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ inline int slab_floats(int n, int K) {
  return K * stride_of(n);
}
__host__ __device__ inline int warp_floats(int n, bool whole) {
  return (whole ? 4 : 5) * np_of(n);
}
inline size_t smem_bytes(int n, int K, int warps, bool whole) {
  return sizeof(float) * (2 * (size_t)slab_floats(n, K) + kTail +
                          (size_t)warps * warp_floats(n, whole));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The shuffle-down tree of one 32-chunk, left in every lane.
__device__ __forceinline__ float tree32(float x) {
  x = x + __shfl_xor_sync(kFull, x, 16);
  x = x + __shfl_xor_sync(kFull, x, 8);
  x = x + __shfl_xor_sync(kFull, x, 4);
  x = x + __shfl_xor_sync(kFull, x, 2);
  x = x + __shfl_xor_sync(kFull, x, 1);
  return x;
}

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// V values a lane (V a power of two <= 32), each summed over the warp by
// tree32's tree, with the trees sharing their shuffles: at the first
// log2(V) levels (xor 16, 8, ...) a lane keeps half of its values and
// sends the other half to its partner, which keeps those, so each level
// moves half as many values (every node is the same sum of the same two
// operands as in tree32, the halves swapped by commutation); the rest of
// the levels are tree32's; then value i is read from lane i << (5 -
// log2 V).  2V + 4 - log2(V) shuffles where tree32 each takes 5V.
template <int V>
__device__ __forceinline__ void tree_many(float (&v)[V], int lane) {
  constexpr int L = V >= 32 ? 5 : V >= 16 ? 4 : V >= 8 ? 3 : V >= 4 ? 2
                  : V >= 2 ? 1 : 0;
  static_assert((1 << L) == V && V <= 32, "V: a power of two <= 32");
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const int h = 16 >> t, H = V >> (t + 1);
    const bool up = lane & h;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float keep = up ? v[i + H] : v[i];
      const float send = up ? v[i] : v[i + H];
      v[i] = keep + __shfl_xor_sync(kFull, send, h);
    }
  }
  float x = v[0];
#pragma unroll
  for (int h = 16 >> L; h > 0; h >>= 1)
    x = x + __shfl_xor_sync(kFull, x, h);
#pragma unroll
  for (int i = 0; i < V; ++i)
    v[i] = L == 0 ? x : __shfl_sync(kFull, x, i << (5 - L));
}

enum Kind { kQ, kW, kP0 };

// One step of the block's slab sequence: rows [K chunk, K chunk + K) of Q_i,
// W or P0, or (col) those columns of Q_i, stored transposed; the buffer
// it is staged in; whether it opens an iteration.
struct Step {
  int i;
  unsigned kind : 2, col : 1, chunk : 9, buf : 1, starts : 1;
};

// One restart on one warp.
template <int C>
struct Lane {
  static constexpr bool kReg = C > 0;
  static constexpr int kC = kReg ? C : 1;
  const Args& a;
  int lane, np;
  // the warp's slice: z (read by every lane), the operand of the product
  // (d_i, or rhs), the total, z_last (C == 0: and the product), np each
  float* ws;
  float racc[kC];

  __device__ float* zv() const { return ws; }
  __device__ float* dv() const { return ws + np; }
  __device__ float* fs() const { return ws + 2 * np; }

  __device__ int NC() const {
    if constexpr (kReg) return C;
    else return np >> 5;
  }
  __device__ int J(int c) const { return lane + 32 * c; }
  __device__ bool jv(int c) const { return J(c) < a.n; }
  // an in-bounds coordinate for padded lanes' loads (their terms are 0)
  __device__ int jj(int c) const { return min(J(c), a.n - 1); }
  // each lane's own coordinates of z, the total and z_last (shared
  // memory: registers go to the product and the projection)
  __device__ float& z(int c) { return zv()[J(c)]; }
  __device__ float& tot(int c) { return fs()[J(c)]; }
  __device__ float& zl(int c) { return fs()[np + J(c)]; }
  __device__ float& acc(int c) {
    if constexpr (kReg) return racc[c];
    else return fs()[2 * np + J(c)];
  }

  // z(c) = val(c) for every lane, once every lane has read the old z.
  template <class F>
  __device__ void set_z(F val) {
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC(); ++c) z(c) = val(c);
    __syncwarp();
  }

  // NS sums over j at once, term(c, t) filling t[0 .. NS-1] (padded
  // coordinates add 0, whatever term computes there), each in _tree_sum's
  // order; every lane gets them.  C > 0: the NS C chunk trees share one
  // transposed butterfly (tree_many); C == 0: a tree32 per chunk.
  template <int NS, class F>
  __device__ void wsum(F term, float (&out)[NS]) {
    if constexpr (kReg) {
      // G sums share a butterfly of at most 8 values (more would leave
      // the compiler's full unrolling, and the values in local memory)
      constexpr int P = pow2_at_least(C);
      constexpr int G = P * NS <= 8 ? NS : 1;
      float t[C][NS];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        term(c, t[c]);
#pragma unroll
        for (int k = 0; k < NS; ++k) t[c][k] = jv(c) ? t[c][k] : 0.0f;
      }
#pragma unroll
      for (int k0 = 0; k0 < NS; k0 += G) {
        float v[pow2_at_least(G * C)];
#pragma unroll
        for (int i = 0; i < pow2_at_least(G * C); ++i) v[i] = 0.0f;
#pragma unroll
        for (int k = 0; k < G; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) v[k * C + c] = t[c][k0 + k];
        tree_many(v, lane);
#pragma unroll
        for (int k = 0; k < G; ++k) {
          out[k0 + k] = v[k * C];
#pragma unroll
          for (int c = 1; c < C; ++c) out[k0 + k] = out[k0 + k] + v[k * C + c];
        }
      }
    } else {
      for (int c = 0; c < NC(); ++c) {
        float t[NS];
        term(c, t);
#pragma unroll
        for (int k = 0; k < NS; ++k) {
          const float x = tree32(jv(c) ? t[k] : 0.0f);
          out[k] = c == 0 ? x : out[k] + x;
        }
      }
    }
  }

  template <class F>
  __device__ float wsum1(F term) {
    float out[1];
    wsum<1>([&](int c, float(&t)[1]) { t[0] = term(c); }, out);
    return out[0];
  }

  // acc(c) = (first ? 0 : acc(c)) + sum_{k < rows} src[k] M[k S + j]: the
  // product with M's rows, lanes over j.  Padded lanes read past column n
  // (the slab is followed by at least 32 floats of shared memory); their
  // sums are never used.  src is 16-byte aligned; one rounding per
  // operation, k in order.
  __device__ void row_product(const float* src, const float* M, int rows,
                              int S, bool first) {
    if constexpr (kReg) {
      float s[C];
#pragma unroll
      for (int c = 0; c < C; ++c) s[c] = first ? 0.0f : racc[c];
      const float* p = M + lane;
      int k = 0;
      for (; k + 4 <= rows; k += 4, p += 4 * S) {
        const float4 x = *reinterpret_cast<const float4*>(src + k);
        const float *p1 = p + S, *p2 = p + 2 * S, *p3 = p + 3 * S;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          s[c] = s[c] + x.x * p[32 * c];
          s[c] = s[c] + x.y * p1[32 * c];
          s[c] = s[c] + x.z * p2[32 * c];
          s[c] = s[c] + x.w * p3[32 * c];
        }
      }
      for (; k < rows; ++k, p += S) {
        const float x = src[k];
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = s[c] + x * p[32 * c];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) racc[c] = s[c];
    } else {
      for (int c = 0; c < NC(); ++c) {
        float s = first ? 0.0f : acc(c);
        const float* p = M + J(c);
        for (int k = 0; k < rows; ++k) s = s + src[k] * p[k * S];
        acc(c) = s;
      }
    }
  }

  // acc(c) = sum_{k < n} src[k] M[j S + k]: the product with the whole
  // slab's columns (M^T's rows), lanes over j, four k a float4 read (rows
  // start on 16 bytes); padded lanes read row n - 1.
  __device__ void col_product(const float* src, const float* M, int S) {
    const int n = a.n;
    if constexpr (kReg) {
      float s[C];
      const float* q[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s[c] = 0.0f;
        q[c] = M + (c == C - 1 ? jj(c) : J(c)) * S;
      }
      int k = 0;
      for (; k + 4 <= n; k += 4) {
        const float4 x = *reinterpret_cast<const float4*>(src + k);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float4 y = *reinterpret_cast<const float4*>(q[c] + k);
          s[c] = s[c] + x.x * y.x;
          s[c] = s[c] + x.y * y.y;
          s[c] = s[c] + x.z * y.z;
          s[c] = s[c] + x.w * y.w;
        }
      }
      for (; k < n; ++k) {
        const float x = src[k];
#pragma unroll
        for (int c = 0; c < C; ++c) s[c] = s[c] + x * q[c][k];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) racc[c] = s[c];
    } else {
      for (int c = 0; c < NC(); ++c) {
        float s = 0.0f;
        const float* q = M + jj(c) * S;
        for (int k = 0; k < n; ++k) s = s + src[k] * q[k];
        acc(c) = s;
      }
    }
  }

  __device__ float viol_of(int i, float f) const {
    return a.eq[i] > 0.5f ? fabsf(f) : nmax(f, 0.0f);
  }

  // uh_i of restart rid in the (R, m, n) scratch
  __device__ float* U(int rid, int i) const {
    return a.uh + ((size_t)rid * a.m + i) * a.n;
  }

  // The start rotated into eigenbasis i (in acc): its violation joins
  // viol; uh_i = 0; the consensus operand d_i = xh_i - 0 goes to dv.
  __device__ void init_constraint(int rid, int i, float& viol) {
    const float* lam = a.lam + (size_t)i * a.n;
    const float* qh = a.qhat + (size_t)i * a.n;
    const float f = wsum1([&](int c) {
      const float x = acc(c);
      return (__ldg(lam + jj(c)) * x + __ldg(qh + jj(c))) * x;
    });
    viol = nmax(viol, viol_of(i, f + __ldg(a.r + i)));
    float* u = U(rid, i);
    __syncwarp();  // every lane has read the previous operand
#pragma unroll
    for (int c = 0; c < NC(); ++c)
      if (jv(c)) {
        u[J(c)] = 0.0f;
        dv()[J(c)] = acc(c) - 0.0f;
      }
    __syncwarp();
  }

  // Project constraint i at z, with zh = z Q_i in acc: vn takes the
  // violation of z; uh_i gets its update, dv the consensus operand.
  __device__ void project(int rid, int i, float& vn) {
    const float* lamp = a.lam + (size_t)i * a.n;
    const float* qhp = a.qhat + (size_t)i * a.n;
    float L[kC], H[kC];
    if constexpr (kReg) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        L[c] = __ldg(lamp + jj(c));
        H[c] = __ldg(qhp + jj(c));
      }
    }
    auto lam = [&](int c) -> float {
      if constexpr (kReg) return L[c];
      else return __ldg(lamp + jj(c));
    };
    auto qh = [&](int c) -> float {
      if constexpr (kReg) return H[c];
      else return __ldg(qhp + jj(c));
    };
    const float ri = __ldg(a.r + i);
    const bool eqi = __ldg(a.eq + i) > 0.5f;
    float* u = U(rid, i);
    // vh = zh + uh replaces zh in acc, after both f terms are taken
    float ff[2];
    wsum<2>(
        [&](int c, float(&t)[2]) {
          const float zh = acc(c);
          const float vh = zh + u[jj(c)];
          acc(c) = vh;
          t[0] = (lam(c) * zh + qh(c)) * zh;
          t[1] = (lam(c) * vh + qh(c)) * vh;
        },
        ff);
    vn = nmax(vn, viol_of(i, ff[0] + ri));
    const float fv = ff[1] + ri;
    const bool skip = !eqi && fv <= 0.0f;  // fast path (utilities.py:157)
    float nu = 0.0f;
    if (!skip) {
      const float lmx = __ldg(a.lmax + i), lmn = __ldg(a.lmin + i);
      const bool s_bnd = lmx > 0.0f, e_bnd = lmn < 0.0f;
      float s = s_bnd ? -1.0f / lmx : -1.0f;
      float e = e_bnd ? -1.0f / lmn : 1.0f;
      // phi at nu (xhat by division, as xhat_of)
      auto phi = [&](float at) {
        return wsum1([&](int c) {
                 float den = 2.0f * (1.0f + at * lam(c));
                 den = den == 0.0f ? 1e-30f : den;
                 const float x = (2.0f * acc(c) - at * qh(c)) / den;
                 return (lam(c) * x + qh(c)) * x;
               }) +
               ri;
      };
      if (a.need_dbl) {
        for (int trip = 0; trip < 13; ++trip) {
          const float fac = trip < 10 ? 2.0f : 1024.0f;
          if (!s_bnd && phi(s) <= 0.0f) s = s * fac;
          if (!e_bnd && phi(e) >= 0.0f) e = e * fac;
        }
      }
      if (fv > 0.0f) s = nmax(s, 0.0f);
      if (fv < 0.0f) e = nmin(e, 0.0f);
      nu = 0.5f * (s + e);
      for (int w = 0; w < a.nw; ++w) {
        float pd[2];
        wsum<2>(
            [&](int c, float(&t)[2]) {
              const float lm = lam(c), q = qh(c), vh = acc(c);
              const float lam2 = 2.0f * lm;
              const float g0 = q + lam2 * vh;
              float den = 2.0f * (1.0f + nu * lm);
              den = den == 0.0f ? 1e-30f : den;
              const float inv = 1.0f / den;
              const float x = (2.0f * vh - nu * q) * inv;
              t[0] = (lm * x + q) * x;
              t[1] = (lam2 * x + q) * g0 * inv * inv;
            },
            pd);
        const float p = pd[0] + ri;
        const float dp = -2.0f * pd[1];
        if (p >= 0.0f) s = nu;
        if (p <= 0.0f) e = nu;
        const float cand = nu - p / dp;
        const bool inside = (cand > s) && (cand < e);
        nu = inside ? cand : 0.5f * (s + e);
      }
    }
    __syncwarp();  // every lane has read the previous operand
#pragma unroll
    for (int c = 0; c < NC(); ++c) {
      if (!jv(c)) continue;
      const float vh = acc(c);
      float xc = vh;
      if (!skip) {
        float den = 2.0f * (1.0f + nu * lam(c));
        den = den == 0.0f ? 1e-30f : den;
        xc = (2.0f * vh - nu * qh(c)) / den;
      }
      const float un = vh - xc;
      u[J(c)] = un;
      dv()[J(c)] = xc - un;
    }
    __syncwarp();
  }

  // The objective at z with Pz = z P0 in acc, and |z - z_last|^2.
  __device__ void objective(float& f, float& dz2) {
    float sums[2];
    wsum<2>(
        [&](int c, float(&t)[2]) {
          t[0] = z(c) * acc(c);
          t[1] = __ldg(a.q0 + jj(c)) * z(c);
        },
        sums);
    f = (sums[0] + sums[1]) + a.r0;
    dz2 = wsum1([&](int c) {
      const float dz = z(c) - zl(c);
      return dz * dz;
    });
  }
};

template <int PHASE, int C>
__global__ void __launch_bounds__(32 * kMaxWarps, 1)
    admm_phase_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr bool kWhole = C > 0;
  const int n = a.n, m = a.m, K = a.K;
  const int S = stride_of(n), np = np_of(n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slab = slab_floats(n, K);
  float* ws = smem + 2 * slab + kTail + (size_t)warp * warp_floats(n, kWhole);

  Lane<C> L{a};
  L.lane = lane;
  L.np = np;
  L.ws = ws;
  const int rid = blockIdx.x * a.warps + warp;
  const bool valid = rid < a.R;

  // The slab sequence: per Q_i one step (whole) or K-row chunks then
  // K-column chunks; W and P0 in K-row chunks.  Phase 1 repeats Q_0 ...
  // Q_{m-1}; phase 2 runs them, then P0, and repeats W, the Q_i, P0.
  // next(st) is the step after st, in the other buffer; starts: it opens
  // an iteration.
  const int nk = kWhole ? 1 : (n + K - 1) / K;
  auto next = [&](Step st) {
    st.starts = false;
    st.buf ^= 1;
    if (st.chunk + 1 < nk) {
      ++st.chunk;
      return st;
    }
    st.chunk = 0;
    if (st.kind == kQ) {
      if (!kWhole && !st.col) {
        st.col = true;
        return st;
      }
      st.col = false;
      if (++st.i < m) return st;
      st.i = 0;
      if (PHASE == 2) st.kind = kP0;
      st.starts = PHASE == 1;
    } else if (st.kind == kP0) {
      st.kind = kW;
      st.starts = true;
    } else {
      st.kind = kQ;
    }
    return st;
  };
  auto stage = [&](const Step& st, float* dst) {
    const float* M = st.kind == kQ   ? a.Q + (size_t)st.i * n * n
                     : st.kind == kW ? a.W
                                     : a.P0;
    const int k0 = st.chunk * K, rows = min(K, n - k0);
    if (!st.col) {
      for (int kk = warp; kk < rows; kk += a.warps)
        for (int j = lane; j < n; j += 32)
          cp_async4(dst + kk * S + j, M + (size_t)(k0 + kk) * n + j);
    } else {
      for (int j = warp; j < n; j += a.warps)
        for (int kk = lane; kk < rows; kk += 32)
          cp_async4(dst + kk * S + j, M + (size_t)j * n + k0 + kk);
    }
  };

  L.set_z([&](int c) {
    return (valid && L.jv(c)) ? __ldg(a.x0 + (size_t)rid * n + L.J(c)) : 0.0f;
  });
#pragma unroll
  for (int c = 0; c < L.NC(); ++c) {
    L.tot(c) = 0.0f;
    L.zl(c) = L.z(c);
  }
  float viol = 0.0f, vn = 0.0f, bb = 0.0f, bf = 0.0f;
  int it = -1;

  bool init = true, live = false, done = !valid;
  Step st{0, kQ, 0, 0, 0, 0};
  stage(st, smem);
  for (;; st = next(st)) {
    const bool starts = st.starts;
    if (starts) {
      init = false;
      if (++it >= a.num_iters) break;  // uniform
      live = PHASE == 1 ? (valid && viol >= a.tol) : !done;
    }
    cp_async_wait_all();
    // the staging gate: this slab visible, the previous one's buffer free
    const int any = __syncthreads_or(live);
    if (starts && !any) break;
    const Step nx = next(st);
    stage(nx, smem + nx.buf * slab);
    if (!(init ? valid : live)) continue;
    const float* M = smem + st.buf * slab;
    const int k0 = st.chunk * K, rows = min(K, n - k0);
    const bool last = st.chunk == nk - 1;
    if (st.kind == kQ) {
      if (PHASE == 1 && starts) {  // z = sum_i (xh_i - uh_i) Q_i^T / m
        L.set_z([&](int c) { return L.tot(c) / (float)m; });
#pragma unroll
        for (int c = 0; c < L.NC(); ++c) L.tot(c) = 0.0f;
        vn = 0.0f;
      }
      if (!st.col) {
        L.row_product(L.zv() + k0, M, rows, S, st.chunk == 0);
        if (last) {
          if (init) {
            L.init_constraint(rid, st.i, viol);
          } else {
            L.project(rid, st.i, vn);
            if (PHASE == 1 && st.i == m - 1) viol = vn;
          }
        }
      }
      if (kWhole || st.col) {  // the consensus: d_i Q_i^T, k in order
        if (kWhole)
          L.col_product(L.dv(), M, S);
        else  // the chunk holds Q_i's columns k0 ... as rows
          L.row_product(L.dv() + k0, M, rows, S, st.chunk == 0);
        if (kWhole || last) {
#pragma unroll
          for (int c = 0; c < L.NC(); ++c) L.tot(c) = L.tot(c) + L.acc(c);
        }
      }
    } else if (st.kind == kW) {
      if (starts) {  // rhs = 2 rho sum_i (xh_i - uh_i) Q_i^T - q0
        const float two_rho = 2.0f * a.rho;
        __syncwarp();
#pragma unroll
        for (int c = 0; c < L.NC(); ++c) {
          if (L.jv(c)) L.dv()[L.J(c)] = two_rho * L.tot(c) - a.q0[L.J(c)];
          L.tot(c) = 0.0f;
        }
        __syncwarp();
        vn = 0.0f;
      }
      L.row_product(L.dv() + k0, M, rows, S, st.chunk == 0);
      if (last) L.set_z([&](int c) { return L.acc(c); });
    } else {  // P0: the objective, then the breaks and the tracker
      L.row_product(L.zv() + k0, M, rows, S, st.chunk == 0);
      if (!last) continue;
      float f, dz2;
      L.objective(f, dz2);
      float* out = a.out + (size_t)rid * n;
      if (init) {
        bf = f;
        bb = floorf(viol / a.better_tol);
#pragma unroll
        for (int c = 0; c < L.NC(); ++c) {
          L.zl(c) = L.z(c);
          if (L.jv(c)) out[L.J(c)] = L.z(c);
        }
        continue;
      }
      // the breaks fire before the tracker absorbs z (qcqp.py:241-250)
      const bool conv = it > 0 && sqrtf(dz2) < a.tol;
      const float b = floorf(vn / a.better_tol);
      const bool stop = conv || vn > a.viol_lim;
      if (!stop && (b < bb || (b == bb && f < bf))) {
        bb = b;
        bf = f;
#pragma unroll
        for (int c = 0; c < L.NC(); ++c)
          if (L.jv(c)) out[L.J(c)] = L.z(c);
      }
      if (stop) done = true;
#pragma unroll
      for (int c = 0; c < L.NC(); ++c) L.zl(c) = L.z(c);
    }
  }
  cp_async_wait_all();  // the last prefetch, if the loop left before it
  if (PHASE == 1 && valid) {
#pragma unroll
    for (int c = 0; c < L.NC(); ++c)
      if (L.jv(c)) a.out[(size_t)rid * n + L.J(c)] = L.z(c);
  }
}

// One launch of the storage C (0: chunked), phase 1 or 2.
template <int C>
int launch(const Args& a, int phase, cudaStream_t s) {
  const size_t smem = smem_bytes(a.n, a.K, a.warps, C > 0);
  auto kernel =
      phase == 1 ? admm_phase_kernel<1, C> : admm_phase_kernel<2, C>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (a.R + a.warps - 1) / a.warps;
  kernel<<<blocks, 32 * a.warps, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qk3
