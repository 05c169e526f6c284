// K5: batched symmetric eigh by round-robin tournament Jacobi, working only
// on the real n0 x n0 block.
//
// Replaces both pallas_calls of qcqp_tpu/kernels/eigh_pallas.py: :272 in
// eigh_jacobi_vec (kernel _jacobi_vec_kernel, round body vec_round_ctx) and
// :377 in _run of eigh_jacobi (kernel _jacobi_kernel).  The two compute the
// same function (the same pivots, inner rotation and tournament schedule)
// and differ in rounding only, so one kernel serves both wrappers of
// kernels/eigh_kernel.py.
//
// Contract: A (B, n0, n0) float32 symmetric, which the JAX wrappers pad
// with zeros to n (a multiple of 128) and run `rounds` tournament rounds
// on; out lam (B, n0), the diagonal at slots 0..n0-1, and V (B, n0, n0),
// rows 0..n0-1 and the columns of slots 0..n0-1, both unsorted (the
// wrapper sorts).
//
// A round, per pair k of slots (2k, 2k+1):
//   params   from the pre-update A: a = A[2k,2k], b = A[2k+1,2k+1],
//            c = A[2k,2k+1]; tau = (b - a) / (c == 0 ? 1 : 2c);
//            t = sign(tau) / (|tau| + sqrt(1 + tau^2)), 1 if tau == 0,
//            0 if c == 0; cs = 1 / sqrt(1 + t^2), sn = t cs (eigh_pallas.py
//            :183-194).  One set serves rows and columns (:198-204).
//   rows     A[2k] <- cs A[2k] - sn A[2k+1], A[2k+1] <- cs A[2k+1] + sn A[2k]
//   columns  the same on the columns of A, then on the columns of V
//   reseat   A <- Pi^T A Pi, V <- V Pi (kernels/eigh_kernel.
//            tournament_permutation).
//
// Only real pairs are worked.  A pair with a padded slot has c = 0, so its
// rotation is cs = 1, sn = 0, an identity for finite values: padded rows
// and columns of A stay +-0 and the padded columns of V stay e_Q, whose
// rows < n0 are +-0.  So A and V are kept at n0 x n0, and the reseat moves
// no data: each round's physical pairs (p[2k], p[2k+1]) depend only on
// (n, n0, rounds), and the wrapper builds them once on the host
// (eigh_kernel.real_pair_schedule: for each round with a real pair, its
// real pairs packed as P | Q << 16, -1 past them; rounds without one are
// left out) and the final slot -> physical map, by which the write-out
// reads lam and V's columns (a padded physical index writes 0, as the
// plain version's +-0).  The values equal those of the plain version, which
// works on all n (eigh_kernel.eigh_jacobi_vec_ref), for finite inputs; a
// non-finite input spreads NaN through the padded rows there (0 * inf)
// and into fewer entries here.
//
// Design.  Warps own pairs, lanes own columns.  Warp wi of the W that
// share a matrix owns the round's pairs wi + W q; lane l computes the
// parameters of the warp's pair q = l + 32 g (g < G) into registers, and
// a shuffle hands them to the warp when it applies pair q.  A lane's
// columns (or rows) are j = lane + 32 c, c < C: no division.  Stage 1
// rotates A's rows and V's columns of the warp's pairs, stage 2 A's
// columns; only the owning warp touches a pair's rows in stage 1 and its
// columns in stage 2, so a round needs a sync after each stage, none
// after the parameters (a __syncwarp orders a warp's parameter reads
// before its writes).  The next round's pairs are loaded while this one
// runs.  Three storages, which launch_geometry in kernels/eigh_kernel.py
// chooses and sizes (its cut points as of now):
//   n0 <= 32   one warp a matrix, several matrices a block, A and V in
//              shared memory, __syncwarp only (C = 1);
//   n0 <= 169  one block a matrix, A and V in shared memory (2 n0 ld
//              floats, ld = n0 rounded up to odd, so that the strided
//              column updates are free of bank conflicts), W warps sized
//              to the round's largest pair count (C = 2..6);
//   larger     the same on a global scratch (B, 2, n0, ld) from the
//              wrapper, C read at run time, G = 4 (n0 <= 8,192).
//
// What bounds it on the H100: a real pair costs 15 operations for its
// parameters and 18 n0 for its three two-sided updates; over 67 TFLOP/s
// float32 that is 0.0365 ms for 132 matrices at n0 = 101 and 2 sweeps.
// What it meets first is shared-memory issue: 6 loads and stores an
// element of a pair (one warp instruction a clock an SM), and one SM per
// matrix at B <= 132, so a round is a chain of 2 syncs and a few pairs a
// warp.
//
// Numerics follow the plain version operation by operation: -fmad=false
// (cs*x and (-sn)*y rounded apart, then added), IEEE division and sqrtf.
// The JAX code's rsqrt is 1 / sqrt on both sides, correctly rounded on the
// card: torch.rsqrt rounds differently in its CPU vector body and scalar
// tail, so no kernel could equal it everywhere.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int GLOBAL_G = 4;  // pairs a lane holds, global storage

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ void rotation(float a, float b, float c,
                                         float& cs, float& sn) {
  const float tau = (b - a) / (c == 0.f ? 1.f : 2.f * c);
  float t = sign_of(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
  t = tau == 0.f ? 1.f : t;
  t = c == 0.f ? 0.f : t;
  cs = 1.f / sqrtf(1.f + t * t);
  sn = t * cs;
}

// x <- c x - s y, y <- c y + s x for the pairs u < m of a batch of U:
// x at base[xo[u] + j * step], y at base[yo[u] + j * step], for this
// lane's j = lane + 32 k < n0.  All the batch's loads come first (the
// pairs are disjoint), so a warp keeps U pairs' loads in flight.
template <int C, int U>
__device__ __forceinline__ void rotate(float* base, const int (&xo)[U],
                                       const int (&yo)[U], int step, int n0,
                                       int nc, int lane, const float (&c)[U],
                                       const float (&s)[U], int m) {
  if constexpr (C > 0) {
    float x[U][C], y[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int j = lane + 32 * k;
        if (u < m && j < n0) {
          x[u][k] = base[xo[u] + j * step];
          y[u][k] = base[yo[u] + j * step];
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const int j = lane + 32 * k;
        if (u < m && j < n0) {
          base[xo[u] + j * step] = c[u] * x[u][k] + (-s[u]) * y[u][k];
          base[yo[u] + j * step] = c[u] * y[u][k] + s[u] * x[u][k];
        }
      }
  } else {
    for (int u = 0; u < U && u < m; ++u)
      for (int k = 0; k < nc; ++k) {
        const int j = lane + 32 * k;
        if (j < n0) {
          float* px = base + xo[u] + j * step;
          float* py = base + yo[u] + j * step;
          const float x = *px, y = *py;
          *px = c[u] * x + (-s[u]) * y;
          *py = c[u] * y + s[u] * x;
        }
      }
  }
}

// The parameters of the warp's pairs l0 .. l0 + U - 1 from the lanes that
// hold them, and each pair's offsets: rows of A (P ld, Q ld) and columns
// (P, Q).  A lane past the warp's pairs gives values rotate() never reads.
template <int U>
__device__ __forceinline__ void fetch_batch(float cs, float sn, int pq,
                                            int l0, int ld, float (&c)[U],
                                            float (&s)[U], int (&P)[U],
                                            int (&Q)[U], int (&Pr)[U],
                                            int (&Qr)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int l = (l0 + u) & 31;
    c[u] = __shfl_sync(FULL, cs, l);
    s[u] = __shfl_sync(FULL, sn, l);
    const int v = __shfl_sync(FULL, pq, l);
    P[u] = v & 0xffff;
    Q[u] = v >> 16;
    Pr[u] = P[u] * ld;
    Qr[u] = Q[u] * ld;
  }
}

template <bool PER_WARP>
__device__ __forceinline__ void sync_matrix() {
  if (PER_WARP)
    __syncwarp();
  else
    __syncthreads();
}

// C: column chunks a lane (0: read n0 at run time); G: pairs a lane holds
// a round; PER_WARP: one warp a matrix (else one block); GLOBAL: A and V
// in the scratch.
template <int C, int G, bool PER_WARP, bool GLOBAL>
__global__ void __launch_bounds__(1024)
eigh_kernel(const float* __restrict__ A_in, float* __restrict__ lam_out,
            float* __restrict__ V_out, float* __restrict__ scratch,
            const int* __restrict__ sched, const int* __restrict__ perm,
            int B, int n0, int nrounds, int maxp, int mats) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = n0 | 1;
  const size_t mat = 2 * (size_t)n0 * ld;
  int b, wi, W;
  float* A;
  if (PER_WARP) {
    b = blockIdx.x * mats + warp;
    if (b >= B) return;  // a warp syncs only with itself
    wi = 0;
    W = 1;
    A = smem + warp * mat;
  } else {
    b = blockIdx.x;
    wi = warp;
    W = blockDim.x >> 5;
    A = GLOBAL ? scratch + b * mat : smem;
  }
  float* V = A + (size_t)n0 * ld;
  const int nc = C > 0 ? C : (n0 + 31) >> 5;
  constexpr int U = C == 1 ? 4 : 1;  // pairs a batch (latency at n0 <= 32)

  const float* Ab = A_in + (size_t)b * n0 * n0;
  for (int i = wi; i < n0; i += W)
    for (int j = lane; j < n0; j += 32) {
      A[i * ld + j] = Ab[(size_t)i * n0 + j];
      V[i * ld + j] = i == j ? 1.f : 0.f;
    }

  // this lane's pairs of round r: entries wi + W (lane + 32 g)
  int next[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int k = wi + W * (lane + 32 * g);
    next[g] = nrounds > 0 && k < maxp ? __ldg(sched + k) : -1;
  }
  sync_matrix<PER_WARP>();

  for (int r = 0; r < nrounds; ++r) {
    int pq[G];
    float cs[G], sn[G];
    int cnt = 0;  // the warp's pairs this round, a prefix of q
#pragma unroll
    for (int g = 0; g < G; ++g) {
      pq[g] = next[g];
      const int k = wi + W * (lane + 32 * g);
      next[g] = r + 1 < nrounds && k < maxp
                    ? __ldg(sched + (size_t)(r + 1) * maxp + k)
                    : -1;
      cs[g] = 1.f;
      sn[g] = 0.f;
      if (pq[g] >= 0) {
        const int P = pq[g] & 0xffff, Q = pq[g] >> 16;
        rotation(A[P * ld + P], A[Q * ld + Q], A[P * ld + Q], cs[g], sn[g]);
      }
      cnt += __popc(__ballot_sync(FULL, pq[g] >= 0));
    }
    __syncwarp();
    // stage 1: rows of A (lanes over columns), columns of V (over rows)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int end = min(32, cnt - 32 * g);
      for (int l0 = 0; l0 < end; l0 += U) {
        float c[U], s[U];
        int P[U], Q[U], Pr[U], Qr[U];
        fetch_batch<U>(cs[g], sn[g], pq[g], l0, ld, c, s, P, Q, Pr, Qr);
        const int m = min(U, end - l0);
        rotate<C, U>(A, Pr, Qr, 1, n0, nc, lane, c, s, m);
        rotate<C, U>(V, P, Q, ld, n0, nc, lane, c, s, m);
      }
    }
    sync_matrix<PER_WARP>();
    // stage 2: columns of A (lanes over rows)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int end = min(32, cnt - 32 * g);
      for (int l0 = 0; l0 < end; l0 += U) {
        float c[U], s[U];
        int P[U], Q[U], Pr[U], Qr[U];
        fetch_batch<U>(cs[g], sn[g], pq[g], l0, ld, c, s, P, Q, Pr, Qr);
        rotate<C, U>(A, P, Q, ld, n0, nc, lane, c, s, min(U, end - l0));
      }
    }
    sync_matrix<PER_WARP>();
  }

  float* Vb = V_out + (size_t)b * n0 * n0;
  for (int j = lane; j < n0; j += 32) {
    const int ph = __ldg(perm + j);
    if (wi == 0) lam_out[(size_t)b * n0 + j] = ph < n0 ? A[ph * ld + ph] : 0.f;
    for (int i = wi; i < n0; i += W)
      Vb[(size_t)i * n0 + j] = ph < n0 ? V[i * ld + ph] : 0.f;
  }
}

template <int C, int G, bool PER_WARP, bool GLOBAL>
int launch(const float* A, float* lam, float* V, float* scratch,
           const int* sched, const int* perm, int B, int n0, int nrounds,
           int maxp, int mats, int warps, size_t smem, cudaStream_t s) {
  auto kernel = eigh_kernel<C, G, PER_WARP, GLOBAL>;
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = PER_WARP ? (B + mats - 1) / mats : B;
  const int threads = 32 * (PER_WARP ? mats : warps);
  kernel<<<grid, threads, smem, s>>>(A, lam, V, scratch, sched, perm, B, n0,
                                     nrounds, maxp, mats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nrounds rounds of the real-pair schedule `sched` ((nrounds, maxp) int32,
// P | Q << 16 with -1 past a round's pairs) on each of B matrices, then
// the write-out through `perm` (n0 int32, slot -> physical index, >= n0
// for a padded one).  The geometry is eigh_kernel.launch_geometry's, which
// alone chooses the storage: smem == 0 puts A and V in `scratch`
// ((B, 2, n0, n0 | 1) floats, one block of `warps` warps a matrix);
// otherwise they live in `smem` bytes of shared memory, one warp a matrix
// and `mats` a block where n0 <= 32 (one column a lane), else one block
// of `warps` warps a matrix (n0 <= 192, six columns a lane).  Checked here
// is only what the kernel's memory needs: the storage fits `smem`, a
// round's pairs fit the lanes (maxp <= 32 G warps); a block above the
// card's shared memory fails in cudaFuncSetAttribute.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int qk_eigh_jacobi(const float* A, float* lam, float* V,
                              float* scratch, const int* sched,
                              const int* perm, int B, int n0, int nrounds,
                              int maxp, int mats, int warps, int smem,
                              void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (B < 0 || n0 < 1 || nrounds < 0 || maxp < 0 ||
      (nrounds > 0 && (sched == nullptr || maxp < 1)) || perm == nullptr ||
      mats < 1 || warps < 1 || smem < 0)
    return invalid;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem == 0) {
    if (mats != 1 || scratch == nullptr || maxp > 32 * GLOBAL_G * warps)
      return invalid;
    return launch<0, GLOBAL_G, false, true>(A, lam, V, scratch, sched, perm,
                                            B, n0, nrounds, maxp, 1, warps,
                                            0, s);
  }
  const size_t mat = 2 * (size_t)n0 * (n0 | 1) * sizeof(float);
  if ((size_t)mats * mat > (size_t)smem) return invalid;
  const int C = (n0 + 31) / 32;
  if (C == 1) {
    if (warps != 1 || maxp > 32) return invalid;
    return launch<1, 1, true, false>(A, lam, V, scratch, sched, perm, B, n0,
                                     nrounds, maxp, mats, 1, smem, s);
  }
  if (mats != 1 || maxp > 32 * warps) return invalid;
#define K5_SHARED(C_)                                                    \
  launch<C_, 1, false, false>(A, lam, V, scratch, sched, perm, B, n0,    \
                              nrounds, maxp, 1, warps, smem, s)
  switch (C) {
    case 2: return K5_SHARED(2);
    case 3: return K5_SHARED(3);
    case 4: return K5_SHARED(4);
    case 5: return K5_SHARED(5);
    case 6: return K5_SHARED(6);
    default: return invalid;
  }
#undef K5_SHARED
}
