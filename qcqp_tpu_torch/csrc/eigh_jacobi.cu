// K5: batched symmetric eigh by round-robin tournament Jacobi, one block
// per matrix.
//
// Replaces both pallas_calls of qcqp_tpu/kernels/eigh_pallas.py: :272 in
// eigh_jacobi_vec (kernel _jacobi_vec_kernel, round body vec_round_ctx) and
// :377 in _run of eigh_jacobi (kernel _jacobi_kernel).  The two compute the
// same function (the same pivots, inner rotation and tournament schedule)
// and differ in rounding only, so one kernel serves both wrappers of
// kernels/eigh_kernel.py.
//
// Contract: A (B, n0, n0) float32 symmetric, zero-padded here to n (a
// multiple of 128, as the JAX wrappers pad); `rounds` rounds; out lam
// (B, n0), the diagonal at slots 0..n0-1, and V (B, n0, n0), rows 0..n0-1
// and the columns of slots 0..n0-1, both unsorted (the wrapper sorts).
//
// A round, per pair k of slots (2k, 2k+1):
//   params   from the pre-update A: a = A[2k,2k], b = A[2k+1,2k+1],
//            c = A[2k,2k+1]; tau = (b - a) / (c == 0 ? 1 : 2c);
//            t = sign(tau) / (|tau| + sqrt(1 + tau^2)), 1 if tau == 0,
//            0 if c == 0; cs = 1 / sqrt(1 + t^2), sn = t cs (eigh_pallas.py
//            :183-194).  One set serves rows and columns (:198-204).
//   rows     A[2k] <- cs A[2k] - sn A[2k+1], A[2k+1] <- cs A[2k+1] + sn A[2k]
//   columns  the same on the columns of A, then on the columns of V
//   reseat   A <- Pi^T A Pi, V <- V Pi, Pi the tournament permutation
//            (round k+1's slot j holds round k's slot sigma[j]).
// The reseat moves no data: an index map p (slot -> physical row and
// column) is composed with sigma once per round, and the write-out reads
// through it.  So the results are those of the data-moving version, also
// after a round count that is not a multiple of n - 1.
//
// Design: 1,024 threads; each stage is a loop over the pair updates
// (k, j), j fastest.  At n = 128 A and V live in dynamic shared memory for
// the whole run (2 x 128 x 129 floats, 132 KB; the row stride n + 1 keeps
// the column updates, 32 rows of one column per warp, free of bank
// conflicts), so the only device-memory traffic is A in and lam, V out.  A
// wider padding (n0 > 128) does not fit and runs the same code on a
// global-memory scratch (B, 2, n, n + 1) from the wrapper.  Three
// __syncthreads per round: after the parameters (and the next index map),
// after the rows of A and the columns of V, after the columns of A.
//
// What bounds it on the H100: about 9 n^2 operations a round (three
// two-sided pair updates of 3 operations per element, plus the
// parameters), sweeps (n - 1) rounds, over 67 TFLOP/s float32: 0.0046 ms
// for one matrix at n = 128 and 2 sweeps, and B times that.  A single
// matrix runs on one SM, so it is latency-bound: a chain of 3 barriers
// and about 24 dependent shared-memory updates per thread per round.
//
// Numerics follow the plain version operation by operation: -fmad=false
// (cs*x and (-sn)*y rounded apart, then added), IEEE division and sqrtf.
// The JAX code's rsqrt is 1 / sqrt on both sides, correctly rounded on the
// card: torch.rsqrt rounds differently in its CPU vector body and scalar
// tail, so no kernel could equal it everywhere.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int LANE = 128;

// sigma[j] of kernels/eigh_kernel.tournament_permutation(n) in closed form:
// slot j sits on seat arr[j] (arr[2i] = i, arr[2i+1] = n-1-i); the seats
// but seat 0 rotate by one; back to the slot of the new seat.
__device__ __forceinline__ int tournament_sigma(int j, int n) {
  const int seat = (j % 2 == 0) ? j / 2 : n - 1 - j / 2;
  const int rot = seat == 0 ? 0 : (seat == 1 ? n - 1 : seat - 1);
  return rot < n / 2 ? 2 * rot : 2 * (n - 1 - rot) + 1;
}

__device__ __forceinline__ float sign_of(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

template <bool SHARED>
__global__ void __launch_bounds__(THREADS)
eigh_kernel(const float* __restrict__ A_in, float* __restrict__ lam_out,
            float* __restrict__ V_out, float* __restrict__ scratch, int n0,
            int n, int rounds) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  const int h = n / 2;
  const int T = blockDim.x, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  float* A;
  float* V;
  float* rest;
  if (SHARED) {
    A = smem;
    V = smem + (size_t)n * ld;
    rest = smem + 2 * (size_t)n * ld;
  } else {
    A = scratch + b * 2 * (size_t)n * ld;
    V = A + (size_t)n * ld;
    rest = smem;
  }
  float* cs = rest;
  float* sn = rest + h;
  int* sig = reinterpret_cast<int*>(rest + 2 * h);
  int* p = sig + n;        // slot -> physical row/column, this round
  int* pn = p + n;         // the next round's

  const float* Ab = A_in + b * n0 * n0;
  for (int e = tid; e < n * n; e += T) {
    const int i = e / n, j = e % n;
    A[i * ld + j] = (i < n0 && j < n0) ? Ab[i * n0 + j] : 0.f;
    V[i * ld + j] = i == j ? 1.f : 0.f;
  }
  for (int j = tid; j < n; j += T) {
    sig[j] = tournament_sigma(j, n);
    p[j] = j;
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    for (int k = tid; k < h; k += T) {
      const int P = p[2 * k], Q = p[2 * k + 1];
      const float a = A[P * ld + P], bq = A[Q * ld + Q], c = A[P * ld + Q];
      const float tau = (bq - a) / (c == 0.f ? 1.f : 2.f * c);
      float t = sign_of(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
      t = tau == 0.f ? 1.f : t;
      t = c == 0.f ? 0.f : t;
      const float co = 1.f / sqrtf(1.f + t * t);
      cs[k] = co;
      sn[k] = t * co;
    }
    for (int j = tid; j < n; j += T) pn[j] = p[sig[j]];
    __syncthreads();
    // rows of A (j a column) and columns of V (j a row)
    for (int e = tid; e < h * n; e += T) {
      const int k = e / n, j = e % n;
      const int P = p[2 * k], Q = p[2 * k + 1];
      const float c = cs[k], s = sn[k];
      float x = A[P * ld + j], y = A[Q * ld + j];
      A[P * ld + j] = c * x + (-s) * y;
      A[Q * ld + j] = c * y + s * x;
      x = V[j * ld + P];
      y = V[j * ld + Q];
      V[j * ld + P] = c * x + (-s) * y;
      V[j * ld + Q] = c * y + s * x;
    }
    __syncthreads();
    // columns of A (j a row)
    for (int e = tid; e < h * n; e += T) {
      const int k = e / n, j = e % n;
      const int P = p[2 * k], Q = p[2 * k + 1];
      const float c = cs[k], s = sn[k];
      const float x = A[j * ld + P], y = A[j * ld + Q];
      A[j * ld + P] = c * x + (-s) * y;
      A[j * ld + Q] = c * y + s * x;
    }
    __syncthreads();
    int* tmp = p;
    p = pn;
    pn = tmp;
  }

  for (int i = tid; i < n0; i += T) lam_out[b * n0 + i] = A[p[i] * ld + p[i]];
  float* Vb = V_out + b * n0 * n0;
  for (int e = tid; e < n0 * n0; e += T) {
    const int i = e / n0, j = e % n0;
    Vb[e] = V[i * ld + p[j]];
  }
}

template <bool SHARED>
int launch(const float* A, float* lam, float* V, float* scratch, int B,
           int n0, int n, int rounds, cudaStream_t s) {
  const int ld = n + 1;
  const size_t smem =
      (SHARED ? 2 * (size_t)n * ld * sizeof(float) : 0) +
      (size_t)n * sizeof(float) + 3 * (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {  // above 48 KB only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        eigh_kernel<SHARED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  eigh_kernel<SHARED><<<B, THREADS, smem, s>>>(A, lam, V, scratch, n0, n,
                                                rounds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `rounds` Jacobi rounds on each of B matrices (n0 <= n, n a multiple of
// 128; scratch (B, 2, n, n + 1) floats unless n == 128).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int qk_eigh_jacobi(const float* A, float* lam, float* V,
                              float* scratch, int B, int n0, int n,
                              int rounds, void* stream) {
  if (B < 0 || n0 < 1 || n < n0 || n % LANE != 0 || rounds < 0 ||
      (n != LANE && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n == LANE ? launch<true>(A, lam, V, scratch, B, n0, n, rounds, s)
                   : launch<false>(A, lam, V, scratch, B, n0, n, rounds, s);
}
