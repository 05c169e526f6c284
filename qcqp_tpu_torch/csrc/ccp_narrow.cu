// K4 at n <= 128 (CPT = 4), and the C entry, which routes by n; the kernel
// is in ccp_impl.cuh, the n <= 256 instantiation in ccp_wide.cu.
#include "ccp_impl.cuh"

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
  if (n < 1 || n > 32 * kCptWide || m < 0 || E < 0 || E > m || R < 0 ||
      R % L != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  CcpArgs a{V, VT, lam0, lam1, qhat, q, shift, r, eq, x0, out, xs, us, xkh,
            qm, rm, trips, n, m, E, R, max_iter, inner_iters, warm,
            n_newton, tau0, mu, tau_max, tau_sat, rho0, stall_tol,
            inner_tol, viol_exit_tol};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return n <= 32 * kCptNarrow ? launch<kCptNarrow>(a, s)
                              : ccp_launch_wide(a, s);
}
