// K3's C entry and its chunked instantiation (C == 0, any n <= 1,024); the
// kernel is in admm_impl.cuh, the whole-slab instantiations (C = 1 ... 5,
// n <= 160) in admm_whole_a.cu and admm_whole_b.cu, which nvcc builds
// alongside.
#include "admm_impl.cuh"

namespace qk3 {
extern template int launch<1>(const Args&, int, cudaStream_t);
extern template int launch<2>(const Args&, int, cudaStream_t);
extern template int launch<3>(const Args&, int, cudaStream_t);
extern template int launch<4>(const Args&, int, cudaStream_t);
extern template int launch<5>(const Args&, int, cudaStream_t);
template int launch<0>(const Args&, int, cudaStream_t);
}  // namespace qk3

using namespace qk3;

// One ADMM phase (1 or 2) of R restarts.  uh: (R, m, n) scratch.  `warps`
// restarts a block and `chunk_rows` (0: the whole Q_i a slab, n <= 160;
// else a multiple of 4) come from kernels/admm_kernel.launch_geometry.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a shape or geometry the kernel does not take.
extern "C" int qk_admm_phase(const float* Q, const float* lam,
                             const float* qhat, const float* r,
                             const float* eq, const float* lmax,
                             const float* lmin, const float* W,
                             const float* P0, const float* q0,
                             const float* x0, float* out, float* uh, int n,
                             int m, int R, int phase, int num_iters,
                             float tol, float viol_lim, float better_tol,
                             float rho, float r0, int need_dbl, int nw,
                             int warps, int chunk_rows, void* stream) {
  const bool whole = chunk_rows == 0;
  const int K = whole ? n : chunk_rows;
  if (n < 1 || n > 1024 || m < 1 || (phase != 1 && phase != 2) ||
      warps < 1 || warps > kMaxWarps || (whole && n > 32 * kWholeMaxC) ||
      (!whole && (chunk_rows < 4 || chunk_rows % 4 != 0)) ||
      smem_bytes(n, K, warps, whole) > kSmemBlockMax)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R <= 0) return 0;
  const Args a{Q,  lam, qhat, r,         eq,       lmax,       lmin, W,
               P0, q0,  x0,   out,       uh,       n,          m,    R,
               num_iters, need_dbl,      nw,       tol,        viol_lim,
               better_tol, rho, r0,      warps,    K};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (whole ? (n + 31) / 32 : 0) {
    case 1: return launch<1>(a, phase, s);
    case 2: return launch<2>(a, phase, s);
    case 3: return launch<3>(a, phase, s);
    case 4: return launch<4>(a, phase, s);
    case 5: return launch<5>(a, phase, s);
    default: return launch<0>(a, phase, s);
  }
}
