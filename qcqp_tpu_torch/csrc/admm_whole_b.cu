// K3's whole-slab instantiations for 96 < n <= 160 (C = 4, 5 coordinates a
// lane; the bench form's n = 100 runs C = 4), built beside admm.cu; the
// kernel is in admm_impl.cuh.
#include "admm_impl.cuh"

namespace qk3 {
template int launch<4>(const Args&, int, cudaStream_t);
template int launch<5>(const Args&, int, cudaStream_t);
}  // namespace qk3
