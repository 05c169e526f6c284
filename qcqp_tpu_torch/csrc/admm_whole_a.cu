// K3's whole-slab instantiations for n <= 96 (C = 1, 2, 3 coordinates a
// lane), built beside admm.cu; the kernel is in admm_impl.cuh.
#include "admm_impl.cuh"

namespace qk3 {
template int launch<1>(const Args&, int, cudaStream_t);
template int launch<2>(const Args&, int, cudaStream_t);
template int launch<3>(const Args&, int, cudaStream_t);
}  // namespace qk3
