// K4 at 128 < n <= 256 (CPT = 8); the kernel is in ccp_impl.cuh, the C
// entry in ccp_narrow.cu.
#include "ccp_impl.cuh"

int qk::ccp_launch_wide(const CcpArgs& a, cudaStream_t s) {
  return launch<kCptWide>(a, s);
}
