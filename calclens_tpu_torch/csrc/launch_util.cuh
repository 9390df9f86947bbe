// Host helpers shared by the kernels' C launchers.
#pragma once

#include <cuda_runtime.h>

namespace calclens {

// Streaming multiprocessors of the current device: the size of a
// persistent grid.
inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

}  // namespace calclens
