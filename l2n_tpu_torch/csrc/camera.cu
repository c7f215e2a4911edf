// The step's camera buffer, written on the card.
//
// The step kernels read the packed (10, 4) camera block from a device
// buffer, which their entry points copy into constant memory ahead of each
// launch (pathtrace.cuh stage_camera), so that one CUDA graph of a step
// serves every camera pose. This kernel writes that buffer from 40 floats
// it takes by value: the launch's parameters hold them, so the write is
// legal inside a stream capture (the capture bakes that camera into its
// graph), and a caller that runs calls ahead of the device never lets an
// earlier call read a later camera, as an asynchronous copy from a reused
// host array could.
//
// Built by l2n_tpu_torch/ops/kernels/build.py.

#include <cuda_runtime.h>
#include <string.h>

namespace {

struct CameraBlock {
  float v[40];
};

__global__ void camera_write_kernel(CameraBlock block,
                                    float* __restrict__ out) {
  out[threadIdx.x] = block.v[threadIdx.x];
}

}  // namespace

// Write the 40 floats of the host array `camera` to the device buffer
// `out` on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int l2n_camera_write(const float* camera, float* out,
                                void* stream) {
  CameraBlock block;
  memcpy(block.v, camera, sizeof(block.v));
  camera_write_kernel<<<1, 40, 0, static_cast<cudaStream_t>(stream)>>>(
      block, out);
  return static_cast<int>(cudaGetLastError());
}
