// Animated UV-gradient kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel l2n_tpu/ops/kernels/uv_demo.py::_kernel: writes
// (0.5(1+cos t) * col/W, 0.5(1+sin t) * row/H, 0) over a (3, H, W) image.
// It is the build chain's smoke test: the smallest kernel that proves nvcc,
// the ctypes binding and the launch path work.
//
// What bounds it on this card: memory writes, 12 bytes per pixel against a
// handful of flops. Design: one thread per pixel, consecutive threads on
// consecutive columns so each plane's stores coalesce; t is read from
// device memory so the wrapper never synchronises to fetch it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void uv_demo_kernel(int height, int width,
                               const float* __restrict__ t,
                               float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y;
  if (col >= width) return;
  const float u = static_cast<float>(col) / static_cast<float>(width);
  const float v = static_cast<float>(row) / static_cast<float>(height);
  const float tt = t[0];
  const size_t plane = static_cast<size_t>(height) * width;
  const size_t pix = static_cast<size_t>(row) * width + col;
  out[pix] = 0.5f * (1.0f + cosf(tt)) * u;
  out[plane + pix] = 0.5f * (1.0f + sinf(tt)) * v;
  out[2 * plane + pix] = 0.0f;
}

}  // namespace

// out: (3, height, width) float32 device buffer; t: one float32 on the
// device. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int l2n_uv_demo(int height, int width, const float* t, float* out,
                           void* stream) {
  const dim3 block(128);
  const dim3 grid(static_cast<unsigned>((width + 127) / 128),
                  static_cast<unsigned>(height));
  uv_demo_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      height, width, t, out);
  return static_cast<int>(cudaGetLastError());
}
