// Streamed-weight spatial-transformer resample for Hopper (sm_90a), fp32:
//
//   out[b] = Wy[b] @ img[b] @ Wx[b]^T
//   Wy [B, oh, ih], img [B, ih, iw], Wx [B, ow, iw]  ->  out [B, oh, ow]
//
// st_fused_dots_kernel replaces air_tpu/kernels/st_pallas.py:
// _fused_dots_kernel, in both of its directions: the attention read
// (canvas -> window, [B, 50, 50] -> [B, 28, 28] at the training shapes) and
// the attention write (window -> canvas). As on the TPU, the dense bilinear
// weight matrices are built outside the kernel and streamed in; their
// gradients, and the backward of the whole op, are plain products outside
// any kernel (the TPU kernel's backward is XLA's VJP, st_pallas.py:100-105).
//
// What bounds it on an H100: the read at B = 64 moves 1.56 MB (images, both
// weight matrices, the windows: 0.47 us at 3.35 TB/s) for 14.0 MFLOP
// (0.21 us at 67 TFLOP/s fp32), so bytes bound it; both are far below the
// few microseconds of a launch.
//
// Design, right and simple first: one block per image. The block stages the
// image and both weight matrices in shared memory, forms tmp = Wy @ img
// there, then writes out = tmp @ Wx^T, so the intermediate never touches
// device memory. Every product is an fp32 FMA in a fixed order (no TF32, no
// atomics). Sizes whose operands do not fit the 227 KB of shared memory a
// block can have are refused by the launcher's attribute call and by the
// wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
st_fused_dots_kernel(const float* __restrict__ wy,
                     const float* __restrict__ img,
                     const float* __restrict__ wx, float* __restrict__ out,
                     int oh, int ow, int ih, int iw) {
  extern __shared__ float smem[];
  float* img_s = smem;             // [ih, iw]
  float* wy_s = img_s + ih * iw;   // [oh, ih]
  float* wx_s = wy_s + oh * ih;    // [ow, iw]
  float* tmp_s = wx_s + ow * iw;   // [oh, iw] = Wy @ img
  const size_t b = blockIdx.x;
  const float* img_b = img + b * ih * iw;
  const float* wy_b = wy + b * oh * ih;
  const float* wx_b = wx + b * ow * iw;
  for (int idx = threadIdx.x; idx < ih * iw; idx += blockDim.x) {
    img_s[idx] = img_b[idx];
  }
  for (int idx = threadIdx.x; idx < oh * ih; idx += blockDim.x) {
    wy_s[idx] = wy_b[idx];
  }
  for (int idx = threadIdx.x; idx < ow * iw; idx += blockDim.x) {
    wx_s[idx] = wx_b[idx];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < oh * iw; idx += blockDim.x) {
    const int i = idx / iw, k = idx - i * iw;
    float acc = 0.0f;
    for (int j = 0; j < ih; ++j) acc = fmaf(wy_s[i * ih + j], img_s[j * iw + k], acc);
    tmp_s[idx] = acc;
  }
  __syncthreads();

  float* out_b = out + b * oh * ow;
  for (int idx = threadIdx.x; idx < oh * ow; idx += blockDim.x) {
    const int i = idx / ow, l = idx - i * ow;
    float acc = 0.0f;
    for (int k = 0; k < iw; ++k) acc = fmaf(tmp_s[i * iw + k], wx_s[l * iw + k], acc);
    out_b[idx] = acc;
  }
}

}  // namespace

// Takes device pointers, the batch and the four sizes, and the stream;
// enqueues one kernel and returns cudaGetLastError() (0 = the launch was
// accepted), or the error of the shared-memory attribute call. The wrapper
// checks shapes, types and contiguity.
extern "C" int st_fused_dots(const float* wy, const float* img,
                             const float* wx, float* out, int batch, int oh,
                             int ow, int ih, int iw, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(ih * iw + oh * ih + ow * iw + oh * iw) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        st_fused_dots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  st_fused_dots_kernel<<<batch, kThreads, smem, stream>>>(wy, img, wx, out, oh,
                                                          ow, ih, iw);
  return static_cast<int>(cudaGetLastError());
}
