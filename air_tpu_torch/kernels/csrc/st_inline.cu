// Spatial-transformer attention kernels for Hopper (sm_90a), fp32, with the
// bilinear "hat" weights built inside the kernel from scalars per image:
//
//   W[i, j] = relu(1 - |p_i - j|),  p_i = (a * t_i + c + 1) * (in - 1.001) / 2,
//   t = linspace(-1, 1, out).
//
// st_read_kernel replaces air_tpu/kernels/st_inline.py:_rd_fwd_kernel
// (canvas -> window):
//   out[b] = Wy(ay, cy) @ img[b] @ Wx(ax, cx)^T              [B, ws, ws]
// st_write_kernel replaces air_tpu/kernels/st_inline.py:_wr_fwd_kernel
// (window -> canvas, masked accumulate):
//   out[b] = canvas[b] + coeff[b] * (Wy(ay, cy) @ win[b] @ Wx(ax, cx)^T)
//                                                            [B, cs, cs]
//
// What bounds them on an H100: at the serving shapes (B = 64, cs = 50,
// ws = 28) the read moves about 0.84 MB (0.25 us at 3.35 TB/s) and does
// about 14 MFLOP (0.21 us at 67 TFLOP/s fp32); the write moves about 1.5 MB
// (0.44 us) for about 14 MFLOP. Both are far below the few microseconds of
// a kernel launch, so launch latency bounds them, not bytes or operations.
//
// Design, right and simple first: one block per image. The block stages its
// input image in shared memory, forms each hat weight in registers from
// (a, c), writes the first product (Wy @ image) to shared memory and takes
// the second product from there, so no weight matrix and no intermediate
// touches device memory. Every product is an fp32 FMA (no TF32). The
// weights are rounded exactly as the plain PyTorch version rounds them
// (explicit _rn intrinsics, no contraction): the grid t by jnp.linspace's
// formula, not the TPU kernel's -1 + 2 i / (out - 1), which differs by an
// ulp at some i; in the write, a = 1/s (up to 10) times (ws - 1.001) / 2
// magnifies that ulp to ~1e-5 in the output. The write kernel reads
// `canvas` and writes `out`; the wrapper passes a fresh `out` (not in place).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// t_i of linspace(-1, 1, n): -1 * (1 - step) + 1 * step, step = i / (n - 1),
// end point exact.
__device__ __forceinline__ float grid_t(int i, int n) {
  if (i == n - 1) return 1.0f;
  const float step = __fdiv_rn(static_cast<float>(i), static_cast<float>(n - 1));
  return __fadd_rn(-__fsub_rn(1.0f, step), step);
}

// Position p_i of output row i of a [out_dim, in_dim] hat matrix. kpix is
// (in_dim - 1.001) / 2 rounded once to float by the launcher.
__device__ __forceinline__ float hat_pos(float a, float c, int i, int out_dim,
                                         float kpix) {
  const float t = grid_t(i, out_dim);
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, t), c), 1.0f), kpix);
}

__device__ __forceinline__ float hat(float p, int j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, static_cast<float>(j)))));
}

__global__ void __launch_bounds__(kThreads)
st_read_kernel(const float* __restrict__ img, const float* __restrict__ ay,
               const float* __restrict__ cy, const float* __restrict__ ax,
               const float* __restrict__ cx, float* __restrict__ out, int cs,
               int ws, float kpix) {
  extern __shared__ float smem[];
  float* img_s = smem;            // [cs, cs]
  float* tmp_s = smem + cs * cs;  // [ws, cs] = Wy @ img
  const int b = blockIdx.x;
  const float* img_b = img + static_cast<size_t>(b) * cs * cs;
  for (int idx = threadIdx.x; idx < cs * cs; idx += blockDim.x) {
    img_s[idx] = img_b[idx];
  }
  const float a_y = ay[b], c_y = cy[b], a_x = ax[b], c_x = cx[b];
  __syncthreads();

  for (int idx = threadIdx.x; idx < ws * cs; idx += blockDim.x) {
    const int i = idx / cs, k = idx - i * cs;
    const float p = hat_pos(a_y, c_y, i, ws, kpix);
    float acc = 0.0f;
    for (int j = 0; j < cs; ++j) acc = fmaf(hat(p, j), img_s[j * cs + k], acc);
    tmp_s[idx] = acc;
  }
  __syncthreads();

  float* out_b = out + static_cast<size_t>(b) * ws * ws;
  for (int idx = threadIdx.x; idx < ws * ws; idx += blockDim.x) {
    const int i = idx / ws, l = idx - i * ws;
    const float p = hat_pos(a_x, c_x, l, ws, kpix);
    float acc = 0.0f;
    for (int k = 0; k < cs; ++k) acc = fmaf(tmp_s[i * cs + k], hat(p, k), acc);
    out_b[idx] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
st_write_kernel(const float* __restrict__ canvas, const float* __restrict__ win,
                const float* __restrict__ ay, const float* __restrict__ cy,
                const float* __restrict__ ax, const float* __restrict__ cx,
                const float* __restrict__ coeff, float* __restrict__ out,
                int cs, int ws, float kpix) {
  extern __shared__ float smem[];
  float* win_s = smem;            // [ws, ws]
  float* tmp_s = smem + ws * ws;  // [cs, ws] = Wy @ win
  const int b = blockIdx.x;
  const float* win_b = win + static_cast<size_t>(b) * ws * ws;
  for (int idx = threadIdx.x; idx < ws * ws; idx += blockDim.x) {
    win_s[idx] = win_b[idx];
  }
  const float a_y = ay[b], c_y = cy[b], a_x = ax[b], c_x = cx[b];
  const float co = coeff[b];
  __syncthreads();

  for (int idx = threadIdx.x; idx < cs * ws; idx += blockDim.x) {
    const int i = idx / ws, k = idx - i * ws;
    const float p = hat_pos(a_y, c_y, i, cs, kpix);
    float acc = 0.0f;
    for (int j = 0; j < ws; ++j) acc = fmaf(hat(p, j), win_s[j * ws + k], acc);
    tmp_s[idx] = acc;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * cs * cs;
  for (int idx = threadIdx.x; idx < cs * cs; idx += blockDim.x) {
    const int i = idx / cs, l = idx - i * cs;
    const float p = hat_pos(a_x, c_x, l, cs, kpix);
    float acc = 0.0f;
    for (int k = 0; k < ws; ++k) acc = fmaf(tmp_s[i * ws + k], hat(p, k), acc);
    out[base + idx] = __fadd_rn(canvas[base + idx], __fmul_rn(co, acc));
  }
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Each launcher takes device pointers, the batch and the two sizes, and the
// stream; it enqueues one kernel and returns cudaGetLastError() (0 = the
// launch was accepted). The wrapper checks shapes, types and contiguity.

extern "C" int st_inline_read(const float* img, const float* ay,
                              const float* cy, const float* ax,
                              const float* cx, float* out, int batch, int cs,
                              int ws, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cs * cs + ws * cs) * sizeof(float);
  const cudaError_t err = allow_smem(st_read_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((cs - 1.001) / 2.0);
  st_read_kernel<<<batch, kThreads, smem, stream>>>(img, ay, cy, ax, cx, out,
                                                    cs, ws, kpix);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int st_inline_write(const float* canvas, const float* win,
                               const float* ay, const float* cy,
                               const float* ax, const float* cx,
                               const float* coeff, float* out, int batch,
                               int cs, int ws, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ws * ws + cs * ws) * sizeof(float);
  const cudaError_t err = allow_smem(st_write_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((ws - 1.001) / 2.0);
  st_write_kernel<<<batch, kThreads, smem, stream>>>(
      canvas, win, ay, cy, ax, cx, coeff, out, cs, ws, kpix);
  return static_cast<int>(cudaGetLastError());
}
