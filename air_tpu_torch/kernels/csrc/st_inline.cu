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
// st_read_bwd_kernel replaces _rd_bwd_kernel: from the output cotangent
// g [B, ws, ws],
//   d_img = Wy^T (g Wx)                                      [B, cs, cs]
//   d_ay, d_cy, d_ax, d_cx                                   [B] each
// st_write_bwd_kernel replaces _wr_bwd_kernel: from g [B, cs, cs],
//   d_win = coeff * Wy^T (g Wx)                              [B, ws, ws]
//   d_ay, d_cy, d_ax, d_cx, d_coeff = <g, Wy win Wx^T>       [B] each
// The scalar cotangents contract the weight cotangents dWy = (g Wx) X^T and
// dWx = g^T (Wy X) (X the image or window; times coeff in the write)
// through dW[i, j] / dp_i = -sign(p_i - j) * 1{|p_i - j| < 1}:
//   dp_i = sum_j dW[i, j] * -sign(p_i - j) * 1{|p_i - j| < 1},
//   d_a = kpix * sum_i t_i dp_i,  d_c = kpix * sum_i dp_i,
// kpix = (in - 1.001) / 2 (cs for the read, ws for the write).
//
// What bounds them on an H100: at the training shapes (B = 64, cs = 50,
// ws = 28), counting the dense products, the read moves about 0.84 MB
// (0.25 us at 3.35 TB/s) for about 14 MFLOP (0.21 us at 67 TFLOP/s fp32),
// the write about 1.5 MB (0.44 us) for 14 MFLOP; the read backward about
// 1.48 MB (0.44 us) for 23.5 MFLOP (0.35 us), the write backward 1.04 MB
// (0.31 us) for 20.2 MFLOP (0.30 us), counting dW only at the two taps per
// row that the scalar cotangents take and d_coeff as <Wy win, g Wx>. All
// are far below the few microseconds of a kernel launch, so launch latency
// bounds them, not bytes or operations.
//
// Design, right and simple first: one block per image. The block stages its
// inputs in shared memory, forms each hat weight in registers from (a, c),
// keeps every intermediate product in shared memory, so no weight matrix
// and no intermediate touches device memory. Every product is an fp32 FMA
// (no TF32). The weights are rounded exactly as the plain PyTorch version
// rounds them (explicit _rn intrinsics, no contraction): the grid t by
// jnp.linspace's formula, not the TPU kernel's -1 + 2 i / (out - 1), which
// differs by an ulp at some i; in the write, a = 1/s (up to 10) times
// (ws - 1.001) / 2 magnifies that ulp to ~1e-5 in the output, and in the
// backward an ulp of p can move a tap of the mask. The backward kernels
// form dW only at the (at most two) taps j of each row where the mask is
// non-zero, and reduce the scalars in a fixed order inside the block (no
// atomics), so a run gives the same bits every time. The write kernel
// reads `canvas` and writes `out`; the wrapper passes a fresh `out`.

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

// -------------------- backward --------------------------------------------

// -sign(p - j) * 1{|p - j| < 1} for the tap j of position p: +1, -1 or 0.
__device__ __forceinline__ float tap_sign(float p, int j) {
  const float d = __fsub_rn(p, static_cast<float>(j));
  if (!(fabsf(d) < 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
}

// Sum of v over the block's threads in a fixed order: warp shuffles, then
// the warps' sums in shared memory (red_s holds kThreads / 32 floats). Every
// thread gets the total. Ends with a barrier, so red_s can be reused.
__device__ float block_sum(float v, float* red_s) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, red_s[w]);
  __syncthreads();
  return total;
}

// Scalar cotangents of one axis from its per-row dp (rows in dp_s), written
// by thread 0: out_a = kpix * sum_i t_i dp_i, out_c = kpix * sum_i dp_i.
__device__ void axis_scalars(const float* dp_s, int rows, float kpix,
                             float* red_s, float* out_a, float* out_c) {
  float ta = 0.0f, tc = 0.0f;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    ta = fmaf(grid_t(i, rows), dp_s[i], ta);
    tc = __fadd_rn(tc, dp_s[i]);
  }
  ta = block_sum(ta, red_s);
  tc = block_sum(tc, red_s);
  if (threadIdx.x == 0) {
    *out_a = __fmul_rn(kpix, ta);
    *out_c = __fmul_rn(kpix, tc);
  }
}

__global__ void __launch_bounds__(kThreads)
st_read_bwd_kernel(const float* __restrict__ img, const float* __restrict__ g,
                   const float* __restrict__ ay, const float* __restrict__ cy,
                   const float* __restrict__ ax, const float* __restrict__ cx,
                   float* __restrict__ d_img, float* __restrict__ d_ay,
                   float* __restrict__ d_cy, float* __restrict__ d_ax,
                   float* __restrict__ d_cx, int cs, int ws, float kpix) {
  extern __shared__ float smem[];
  float* img_s = smem;                // [cs, cs]
  float* g_s = img_s + cs * cs;       // [ws, ws]
  float* gwx_s = g_s + ws * ws;       // [ws, cs] = g @ Wx
  float* tmp_s = gwx_s + ws * cs;     // [ws, cs] = Wy @ img
  float* py_s = tmp_s + ws * cs;      // [ws] row positions of Wy
  float* px_s = py_s + ws;            // [ws] row positions of Wx
  float* dp_s = px_s + ws;            // [2 ws] dp of y rows, then x rows
  float* red_s = dp_s + 2 * ws;       // [kThreads / 32]
  const int b = blockIdx.x;
  const float* img_b = img + static_cast<size_t>(b) * cs * cs;
  const float* g_b = g + static_cast<size_t>(b) * ws * ws;
  for (int idx = threadIdx.x; idx < cs * cs; idx += blockDim.x) {
    img_s[idx] = img_b[idx];
  }
  for (int idx = threadIdx.x; idx < ws * ws; idx += blockDim.x) {
    g_s[idx] = g_b[idx];
  }
  for (int i = threadIdx.x; i < ws; i += blockDim.x) {
    py_s[i] = hat_pos(ay[b], cy[b], i, ws, kpix);
    px_s[i] = hat_pos(ax[b], cx[b], i, ws, kpix);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < ws * cs; idx += blockDim.x) {
    const int i = idx / cs, k = idx - i * cs;
    float acc = 0.0f;
    for (int l = 0; l < ws; ++l) acc = fmaf(g_s[i * ws + l], hat(px_s[l], k), acc);
    gwx_s[idx] = acc;
    const float p = py_s[i];
    acc = 0.0f;
    for (int j = 0; j < cs; ++j) acc = fmaf(hat(p, j), img_s[j * cs + k], acc);
    tmp_s[idx] = acc;
  }
  __syncthreads();

  float* d_img_b = d_img + static_cast<size_t>(b) * cs * cs;
  for (int idx = threadIdx.x; idx < cs * cs; idx += blockDim.x) {
    const int j = idx / cs, k = idx - j * cs;
    float acc = 0.0f;
    for (int i = 0; i < ws; ++i) acc = fmaf(hat(py_s[i], j), gwx_s[i * cs + k], acc);
    d_img_b[idx] = acc;
  }
  // dp of row r: y rows take dWy[i, j] = sum_k gwx[i, k] img[j, k],
  // x rows take dWx[l, k] = sum_i g[i, l] tmp[i, k], at the two taps
  for (int r = threadIdx.x; r < 2 * ws; r += blockDim.x) {
    const bool y_axis = r < ws;
    const int i = y_axis ? r : r - ws;
    const float p = y_axis ? py_s[i] : px_s[i];
    const int j0 = static_cast<int>(floorf(p));
    float dp = 0.0f;
    for (int j = j0; j <= j0 + 1; ++j) {
      const float sgn = tap_sign(p, j);
      if (j < 0 || j >= cs || sgn == 0.0f) continue;
      float dw = 0.0f;
      if (y_axis) {
        for (int k = 0; k < cs; ++k) dw = fmaf(gwx_s[i * cs + k], img_s[j * cs + k], dw);
      } else {
        for (int m = 0; m < ws; ++m) dw = fmaf(g_s[m * ws + i], tmp_s[m * cs + j], dw);
      }
      dp = __fadd_rn(dp, __fmul_rn(sgn, dw));
    }
    dp_s[r] = dp;
  }
  __syncthreads();
  axis_scalars(dp_s, ws, kpix, red_s, d_ay + b, d_cy + b);
  axis_scalars(dp_s + ws, ws, kpix, red_s, d_ax + b, d_cx + b);
}

__global__ void __launch_bounds__(kThreads)
st_write_bwd_kernel(const float* __restrict__ win, const float* __restrict__ g,
                    const float* __restrict__ ay, const float* __restrict__ cy,
                    const float* __restrict__ ax, const float* __restrict__ cx,
                    const float* __restrict__ coeff, float* __restrict__ d_win,
                    float* __restrict__ d_ay, float* __restrict__ d_cy,
                    float* __restrict__ d_ax, float* __restrict__ d_cx,
                    float* __restrict__ d_coeff, int cs, int ws, float kpix) {
  extern __shared__ float smem[];
  float* win_s = smem;                // [ws, ws]
  float* g_s = win_s + ws * ws;       // [cs, cs]
  float* gwx_s = g_s + cs * cs;       // [cs, ws] = g @ Wx
  float* tmp_s = gwx_s + cs * ws;     // [cs, ws] = Wy @ win
  float* py_s = tmp_s + cs * ws;      // [cs] row positions of Wy
  float* px_s = py_s + cs;            // [cs] row positions of Wx
  float* dp_s = px_s + cs;            // [2 cs] dp of y rows, then x rows
  float* red_s = dp_s + 2 * cs;       // [kThreads / 32]
  const int b = blockIdx.x;
  const float* win_b = win + static_cast<size_t>(b) * ws * ws;
  const float* g_b = g + static_cast<size_t>(b) * cs * cs;
  for (int idx = threadIdx.x; idx < ws * ws; idx += blockDim.x) {
    win_s[idx] = win_b[idx];
  }
  for (int idx = threadIdx.x; idx < cs * cs; idx += blockDim.x) {
    g_s[idx] = g_b[idx];
  }
  for (int i = threadIdx.x; i < cs; i += blockDim.x) {
    py_s[i] = hat_pos(ay[b], cy[b], i, cs, kpix);
    px_s[i] = hat_pos(ax[b], cx[b], i, cs, kpix);
  }
  const float co = coeff[b];
  __syncthreads();

  // gwx, tmp, and each thread's share of d_coeff = <tmp, gwx> = <g, recon>
  float dco = 0.0f;
  for (int idx = threadIdx.x; idx < cs * ws; idx += blockDim.x) {
    const int i = idx / ws, k = idx - i * ws;
    float acc = 0.0f;
    for (int l = 0; l < cs; ++l) acc = fmaf(g_s[i * cs + l], hat(px_s[l], k), acc);
    gwx_s[idx] = acc;
    const float p = py_s[i];
    float t = 0.0f;
    for (int j = 0; j < ws; ++j) t = fmaf(hat(p, j), win_s[j * ws + k], t);
    tmp_s[idx] = t;
    dco = fmaf(t, acc, dco);
  }
  __syncthreads();

  float* d_win_b = d_win + static_cast<size_t>(b) * ws * ws;
  for (int idx = threadIdx.x; idx < ws * ws; idx += blockDim.x) {
    const int j = idx / ws, k = idx - j * ws;
    float acc = 0.0f;
    for (int i = 0; i < cs; ++i) acc = fmaf(hat(py_s[i], j), gwx_s[i * ws + k], acc);
    d_win_b[idx] = __fmul_rn(co, acc);
  }
  // dp of row r: y rows take dWy[i, j] = co * sum_k gwx[i, k] win[j, k],
  // x rows take dWx[l, k] = co * sum_i g[i, l] tmp[i, k], at the two taps
  for (int r = threadIdx.x; r < 2 * cs; r += blockDim.x) {
    const bool y_axis = r < cs;
    const int i = y_axis ? r : r - cs;
    const float p = y_axis ? py_s[i] : px_s[i];
    const int j0 = static_cast<int>(floorf(p));
    float dp = 0.0f;
    for (int j = j0; j <= j0 + 1; ++j) {
      const float sgn = tap_sign(p, j);
      if (j < 0 || j >= ws || sgn == 0.0f) continue;
      float dw = 0.0f;
      if (y_axis) {
        for (int k = 0; k < ws; ++k) dw = fmaf(gwx_s[i * ws + k], win_s[j * ws + k], dw);
      } else {
        for (int m = 0; m < cs; ++m) dw = fmaf(g_s[m * cs + i], tmp_s[m * ws + j], dw);
      }
      dp = __fadd_rn(dp, __fmul_rn(sgn, __fmul_rn(co, dw)));
    }
    dp_s[r] = dp;
  }
  __syncthreads();
  axis_scalars(dp_s, cs, kpix, red_s, d_ay + b, d_cy + b);
  axis_scalars(dp_s + cs, cs, kpix, red_s, d_ax + b, d_cx + b);
  dco = block_sum(dco, red_s);
  if (threadIdx.x == 0) d_coeff[b] = dco;
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

extern "C" int st_inline_read_bwd(const float* img, const float* g,
                                  const float* ay, const float* cy,
                                  const float* ax, const float* cx,
                                  float* d_img, float* d_ay, float* d_cy,
                                  float* d_ax, float* d_cx, int batch, int cs,
                                  int ws, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cs * cs + ws * ws + 2 * ws * cs +
                                          4 * ws + kThreads / 32) *
                      sizeof(float);
  const cudaError_t err = allow_smem(st_read_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((cs - 1.001) / 2.0);
  st_read_bwd_kernel<<<batch, kThreads, smem, stream>>>(
      img, g, ay, cy, ax, cx, d_img, d_ay, d_cy, d_ax, d_cx, cs, ws, kpix);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int st_inline_write_bwd(const float* win, const float* g,
                                   const float* ay, const float* cy,
                                   const float* ax, const float* cx,
                                   const float* coeff, float* d_win,
                                   float* d_ay, float* d_cy, float* d_ax,
                                   float* d_cx, float* d_coeff, int batch,
                                   int cs, int ws, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(ws * ws + cs * cs + 2 * cs * ws +
                                          4 * cs + kThreads / 32) *
                      sizeof(float);
  const cudaError_t err = allow_smem(st_write_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((ws - 1.001) / 2.0);
  st_write_bwd_kernel<<<batch, kThreads, smem, stream>>>(
      win, g, ay, cy, ax, cx, coeff, d_win, d_ay, d_cy, d_ax, d_cx, d_coeff,
      cs, ws, kpix);
  return static_cast<int>(cudaGetLastError());
}
