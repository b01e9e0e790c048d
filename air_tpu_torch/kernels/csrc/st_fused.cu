// Streamed-weight attention write fused with the masked canvas accumulate,
// forward and backward, for Hopper (sm_90a), fp32:
//
//   out[b] = canvas[b] + coeff[b] * (Wy[b] @ win[b] @ Wx[b]^T)
//   Wy, Wx [B, cs, ws], win [B, ws, ws], coeff [B], canvas [B, cs, cs]
//
// st_wmac_fwd_kernel replaces air_tpu/kernels/st_fused.py:_fwd_kernel.
// st_wmac_bwd_kernel replaces st_fused.py:_bwd_kernel: from the canvas
// cotangent g [B, cs, cs], with gwx = g @ Wx and tmp = Wy @ win [B, cs, ws],
//
//   d_Wy    = coeff * gwx @ win^T          [B, cs, ws]
//   d_win   = coeff * Wy^T @ gwx           [B, ws, ws]
//   d_Wx    = coeff * g^T @ tmp            [B, cs, ws]
//   d_coeff = <g, tmp @ Wx^T> = <gwx, tmp> [B]
//
// (the canvas's own cotangent is g). The dense weight matrices are built
// outside the kernels from (s, x, y), and the gradients of (s, x, y) flow
// through that construction, as on the TPU.
//
// What bounds them on an H100 at the training shapes (B = 64, cs = 50,
// ws = 28): the forward moves 2.20 MB (0.66 us at 3.35 TB/s) for 14.3
// MFLOP (0.21 us at 67 TFLOP/s fp32); the backward 2.48 MB (0.74 us) for
// 33.2 MFLOP (0.50 us), its weight cotangents dense because its outputs
// are. Bytes bound both, and both are far below a launch's few
// microseconds, so what a launch costs is latency: the round trip of
// staging, and the length of the dependent FMA chains.
//
// The forward (st_resample.cuh) splits each canvas into groups of rows, one
// block per (image, group), so a batch of 64 fills the card and one canvas
// spans several SMs. A block stages the window, Wx and its rows of Wy with
// 1-D bulk copies on one mbarrier and its canvas rows on a second one, which
// arrive while the products run (4-byte cp.async where a range is not
// 16-byte sized and aligned); it transposes Wx in shared memory, forms its
// rows of tmp = Wy @ win, then out = tmp @ Wx^T in 2 x 4 register tiles,
// adds coeff * out to its canvas rows in shared memory and writes them with
// 16-byte stores. Shared loads are free of bank conflicts. Each output is one
// fmaf chain in ascending order, then canvas + coeff * acc rounded as
// __fadd_rn(canvas, __fmul_rn(coeff, acc)); no atomics.
//
// The backward, right and simple first: one block per image. The block
// stages its operands in shared memory (about 35.5 KB at these shapes: g,
// win, both weights and the two shared intermediates gwx and tmp), so no
// intermediate touches device memory. Every product is an fp32 FMA in a
// fixed order. d_coeff is each thread's partial sum of gwx * tmp, reduced in
// the block in a fixed order (no atomics), so a run gives the same bits
// every time. The forward reads `canvas` and writes `out`; the wrapper passes
// a fresh `out` (the TPU kernel aliases them). Sizes whose operands do not
// fit the 227 KB of shared memory a block can have are refused by the
// launcher's attribute call and by the wrapper.
//
// No tensor cores: both kernels are held to fp32 at 1e-5, Hopper's tensor
// cores take fp32 only as TF32 (10-bit mantissa), which the port's numeric
// flags forbid (models/air.py:_numeric_flags), and the FLOP bounds lie below
// the byte bounds, so they would not lower the bounds.

#include <cuda_runtime.h>

#include "st_resample.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* dst, int n) {
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) dst[idx] = src[idx];
}

// Sum of v over the block's threads in a fixed order: warp shuffles, then
// the warps' sums in shared memory (red_s holds kThreads / 32 floats).
// Thread 0 gets the total.
__device__ float block_sum(float v, float* red_s) {
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red_s[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kThreads / 32; ++w) total = __fadd_rn(total, red_s[w]);
  return total;
}

// kCs, kWs: the sizes fixed at compile time, or 0 to take them from the
// arguments (st_resample.cuh, Sizes).
template <int kCs, int kWs>
__global__ void __launch_bounds__(st_resample::kMaxThreads)
st_wmac_fwd_kernel(const float* __restrict__ wy, const float* __restrict__ win,
                   const float* __restrict__ wx,
                   const float* __restrict__ coeff,
                   const float* __restrict__ canvas, float* __restrict__ out,
                   int cs_arg, int ws_arg, int groups, int rows, int bulk) {
  using namespace st_resample;
  const int cs = kCs ? kCs : cs_arg, ws = kWs ? kWs : ws_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bars[2];   // operands; canvas rows
  const int b = blockIdx.x / groups, g = blockIdx.x - b * groups;
  const int r0 = g * rows, rg = min(rows, cs - r0), half = rows / 2;
  const Layout lay(rows, cs, ws, ws, true);
  float* win_s = smem + lay.x;
  float* wy_s = smem + lay.wy;
  float* wx_s = smem + lay.wx;
  float* wxt_s = smem + lay.wxt;
  float* tmp_s = smem + lay.tmp;
  float* canvas_s = smem + lay.canvas;   // [rg, cs], then the output rows
  const float* wy_g = wy + (static_cast<size_t>(b) * cs + r0) * ws;
  const float* win_b = win + static_cast<size_t>(b) * ws * ws;
  const float* wx_b = wx + static_cast<size_t>(b) * cs * ws;
  const size_t rows_off = (static_cast<size_t>(b) * cs + r0) * cs;
  const int n_rows = rg * cs;

  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(&bars[0]);
      mbar_init(&bars[1]);
      mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t n_win = 4u * ws * ws, n_wy = 4u * rg * ws,
                     n_wx = 4u * cs * ws;
      mbar_expect_tx(&bars[0], n_win + n_wy + n_wx);
      bulk_copy(win_s, win_b, n_win, &bars[0]);
      bulk_copy(wy_s, wy_g, n_wy, &bars[0]);
      bulk_copy(wx_s, wx_b, n_wx, &bars[0]);
      mbar_expect_tx(&bars[1], 4u * n_rows);
      bulk_copy(canvas_s, canvas + rows_off, 4u * n_rows, &bars[1]);
    }
    mbar_wait(&bars[0], 0);
  } else {
    copy4(win_s, win_b, ws * ws);
    copy4(wy_s, wy_g, rg * ws);
    copy4(wx_s, wx_b, cs * ws);
    copy4_commit();
    copy4(canvas_s, canvas + rows_off, n_rows);
    copy4_commit();
    copy4_wait<1>();
    __syncthreads();
  }
  const float co = coeff[b];

  transpose_wx(wx_s, wxt_s, cs, ws);
  first_product(wy_s, win_s, tmp_s, rg, half, ws, ws);
  __syncthreads();

  float acc[2][kTileCols];
  const bool has_tile = second_product(tmp_s, wxt_s, rg, half, cs, ws, acc);
  // the canvas rows, prefetched while the products ran
  if (bulk) {
    mbar_wait(&bars[1], 0);
  } else {
    copy4_wait<0>();
    __syncthreads();
  }
  if (has_tile) {
    for_each_output(rg, half, cs, acc, [&](int i, int l, float v) {
      float* c = canvas_s + i * cs + l;
      *c = __fadd_rn(*c, __fmul_rn(co, v));
    });
  }
  __syncthreads();
  float* out_g = out + rows_off;
  if (bulk) {   // 16-byte stores of the block's contiguous rows
    const float4* src = reinterpret_cast<const float4*>(canvas_s);
    float4* dst = reinterpret_cast<float4*>(out_g);
    for (int i = threadIdx.x; i < n_rows / 4; i += blockDim.x) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n_rows; i += blockDim.x) out_g[i] = canvas_s[i];
  }
}

__global__ void __launch_bounds__(kThreads)
st_wmac_bwd_kernel(const float* __restrict__ wy, const float* __restrict__ win,
                   const float* __restrict__ wx,
                   const float* __restrict__ coeff,
                   const float* __restrict__ g, float* __restrict__ d_wy,
                   float* __restrict__ d_win, float* __restrict__ d_wx,
                   float* __restrict__ d_coeff, int cs, int ws) {
  extern __shared__ float smem[];
  float* g_s = smem;               // [cs, cs]
  float* win_s = g_s + cs * cs;    // [ws, ws]
  float* wy_s = win_s + ws * ws;   // [cs, ws]
  float* wx_s = wy_s + cs * ws;    // [cs, ws]
  float* gwx_s = wx_s + cs * ws;   // [cs, ws] = g @ Wx
  float* tmp_s = gwx_s + cs * ws;  // [cs, ws] = Wy @ win
  float* red_s = tmp_s + cs * ws;  // [kThreads / 32]
  const size_t b = blockIdx.x;
  stage(g + b * cs * cs, g_s, cs * cs);
  stage(win + b * ws * ws, win_s, ws * ws);
  stage(wy + b * cs * ws, wy_s, cs * ws);
  stage(wx + b * cs * ws, wx_s, cs * ws);
  const float co = coeff[b];
  __syncthreads();

  // gwx, tmp, and each thread's share of d_coeff = <gwx, tmp>
  float dco = 0.0f;
  for (int idx = threadIdx.x; idx < cs * ws; idx += blockDim.x) {
    const int i = idx / ws, k = idx - i * ws;
    float acc = 0.0f;
    for (int l = 0; l < cs; ++l) acc = fmaf(g_s[i * cs + l], wx_s[l * ws + k], acc);
    gwx_s[idx] = acc;
    float t = 0.0f;
    for (int j = 0; j < ws; ++j) t = fmaf(wy_s[i * ws + j], win_s[j * ws + k], t);
    tmp_s[idx] = t;
    dco = fmaf(acc, t, dco);
  }
  __syncthreads();

  const size_t mat = b * cs * ws;
  for (int idx = threadIdx.x; idx < cs * ws; idx += blockDim.x) {
    const int i = idx / ws, j = idx - i * ws;   // row i, column j of d_Wy
    float acc = 0.0f;
    for (int k = 0; k < ws; ++k) acc = fmaf(gwx_s[i * ws + k], win_s[j * ws + k], acc);
    d_wy[mat + idx] = __fmul_rn(co, acc);
    // row l = i, column k = j of d_Wx
    acc = 0.0f;
    for (int m = 0; m < cs; ++m) acc = fmaf(g_s[m * cs + i], tmp_s[m * ws + j], acc);
    d_wx[mat + idx] = __fmul_rn(co, acc);
  }
  float* d_win_b = d_win + b * ws * ws;
  for (int idx = threadIdx.x; idx < ws * ws; idx += blockDim.x) {
    const int j = idx / ws, k = idx - j * ws;
    float acc = 0.0f;
    for (int i = 0; i < cs; ++i) acc = fmaf(wy_s[i * ws + j], gwx_s[i * ws + k], acc);
    d_win_b[idx] = __fmul_rn(co, acc);
  }
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

// Each launcher takes device pointers, the batch and the two sizes (the
// forward also the launch geometry the wrapper computed,
// kernels/st_fused.py:geometry: row groups per canvas, rows per group,
// threads, shared-memory bytes per block, and 1 for the bulk-copy path), and
// the stream; it enqueues one kernel and returns cudaGetLastError() (0 = the
// launch was accepted), the error of the shared-memory attribute call, or
// cudaErrorInvalidValue for a geometry the forward cannot run. The wrapper
// checks shapes, types, contiguity and, for the bulk path, alignment.

extern "C" int st_wmac_fwd(const float* wy, const float* win, const float* wx,
                           const float* coeff, const float* canvas, float* out,
                           int batch, int cs, int ws, int groups, int rows,
                           int threads, int smem_bytes, int bulk,
                           cudaStream_t stream) {
  if (!st_resample::geometry_ok(cs, cs, ws, ws, groups, rows, threads,
                                smem_bytes, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = cs == 50 && ws == 28 ? st_wmac_fwd_kernel<50, 28>
                                           : st_wmac_fwd_kernel<0, 0>;
  const cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * groups, threads, smem_bytes, stream>>>(
      wy, win, wx, coeff, canvas, out, cs, ws, groups, rows, bulk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int st_wmac_bwd(const float* wy, const float* win, const float* wx,
                           const float* coeff, const float* g, float* d_wy,
                           float* d_win, float* d_wx, float* d_coeff,
                           int batch, int cs, int ws, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(cs * cs + ws * ws + 4 * cs * ws +
                                          kThreads / 32) *
                      sizeof(float);
  const cudaError_t err = allow_smem(st_wmac_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  st_wmac_bwd_kernel<<<batch, kThreads, smem, stream>>>(
      wy, win, wx, coeff, g, d_wy, d_win, d_wx, d_coeff, cs, ws);
  return static_cast<int>(cudaGetLastError());
}
