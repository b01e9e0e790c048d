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
// few microseconds of a launch, so what a launch costs is latency: the
// round trip of staging, and the length of the dependent FMA chains.
//
// Design (st_resample.cuh): each image is split into groups of output rows,
// one block per (image, group), so a batch of 64 fills the card and one
// image spans several SMs. A block stages the image, Wx and its rows of Wy
// with 1-D bulk copies on an mbarrier (4-byte cp.async where a range is not
// 16-byte sized and aligned), transposes Wx in shared memory, forms its rows
// of tmp = Wy @ img there, then writes out = tmp @ Wx^T from 2 x 4 register
// tiles. Shared loads are free of bank conflicts, and every output is one
// fmaf chain in ascending order (no atomics), so the bits do not depend on
// the split.
//
// No tensor cores: the kernel is held to fp32 at 1e-5, Hopper's tensor cores
// take fp32 only as TF32 (10-bit mantissa), which the port's numeric flags
// forbid (models/air.py:_numeric_flags), and the FLOP bound lies below the
// byte bound, so they would not lower the bound.

#include "st_resample.cuh"

namespace {

using namespace st_resample;

// kIh, kIw, kOw: the sizes fixed at compile time, or 0 to take them from the
// arguments (st_resample.cuh, Sizes).
template <int kIh, int kIw, int kOw>
__global__ void __launch_bounds__(kMaxThreads)
st_fused_dots_kernel(const float* __restrict__ wy,
                     const float* __restrict__ img,
                     const float* __restrict__ wx, float* __restrict__ out,
                     int oh, int ow_arg, int ih_arg, int iw_arg, int groups,
                     int rows, int bulk) {
  const int ih = kIh ? kIh : ih_arg, iw = kIw ? kIw : iw_arg;
  const int ow = kOw ? kOw : ow_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.x / groups, g = blockIdx.x - b * groups;
  const int r0 = g * rows, rg = min(rows, oh - r0), half = rows / 2;
  const Layout lay(rows, ow, ih, iw, false);
  float* x_s = smem + lay.x;
  float* wy_s = smem + lay.wy;
  float* wx_s = smem + lay.wx;
  float* wxt_s = smem + lay.wxt;
  float* tmp_s = smem + lay.tmp;
  const float* wy_g = wy + (static_cast<size_t>(b) * oh + r0) * ih;
  const float* img_b = img + static_cast<size_t>(b) * ih * iw;
  const float* wx_b = wx + static_cast<size_t>(b) * ow * iw;

  if (bulk) {
    if (threadIdx.x == 0) {
      mbar_init(&bar);
      mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t n_x = 4u * ih * iw, n_wy = 4u * rg * ih, n_wx = 4u * ow * iw;
      mbar_expect_tx(&bar, n_x + n_wy + n_wx);
      bulk_copy(x_s, img_b, n_x, &bar);
      bulk_copy(wy_s, wy_g, n_wy, &bar);
      bulk_copy(wx_s, wx_b, n_wx, &bar);
    }
    mbar_wait(&bar, 0);
  } else {
    copy4(x_s, img_b, ih * iw);
    copy4(wy_s, wy_g, rg * ih);
    copy4(wx_s, wx_b, ow * iw);
    copy4_commit();
    copy4_wait<0>();
    __syncthreads();
  }

  transpose_wx(wx_s, wxt_s, ow, iw);
  first_product(wy_s, x_s, tmp_s, rg, half, ih, iw);
  __syncthreads();

  float acc[2][kTileCols];
  if (!second_product(tmp_s, wxt_s, rg, half, ow, iw, acc)) return;
  float* out_g = out + (static_cast<size_t>(b) * oh + r0) * ow;
  for_each_output(rg, half, ow, acc,
                  [&](int i, int l, float v) { out_g[i * ow + l] = v; });
}

using Kernel = decltype(&st_fused_dots_kernel<0, 0, 0>);

// The model's read (canvas 50 -> window 28) and write with compile-time sizes.
Kernel pick(int ih, int iw, int ow) {
  if (ih == 50 && iw == 50 && ow == 28) return st_fused_dots_kernel<50, 50, 28>;
  if (ih == 28 && iw == 28 && ow == 50) return st_fused_dots_kernel<28, 28, 50>;
  return st_fused_dots_kernel<0, 0, 0>;
}

}  // namespace

// Takes device pointers, the batch, the four sizes, the launch geometry the
// wrapper computed (kernels/st_pallas.py:geometry: row groups per image, rows
// per group, threads, shared-memory bytes per block, and 1 for the bulk-copy
// path) and the stream; enqueues one kernel and returns cudaGetLastError()
// (0 = the launch was accepted), the error of the shared-memory attribute
// call, or cudaErrorInvalidValue for a geometry the kernel cannot run. The
// wrapper checks shapes, types, contiguity and, for the bulk path, alignment.
extern "C" int st_fused_dots(const float* wy, const float* img,
                             const float* wx, float* out, int batch, int oh,
                             int ow, int ih, int iw, int groups, int rows,
                             int threads, int smem_bytes, int bulk,
                             cudaStream_t stream) {
  if (!geometry_ok(oh, ow, ih, iw, groups, rows, threads, smem_bytes, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(ih, iw, ow);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<batch * groups, threads, smem_bytes, stream>>>(
      wy, img, wx, out, oh, ow, ih, iw, groups, rows, bulk);
  return static_cast<int>(cudaGetLastError());
}
