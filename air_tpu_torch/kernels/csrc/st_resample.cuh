// Shared pieces of the two streamed-weight resample kernels for Hopper
// (sm_90a): st_pallas.cu:st_fused_dots_kernel and
// st_fused.cu:st_wmac_fwd_kernel. Both compute, for one image b,
//
//   tmp = Wy[b] @ X[b]        Wy [oh, ih], X [ih, iw]  ->  tmp [oh, iw]
//   out = tmp @ Wx[b]^T       Wx [ow, iw]              ->  out [oh, ow]
//
// and the write-accumulate adds canvas + coeff * out.
//
// Work split. Output row i needs row i of Wy and all of X and Wx, so each
// image is cut into `groups` groups of `rows` consecutive output rows (the
// last may have fewer), one block per (image, group), and no block talks to
// another. The wrapper picks the geometry (kernels/st_pallas.py:geometry):
// enough groups that a batch of 64 gives every SM blocks, and more than one
// block for a single image.
//
// Staging. A block copies X, Wx and its rows of Wy (and of the canvas) from
// device memory into shared memory with 1-D bulk copies (cp.async.bulk,
// completing on an mbarrier) when every range is a multiple of 16 bytes and
// 16-byte aligned, as at the model's shapes; otherwise each thread issues
// 4-byte cp.async copies (completing on cp.async.wait_group). The
// write-accumulate's canvas rows have a barrier (or group) of their own, so
// they arrive while the products run.
//
// Register tiles. A thread owns 2 rows (p and p + half, half = rows / 2) by
// kTileCols columns (q, q + Q, q + 2Q, q + 3Q, Q = ceil(width / kTileCols)):
// per step of the inner index it loads 2 values of the left operand and
// kTileCols of the right one from shared memory, and runs 2 * kTileCols
// independent fmaf chains.
//
// Bank conflicts. Neighbouring lanes take neighbouring columns q, so a warp's
// loads of X and of Wx^T are contiguous runs of at most 32 floats. Wx^T is
// transposed in shared memory from the staged Wx with an odd row stride, and
// tmp has an odd row stride, so rows read by one warp fall in distinct banks;
// the rows of Wy keep the staged stride ih, and the geometry keeps half at
// most 32 / gcd(ih, 32) so that a warp's rows of Wy fall in distinct banks too.
//
// Sizes. The kernels are instantiated for the model's shapes (canvas 50,
// window 28) with the sizes as compile-time constants, so that the inner
// loops unroll with constant shared-memory offsets; any other size runs the
// same code with the sizes from the arguments. The device functions below
// take the sizes as ints and are inlined, so constants propagate.
//
// Order of sums. Each output is one fmaf chain from 0.0f over the inner index
// in ascending order, whatever the geometry, so every launch gives the same
// bits. No atomics; fp32 only.

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace st_resample {

constexpr int kTileCols = 4;
constexpr int kMaxThreads = 256;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int odd(int n) { return n | 1; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// One block's shared memory, offsets in floats, every region on 16 bytes.
// Mirrored by kernels/st_pallas.py:_smem_floats.
struct Layout {
  int x, wy, wx, wxt, tmp, canvas, total;
  __host__ __device__ Layout(int rows, int ow, int ih, int iw, bool with_canvas)
      : x(0),
        wy(x + round4(ih * iw)),                  // X       [ih, iw]
        wx(wy + round4(rows * ih)),               // Wy rows [rows, ih]
        wxt(wx + round4(ow * iw)),                // Wx      [ow, iw]
        tmp(wxt + round4(iw * odd(ow))),          // Wx^T    [iw, odd(ow)]
        canvas(tmp + round4(rows * odd(iw))),     // tmp     [rows, odd(iw)]
        total(canvas + (with_canvas ? round4(rows * ow) : 0)) {}  // [rows, ow]
};

// ---- asynchronous copies -------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// n floats, 4 bytes per cp.async, spread over the block's threads.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst + i)),
                 "l"(src + i)
                 : "memory");
  }
}

__device__ __forceinline__ void copy4_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copy4_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// ---- the two products ----------------------------------------------------

// Wx^T [iw, odd(ow)] from the staged Wx [ow, iw]: reads are contiguous and
// writes go at the odd stride, both without bank conflicts. (l, k) of a
// thread's next element follow by addition, without a division.
__device__ __forceinline__ void transpose_wx(const float* wx_s, float* wxt_s,
                                             int ow, int iw) {
  const int stride = odd(ow);
  const int dl = blockDim.x / iw, dk = blockDim.x - dl * iw;
  int l = threadIdx.x / iw, k = threadIdx.x - l * iw;
  for (int idx = threadIdx.x; idx < ow * iw; idx += blockDim.x) {
    wxt_s[k * stride + l] = wx_s[idx];
    l += dl;
    k += dk;
    if (k >= iw) {
      k -= iw;
      ++l;
    }
  }
}

// A thread's tile: rows r[0] = p and r[1] = p + half, columns q + c * qn.
struct Tile {
  int qn, p, q;
  __device__ explicit Tile(int width)
      : qn(cdiv(width, kTileCols)),
        p(static_cast<int>(threadIdx.x) / qn),
        q(static_cast<int>(threadIdx.x) % qn) {}
};

// tmp_s[i][k] = sum_j wy_s[i][j] * x_s[j][k] for the group's rg rows.
__device__ __forceinline__ void first_product(const float* wy_s,
                                              const float* x_s, float* tmp_s,
                                              int rg, int half, int ih,
                                              int iw) {
  const Tile t(iw);
  if (t.p >= half) return;
  const int r0 = min(t.p, rg - 1), r1 = min(t.p + half, rg - 1);
  int col[kTileCols];
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) col[c] = min(t.q + c * t.qn, iw - 1);
  const float* a0 = wy_s + r0 * ih;
  const float* a1 = wy_s + r1 * ih;
  float acc[2][kTileCols] = {};
#pragma unroll 10
  for (int j = 0; j < ih; ++j) {
    const float w0 = a0[j], w1 = a1[j];
    const float* xr = x_s + j * iw;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const float v = xr[col[c]];
      acc[0][c] = fmaf(w0, v, acc[0][c]);
      acc[1][c] = fmaf(w1, v, acc[1][c]);
    }
  }
  const int stride = odd(iw);
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) {
    if (t.q + c * t.qn >= iw) continue;
    if (t.p < rg) tmp_s[t.p * stride + col[c]] = acc[0][c];
    if (t.p + half < rg) tmp_s[(t.p + half) * stride + col[c]] = acc[1][c];
  }
}

// The thread's tile of out[i][l] = sum_k tmp_s[i][k] * wxt_s[k][l] into acc;
// false for a thread without a tile.
__device__ __forceinline__ bool second_product(const float* tmp_s,
                                               const float* wxt_s, int rg,
                                               int half, int ow, int iw,
                                               float (&acc)[2][kTileCols]) {
  const Tile t(ow);
  if (t.p >= half) return false;
  const int r0 = min(t.p, rg - 1), r1 = min(t.p + half, rg - 1);
  const int ts = odd(iw), ws = odd(ow);
  int col[kTileCols];
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) col[c] = min(t.q + c * t.qn, ow - 1);
  const float* t0 = tmp_s + r0 * ts;
  const float* t1 = tmp_s + r1 * ts;
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) acc[0][c] = acc[1][c] = 0.0f;
#pragma unroll 10
  for (int k = 0; k < iw; ++k) {
    const float u0 = t0[k], u1 = t1[k];
    const float* wr = wxt_s + k * ws;
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const float w = wr[col[c]];
      acc[0][c] = fmaf(u0, w, acc[0][c]);
      acc[1][c] = fmaf(u1, w, acc[1][c]);
    }
  }
  return true;
}

// Calls f(i, l, value) for each valid output of the thread's tile.
template <typename F>
__device__ __forceinline__ void for_each_output(int rg, int half, int ow,
                                                const float (&acc)[2][kTileCols],
                                                F f) {
  const Tile t(ow);
#pragma unroll
  for (int c = 0; c < kTileCols; ++c) {
    const int l = t.q + c * t.qn;
    if (l >= ow) continue;
    if (t.p < rg) f(t.p, l, acc[0][c]);
    if (t.p + half < rg) f(t.p + half, l, acc[1][c]);
  }
}

// What the launchers check of the geometry the wrapper passes.
inline bool geometry_ok(int oh, int ow, int ih, int iw, int groups, int rows,
                        int threads, int smem_bytes, bool with_canvas) {
  const int half = rows / 2;
  const int need = half * (cdiv(iw, kTileCols) > cdiv(ow, kTileCols)
                               ? cdiv(iw, kTileCols)
                               : cdiv(ow, kTileCols));
  return rows >= 2 && rows % 2 == 0 && groups * rows >= oh &&
         (groups - 1) * rows < oh && threads >= need &&
         threads <= kMaxThreads && threads % 32 == 0 &&
         static_cast<size_t>(Layout(rows, ow, ih, iw, with_canvas).total) *
                 sizeof(float) <=
             static_cast<size_t>(smem_bytes);
}

}  // namespace st_resample
