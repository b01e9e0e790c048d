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
// The backward (st_cluster.cuh) gives each image a cluster of 2 CTAs up to
// B = 66 (128 CTAs for 132 SMs at B = 64) and 1 from B = 67 on
// (kernels/cluster.py:geometry; the kernel takes up to 8, which measured
// slower, PERF.md). Every CTA stages g, win, Wy and Wx whole with 1-D bulk
// copies on one mbarrier (4-byte cp.async where a range is not 16-byte sized
// and aligned): 24 KB at the model's shapes, read again from L2 by the
// cluster's other CTA. CTA r forms its group of rows of gwx = g @ Wx beside
// those of tmp = Wy @ win (disjoint warps of the block, 2 x 4 register
// tiles); after a cluster barrier it copies the other groups' rows out of
// their CTAs' shared memory, so that gwx and tmp are whole in each CTA, and
// arrives at the last barrier. Then, side by side, it writes its rows of
// d_Wy (its rows of gwx against win^T, transposed in shared memory to an
// odd stride so that a warp's loads fall in distinct banks; win itself, at
// stride 28, would conflict 4 ways), its rows of d_Wx (columns of g
// against tmp) and its group of rows of d_win (columns of Wy against gwx),
// each output one fmaf chain in ascending order, times coeff as
// __fmul_rn(co, acc). The cluster's last CTA forms d_coeff = <gwx, tmp> in
// the order of a 256-thread block: lane t's chain over idx = t, t + 256,
// ..., the xor-shuffle tree in each warp, the 8 warps in order, whatever
// the geometry. So every launch gives the same bits (no atomics). The
// compile-time sizes of the model's shapes (cs 50, ws 28) let the loops
// unroll; other sizes take them at run time. At the model's shapes a CTA
// needs 39.8 KB of shared memory; sizes that do not fit 227 KB are refused
// by the wrapper and the launcher.
//
// The forward reads `canvas` and writes `out`; the wrapper passes a fresh
// `out` (the TPU kernel aliases them).
//
// No tensor cores: both kernels are held to fp32 at 1e-5, Hopper's tensor
// cores take fp32 only as TF32 (10-bit mantissa), which the port's numeric
// flags forbid (models/air.py:_numeric_flags), and the FLOP bounds lie below
// the byte bounds, so they would not lower the bounds.

#include <cuda_runtime.h>

#include "st_cluster.cuh"
#include "st_resample.cuh"

namespace {

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

// One backward CTA's shared memory, offsets in floats, every region on 16
// bytes. Mirrored by kernels/st_fused.py:_bwd_smem_floats.
struct BwdLayout {
  int g, win, wy, wx, wint, gwx, tmp, lanes, red, total;
  __host__ __device__ BwdLayout(int cs, int ws)
      : g(0),
        win(g + st_cluster::round4(cs * cs)),              // g      [cs, cs]
        wy(win + st_cluster::round4(ws * ws)),             // win    [ws, ws]
        wx(wy + st_cluster::round4(cs * ws)),              // Wy     [cs, ws]
        wint(wx + st_cluster::round4(cs * ws)),            // Wx     [cs, ws]
        gwx(wint + st_cluster::round4(ws * st_cluster::odd(ws))),  // win^T
        tmp(gwx + st_cluster::round4(cs * ws)),            // gwx    [cs, ws]
        lanes(tmp + st_cluster::round4(cs * ws)),          // tmp    [cs, ws]
        red(lanes + st_cluster::kLanes),                   // d_coeff's lanes
        total(red + st_cluster::kLanes / 32) {}            // its warps' sums
};

// kCs, kWs as for the forward. One cluster of `cluster` CTAs per image; CTA
// `rank` owns rows [rank * rows, ...) of gwx, tmp, d_Wy and d_Wx and rows
// [rank * out_rows, ...) of d_win.
template <int kCs, int kWs>
__global__ void __launch_bounds__(st_cluster::kMaxThreads)
st_wmac_bwd_kernel(const float* __restrict__ wy, const float* __restrict__ win,
                   const float* __restrict__ wx,
                   const float* __restrict__ coeff,
                   const float* __restrict__ g, float* __restrict__ d_wy,
                   float* __restrict__ d_win, float* __restrict__ d_wx,
                   float* __restrict__ d_coeff, int cs_arg, int ws_arg,
                   int cluster, int rows, int out_rows, int bulk) {
  using namespace st_cluster;
  const int cs = kCs ? kCs : cs_arg, ws = kWs ? kWs : ws_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int b = blockIdx.x / cluster;
  const BwdLayout lay(cs, ws);
  float* g_s = smem + lay.g;
  float* win_s = smem + lay.win;
  float* wy_s = smem + lay.wy;
  float* wx_s = smem + lay.wx;
  float* wint_s = smem + lay.wint;
  float* gwx_s = smem + lay.gwx;
  float* tmp_s = smem + lay.tmp;
  const size_t mat = static_cast<size_t>(b) * cs * ws;
  const float* g_b = g + static_cast<size_t>(b) * cs * cs;
  const float* win_b = win + static_cast<size_t>(b) * ws * ws;

  if (bulk) {
    if (threadIdx.x == 0) {
      st_resample::mbar_init(&bar);
      st_resample::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t n_g = 4u * cs * cs, n_win = 4u * ws * ws,
                     n_w = 4u * cs * ws;
      st_resample::mbar_expect_tx(&bar, n_g + n_win + 2 * n_w);
      st_resample::bulk_copy(g_s, g_b, n_g, &bar);
      st_resample::bulk_copy(win_s, win_b, n_win, &bar);
      st_resample::bulk_copy(wy_s, wy + mat, n_w, &bar);
      st_resample::bulk_copy(wx_s, wx + mat, n_w, &bar);
    }
    st_resample::mbar_wait(&bar, 0);
  } else {
    st_resample::copy4(g_s, g_b, cs * cs);
    st_resample::copy4(win_s, win_b, ws * ws);
    st_resample::copy4(wy_s, wy + mat, cs * ws);
    st_resample::copy4(wx_s, wx + mat, cs * ws);
    st_resample::copy4_commit();
    st_resample::copy4_wait<0>();
    __syncthreads();
  }
  const float co = coeff[b];
  st_resample::transpose_wx(win_s, wint_s, ws, ws);   // win^T [ws, odd(ws)]

  // this CTA's rows of gwx = g @ Wx and tmp = Wy @ win, side by side
  const Group own(rank, rows, cs);
  const int half = rows / 2, tiles = half * cdiv(ws, kTileCols);
  const Split first(blockDim.x, tiles, tiles);
  tile_product(g_s + own.first * cs, cs, 1, wx_s, ws, own.count, half, ws, cs,
               first.t0[0], first.nt[0], [&](int i, int k, float v) {
                 gwx_s[(own.first + i) * ws + k] = v;
               });
  tile_product(wy_s + own.first * ws, ws, 1, win_s, ws, own.count, half, ws,
               ws, first.t0[1], first.nt[1], [&](int i, int k, float v) {
                 tmp_s[(own.first + i) * ws + k] = v;
               });
  cluster_sync();
  gather_rows(gwx_s, ws, rows, cs, cluster, rank);
  gather_rows(tmp_s, ws, rows, cs, cluster, rank);
  cluster_arrive();   // done with the other CTAs' shared memory
  __syncthreads();

  // the three weight cotangents, side by side
  const Group out(rank, out_rows, ws);
  const Split second(blockDim.x, tiles, tiles,
                     out_rows / 2 * cdiv(ws, kTileCols));
  // d_Wy[i][j] = co * sum_k gwx[i][k] win[j][k], this CTA's rows i
  float* d_wy_b = d_wy + mat;
  tile_product(gwx_s + own.first * ws, ws, 1, wint_s, odd(ws), own.count,
               half, ws, ws, second.t0[0], second.nt[0],
               [&](int i, int j, float v) {
                 d_wy_b[(own.first + i) * ws + j] = __fmul_rn(co, v);
               });
  // d_Wx[l][k] = co * sum_m g[m][l] tmp[m][k], this CTA's rows l
  float* d_wx_b = d_wx + mat;
  tile_product(g_s + own.first, 1, cs, tmp_s, ws, own.count, half, ws, cs,
               second.t0[1], second.nt[1], [&](int l, int k, float v) {
                 d_wx_b[(own.first + l) * ws + k] = __fmul_rn(co, v);
               });
  // d_win[j][k] = co * sum_i Wy[i][j] gwx[i][k], this CTA's rows j
  float* d_win_b = d_win + static_cast<size_t>(b) * ws * ws;
  tile_product(wy_s + out.first, 1, ws, gwx_s, ws, out.count, out_rows / 2,
               ws, cs, second.t0[2], second.nt[2],
               [&](int j, int k, float v) {
                 d_win_b[(out.first + j) * ws + k] = __fmul_rn(co, v);
               });
  // d_coeff = <gwx, tmp>, in the order of a 256-thread block
  if (rank == cluster - 1) {
    float total[1];
    lane_tree_sums<1>(
        [&](int lane, float (&x)[1]) {
          float dco = 0.0f;
          for (int idx = lane; idx < cs * ws; idx += kLanes) {
            dco = fmaf(gwx_s[idx], tmp_s[idx], dco);
          }
          x[0] = dco;
        },
        smem + lay.lanes, smem + lay.red, total);
    if (threadIdx.x == 0) d_coeff[b] = total[0];
  }
  cluster_wait();
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

// Each launcher takes device pointers, the batch, the two sizes, the launch
// geometry the wrapper computed and the stream: for the forward
// (kernels/st_fused.py:geometry) row groups per canvas, rows per group,
// threads, shared-memory bytes per block and 1 for the bulk-copy path; for
// the backward (kernels/st_fused.py:bwd_geometry) CTAs per cluster, rows of
// gwx / tmp / d_Wy / d_Wx per CTA, rows of d_win per CTA, threads,
// shared-memory bytes per CTA and 1 for the bulk-copy path. It enqueues one
// kernel and returns cudaGetLastError() (0 = the launch was accepted), the
// error of the shared-memory attribute call or of the cluster launch, or
// cudaErrorInvalidValue for a geometry the kernel cannot run. The wrapper
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
                           int batch, int cs, int ws, int cluster, int rows,
                           int out_rows, int threads, int smem_bytes, int bulk,
                           cudaStream_t stream) {
  if (!st_cluster::geometry_ok(cs, ws, cluster, rows, out_rows, threads,
                               smem_bytes, BwdLayout(cs, ws).total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = cs == 50 && ws == 28 ? st_wmac_bwd_kernel<50, 28>
                                           : st_wmac_bwd_kernel<0, 0>;
  return static_cast<int>(st_cluster::launch_clusters(
      kernel, batch, cluster, threads, smem_bytes, stream, wy, win, wx, coeff,
      g, d_wy, d_win, d_wx, d_coeff, cs, ws, cluster, rows, out_rows, bulk));
}
