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
// Kernels 1, 2 and 4 (read, write, write backward), right and simple first:
// one block per image. The block stages its inputs in shared memory, forms
// each hat weight in registers from (a, c),
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
//
// The read backward (st_read_bwd_kernel, on st_cluster.cuh) gives each
// image a cluster of 2 CTAs up to B = 66 (128 CTAs for 132 SMs at B = 64)
// and 1 from B = 67 on (kernels/cluster.py:geometry; the kernel takes up to
// 8, which measured slower, PERF.md). Every CTA stages img and g whole with
// 1-D bulk copies on an mbarrier (4-byte cp.async where a range is not
// 16-byte sized and aligned) and, while they arrive, forms the hat weights
// once: each row's position p and its two taps floor(p) and floor(p) + 1,
// the only columns where relu(1 - |p - j|) is not 0, written into zeroed
// dense Wy, Wx [ws, cs] in shared memory, equal bit for bit to the dense
// hat matrices, instead of a weight rebuilt inside every FMA. CTA r forms
// its group of rows of gwx = g @ Wx in 2 x 4 register tiles and of
// tmp = Wy @ img from the row's two taps only (the dense chain's other terms
// are fmaf(+0, x, acc) with acc +0 or the sum so far, which leave it as it is
// for finite x, so tmp keeps its bits). After a cluster barrier it copies the
// other groups' rows of gwx and tmp out of their CTAs' shared memory, then
// writes its rows of d_img = Wy^T gwx in 2 x 4 register tiles beside its dW
// chains at the taps of its rows, one per (axis, row, tap) on a thread of
// its own. The dp of its rows go into the cluster's last CTA, which after a
// second cluster barrier forms the four scalars in one pass, in the order
// of a 256-thread block (lane t's chain over rows t, t + 256, ..., the
// xor-shuffle tree in each warp, the 8 warps in order). Every output keeps
// one order of sums whatever the geometry, so every launch gives the same
// bits. The compile-time sizes of the model's shapes (cs 50, ws 28) let the
// loops unroll; other sizes take them at run time. At the model's shapes a
// CTA needs 40.4 KB of shared memory; sizes that do not fit 227 KB are
// refused by the wrapper and the launcher.

#include <cuda_runtime.h>

#include "st_cluster.cuh"
#include "st_resample.cuh"

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

// One read-backward CTA's shared memory, offsets in floats, every region on
// 16 bytes. Mirrored by kernels/st_inline.py:_read_bwd_smem_floats.
struct ReadBwdLayout {
  int img, g, wy, wx, gwx, tmp, py, px, dw, dp, lanes, red, total;
  __host__ __device__ ReadBwdLayout(int cs, int ws, int rows)
      : img(0),
        g(img + st_cluster::round4(cs * cs)),      // img  [cs, cs]
        wy(g + st_cluster::round4(ws * ws)),       // g    [ws, ws]
        wx(wy + st_cluster::round4(ws * cs)),      // Wy   [ws, cs], dense
        gwx(wx + st_cluster::round4(ws * cs)),     // Wx   [ws, cs], dense
        tmp(gwx + st_cluster::round4(ws * cs)),    // gwx  [ws, cs] = g @ Wx
        py(tmp + st_cluster::round4(ws * cs)),     // tmp  [ws, cs] = Wy @ img
        px(py + st_cluster::round4(ws)),           // row positions of Wy
        dw(px + st_cluster::round4(ws)),           // row positions of Wx
        dp(dw + 4 * rows),                         // dW at this CTA's taps
        lanes(dp + st_cluster::round4(2 * ws)),    // dp of y rows, x rows
        red(lanes + 4 * st_cluster::kLanes),       // the 4 reductions' lanes
        total(red + 4 * st_cluster::kLanes / 32) {}   // their warps' sums
};

// kCs, kWs: the sizes fixed at compile time (the model's 50, 28), or 0 to
// take them from the arguments. One cluster of `cluster` CTAs per image; CTA
// `rank` owns rows [rank * rows, ...) of gwx and tmp, and with them the dp of
// those rows of Wy and of Wx, and rows [rank * out_rows, ...) of d_img.
template <int kCs, int kWs>
__global__ void __launch_bounds__(st_cluster::kMaxThreads)
st_read_bwd_kernel(const float* __restrict__ img, const float* __restrict__ g,
                   const float* __restrict__ ay, const float* __restrict__ cy,
                   const float* __restrict__ ax, const float* __restrict__ cx,
                   float* __restrict__ d_img, float* __restrict__ d_ay,
                   float* __restrict__ d_cy, float* __restrict__ d_ax,
                   float* __restrict__ d_cx, int cs_arg, int ws_arg,
                   float kpix, int cluster, int rows, int out_rows,
                   int bulk) {
  using namespace st_cluster;
  const int cs = kCs ? kCs : cs_arg, ws = kWs ? kWs : ws_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / cluster;
  const ReadBwdLayout lay(cs, ws, rows);
  float* img_s = smem + lay.img;
  float* g_s = smem + lay.g;
  float* wy_s = smem + lay.wy;
  float* wx_s = smem + lay.wx;
  float* gwx_s = smem + lay.gwx;
  float* tmp_s = smem + lay.tmp;
  float* py_s = smem + lay.py;
  float* px_s = smem + lay.px;
  float* dw_s = smem + lay.dw;
  const float* img_b = img + static_cast<size_t>(b) * cs * cs;
  const float* g_b = g + static_cast<size_t>(b) * ws * ws;

  // stage img and g; they arrive while the weights are formed
  if (bulk) {
    if (threadIdx.x == 0) {
      st_resample::mbar_init(&bar);
      st_resample::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t n_img = 4u * cs * cs, n_g = 4u * ws * ws;
      st_resample::mbar_expect_tx(&bar, n_img + n_g);
      st_resample::bulk_copy(img_s, img_b, n_img, &bar);
      st_resample::bulk_copy(g_s, g_b, n_g, &bar);
    }
  } else {
    st_resample::copy4(img_s, img_b, cs * cs);
    st_resample::copy4(g_s, g_b, ws * ws);
    st_resample::copy4_commit();
  }
  // the hat matrices Wy, Wx [ws, cs], dense: zeros, then each row's weights
  // at its two taps floor(p) and floor(p) + 1, the only columns where
  // relu(1 - |p - j|) is not 0 (tests/test_torch_st_inline.py mirrors this)
  const float a_y = ay[b], c_y = cy[b], a_x = ax[b], c_x = cx[b];
  for (int i = threadIdx.x; i < ws; i += blockDim.x) {
    py_s[i] = hat_pos(a_y, c_y, i, ws, kpix);
    px_s[i] = hat_pos(a_x, c_x, i, ws, kpix);
  }
  float4* zero = reinterpret_cast<float4*>(wy_s);
  for (int i = threadIdx.x; i < (lay.gwx - lay.wy) / 4; i += blockDim.x) {
    zero[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < 2 * ws; r += blockDim.x) {
    const bool y_axis = r < ws;
    const float p = y_axis ? py_s[r] : px_s[r - ws];
    float* row = y_axis ? wy_s + r * cs : wx_s + (r - ws) * cs;
    const float j0 = floorf(p);
    for (int tap = 0; tap < 2; ++tap) {
      const float jf = j0 + static_cast<float>(tap);
      if (jf >= 0.0f && jf < static_cast<float>(cs)) {
        const int j = static_cast<int>(jf);
        row[j] = hat(p, j);
      }
    }
  }
  if (bulk) {
    st_resample::mbar_wait(&bar, 0);
  } else {
    st_resample::copy4_wait<0>();
  }
  __syncthreads();

  // this CTA's rows of gwx = g @ Wx (2 x 4 register tiles) and of
  // tmp = Wy @ img (the row's two taps, in ascending order: the dense
  // chain's other terms add exact zeros)
  const Group own(rank, rows, ws);
  tile_product(g_s + own.first * ws, ws, 1, wx_s, cs, own.count, rows / 2, cs,
               ws, 0, blockDim.x, [&](int i, int k, float v) {
                 gwx_s[(own.first + i) * cs + k] = v;
               });
  for (int idx = threadIdx.x; idx < own.count * cs; idx += blockDim.x) {
    const int i = own.first + idx / cs, k = idx % cs;
    const float j0 = floorf(py_s[i]);
    float acc = 0.0f;
    for (int tap = 0; tap < 2; ++tap) {
      const float jf = j0 + static_cast<float>(tap);
      if (jf >= 0.0f && jf < static_cast<float>(cs)) {
        const int j = static_cast<int>(jf);
        acc = fmaf(wy_s[i * cs + j], img_s[j * cs + k], acc);
      }
    }
    tmp_s[i * cs + k] = acc;
  }
  cluster_sync();
  gather_rows(gwx_s, cs, rows, ws, cluster, rank);
  gather_rows(tmp_s, cs, rows, ws, cluster, rank);
  __syncthreads();

  // d_img[j][k] = sum_i Wy[i][j] gwx[i][k], this CTA's rows j, beside dW
  // at the taps of this CTA's rows, one chain per (axis, row, tap): y rows
  // dWy[i, j] = sum_k gwx[i, k] img[j, k], x rows
  // dWx[l, k] = sum_i g[i, l] tmp[i, k]
  const Group out(rank, out_rows, cs);
  const int n_items = 2 * own.count;
  const Split side(blockDim.x, out_rows / 2 * cdiv(cs, kTileCols), 4 * rows);
  float* d_img_b = d_img + static_cast<size_t>(b) * cs * cs;
  tile_product(wy_s + out.first, 1, cs, gwx_s, cs, out.count, out_rows / 2,
               cs, ws, side.t0[0], side.nt[0], [&](int j, int k, float v) {
                 d_img_b[(out.first + j) * cs + k] = v;
               });
  const int me = static_cast<int>(threadIdx.x) - side.t0[1];
  for (int w = me; me >= 0 && me < side.nt[1] && w < 2 * n_items;
       w += side.nt[1]) {
    const int item = w >> 1, tap = w & 1;
    const bool y_axis = item < own.count;
    const int i = own.first + (y_axis ? item : item - own.count);
    const float p = y_axis ? py_s[i] : px_s[i];
    const int j = static_cast<int>(floorf(p)) + tap;
    float dw = 0.0f;
    if (j >= 0 && j < cs && tap_sign(p, j) != 0.0f) {
      if (y_axis) {
        for (int k = 0; k < cs; ++k) {
          dw = fmaf(gwx_s[i * cs + k], img_s[j * cs + k], dw);
        }
      } else {
        for (int m = 0; m < ws; ++m) {
          dw = fmaf(g_s[m * ws + i], tmp_s[m * cs + j], dw);
        }
      }
    }
    dw_s[w] = dw;
  }
  __syncthreads();
  // dp of each of this CTA's rows, into the cluster's last CTA
  float* dp_last = cl.map_shared_rank(smem + lay.dp, cluster - 1);
  for (int item = threadIdx.x; item < n_items; item += blockDim.x) {
    const bool y_axis = item < own.count;
    const int i = own.first + (y_axis ? item : item - own.count);
    const float p = y_axis ? py_s[i] : px_s[i];
    const int j0 = static_cast<int>(floorf(p));
    float dp = 0.0f;
    for (int tap = 0; tap < 2; ++tap) {
      const int j = j0 + tap;
      const float sgn = tap_sign(p, j);
      if (j < 0 || j >= cs || sgn == 0.0f) continue;
      dp = __fadd_rn(dp, __fmul_rn(sgn, dw_s[2 * item + tap]));
    }
    dp_last[(y_axis ? 0 : ws) + i] = dp;
  }
  cluster_sync();   // the dp are in; no CTA reads another's memory after it

  // the scalar cotangents, in the order of a 256-thread block: d_a =
  // kpix * sum_i t_i dp_i, d_c = kpix * sum_i dp_i for each axis
  if (rank == cluster - 1) {
    const float* dp_s = smem + lay.dp;
    float total[4];   // ta and tc of the y rows, then of the x rows
    lane_tree_sums<4>(
        [&](int lane, float (&x)[4]) {
          for (int axis = 0; axis < 2; ++axis) {
            const float* dp = dp_s + axis * ws;
            float ta = 0.0f, tc = 0.0f;
            for (int i = lane; i < ws; i += kLanes) {
              ta = fmaf(grid_t(i, ws), dp[i], ta);
              tc = __fadd_rn(tc, dp[i]);
            }
            x[2 * axis] = ta;
            x[2 * axis + 1] = tc;
          }
        },
        smem + lay.lanes, smem + lay.red, total);
    if (threadIdx.x == 0) {
      d_ay[b] = __fmul_rn(kpix, total[0]);
      d_cy[b] = __fmul_rn(kpix, total[1]);
      d_ax[b] = __fmul_rn(kpix, total[2]);
      d_cx[b] = __fmul_rn(kpix, total[3]);
    }
  }
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

// Each launcher takes device pointers, the batch and the two sizes (the read
// backward also the geometry of kernels/st_inline.py:read_bwd_geometry: CTAs
// per cluster, rows of gwx / tmp per CTA, rows of d_img per CTA, threads,
// shared-memory bytes per CTA and 1 for the bulk-copy path), and the stream;
// it enqueues one kernel and returns cudaGetLastError() (0 = the launch was
// accepted), the error of the shared-memory attribute call or of the cluster
// launch, or cudaErrorInvalidValue for a geometry the read backward cannot
// run. The wrapper checks shapes, types, contiguity and, for the bulk path,
// alignment.

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
                                  int ws, int cluster, int rows, int out_rows,
                                  int threads, int smem_bytes, int bulk,
                                  cudaStream_t stream) {
  if (!st_cluster::geometry_ok(ws, cs, cluster, rows, out_rows, threads,
                               smem_bytes,
                               ReadBwdLayout(cs, ws, rows).total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float kpix = static_cast<float>((cs - 1.001) / 2.0);
  const auto kernel = cs == 50 && ws == 28 ? st_read_bwd_kernel<50, 28>
                                           : st_read_bwd_kernel<0, 0>;
  return static_cast<int>(st_cluster::launch_clusters(
      kernel, batch, cluster, threads, smem_bytes, stream, img, g, ay, cy, ax,
      cx, d_img, d_ay, d_cy, d_ax, d_cx, cs, ws, kpix, cluster, rows,
      out_rows, bulk));
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
