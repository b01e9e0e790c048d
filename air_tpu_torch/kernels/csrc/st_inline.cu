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
// are far below the few microseconds of a kernel launch, so the latency of
// a launch's dependent steps bounds them, not bytes or operations.
//
// Every product is an fp32 FMA (no TF32). The weights are rounded exactly
// as the plain PyTorch version rounds them (explicit _rn intrinsics, no
// contraction): the grid t by jnp.linspace's formula, not the TPU kernel's
// -1 + 2 i / (out - 1), which differs by an ulp at some i; in the write,
// a = 1/s (up to 10) times (ws - 1.001) / 2 magnifies that ulp to ~1e-5 in
// the output, and in the backward an ulp of p can move a tap of the mask.
// No kernel uses atomics, and every output keeps one order of sums, so a
// run gives the same bits every time. The write kernel reads `canvas` and
// writes `out`; the wrapper passes a fresh `out`.
//
// Kernels 1 and 2 (read, write): two taps per hat row, spread over the
// card. A row of a hat matrix has at most two non-zero weights, at
// floor(p) and floor(p) + 1, so each output takes 4 inputs and 6 FMAs
// instead of dense chains over the whole inner axis (the TPU kernel's two
// MXU products; dense is cheap there, not in fp32 here):
//   tmp(i, k) = fmaf(wy1, X[jy + 1, k], fmaf(wy0, X[jy, k], 0))  at k = kx,
//               kx + 1,
//   out(i, l) = fmaf(tmp(i, kx + 1), wx1, fmaf(tmp(i, kx), wx0, 0)),
// where X is the image (read) or the window (write), and the write adds
// canvas + coeff * out. This is the dense chain's result bit for bit: a
// dense term whose weight is +0 adds +0 or -0 to an accumulator that
// started at +0 and so is never -0, which leaves it as it is for finite X,
// and the two taps come in the dense chain's ascending order. Each hat row
// is kept as a Tap (j, w0, w1): the row is w0 at column j, w1 at j + 1 and
// 0 elsewhere, with j clamped into [0, in - 2] so both reads are in range; a
// tap outside [0, in) gets weight 0, and a NaN or far-off position none (as
// the dense chain, whose fmaxf drops a NaN), since floorf(p) is compared
// in float before any cast to int (tests/test_torch_st_inline.py mirrors
// two_taps). One block per (image, band of output rows), so a batch of 64
// gives every SM blocks and one image spans many SMs
// (kernels/st_inline.py:fwd_geometry): the block forms its rows' and the
// columns' taps once into shared memory (one __fdiv_rn per row or column),
// then each thread writes kVec (2 where the width is even: float2 loads and
// stores) neighbouring outputs of a row, neighbouring lanes on neighbouring
// columns, reading X through the read-only cache or, with `stage`, from the
// band's rows of X staged in shared memory while the taps are formed (a
// bulk copy on an mbarrier where the range is 16-byte sized and aligned,
// else 4-byte cp.async). Compile-time sizes for the model's (50, 28).
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
//
// The write backward (st_write_bwd_kernel) runs one CTA per image with a
// plain launch (kernels/st_inline.py:write_bwd_geometry). It stages win and
// g whole with bulk copies, as the read backward does, and runs every chain
// over the taps alone. A hat matrix W [cs, ws] has at most two non-zero
// weights per row; with the write's a = 1/s > 1 a column of it has them in
// at most 4 rows. So the CTA forms, while win and g arrive, the rows'
// positions and each column k's range [lo(k), hi(k)]: the least and the
// greatest row whose taps (tap_column) include k. Then:
//   gwx[i][k] = chain over l in [lo_x(k), hi_x(k)] of g[i][l] * hat(px_l, k),
//   tmp[i][k] = fmaf(w1, win[j + 1][k], fmaf(w0, win[j][k], 0))  (two_taps),
//   d_win[j][k] = coeff * chain over i in [lo_y(j), hi_y(j)] of
//                 hat(py_i, j) * gwx[i][k],
// each the dense chain's result bit for bit, for finite g and any positions,
// monotone or not: a row inside the range that does not tap the column
// weighs +0, and outside it the dense chain's accumulator is +0 and stays so
// (the argument above). gwx runs beside tmp, then d_win beside the dp of
// each row of Wy and Wx, on disjoint warps (st_cluster.cuh's Split), one
// thread per row running the dW chains of its two taps side by side (the x
// rows' 50-term chains over g and tmp are the longest work). The four axis
// scalars and d_coeff = <tmp, gwx> are summed in the order of a 256-thread
// block (st_cluster.cuh's lane_tree_sums: lane t's chain over t, t + 256,
// ..., row-major for d_coeff; the xor-shuffle tree; the 8 warps in order),
// the order of the one-block kernel this replaced, so every output keeps its
// bits. An image's work is a chain of dependent phases, each of which runs
// its items in one pass, so a second CTA per image shortens none of them:
// clusters of 2 measured slower at every batch (PERF.md). At the model's
// shapes a CTA needs 31,088 bytes of shared memory.

#include <cuda_runtime.h>

#include "st_cluster.cuh"
#include "st_resample.cuh"

namespace {

// t_i of linspace(-1, 1, n): -1 * (1 - step) + 1 * step, step = i / (n - 1),
// end point exact.
__device__ __forceinline__ float grid_t(int i, int n) {
  if (i == n - 1) return 1.0f;
  const float step = __fdiv_rn(static_cast<float>(i), static_cast<float>(n - 1));
  return __fadd_rn(-__fsub_rn(1.0f, step), step);
}

// Position (a * t + c + 1) * kpix of the hat row at grid point t. kpix is
// (in_dim - 1.001) / 2 rounded once to float by the launcher.
__device__ __forceinline__ float hat_pos_at(float a, float c, float t,
                                            float kpix) {
  return __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, t), c), 1.0f), kpix);
}

// Position p_i of output row i of a [out_dim, in_dim] hat matrix.
__device__ __forceinline__ float hat_pos(float a, float c, int i, int out_dim,
                                         float kpix) {
  return hat_pos_at(a, c, grid_t(i, out_dim), kpix);
}

__device__ __forceinline__ float hat(float p, int j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(p, static_cast<float>(j)))));
}

// -------------------- forward: two taps per hat row ------------------------

constexpr int kFwdThreads = 256;

// A hat row relu(1 - |p - j'|) over j' in [0, n), n >= 2: w0 at column j, w1
// at j + 1, 0 elsewhere; j in [0, n - 2]. 16 bytes, one shared load.
struct __align__(16) Tap {
  int j;
  float w0, w1, unused;
};

// Column floor(p) + tap (tap 0 or 1) of position p into *j, if it lies in
// [0, n). floorf(p) is compared in float before the cast, so a NaN or a p
// beyond int's range gives no column.
__device__ __forceinline__ bool tap_column(float p, int tap, int n, int* j) {
  const float jf = floorf(p) + static_cast<float>(tap);
  if (!(jf >= 0.0f && jf < static_cast<float>(n))) return false;
  *j = static_cast<int>(jf);
  return true;
}

// The row of position p: its taps floor(p) and floor(p) + 1 where they lie
// in [0, n), weighted as the dense row weights them (hat), and j the first
// tap clamped into [0, n - 2] (0 for a NaN p, whose row has no tap).
__device__ __forceinline__ Tap two_taps(float p, int n) {
  Tap t;
  t.j = static_cast<int>(
      fminf(fmaxf(floorf(p), 0.0f), static_cast<float>(n - 2)));
  t.w0 = t.w1 = t.unused = 0.0f;
#pragma unroll
  for (int tap = 0; tap < 2; ++tap) {
    int j;
    if (tap_column(p, tap, n, &j)) {
      const float w = hat(p, j);
      if (j == t.j) {
        t.w0 = w;
      } else {
        t.w1 = w;
      }
    }
  }
  return t;
}

// One band of output rows [r0, r0 + rows) of out[b] (n x n) = Wy X[b] Wx^T
// (X[b] in x in), or with kCanvas canvas[b] + coeff[b] * (Wy X[b] Wx^T),
// from block blockIdx.x = b * bands + band. kIn, kOut: the sizes fixed at
// compile time, or 0 to take them from the arguments. kVec: outputs per
// item, neighbouring columns of one row (2 needs n even and 8-byte aligned
// out and canvas). stage: X's rows that the band's taps touch are copied
// into shared memory first; bulk: by one bulk copy (X 16-byte aligned,
// in * in a multiple of 4).
template <int kIn, int kOut, int kVec, bool kCanvas>
__device__ __forceinline__ void two_tap_band(
    const float* __restrict__ x, const float* __restrict__ ay,
    const float* __restrict__ cy, const float* __restrict__ ax,
    const float* __restrict__ cx, const float* __restrict__ canvas,
    const float* __restrict__ coeff, float* __restrict__ out, int in_arg,
    int n_arg, float kpix, int bands, int rows, int stage, int bulk) {
  const int in = kIn ? kIn : in_arg, n = kOut ? kOut : n_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.x / bands, band = blockIdx.x - b * bands;
  const int r0 = band * rows, rb = min(rows, n - r0);
  Tap* ty = reinterpret_cast<Tap*>(smem);   // [rb] the band's rows
  Tap* tx = ty + rb;                        // [n] the columns
  float* x_s = smem + 4 * (rows + n);       // the staged rows of X
  const float a_y = ay[b], c_y = cy[b], a_x = ax[b], c_x = cx[b];
  const float* x_b = x + static_cast<size_t>(b) * in * in;

  // Staged: rows [lo, hi) of X hold every tap of the band. p is monotone in
  // the row index (each rounding step is), so the end rows' taps bound the
  // others'; a row without a tap (NaN p) is clamped into the range below.
  int lo = 0, hi = in, off = 0;
  if (stage) {
    const int ja = two_taps(hat_pos(a_y, c_y, r0, n, kpix), in).j;
    const int jb = two_taps(hat_pos(a_y, c_y, r0 + rb - 1, n, kpix), in).j;
    lo = min(ja, jb);
    hi = max(ja, jb) + 2;
    if (bulk) {
      off = (lo * in) & ~3;
      const uint32_t bytes = 4u * (st_resample::round4(hi * in) - off);
      if (threadIdx.x == 0) {
        st_resample::mbar_init(&bar);
        st_resample::mbar_fence_init();
        st_resample::mbar_expect_tx(&bar, bytes);
        st_resample::bulk_copy(x_s, x_b + off, bytes, &bar);
      }
    } else {
      off = lo * in;
      st_resample::copy4(x_s, x_b + off, (hi - lo) * in);
      st_resample::copy4_commit();
    }
  }
  for (int t = threadIdx.x; t < rb + n; t += blockDim.x) {
    ty[t] = t < rb ? two_taps(hat_pos(a_y, c_y, r0 + t, n, kpix), in)
                   : two_taps(hat_pos(a_x, c_x, t - rb, n, kpix), in);
  }
  if (stage && !bulk) st_resample::copy4_wait<0>();
  __syncthreads();   // the taps, and the barrier's init, seen by every thread
  if (stage && bulk) st_resample::mbar_wait(&bar, 0);

  const float co = kCanvas ? coeff[b] : 0.0f;
  const int per_row = n / kVec, items = rb * per_row;
  float* out_b = out + (static_cast<size_t>(b) * n + r0) * n;
  const float* canvas_b =
      kCanvas ? canvas + (static_cast<size_t>(b) * n + r0) * n : nullptr;
  auto run = [&](auto ld) {
    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int i = it / per_row, l = (it - i * per_row) * kVec;
      Tap r = ty[i];
      r.j = min(max(r.j, lo), hi - 2);
      const int row0 = r.j * in, row1 = row0 + in;
      float v[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const Tap c = tx[l + e];
        const float t0 = fmaf(r.w1, ld(row1 + c.j),
                              fmaf(r.w0, ld(row0 + c.j), 0.0f));
        const float t1 = fmaf(r.w1, ld(row1 + c.j + 1),
                              fmaf(r.w0, ld(row0 + c.j + 1), 0.0f));
        v[e] = fmaf(t1, c.w1, fmaf(t0, c.w0, 0.0f));
      }
      const int o = i * n + l;
      if constexpr (kCanvas) {
        if constexpr (kVec == 2) {
          const float2 cv = __ldg(reinterpret_cast<const float2*>(canvas_b + o));
          v[0] = __fadd_rn(cv.x, __fmul_rn(co, v[0]));
          v[1] = __fadd_rn(cv.y, __fmul_rn(co, v[1]));
        } else {
          v[0] = __fadd_rn(__ldg(canvas_b + o), __fmul_rn(co, v[0]));
        }
      }
      if constexpr (kVec == 2) {
        *reinterpret_cast<float2*>(out_b + o) = make_float2(v[0], v[1]);
      } else {
        out_b[o] = v[0];
      }
    }
  };
  if (stage) {
    run([&](int idx) { return x_s[idx - off]; });
  } else {
    run([&](int idx) { return __ldg(x_b + idx); });
  }
}

template <int kCs, int kWs, int kVec>
__global__ void __launch_bounds__(kFwdThreads)
st_read_kernel(const float* __restrict__ img, const float* __restrict__ ay,
               const float* __restrict__ cy, const float* __restrict__ ax,
               const float* __restrict__ cx, float* __restrict__ out, int cs,
               int ws, float kpix, int bands, int rows, int stage, int bulk) {
  two_tap_band<kCs, kWs, kVec, false>(img, ay, cy, ax, cx, nullptr, nullptr,
                                      out, cs, ws, kpix, bands, rows, stage,
                                      bulk);
}

template <int kCs, int kWs, int kVec>
__global__ void __launch_bounds__(kFwdThreads)
st_write_kernel(const float* __restrict__ canvas, const float* __restrict__ win,
                const float* __restrict__ ay, const float* __restrict__ cy,
                const float* __restrict__ ax, const float* __restrict__ cx,
                const float* __restrict__ coeff, float* __restrict__ out,
                int cs, int ws, float kpix, int bands, int rows, int stage,
                int bulk) {
  two_tap_band<kWs, kCs, kVec, true>(win, ay, cy, ax, cx, canvas, coeff, out,
                                     ws, cs, kpix, bands, rows, stage, bulk);
}

// What the forward launchers check of the geometry the wrapper passes
// (kernels/st_inline.py:fwd_geometry): X in x in, out n x n.
inline bool fwd_geometry_ok(int in, int n, int bands, int rows, int threads,
                            int smem_bytes, int vec, int stage, int bulk) {
  const size_t need = sizeof(float) * (4 * static_cast<size_t>(rows + n) +
                                       (stage ? static_cast<size_t>(in) * in
                                              : 0));
  return in >= 2 && n >= 2 && rows >= 1 && bands >= 1 && bands * rows >= n &&
         (bands - 1) * rows < n && threads >= 32 && threads <= kFwdThreads &&
         threads % 32 == 0 && (vec == 1 || (vec == 2 && n % 2 == 0)) &&
         (stage == 0 || stage == 1) &&
         (bulk == 0 || (bulk == 1 && stage == 1 && in * in % 4 == 0)) &&
         need <= static_cast<size_t>(smem_bytes);
}

// -------------------- backward --------------------------------------------

// -sign(p - j) * 1{|p - j| < 1} for the tap j of position p: +1, -1 or 0.
__device__ __forceinline__ float tap_sign(float p, int j) {
  const float d = __fsub_rn(p, static_cast<float>(j));
  if (!(fabsf(d) < 1.0f)) return 0.0f;
  return d > 0.0f ? -1.0f : (d < 0.0f ? 1.0f : 0.0f);
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
    for (int tap = 0; tap < 2; ++tap) {
      int j;
      if (tap_column(p, tap, cs, &j)) row[j] = hat(p, j);
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
    float acc = 0.0f;
    for (int tap = 0; tap < 2; ++tap) {
      int j;
      if (tap_column(py_s[i], tap, cs, &j)) {
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
    int j;
    float dw = 0.0f;
    if (tap_column(p, tap, cs, &j) && tap_sign(p, j) != 0.0f) {
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
    float dp = 0.0f;
    for (int tap = 0; tap < 2; ++tap) {
      int j;
      if (!tap_column(p, tap, cs, &j)) continue;
      const float sgn = tap_sign(p, j);
      if (sgn == 0.0f) continue;
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

// One write-backward CTA's shared memory, offsets in floats, every region on
// 16 bytes. Mirrored by kernels/st_inline.py:_write_bwd_smem_floats.
struct WriteBwdLayout {
  int win, g, gwx, tmp, t, py, px, range, dp, lanes, red, total;
  __host__ __device__ WriteBwdLayout(int cs, int ws)
      : win(0),
        g(win + st_cluster::round4(ws * ws)),      // win  [ws, ws]
        gwx(g + st_cluster::round4(cs * cs)),      // g    [cs, cs]
        tmp(gwx + st_cluster::round4(cs * ws)),    // gwx  [cs, ws] = g @ Wx
        t(tmp + st_cluster::round4(cs * ws)),      // tmp  [cs, ws] = Wy @ win
        py(t + st_cluster::round4(cs)),            // the grid t_i of the rows
        px(py + st_cluster::round4(cs)),           // row positions of Wy
        range(px + st_cluster::round4(cs)),        // row positions of Wx
        dp(range + 4 * ws),                        // int lo, hi [2][ws]
        lanes(dp + st_cluster::round4(2 * cs)),    // dp of y rows, x rows
        red(lanes + 5 * st_cluster::kLanes),       // the 5 reductions' lanes
        total(red + 5 * st_cluster::kLanes / 32) {}   // their warps' sums
};

// The write backward's items (kernels/st_inline.py:_write_bwd_phases
// mirrors them): gwx kGwxRows rows band + r * bands of one column, tmp one
// row at kTmpCols columns q + c * qn, d_win one row at kDwinCols columns. At
// the model's shapes gwx's 112 items and tmp's 100 run side by side on 256
// threads, each ~4 range terms deep with 13 or 14 independent chains.
constexpr int kGwxRows = 13, kTmpCols = 14, kDwinCols = 8;

// kCs, kWs: the sizes fixed at compile time (the model's 50, 28), or 0 to
// take them from the arguments. One CTA per image, blockIdx.x.
template <int kCs, int kWs>
__global__ void __launch_bounds__(st_cluster::kMaxThreads)
st_write_bwd_kernel(const float* __restrict__ win, const float* __restrict__ g,
                    const float* __restrict__ ay, const float* __restrict__ cy,
                    const float* __restrict__ ax, const float* __restrict__ cx,
                    const float* __restrict__ coeff, float* __restrict__ d_win,
                    float* __restrict__ d_ay, float* __restrict__ d_cy,
                    float* __restrict__ d_ax, float* __restrict__ d_cx,
                    float* __restrict__ d_coeff, int cs_arg, int ws_arg,
                    float kpix, int bulk) {
  using namespace st_cluster;
  const int cs = kCs ? kCs : cs_arg, ws = kWs ? kWs : ws_arg;
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  const int b = blockIdx.x;
  const WriteBwdLayout lay(cs, ws);
  float* win_s = smem + lay.win;
  float* g_s = smem + lay.g;
  float* gwx_s = smem + lay.gwx;
  float* tmp_s = smem + lay.tmp;
  float* t_s = smem + lay.t;
  float* py_s = smem + lay.py;
  float* px_s = smem + lay.px;
  int* lo_s = reinterpret_cast<int*>(smem + lay.range);   // y columns, x
  int* hi_s = lo_s + 2 * ws;
  float* dp_s = smem + lay.dp;
  const float* win_b = win + static_cast<size_t>(b) * ws * ws;
  const float* g_b = g + static_cast<size_t>(b) * cs * cs;

  // stage win and g; they arrive while the positions and ranges are formed
  if (bulk) {
    if (threadIdx.x == 0) {
      const uint32_t n_win = 4u * ws * ws, n_g = 4u * cs * cs;
      st_resample::mbar_init(&bar);
      st_resample::mbar_fence_init();
      st_resample::mbar_expect_tx(&bar, n_win + n_g);
      st_resample::bulk_copy(win_s, win_b, n_win, &bar);
      st_resample::bulk_copy(g_s, g_b, n_g, &bar);
    }
  } else {
    st_resample::copy4(win_s, win_b, ws * ws);
    st_resample::copy4(g_s, g_b, cs * cs);
    st_resample::copy4_commit();
  }
  const float a_y = ay[b], c_y = cy[b], a_x = ax[b], c_x = cx[b];
  const float co = coeff[b];
  for (int i = threadIdx.x; i < cs; i += blockDim.x) {
    const float t = grid_t(i, cs);
    t_s[i] = t;
    py_s[i] = hat_pos_at(a_y, c_y, t, kpix);
    px_s[i] = hat_pos_at(a_x, c_x, t, kpix);
  }
  for (int k = threadIdx.x; k < 2 * ws; k += blockDim.x) {
    lo_s[k] = cs;
    hi_s[k] = -1;
  }
  __syncthreads();
  // Column k's range [lo, hi]: the least and the greatest row whose taps
  // (tap_column: none for a NaN, infinite or far-off position) include k,
  // empty (lo > hi) where no row's do. A row outside it weighs +0 in column
  // k. Integer min and max, so the order of the atomics does not matter.
  for (int r = threadIdx.x; r < 2 * cs; r += blockDim.x) {
    const bool y_axis = r < cs;
    const int i = y_axis ? r : r - cs;
    const float p = y_axis ? py_s[i] : px_s[i];
    for (int tap = 0; tap < 2; ++tap) {
      int j;
      if (tap_column(p, tap, ws, &j)) {
        atomicMin(lo_s + (y_axis ? 0 : ws) + j, i);
        atomicMax(hi_s + (y_axis ? 0 : ws) + j, i);
      }
    }
  }
  if (bulk) {
    st_resample::mbar_wait(&bar, 0);
  } else {
    st_resample::copy4_wait<0>();
  }
  __syncthreads();

  // gwx = g @ Wx and tmp = Wy @ win side by side where they fit. gwx[i][k]
  // is one chain over the rows l of column k's range, ascending, weighted
  // hat(px_l, k); tmp[i][k] the two taps of row i of Wy.
  const int bands = cdiv(cs, kGwxRows), tq = cdiv(ws, kTmpCols);
  const Split one(blockDim.x, bands * ws, cs * tq);
  int me = static_cast<int>(threadIdx.x) - one.t0[0];
  for (int it = me; me >= 0 && me < one.nt[0] && it < bands * ws;
       it += one.nt[0]) {
    const int band = it / ws, k = it - band * ws;
    const int lo = lo_s[ws + k], hi = hi_s[ws + k];
    int row[kGwxRows];
    float acc[kGwxRows];
#pragma unroll
    for (int r = 0; r < kGwxRows; ++r) {
      row[r] = min(band + r * bands, cs - 1) * cs;
      acc[r] = 0.0f;
    }
    for (int l = lo; l <= hi; ++l) {
      const float w = hat(px_s[l], k);
#pragma unroll
      for (int r = 0; r < kGwxRows; ++r) {
        acc[r] = fmaf(g_s[row[r] + l], w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kGwxRows; ++r) {
      const int i = band + r * bands;
      if (i < cs) gwx_s[i * ws + k] = acc[r];
    }
  }
  me = static_cast<int>(threadIdx.x) - one.t0[1];
  for (int it = me; me >= 0 && me < one.nt[1] && it < cs * tq;
       it += one.nt[1]) {
    const int i = it / tq, q = it - i * tq;
    const Tap t = two_taps(py_s[i], ws);
    const float* r0 = win_s + t.j * ws;
    const float* r1 = r0 + ws;
    float* row = tmp_s + i * ws;
#pragma unroll
    for (int c = 0; c < kTmpCols; ++c) {
      const int k = q + c * tq;
      if (k < ws) row[k] = fmaf(t.w1, r1[k], fmaf(t.w0, r0[k], 0.0f));
    }
  }
  __syncthreads();

  // d_win[j][k] = coeff * sum_i Wy[i][j] gwx[i][k]: one chain over the rows
  // i of column j's range of Wy, ascending, at kDwinCols columns; beside it
  // on other warps the dp of every row, one thread per (axis, row) running
  // the dW chains of both taps side by side, y rows and x rows on warps of
  // their own (so no warp runs both chain lengths one after the other):
  // y rows dWy[i, j] = sum_k gwx[i, k] win[j, k], x rows
  // dWx[l, j] = sum_m g[m, l] tmp[m, j]; then
  // dp_i = sum over the taps of -sign(p_i - j) * (coeff * dW[i, j]).
  const int dq = cdiv(ws, kDwinCols), yspan = round32(cs);
  const Split two(blockDim.x, ws * dq, 2 * yspan);
  float* d_win_b = d_win + static_cast<size_t>(b) * ws * ws;
  me = static_cast<int>(threadIdx.x) - two.t0[0];
  for (int it = me; me >= 0 && me < two.nt[0] && it < ws * dq;
       it += two.nt[0]) {
    const int j = it / dq, q = it - j * dq;
    const int lo = lo_s[j], hi = hi_s[j];
    int col[kDwinCols];
    float acc[kDwinCols];
#pragma unroll
    for (int c = 0; c < kDwinCols; ++c) {
      col[c] = min(q + c * dq, ws - 1);
      acc[c] = 0.0f;
    }
    for (int i = lo; i <= hi; ++i) {
      const float w = hat(py_s[i], j);
      const float* gr = gwx_s + i * ws;
#pragma unroll
      for (int c = 0; c < kDwinCols; ++c) acc[c] = fmaf(w, gr[col[c]], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kDwinCols; ++c) {
      const int k = q + c * dq;
      if (k < ws) d_win_b[j * ws + k] = __fmul_rn(co, acc[c]);
    }
  }
  me = static_cast<int>(threadIdx.x) - two.t0[1];
  for (int item = me; me >= 0 && me < two.nt[1] && item < 2 * yspan;
       item += two.nt[1]) {
    const bool y_axis = item < yspan;
    const int i = y_axis ? item : item - yspan;
    if (i >= cs) continue;
    const float p = y_axis ? py_s[i] : px_s[i];
    int j[2];
    float sgn[2];
#pragma unroll
    for (int tap = 0; tap < 2; ++tap) {
      sgn[tap] = tap_column(p, tap, ws, &j[tap]) ? tap_sign(p, j[tap]) : 0.0f;
      if (sgn[tap] == 0.0f) j[tap] = 0;   // a column to read; not used
    }
    float dw[2] = {0.0f, 0.0f};
    if (y_axis) {
      const float* gr = gwx_s + i * ws;
      const float* w0 = win_s + j[0] * ws;
      const float* w1 = win_s + j[1] * ws;
      for (int k = 0; k < ws; ++k) {
        dw[0] = fmaf(gr[k], w0[k], dw[0]);
        dw[1] = fmaf(gr[k], w1[k], dw[1]);
      }
    } else {
#pragma unroll 10
      for (int m = 0; m < cs; ++m) {
        const float v = g_s[m * cs + i];
        dw[0] = fmaf(v, tmp_s[m * ws + j[0]], dw[0]);
        dw[1] = fmaf(v, tmp_s[m * ws + j[1]], dw[1]);
      }
    }
    float dp = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 2; ++tap) {
      if (sgn[tap] != 0.0f) {
        dp = __fadd_rn(dp, __fmul_rn(sgn[tap], __fmul_rn(co, dw[tap])));
      }
    }
    dp_s[(y_axis ? 0 : cs) + i] = dp;
  }
  __syncthreads();

  // the five scalars, each in the order of a 256-thread block: d_a =
  // kpix * sum_i t_i dp_i and d_c = kpix * sum_i dp_i for each axis (lane
  // v's chains over rows v, v + 256, ...) and d_coeff = <tmp, gwx> (lane
  // v's fmaf chain over the row-major elements v, v + 256, ...: the one-block
  // kernel's thread v); the xor-shuffle tree in each warp and the 8 warps in
  // order
  float total[5];
  lane_tree_sums<5>(
      [&](int v, float (&x)[5]) {
        for (int axis = 0; axis < 2; ++axis) {
          const float* dp = dp_s + axis * cs;
          float ta = 0.0f, tc = 0.0f;
          for (int i = v; i < cs; i += kLanes) {
            ta = fmaf(t_s[i], dp[i], ta);
            tc = __fadd_rn(tc, dp[i]);
          }
          x[2 * axis] = ta;
          x[2 * axis + 1] = tc;
        }
        float dco = 0.0f;
        for (int idx = v; idx < cs * ws; idx += kLanes) {
          dco = fmaf(tmp_s[idx], gwx_s[idx], dco);
        }
        x[4] = dco;
      },
      smem + lay.lanes, smem + lay.red, total);
  if (threadIdx.x == 0) {
    d_ay[b] = __fmul_rn(kpix, total[0]);
    d_cy[b] = __fmul_rn(kpix, total[1]);
    d_ax[b] = __fmul_rn(kpix, total[2]);
    d_cx[b] = __fmul_rn(kpix, total[3]);
    d_coeff[b] = total[4];
  }
}

// What the write backward's launcher checks of the geometry the wrapper
// passes (kernels/st_inline.py:write_bwd_geometry): threads in whole warps
// within the kernel's bounds, a CTA's shared memory that holds the layout
// and fits the card, and the bulk path only where win and g are each a
// multiple of 16 bytes.
inline bool write_bwd_geometry_ok(int cs, int ws, int threads, int smem_bytes,
                                  int bulk) {
  return cs >= 2 && ws >= 2 && threads >= 32 &&
         threads <= st_cluster::kMaxThreads && threads % 32 == 0 &&
         static_cast<size_t>(WriteBwdLayout(cs, ws).total) * sizeof(float) <=
             static_cast<size_t>(smem_bytes) &&
         smem_bytes <= st_cluster::kMaxSmemBytes &&
         (bulk == 0 || (bulk == 1 && cs * cs % 4 == 0 && ws * ws % 4 == 0));
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
// forward kernels also the geometry of kernels/st_inline.py:fwd_geometry:
// bands per image, rows per band, threads, shared-memory bytes per block,
// outputs per item, 1 to stage X and 1 for the bulk-copy path; the read
// backward that of read_bwd_geometry: CTAs per cluster, rows of gwx / tmp
// per CTA, rows of d_img per CTA, threads, shared-memory bytes per CTA and 1
// for the bulk-copy path; the write backward that of write_bwd_geometry:
// threads, shared-memory bytes per CTA and 1 for the bulk-copy path), and
// the stream; it enqueues one kernel and
// returns cudaGetLastError() (0 = the launch was accepted), the error of the
// shared-memory attribute call or of the cluster launch, or
// cudaErrorInvalidValue for a geometry the kernel cannot run. The wrapper
// checks shapes, types, contiguity and, for the float2 and bulk paths,
// alignment.

extern "C" int st_inline_read(const float* img, const float* ay,
                              const float* cy, const float* ax,
                              const float* cx, float* out, int batch, int cs,
                              int ws, int bands, int rows, int threads,
                              int smem_bytes, int vec, int stage, int bulk,
                              cudaStream_t stream) {
  if (!fwd_geometry_ok(cs, ws, bands, rows, threads, smem_bytes, vec, stage,
                       bulk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // compile-time sizes at the model's (50, 28) with float2 items
  const auto kernel = cs == 50 && ws == 28 && vec == 2
                          ? st_read_kernel<50, 28, 2>
                          : (vec == 2 ? st_read_kernel<0, 0, 2>
                                      : st_read_kernel<0, 0, 1>);
  const cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((cs - 1.001) / 2.0);
  kernel<<<batch * bands, threads, smem_bytes, stream>>>(
      img, ay, cy, ax, cx, out, cs, ws, kpix, bands, rows, stage, bulk);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int st_inline_write(const float* canvas, const float* win,
                               const float* ay, const float* cy,
                               const float* ax, const float* cx,
                               const float* coeff, float* out, int batch,
                               int cs, int ws, int bands, int rows,
                               int threads, int smem_bytes, int vec,
                               int stage, int bulk, cudaStream_t stream) {
  if (!fwd_geometry_ok(ws, cs, bands, rows, threads, smem_bytes, vec, stage,
                       bulk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = cs == 50 && ws == 28 && vec == 2
                          ? st_write_kernel<50, 28, 2>
                          : (vec == 2 ? st_write_kernel<0, 0, 2>
                                      : st_write_kernel<0, 0, 1>);
  const cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((ws - 1.001) / 2.0);
  kernel<<<batch * bands, threads, smem_bytes, stream>>>(
      canvas, win, ay, cy, ax, cx, coeff, out, cs, ws, kpix, bands, rows,
      stage, bulk);
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
                                   int cs, int ws, int threads,
                                   int smem_bytes, int bulk,
                                   cudaStream_t stream) {
  if (!write_bwd_geometry_ok(cs, ws, threads, smem_bytes, bulk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = cs == 50 && ws == 28 ? st_write_bwd_kernel<50, 28>
                                           : st_write_bwd_kernel<0, 0>;
  const cudaError_t err = allow_smem(kernel, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float kpix = static_cast<float>((ws - 1.001) / 2.0);
  kernel<<<batch, threads, smem_bytes, stream>>>(
      win, g, ay, cy, ax, cx, coeff, d_win, d_ay, d_cy, d_ax, d_cx, d_coeff,
      cs, ws, kpix, bulk);
  return static_cast<int>(cudaGetLastError());
}
