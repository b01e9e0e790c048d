// Shared pieces of the two cluster backward kernels for Hopper (sm_90a):
// st_fused.cu:st_wmac_bwd_kernel and st_inline.cu:st_read_bwd_kernel.
// st_inline.cu:st_write_bwd_kernel, one CTA per image, takes Split and
// lane_tree_sums from here.
//
// Both need, for one image, two intermediates (gwx and tmp) whole: every row
// of an output sums over all of their rows. So each image gets a thread-block
// cluster of `cluster` CTAs (at most 8, the portable limit), launched with
// cudaLaunchKernelEx. CTA `rank` computes its group of `rows` consecutive
// rows of the intermediates; after a cluster barrier each CTA copies the
// other CTAs' rows out of their shared memory (distributed shared memory,
// map_shared_rank) into its own, so every later product reads local shared
// memory only. Each CTA then computes a disjoint share of the outputs. A
// last split barrier (arrive once the CTA is done reading or writing other
// CTAs' shared memory, wait before it exits) keeps every CTA's shared memory
// alive while another one uses it.
//
// Register tiles (tile_product): a tile is 2 rows (p, p + half) by
// kTileCols columns (q + c * qn, qn = ceil(width / kTileCols)); a range of
// the block's threads walks the tiles, so any size runs with any thread
// count. Neighbouring lanes take neighbouring columns, so a warp's loads of
// the right operand are contiguous, and the left operand's few rows per warp
// are broadcasts. Products that do not depend on each other run side by side
// on disjoint warp ranges of the block where they fit (Split), else one
// after the other on all of it.
//
// Order of sums. Each matrix output is one fmaf chain from 0.0f over the
// inner index in ascending order. The scalar reductions (lane_tree_sum)
// reproduce a 256-thread block_sum bit for bit with any thread count: each
// of kLanes virtual lanes keeps its own chain, a warp reduces 32 of them with
// the xor-shuffle tree, and one thread adds the 8 warps' sums in order. No
// atomics; fp32 only.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace st_cluster {

namespace cg = cooperative_groups;

constexpr int kTileCols = 4;
constexpr int kMaxThreads = 256;
constexpr int kMaxCluster = 8;
constexpr int kLanes = 256;   // the block_sum being reproduced: 256 threads
constexpr int kMaxSmemBytes = 232448;   // a block's shared memory on an H100

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int odd(int n) { return n | 1; }
__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// Rows of group `rank` of n rows in groups of `rows`: [first, first + count).
struct Group {
  int first, count;
  __host__ __device__ Group(int rank, int rows, int n)
      : first(rank * rows),
        count(n - first < 0 ? 0 : (n - first < rows ? n - first : rows)) {}
};

// Thread ranges [t0[k], t0[k] + nt[k]) of up to three products with n0, n1,
// n2 work items (tiles, chains) run side by side: each its items rounded up
// to whole warps, in order, if they all fit the block's `threads`; else each
// the whole block. Mirrored by tests/test_torch_st_fused.py:_split.
struct Split {
  int t0[3], nt[3];
  __host__ __device__ Split(int threads, int n0, int n1, int n2 = 0) {
    const int w[3] = {round32(n0), round32(n1), round32(n2)};
    const bool side = w[0] + w[1] + w[2] <= threads;
    int start = 0;
    for (int k = 0; k < 3; ++k) {
      t0[k] = side ? start : 0;
      nt[k] = side ? w[k] : threads;
      start += w[k];
    }
  }
};

// ---- cluster barriers and distributed shared memory -----------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// Rows [first, first + count) of the [*, width] array `local` from every
// other CTA of the cluster into the same place of `local`: 16-byte loads
// when each group's range is 16-byte sized and aligned (row groups start at
// multiples of `rows`), else 4-byte ones.
__device__ __forceinline__ void gather_rows(float* local, int width, int rows,
                                            int n, int cluster, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  const bool vec = (rows * width) % 4 == 0 && (n * width) % 4 == 0;
  for (int r = 0; r < cluster; ++r) {
    if (r == rank) continue;
    const Group grp(r, rows, n);
    const int lo = grp.first * width, len = grp.count * width;
    const float* remote = cl.map_shared_rank(local, r);
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(remote + lo);
      float4* dst = reinterpret_cast<float4*>(local + lo);
      for (int i = threadIdx.x; i < len / 4; i += blockDim.x) dst[i] = src[i];
    } else {
      for (int i = threadIdx.x; i < len; i += blockDim.x) {
        local[lo + i] = remote[lo + i];
      }
    }
  }
}

// ---- products -------------------------------------------------------------

// out[i][l] = sum_m A(i, m) * B(m, l) for the rg rows i of a group and the
// `width` columns l, one fmaf chain from 0.0f per output in ascending m;
// A(i, m) = a[i * a_rs + m * a_is], B(m, l) = bm[m * b_rs + l]. Calls
// store(i, l, value) for each output, i relative to the group. `half` is the
// tile's row offset (rows of the group's geometry / 2). Threads
// [t0, t0 + nt) walk the tiles; the others return at once.
template <typename F>
__device__ __forceinline__ void tile_product(const float* a, int a_rs,
                                             int a_is, const float* bm,
                                             int b_rs, int rg, int half,
                                             int width, int n_in, int t0,
                                             int nt, F store) {
  const int qn = cdiv(width, kTileCols), tiles = half * qn;
  const int me = static_cast<int>(threadIdx.x) - t0;
  if (me < 0 || me >= nt) return;
  for (int tile = me; tile < tiles; tile += nt) {
    const int p = tile / qn, q = tile - p * qn;
    if (p >= rg) continue;
    const int r1 = min(p + half, rg - 1);
    int col[kTileCols];
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) col[c] = min(q + c * qn, width - 1);
    const float* a0 = a + p * a_rs;
    const float* a1 = a + r1 * a_rs;
    float acc[2][kTileCols];
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) acc[0][c] = acc[1][c] = 0.0f;
#pragma unroll 10
    for (int m = 0; m < n_in; ++m) {
      const float w0 = a0[m * a_is], w1 = a1[m * a_is];
      const float* br = bm + m * b_rs;
#pragma unroll
      for (int c = 0; c < kTileCols; ++c) {
        const float v = br[col[c]];
        acc[0][c] = fmaf(w0, v, acc[0][c]);
        acc[1][c] = fmaf(w1, v, acc[1][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kTileCols; ++c) {
      const int l = q + c * qn;
      if (l >= width) continue;
      store(p, l, acc[0][c]);
      if (p + half < rg) store(p + half, l, acc[1][c]);
    }
  }
}

// ---- reductions -----------------------------------------------------------

// The K sums a 256-thread block_sum gives, K times, when thread v holds
// lane(v, x)'s x[0 .. K): the xor-shuffle tree within each warp of 32 lanes,
// then the 8 warps' sums added in order from 0.0f. Thread t computes the
// virtual lanes t, t + blockDim.x, ...; warp w reduces row w of every sum at
// once (K independent trees). lanes_s holds K * kLanes floats, red_s
// K * kLanes / 32. Thread 0 gets the sums in `total`.
template <int K, typename Lane>
__device__ void lane_tree_sums(Lane lane, float* lanes_s, float* red_s,
                               float (&total)[K]) {
  for (int v = threadIdx.x; v < kLanes; v += blockDim.x) {
    float x[K];
    lane(v, x);
#pragma unroll
    for (int k = 0; k < K; ++k) lanes_s[k * kLanes + v] = x[k];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  const int n_warps = static_cast<int>(blockDim.x) >> 5;
  for (int w = warp; w < kLanes / 32; w += n_warps) {
    float x[K];
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = lanes_s[k * kLanes + w * 32 + lane_id];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        x[k] = __fadd_rn(x[k], __shfl_xor_sync(0xffffffffu, x[k], off));
      }
    }
    if (lane_id == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) red_s[k * kLanes / 32 + w] = x[k];
    }
  }
  __syncthreads();
  // thread 0 loads every warp sum before the adds, so only the adds wait on
  // each other
#pragma unroll
  for (int k = 0; k < K; ++k) total[k] = 0.0f;
  if (threadIdx.x == 0) {
    float r[K * kLanes / 32];
#pragma unroll
    for (int i = 0; i < K * kLanes / 32; ++i) r[i] = red_s[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int w = 0; w < kLanes / 32; ++w) {
        total[k] = __fadd_rn(total[k], r[k * kLanes / 32 + w]);
      }
    }
  }
}

// What the launchers check of the geometry the wrapper passes: n rows of the
// intermediates in groups of `rows` and n_out rows of the separately split
// output in groups of `out_rows`, even and covering every row; a CTA within
// the card's shared memory.
inline bool geometry_ok(int n, int n_out, int cluster, int rows, int out_rows,
                        int threads, int smem_bytes, int smem_floats) {
  return cluster >= 1 && cluster <= kMaxCluster && rows >= 2 &&
         rows % 2 == 0 && cluster * rows >= n &&
         out_rows >= 2 && out_rows % 2 == 0 && cluster * out_rows >= n_out &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         static_cast<size_t>(smem_floats) * sizeof(float) <=
             static_cast<size_t>(smem_bytes) &&
         smem_bytes <= kMaxSmemBytes;
}

// Launch `kernel` on batch * cluster CTAs in clusters of `cluster`; returns
// the launch's error (the shared-memory attribute call's first). A cluster of
// one CTA is launched without the cluster attribute, which measured faster
// on an H100 (PERF.md); a CTA launched so is a cluster of one to the cluster
// barriers and map_shared_rank.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int batch, int cluster,
                            int threads, int smem_bytes, cudaStream_t stream,
                            Args... args) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace st_cluster
