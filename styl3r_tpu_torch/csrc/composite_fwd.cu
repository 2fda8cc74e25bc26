// Forward tile compositor for the Gaussian splatting renderer, sm_90a.
//
// Replaces styl3r_tpu/ops/rasterizer/pallas_kernel.py::_composite_kernel
// (launched there by composite_tiles_pallas). Same outputs, same semantics:
// each 16x16 tile composites its depth-sorted pair range [start, start+count)
// front to back, walking it in 128-pair windows whose boundaries sit at
// global multiples of 128 (base = start / 128 * 128), and stops at window
// granularity once every pixel's transmittance is <= 1e-4. So n_done (the
// windows composited) equals the TPU kernel's window count, which the
// backward replays.
//
// What bounds it on this card: FP32 and SFU arithmetic, about 25 flops and
// one expf per walked (pixel, pair) evaluation, while a pair's bytes are 48,
// read once per tile and shared by its 256 pixels. But a tile's windows are
// one dependent chain, and the tiles are uneven: on the training path's
// inputs the heaviest tile walks 17 windows (2,176 pairs) against a mean of
// 1.9. With one thread per pixel walking the windows in series, the launch
// lasted as long as that one tile's chain, about 180 cycles a pair on an
// otherwise idle SM. What the design does about it (times in PERF.md §6):
//
//  * kChunks threads a pixel. Compositing a run of pairs is associative: a
//    run reduces to (P, C) with P = prod (1 - alpha) and C = sum of alpha_j *
//    prod_{k<j} (1 - alpha_k) * (r, g, b, depth)_j, and two runs combine in
//    order as (P1, C1) o (P2, C2) = (P1 P2, C1 + P1 C2). Each staged window
//    is cut into kChunks chunks of kWindow / kChunks consecutive pairs; the
//    thread of (chunk, pixel) reduces its chunk from (1, 0), and the chunk-0
//    thread of each pixel folds the partials into the pixel's running
//    transmittance, colour and depth in chunk order through shared memory: a
//    fixed order, so two calls give bitwise-equal outputs. The longest chain
//    is a chunk, 16 pairs a window. A warp holds 32 pixels of one chunk, so
//    its lanes read the same pair row (a shared-memory broadcast).
//  * kSplit blocks a tile, one cluster. 256 pixels x kChunks threads do not
//    fit one block, and a tile's chain is latency-bound, so the cluster's
//    blocks split the tile's pixels (32 each, rows 2r and 2r + 1 of the
//    tile for block r) and run on several SMs. All they share is each
//    window's exit vote: a warp with a pixel still above T = 1e-4 writes 0
//    into every block's vote slot, read after a cluster barrier, so every
//    block of the tile stops after the same window. Every block of the tile
//    pays that barrier once a window.
//  * The split stays inside the window. A tile learns that it may stop only
//    after each window, so compositing all of its windows in parallel and
//    finding the exit afterwards would do work the exit skips: on the dense
//    test cloud of chip_smoke.py the windows in range are 3.7x those walked.
//    For the same reason the next window is not composited before the vote
//    on this one is in (that hid the barrier but cost the dense cloud a
//    window of work per tile).
//  * The next window's rows are copied into a second buffer with cp.async
//    while this one composites. Each thread waits for its pieces before the
//    vote, so the vote's barrier also shows the window to the whole block,
//    and no copy is in flight when a tile stops.
//  * The kernel is built with FMA contraction and at most 40 registers a
//    thread (cuda_build.KERNEL_FLAGS): 6 blocks share an SM's registers
//    instead of the 5 that the 48 ptxas picks by itself allow, and it ran
//    faster so. The values that decide the masks, power and alpha, are
//    rounded operation by operation with __fmul_rn / __fadd_rn as PyTorch's
//    separate elementwise operations round them, with expf as the plain
//    version's exp, so the thresholds (power > 0, alpha < 1/255) decide as
//    they do there and in composite_bwd.cu.
//
// Transmittance below the smallest normal f32 is flushed to 0: inside a
// chunk's running product, and after every fold of a partial. With
// round-to-nearest, a denormal T times (1 - alpha) can round back to itself
// (1.4e-45 * 0.7 is 1.4e-45), so a pair-by-pair product could stay far above
// the true one, where the TPU kernel's log-space product underflows to 0.
// The backward rebuilds T by dividing by each window's product clamped at
// 1e-12, and would blow such a stuck T up by 1e12 a window (measured: grads
// of 1e11 on the dense test cloud before this flush).
//
// Layout: attrs are pair-major (n_pairs, 12) f32 rows
// [mx, my, conic a, b, c, opacity, r, g, b, depth, pad, pad], 48 bytes, copied
// as three 16-byte pieces. Outputs: color (n_tiles, 256, 3), depth, alpha,
// t_final (n_tiles, 256) f32 and n_done (n_tiles,) i32.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
// Threads a pixel and blocks a tile (one cluster). The repo's build takes
// these values; scripts/composite_fwd_variants.py builds others with -D to
// time them.
#ifndef COMPOSITE_FWD_CHUNKS
#define COMPOSITE_FWD_CHUNKS 8
#endif
#ifndef COMPOSITE_FWD_SPLIT
#define COMPOSITE_FWD_SPLIT 8
#endif
constexpr int kChunks = COMPOSITE_FWD_CHUNKS;
constexpr int kSplit = COMPOSITE_FWD_SPLIT;
constexpr int kBlockPixels = kPixels / kSplit;
constexpr int kThreads = kBlockPixels * kChunks;  // threads a block
constexpr int kWindow = 128;                 // pairs per staged window
constexpr int kChunk = kWindow / kChunks;    // pairs a chunk
constexpr int kAttr = 12;                    // floats per pair row
constexpr int kVec = kAttr / 4;              // float4s per pair row
constexpr int kRows = kWindow * kVec;        // float4s per window
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kTransEps = 1e-4f;
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN

// Starts copying the window of rows [offset, offset + 128) into `buf`, one
// 16-byte piece a thread, and commits it as one cp.async group. Rows past
// n_pairs are zero-filled (a source size of 0 reads nothing).
__device__ __forceinline__ void stage(float4* buf, const float4* attrs,
                                      int offset, int n_pairs) {
  for (int i = threadIdx.x; i < kRows; i += kThreads) {
    const int row = offset + i / kVec;
    const bool valid = row < n_pairs;
    const float4* src = valid ? attrs + static_cast<size_t>(row) * kVec + i % kVec : attrs;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// -0.5 * (a dx^2 + c dy^2) - b dx dy, rounded step by step as PyTorch's
// separate operations round it (composite_bwd.cu's power_of).
__device__ __forceinline__ float power_of(const float* a, float dx, float dy) {
  const float xx = __fmul_rn(__fmul_rn(a[2], dx), dx);
  const float yy = __fmul_rn(__fmul_rn(a[4], dy), dy);
  const float xy = __fmul_rn(__fmul_rn(a[3], dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(xx, yy)), xy);
}

// Folds a run's partial (t, c) behind the pixel's running (trans, acc).
__device__ __forceinline__ void fold(float& trans, float4& acc, float t, float4 c) {
  acc.x += trans * c.x;
  acc.y += trans * c.y;
  acc.z += trans * c.z;
  acc.w += trans * c.w;
  trans *= t;
  if (trans < kMinNormal) trans = 0.0f;
}

// Ends window w: true when every pixel of the tile is at T <= 1e-4. Each
// thread has waited for its pieces of the next window's copy, so the barrier
// that collects the vote also shows that window to the whole block. Every
// warp of the cluster votes: a warp with a pixel still above 1e-4 writes 0
// into slot w % 2 of every block's `votes`, which holds 1 otherwise (set one
// window ahead, before the cluster barrier that lets a peer write it); all
// blocks of the tile then stop after the same window.
__device__ __forceinline__ bool tile_saturated(bool mine, int w, int (&votes)[2]) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int slot = w & 1;
  if (!__all_sync(0xffffffffu, mine) && threadIdx.x % 32 == 0) {
#pragma unroll
    for (int r = 0; r < kSplit; ++r) *cluster.map_shared_rank(&votes[slot], r) = 0;
  }
  cluster.sync();
  return votes[slot] != 0;
}

__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads) composite_fwd_kernel(
    const float4* __restrict__ attrs, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ background,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ alpha, int* __restrict__ n_done,
    float* __restrict__ t_final, int n_pairs, int tiles_per_view, int grid_x,
    int max_windows) {
  __shared__ float4 batch[2][kRows];
  // Chunks 1.. hand their partials to the chunk-0 thread of their pixel.
  __shared__ float4 part_c[kChunks - 1][kBlockPixels];  // a chunk's (r, g, b, depth)
  __shared__ float part_t[kChunks - 1][kBlockPixels];   // a chunk's transmittance
  __shared__ int votes[2];  // the cluster's vote on a window, by its parity

  const int tile = blockIdx.x / kSplit;
  const int chunk = threadIdx.x / kBlockPixels;
  const int p = (blockIdx.x % kSplit) * kBlockPixels + threadIdx.x % kBlockPixels;  // pixel of the tile
  const int view = tile / tiles_per_view;
  const int tv = tile - view * tiles_per_view;
  const int ty = tv / grid_x;
  const int tx = tv - ty * grid_x;
  const float px = static_cast<float>(tx * kTile + p % kTile);
  const float py = static_cast<float>(ty * kTile + p / kTile);

  const int start = starts[tile];
  const int end = start + counts[tile];
  const int base = (start / kWindow) * kWindow;
  const int n_windows = min((end - base + kWindow - 1) / kWindow, max_windows);

  // The pixel's running transmittance, colour and depth (chunk-0 threads).
  float trans = 1.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (n_windows > 0) stage(batch[0], attrs, base, n_pairs);
  asm volatile("cp.async.wait_group 0;\n" ::);
  // Window 0 is in shared memory, and every block of the cluster has
  // started before a vote reaches its shared memory.
  if (threadIdx.x == 0) votes[0] = 1;
  cooperative_groups::this_cluster().sync();
  int w = 0;
  while (w < n_windows) {
    const int offset = base + w * kWindow;
    // The next window's copy runs while this one composites; its buffer
    // was last read before the previous window's partials barrier.
    if (w + 1 < n_windows) stage(batch[(w + 1) & 1], attrs, offset + kWindow, n_pairs);

    // This chunk's share of the tile's pairs [start, end) in the window.
    const int lo = max(start - offset, chunk * kChunk);
    const int hi = min(end - offset, (chunk + 1) * kChunk);
    const float* s = reinterpret_cast<const float*>(batch[w & 1]);
    float ct = 1.0f;
    float4 cc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = lo; j < hi; ++j) {
      const float* a = s + j * kAttr;
      const float dx = px - a[0];
      const float dy = py - a[1];
      const float power = power_of(a, dx, dy);
      const float al = fminf(__fmul_rn(a[5], expf(fminf(power, 0.0f))), kMaxAlpha);
      if (power > 0.0f || al < kMinAlpha) continue;
      const float weight = al * ct;
      cc.x += weight * a[6];
      cc.y += weight * a[7];
      cc.z += weight * a[8];
      cc.w += weight * a[9];
      ct *= 1.0f - al;
      if (ct < kMinNormal) ct = 0.0f;
    }
    const int q = threadIdx.x % kBlockPixels;
    if (chunk > 0) {
      part_t[chunk - 1][q] = ct;
      part_c[chunk - 1][q] = cc;
    }
    __syncthreads();  // the partials are in; window w's rows are read
    if (threadIdx.x == 0) votes[(w + 1) & 1] = 1;
    if (chunk == 0) {
      fold(trans, acc, ct, cc);
#pragma unroll
      for (int c = 0; c < kChunks - 1; ++c) fold(trans, acc, part_t[c][q], part_c[c][q]);
    }
    // The next window has landed (so no copy is in flight at an early
    // exit). The vote's barrier also keeps the partials until every fold
    // has read them.
    asm volatile("cp.async.wait_group 0;\n" ::);
    if (tile_saturated(chunk > 0 || trans <= kTransEps, w++, votes)) break;
  }

  if (chunk == 0) {
    const size_t o = static_cast<size_t>(tile) * kPixels + p;
    color[o * 3 + 0] = acc.x + trans * background[view * 3 + 0];
    color[o * 3 + 1] = acc.y + trans * background[view * 3 + 1];
    color[o * 3 + 2] = acc.z + trans * background[view * 3 + 2];
    depth[o] = acc.w;
    alpha[o] = 1.0f - trans;
    t_final[o] = trans;
    if (p == 0) n_done[tile] = w;
  }
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError().
extern "C" int composite_fwd(const void* attrs, const void* starts,
                             const void* counts, const void* background,
                             void* color, void* depth, void* alpha,
                             void* n_done, void* t_final, int n_tiles,
                             int n_pairs, int tiles_per_view, int grid_x,
                             int max_windows, void* stream) {
  if (n_tiles > 0) {
    composite_fwd_kernel<<<n_tiles * kSplit, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(attrs), static_cast<const int*>(starts),
        static_cast<const int*>(counts), static_cast<const float*>(background),
        static_cast<float*>(color), static_cast<float*>(depth),
        static_cast<float*>(alpha), static_cast<int*>(n_done),
        static_cast<float*>(t_final), n_pairs, tiles_per_view, grid_x,
        max_windows);
  }
  return static_cast<int>(cudaGetLastError());
}
