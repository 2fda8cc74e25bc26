// Forward tile compositor for the Gaussian splatting renderer, sm_90a.
//
// Replaces styl3r_tpu/ops/rasterizer/pallas_kernel.py::_composite_kernel
// (launched there by composite_tiles_pallas). Same outputs, same semantics:
// each 16x16 tile composites its depth-sorted pair range [start, start+count)
// front to back, walking it in 128-pair batches whose boundaries sit at
// global multiples of 128 (base = start / 128 * 128), and stops at batch
// granularity once every pixel's transmittance is <= 1e-4. So n_done (the
// batches composited) equals the TPU kernel's window count, which the
// backward replays.
//
// What bounds it on this card: FP32 and SFU arithmetic. Each composited
// (pixel, pair) evaluation costs about 25 flops and one expf, while its
// bytes are 48 per pair, read once per tile and shared by 256 pixels.
// What the design does about that: one block per tile and one thread per
// pixel, with each batch's attributes staged once in shared memory
// (128 x 48 B = 6 KB), so the inner loop is register arithmetic on
// broadcast shared-memory reads; every thread keeps its running
// transmittance in a register.
//
// Transmittance below the smallest normal f32 is flushed to 0. With
// round-to-nearest, a denormal T times (1 - alpha) can round back to itself
// (1.4e-45 * 0.7 is 1.4e-45), so a pair-by-pair product could stay far above
// the true one, where the TPU kernel's log-space product underflows to 0.
// The backward rebuilds T by dividing by each window's product clamped at
// 1e-12, and would blow such a stuck T up by 1e12 a window (measured: grads
// of 1e11 on the dense test cloud before this flush).
//
// Layout: attrs are pair-major (n_pairs, 12) f32 rows
// [mx, my, conic a, b, c, opacity, r, g, b, depth, pad, pad], 48 bytes, read
// as three float4s. Outputs: color (n_tiles, 256, 3), depth, alpha, t_final
// (n_tiles, 256) f32 and n_done (n_tiles,) i32.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kWindow = 128;            // pairs per staged batch
constexpr int kAttr = 12;               // floats per pair row
constexpr int kVec = kAttr / 4;         // float4s per pair row
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kTransEps = 1e-4f;
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN

__global__ void __launch_bounds__(kPixels) composite_fwd_kernel(
    const float4* __restrict__ attrs, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ background,
    float* __restrict__ color, float* __restrict__ depth,
    float* __restrict__ alpha, int* __restrict__ n_done,
    float* __restrict__ t_final, int n_pairs, int tiles_per_view, int grid_x,
    int max_windows) {
  __shared__ float4 batch[kWindow * kVec];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
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

  float trans = 1.0f, r = 0.0f, g = 0.0f, b = 0.0f, d = 0.0f;
  int w = 0;
  while (w < n_windows) {
    const int offset = base + w * kWindow;
    for (int i = p; i < kWindow * kVec; i += kPixels) {
      const int row = offset + i / kVec;
      batch[i] = row < n_pairs ? attrs[static_cast<size_t>(row) * kVec + i % kVec]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();

    // Pairs of this tile are contiguous: [start, end) within the batch.
    const int lo = max(start - offset, 0);
    const int hi = min(end - offset, kWindow);
    const float* s = reinterpret_cast<const float*>(batch);
    for (int j = lo; j < hi; ++j) {
      const float* a = s + j * kAttr;
      const float dx = px - a[0];
      const float dy = py - a[1];
      const float power = -0.5f * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy;
      const float al = fminf(a[5] * expf(fminf(power, 0.0f)), kMaxAlpha);
      if (power > 0.0f || al < kMinAlpha) continue;
      const float weight = al * trans;
      r += weight * a[6];
      g += weight * a[7];
      b += weight * a[8];
      d += weight * a[9];
      trans *= 1.0f - al;
      if (trans < kMinNormal) trans = 0.0f;
    }
    ++w;
    // Tile-level early exit once every pixel is saturated; the barrier also
    // guards the shared batch before the next one overwrites it.
    if (__syncthreads_and(trans <= kTransEps)) break;
  }

  const size_t o = static_cast<size_t>(tile) * kPixels + p;
  color[o * 3 + 0] = r + trans * background[view * 3 + 0];
  color[o * 3 + 1] = g + trans * background[view * 3 + 1];
  color[o * 3 + 2] = b + trans * background[view * 3 + 2];
  depth[o] = d;
  alpha[o] = 1.0f - trans;
  t_final[o] = trans;
  if (p == 0) n_done[tile] = w;
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
    composite_fwd_kernel<<<n_tiles, kPixels, 0,
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
