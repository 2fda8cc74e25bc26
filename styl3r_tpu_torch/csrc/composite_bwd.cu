// Backward tile compositor for the Gaussian splatting renderer, sm_90a.
//
// Replaces styl3r_tpu/ops/rasterizer/pallas_backward.py::_backward_kernel
// (launched there by backward_tiles_pallas and unpacked by
// gather_window_grads). Same gradients, same semantics: each 16x16 tile
// replays the 128-pair windows its forward composited (n_done of them,
// aligned to global multiples of 128) from the last to the first. A window
// rebuilds its entry transmittance as T / max(exp(sum log1p(-alpha)), 1e-12),
// the reference's reconstruction with its clamp, so a window that attenuates
// a pixel by more than 1e12 gives the reference's (scaled-down) gradients and
// not the exact ones. Two masks, as in the reference: "composited" (power <= 0,
// alpha >= 1/255, pair in range) drives T and the color and depth grads;
// "live" also drops alpha_raw >= 0.99 and drives dalpha and the geometry and
// opacity grads.
//
// What bounds it on this card: FP32 and SFU arithmetic. Each walked
// (pixel, pair) evaluation costs two expf and a log1pf in the back-to-front
// pass plus an expf and a log1pf in the front-to-back pass, and about 90
// flops with the per-pair reductions, while its bytes are 48 per pair read
// and 40 per pair written, shared by 256 pixels. What the design does about
// that: one block per tile and one thread per pixel (as composite_fwd.cu);
// each window's 128 rows are staged once in shared memory (6 KB), so the
// inner loops are register arithmetic on broadcast shared reads; each pair's
// ten gradients are summed over the 256 pixels by warp shuffles (skipped for
// a warp none of whose pixels the pair reaches) and the eight warp partials
// through shared memory (40 KB), and the pair's row is written once, directly
// at its index: tiles own disjoint pair ranges, so there are no atomics.
//
// Layout: attrs are the forward's pair-major (n_pairs, 12) f32 rows
// [mx, my, conic a, b, c, opacity, r, g, b, depth, pad, pad]; grad has the
// same layout and must be zeroed by the caller (pairs never walked stay 0).
// Per-pixel inputs: t_final, ddepth, dalpha (n_tiles, 256), dcolor
// (n_tiles, 256, 3) f32; starts, counts, n_done (n_tiles,) i32. dalpha is
// the folded dL/dalpha - dL/dcolor . background.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kWarps = kPixels / 32;
constexpr int kWindow = 128;            // pairs per staged window
constexpr int kAttr = 12;               // floats per pair row
constexpr int kVec = kAttr / 4;         // float4s per pair row
constexpr int kGrad = 10;               // gradient columns written
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinProd = 1e-12f;
constexpr float kMinOneMinus = 0.01f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kPixels) composite_bwd_kernel(
    const float4* __restrict__ attrs, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ n_done,
    const float* __restrict__ t_final, const float* __restrict__ dcolor,
    const float* __restrict__ ddepth, const float* __restrict__ dalpha,
    float* __restrict__ grad, int n_pairs, int tiles_per_view, int grid_x) {
  __shared__ float4 batch[kWindow * kVec];
  __shared__ float partial[kWarps * kWindow * kGrad];

  const int tile = blockIdx.x;
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int view = tile / tiles_per_view;
  const int tv = tile - view * tiles_per_view;
  const int ty = tv / grid_x;
  const int tx = tv - ty * grid_x;
  const float px = static_cast<float>(tx * kTile + p % kTile);
  const float py = static_cast<float>(ty * kTile + p / kTile);

  const int start = starts[tile];
  const int end = start + counts[tile];
  const int base = (start / kWindow) * kWindow;

  const size_t o = static_cast<size_t>(tile) * kPixels + p;
  const float tfin = t_final[o];
  const float dc_r = dcolor[o * 3 + 0];
  const float dc_g = dcolor[o * 3 + 1];
  const float dc_b = dcolor[o * 3 + 2];
  const float dd = ddepth[o];
  const float da = dalpha[o];

  float t_cur = tfin;  // transmittance behind the current window
  float s_q = 0.0f;    // sum of weight * q over the pairs behind
  for (int w = n_done[tile] - 1; w >= 0; --w) {
    const int offset = base + w * kWindow;
    __syncthreads();  // the previous window's reads of batch and partial are done
    for (int i = p; i < kWindow * kVec; i += kPixels) {
      const int row = offset + i / kVec;
      batch[i] = row < n_pairs ? attrs[static_cast<size_t>(row) * kVec + i % kVec]
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    const int lo = max(start - offset, 0);
    const int hi = min(end - offset, kWindow);
    const float* s = reinterpret_cast<const float*>(batch);

    // Pass A, front to back: the window's sum of log1p(-alpha).
    float sum_lm = 0.0f;
    for (int j = lo; j < hi; ++j) {
      const float* a = s + j * kAttr;
      const float dx = px - a[0];
      const float dy = py - a[1];
      const float power = -0.5f * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy;
      const float alpha = fminf(a[5] * expf(fminf(power, 0.0f)), kMaxAlpha);
      if (power <= 0.0f && alpha >= kMinAlpha) sum_lm += log1pf(-alpha);
    }
    const float t_ws = t_cur / fmaxf(expf(sum_lm), kMinProd);

    // Pass B, back to front: T_i = t_ws * exp(sum of lm in front of i).
    float suffix_lm = 0.0f;  // sum of lm over this pair and the pairs behind it
    for (int j = hi - 1; j >= lo; --j) {
      const float* a = s + j * kAttr;
      const float dx = px - a[0];
      const float dy = py - a[1];
      const float power = -0.5f * (a[2] * dx * dx + a[4] * dy * dy) - a[3] * dx * dy;
      const float g_exp = expf(fminf(power, 0.0f));
      const float alpha_raw = a[5] * g_exp;
      const float alpha = fminf(alpha_raw, kMaxAlpha);
      const bool composited = power <= 0.0f && alpha >= kMinAlpha;
      float g[kGrad];
#pragma unroll
      for (int c = 0; c < kGrad; ++c) g[c] = 0.0f;
      if (composited) {
        const float lm = log1pf(-alpha);
        suffix_lm += lm;
        const float t_i = t_ws * expf(sum_lm - suffix_lm);
        const float weight = alpha * t_i;
        const float q = dc_r * a[6] + dc_g * a[7] + dc_b * a[8] + dd * a[9];
        g[6] = weight * dc_r;
        g[7] = weight * dc_g;
        g[8] = weight * dc_b;
        g[9] = weight * dd;
        if (alpha_raw < kMaxAlpha) {  // live
          const float one_minus = fmaxf(1.0f - alpha, kMinOneMinus);
          const float dal = t_i * q - s_q / one_minus + da * (tfin / one_minus);
          const float dpower = alpha * dal;
          g[0] = (a[2] * dx + a[3] * dy) * dpower;
          g[1] = (a[3] * dx + a[4] * dy) * dpower;
          g[2] = -0.5f * dx * dx * dpower;
          g[3] = -dx * dy * dpower;
          g[4] = -0.5f * dy * dy * dpower;
          g[5] = g_exp * dal;
        }
        s_q += weight * q;
      }
      // The loop bounds are the block's, so every lane of a warp is here.
      const bool any = __any_sync(0xffffffffu, composited);
#pragma unroll
      for (int c = 0; c < kGrad; ++c) {
        const float v = any ? warp_sum(g[c]) : 0.0f;
        if (lane == 0) partial[(warp * kWindow + j) * kGrad + c] = v;
      }
    }
    __syncthreads();
    // Sum the warp partials: one (pair, column) output per thread and step.
    for (int k = lo * kGrad + p; k < hi * kGrad; k += kPixels) {
      float v = 0.0f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) v += partial[i * kWindow * kGrad + k];
      const int j = k / kGrad;
      grad[static_cast<size_t>(offset + j) * kAttr + (k - j * kGrad)] = v;
    }
    t_cur = t_ws;
  }
}

}  // namespace

// Launches on `stream` without synchronizing; returns cudaGetLastError().
extern "C" int composite_bwd(const void* attrs, const void* starts,
                             const void* counts, const void* n_done,
                             const void* t_final, const void* dcolor,
                             const void* ddepth, const void* dalpha,
                             void* grad, int n_tiles, int n_pairs,
                             int tiles_per_view, int grid_x, void* stream) {
  if (n_tiles > 0) {
    composite_bwd_kernel<<<n_tiles, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(attrs), static_cast<const int*>(starts),
        static_cast<const int*>(counts), static_cast<const int*>(n_done),
        static_cast<const float*>(t_final), static_cast<const float*>(dcolor),
        static_cast<const float*>(ddepth), static_cast<const float*>(dalpha),
        static_cast<float*>(grad), n_pairs, tiles_per_view, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}
