// Backward tile compositor for the Gaussian splatting renderer, sm_90a.
//
// Replaces styl3r_tpu/ops/rasterizer/pallas_backward.py::_backward_kernel
// (launched there by backward_tiles_pallas and unpacked by
// gather_window_grads). Same gradients, same semantics: each 16x16 tile
// replays the 128-pair windows its forward composited (n_done of them,
// aligned to global multiples of 128). A window's entry transmittance is
// rebuilt from the one behind it as t_ws(w) = t_ws(w + 1) / max(exp(L_w),
// 1e-12), with t_ws(n_done) = T_final and L_w the window's sum of
// log1p(-alpha): the reference's reconstruction with its clamp, so a window
// that attenuates a pixel by more than 1e12 gives the reference's
// (scaled-down) gradients and not the exact ones. Two masks, as in the
// reference: "composited" (power <= 0, alpha >= 1/255, pair in range) drives
// T and the color and depth grads; "live" also drops alpha_raw >= 0.99 and
// drives dalpha and the geometry and opacity grads.
//
// What bounds it on this card. The work is FP32 and SFU arithmetic per
// walked (pixel, pair) evaluation (two expf and a log1pf, ~90 flops), while
// its bytes are 48 per pair read and 40 written, shared by 256 pixels. The
// TPU kernel walks a tile's windows in series, back to front, carrying T
// and the suffix sum of weight * q from one window to the next; one block
// per tile doing the same leaves the card waiting on its heaviest tile
// (17 windows, 2,176 pairs, against a mean of 1.9 windows on the training
// path). What the design does about it:
//
//  * Two launches, one block per (tile, window) in each; blocks of windows
//    the forward did not walk exit at once. The chain between windows goes
//    through per-pixel window sums instead of through the block:
//      phase 1 (bwd_sums_kernel) walks its window front to back and writes
//        L_w = sum of log1p(-alpha) over the composited pairs, summed pair
//        by pair front to back (t_ws divides by it), and
//        U_w = sum of alpha_j * prod_{k<j} (1 - alpha_k) * q_j, the window's
//        sum of weight * q divided by its entry transmittance, where
//        q = <dcolor, rgb> + ddepth * depth;
//      phase 2 (bwd_grad_kernel) replays the chain per pixel from the last
//        walked window down to its own, t <- t / max(exp(L_v), 1e-12) and
//        s_q += t_ws(v) * U_v for v > w (at most 17 steps, one division per
//        window: a product of clamped products would underflow to 0), then
//        walks its window back to front as the reference does and writes
//        each pair's row once. The longest dependent chain is one window.
//  * Each pair's ten gradients are summed over a warp by a reduce-scatter:
//    at each step a lane sends half of its remaining columns to its partner
//    and keeps the other half (5 + 3 + 2 + 1 + 1 = 12 shuffles, where ten
//    butterflies take 50), skipped for a warp none of whose pixels the pair
//    reaches; the eight warp partials are summed through shared memory in a
//    fixed order. No atomics: two calls give bitwise-equal gradients.
//  * The loops are bounded by instruction issue, not by latency (unrolled,
//    branch-free loops measured slower), so the arithmetic is cut where no
//    decision depends on it. The kernel is built with contraction
//    (cuda_build.KERNEL_FLAGS), T_i takes __expf and 1 / (1 - alpha) one
//    approximate reciprocal (each within a few ulp; about 20% off the dense
//    cloud's time). The values that decide the masks, power and alpha_raw,
//    are rounded operation by operation with __fmul_rn / __fadd_rn exactly
//    as composite_fwd.cu rounds them (both kernels contract everywhere
//    else), and L_w with expf and log1pf as before, so t_ws keeps its
//    rounding.
//
// Layout: attrs are the forward's pair-major (n_pairs, 12) f32 rows
// [mx, my, conic a, b, c, opacity, r, g, b, depth, pad, pad]; grad has the
// same layout and must be zeroed by the caller (pairs never walked stay 0).
// Per-pixel inputs: t_final, ddepth, dalpha (n_tiles, 256), dcolor
// (n_tiles, 256, 3) f32; starts, counts, n_done (n_tiles,) i32. dalpha is
// the folded dL/dalpha - dL/dcolor . background. sums is the caller's
// scratch, (n_tiles, n_windows, 256) float2 (L_w, U_w), n_windows >=
// max(n_done); only walked windows are written and read.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;  // threads per block
constexpr int kWarps = kPixels / 32;
constexpr int kWindow = 128;            // pairs per staged window
constexpr int kAttr = 12;               // floats per pair row
constexpr int kVec = kAttr / 4;         // float4s per pair row
constexpr int kGrad = 10;               // gradient columns written
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.99f;
constexpr float kMinProd = 1e-12f;
constexpr float kMinOneMinus = 0.01f;

// A (tile, window) block: its pixel, its pair range inside the window, and
// the window's rows staged in shared memory.
struct Window {
  int tile, w, offset, lo, hi;
  float px, py;
  size_t o;  // the pixel's index in the per-pixel arrays
};

__device__ __forceinline__ Window locate(const int* starts, const int* counts,
                                         int tiles_per_view, int grid_x) {
  Window win;
  win.tile = blockIdx.x;
  win.w = blockIdx.y;
  const int p = threadIdx.x;
  const int tv = win.tile % tiles_per_view;
  const int ty = tv / grid_x;
  const int tx = tv - ty * grid_x;
  win.px = static_cast<float>(tx * kTile + p % kTile);
  win.py = static_cast<float>(ty * kTile + p / kTile);
  const int start = starts[win.tile];
  const int end = start + counts[win.tile];
  win.offset = (start / kWindow) * kWindow + win.w * kWindow;
  win.lo = max(start - win.offset, 0);
  win.hi = min(end - win.offset, kWindow);
  win.o = static_cast<size_t>(win.tile) * kPixels + p;
  return win;
}

__device__ __forceinline__ void stage(float4* batch, const float4* attrs,
                                      int offset, int n_pairs) {
  for (int i = threadIdx.x; i < kWindow * kVec; i += kPixels) {
    const int row = offset + i / kVec;
    batch[i] = row < n_pairs ? attrs[static_cast<size_t>(row) * kVec + i % kVec]
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// -0.5 * (a dx^2 + c dy^2) - b dx dy, rounded step by step as the forward
// kernel rounds it with the same intrinsics.
__device__ __forceinline__ float power_of(const float* a, float dx, float dy) {
  const float xx = __fmul_rn(__fmul_rn(a[2], dx), dx);
  const float yy = __fmul_rn(__fmul_rn(a[4], dy), dy);
  const float xy = __fmul_rn(__fmul_rn(a[3], dx), dy);
  return __fsub_rn(__fmul_rn(-0.5f, __fadd_rn(xx, yy)), xy);
}

__device__ __forceinline__ bool is_composited(float power, float alpha) {
  return power <= 0.0f && alpha >= kMinAlpha;
}

// Sums g[0..9] over the warp. Returns in each lane the total of the column
// reduce_column(lane) names (another column's partial where that is -1).
__device__ __forceinline__ float reduce_scatter(const float (&g)[kGrad], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float h[6];  // columns 5 * b4 + 0..4, and a pad
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float send = b4 ? g[c] : g[c + 5];
    h[c] = (b4 ? g[c + 5] : g[c]) + __shfl_xor_sync(kFull, send, 16);
  }
  h[5] = 0.0f;
  float k3[4];  // h[3 * b3 + 0..2], and a pad
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float send = b3 ? h[c] : h[c + 3];
    k3[c] = (b3 ? h[c + 3] : h[c]) + __shfl_xor_sync(kFull, send, 8);
  }
  k3[3] = 0.0f;
  float k2[2];  // k3[2 * b2 + 0..1]
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float send = b2 ? k3[c] : k3[c + 2];
    k2[c] = (b2 ? k3[c + 2] : k3[c]) + __shfl_xor_sync(kFull, send, 4);
  }
  const float k1 = (b1 ? k2[1] : k2[0]) + __shfl_xor_sync(kFull, b1 ? k2[0] : k2[1], 2);
  return k1 + __shfl_xor_sync(kFull, k1, 1);
}

// The column whose warp total reduce_scatter leaves in `lane`, for the even
// lane of each pair (the odd one holds the same total); -1 for a pad.
__device__ __forceinline__ int reduce_column(int lane) {
  if (lane & 1) return -1;
  const int k3 = ((lane >> 1) & 1) + 2 * ((lane >> 2) & 1);  // index into k3
  const int h = k3 + 3 * ((lane >> 3) & 1);                  // index into h
  return (k3 < 3 && h < 5) ? 5 * ((lane >> 4) & 1) + h : -1;
}

__global__ void __launch_bounds__(kPixels) bwd_sums_kernel(
    const float4* __restrict__ attrs, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ n_done,
    const float* __restrict__ dcolor, const float* __restrict__ ddepth,
    float2* __restrict__ sums, int n_pairs, int tiles_per_view, int grid_x) {
  __shared__ float4 batch[kWindow * kVec];
  if (static_cast<int>(blockIdx.y) >= n_done[blockIdx.x]) return;  // not walked
  const Window win = locate(starts, counts, tiles_per_view, grid_x);
  stage(batch, attrs, win.offset, n_pairs);
  const float dc_r = dcolor[win.o * 3 + 0];
  const float dc_g = dcolor[win.o * 3 + 1];
  const float dc_b = dcolor[win.o * 3 + 2];
  const float dd = ddepth[win.o];
  __syncthreads();

  const float* s = reinterpret_cast<const float*>(batch);
  float sum_lm = 0.0f;  // L_w
  float trans = 1.0f;   // prod of (1 - alpha) over the pairs in front
  float u = 0.0f;       // U_w
  for (int j = win.lo; j < win.hi; ++j) {
    const float* a = s + j * kAttr;
    const float dx = win.px - a[0];
    const float dy = win.py - a[1];
    const float power = power_of(a, dx, dy);
    const float alpha = fminf(__fmul_rn(a[5], expf(fminf(power, 0.0f))), kMaxAlpha);
    if (!is_composited(power, alpha)) continue;
    sum_lm += log1pf(-alpha);
    if (win.w == 0) continue;  // no window lies in front of window 0: U_0 is never read
    const float q = dc_r * a[6] + dc_g * a[7] + dc_b * a[8] + dd * a[9];
    u += alpha * trans * q;
    trans *= 1.0f - alpha;
  }
  sums[(static_cast<size_t>(win.tile) * gridDim.y + win.w) * kPixels + threadIdx.x] =
      make_float2(sum_lm, u);
}

__global__ void __launch_bounds__(kPixels) bwd_grad_kernel(
    const float4* __restrict__ attrs, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ n_done,
    const float* __restrict__ t_final, const float* __restrict__ dcolor,
    const float* __restrict__ ddepth, const float* __restrict__ dalpha,
    const float2* __restrict__ sums, float* __restrict__ grad, int n_pairs,
    int tiles_per_view, int grid_x) {
  __shared__ float4 batch[kWindow * kVec];
  __shared__ float partial[kWarps * kWindow * kGrad];
  const int nd = n_done[blockIdx.x];
  if (static_cast<int>(blockIdx.y) >= nd) return;  // not walked
  const Window win = locate(starts, counts, tiles_per_view, grid_x);
  stage(batch, attrs, win.offset, n_pairs);
  const int p = threadIdx.x;
  const int warp = p / 32;
  const int lane = p % 32;
  const int col = reduce_column(lane);
  const float tfin = t_final[win.o];
  const float dc_r = dcolor[win.o * 3 + 0];
  const float dc_g = dcolor[win.o * 3 + 1];
  const float dc_b = dcolor[win.o * 3 + 2];
  const float dd = ddepth[win.o];
  const float da = dalpha[win.o];

  // The chain from T_final back to this window's entry transmittance, and
  // the sum of weight * q over the windows behind it.
  const float2* chain = sums + static_cast<size_t>(win.tile) * gridDim.y * kPixels + p;
  float t = tfin;
  float s_q = 0.0f;
  for (int v = nd - 1; v > win.w; --v) {
    const float2 lu = chain[static_cast<size_t>(v) * kPixels];
    t = t / fmaxf(expf(lu.x), kMinProd);
    s_q += t * lu.y;
  }
  const float sum_lm = chain[static_cast<size_t>(win.w) * kPixels].x;
  const float t_ws = t / fmaxf(expf(sum_lm), kMinProd);
  __syncthreads();

  // Back to front: T_i = t_ws * exp(L_w - sum of lm over this pair and the
  // pairs behind it).
  const float* s = reinterpret_cast<const float*>(batch);
  float suffix_lm = 0.0f;
  for (int j = win.hi - 1; j >= win.lo; --j) {
    const float* a = s + j * kAttr;
    const float dx = win.px - a[0];
    const float dy = win.py - a[1];
    const float power = power_of(a, dx, dy);
    const float g_exp = expf(fminf(power, 0.0f));
    const float alpha_raw = __fmul_rn(a[5], g_exp);
    const float alpha = fminf(alpha_raw, kMaxAlpha);
    const bool composited = is_composited(power, alpha);
    float g[kGrad];
#pragma unroll
    for (int c = 0; c < kGrad; ++c) g[c] = 0.0f;
    if (composited) {
      suffix_lm += log1pf(-alpha);
      const float t_i = t_ws * __expf(sum_lm - suffix_lm);
      const float weight = alpha * t_i;
      const float q = dc_r * a[6] + dc_g * a[7] + dc_b * a[8] + dd * a[9];
      g[6] = weight * dc_r;
      g[7] = weight * dc_g;
      g[8] = weight * dc_b;
      g[9] = weight * dd;
      if (alpha_raw < kMaxAlpha) {  // live
        const float inv_one_minus = __fdividef(1.0f, fmaxf(1.0f - alpha, kMinOneMinus));
        const float dal = t_i * q + (da * tfin - s_q) * inv_one_minus;
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
    const bool any = __any_sync(kFull, composited);
    const float total = any ? reduce_scatter(g, lane) : 0.0f;
    if (col >= 0) partial[(warp * kWindow + j) * kGrad + col] = total;
  }
  __syncthreads();
  // Sum the warp partials: one (pair, column) output per thread and step.
  for (int k = win.lo * kGrad + p; k < win.hi * kGrad; k += kPixels) {
    float v = 0.0f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) v += partial[i * kWindow * kGrad + k];
    const int j = k / kGrad;
    grad[static_cast<size_t>(win.offset + j) * kAttr + (k - j * kGrad)] = v;
  }
}

}  // namespace

// Launches both phases on `stream` without synchronizing; returns the first
// launch error (cudaGetLastError()), or 0.
extern "C" int composite_bwd(const void* attrs, const void* starts,
                             const void* counts, const void* n_done,
                             const void* t_final, const void* dcolor,
                             const void* ddepth, const void* dalpha,
                             void* sums, void* grad, int n_tiles, int n_pairs,
                             int tiles_per_view, int grid_x, int n_windows,
                             void* stream) {
  if (n_tiles > 0 && n_windows > 0) {
    const dim3 blocks(n_tiles, n_windows);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    bwd_sums_kernel<<<blocks, kPixels, 0, s>>>(
        static_cast<const float4*>(attrs), static_cast<const int*>(starts),
        static_cast<const int*>(counts), static_cast<const int*>(n_done),
        static_cast<const float*>(dcolor), static_cast<const float*>(ddepth),
        static_cast<float2*>(sums), n_pairs, tiles_per_view, grid_x);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_grad_kernel<<<blocks, kPixels, 0, s>>>(
        static_cast<const float4*>(attrs), static_cast<const int*>(starts),
        static_cast<const int*>(counts), static_cast<const int*>(n_done),
        static_cast<const float*>(t_final), static_cast<const float*>(dcolor),
        static_cast<const float*>(ddepth), static_cast<const float*>(dalpha),
        static_cast<const float2*>(sums), static_cast<float*>(grad), n_pairs,
        tiles_per_view, grid_x);
  }
  return static_cast<int>(cudaGetLastError());
}
