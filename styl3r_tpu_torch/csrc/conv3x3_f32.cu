// 3x3, stride-1, zero-padding-1 convolution in float32 on the CUDA cores,
// sm_90a: the DPT heads' convolutions (models/dpt.py through
// ops/conv.py::conv3x3).
//
// Replaces no TPU kernel: the JAX package leaves these convolutions to XLA.
// With float32 weights and TF32 off, cuDNN's heuristic picks an FFT-tiled
// algorithm built from complex-f32 GEMMs with 32x32x8 tiles, which runs the
// heads' convolutions at a small share of the card's f32 rate. This kernel
// keeps full float32: FFMA on the CUDA cores, no tensor cores, no TF32.
//
// Function: y[n, co, r, c] = bias[co] + sum_{ci, ky, kx} w[co, ci, ky, kx] *
// x[n, ci, r + ky - 1, c + kx - 1], x outside the image read as 0; with
// `relu`, y = max(y, 0). NCHW in, NCHW out, weights as nn.Conv2d keeps them.
//
// What bounds it on this card: the FFMA rate (67 TFLOP/s at 700 W). A
// routed conv does 2 * pixels * C_out * 9 * C_in operations on a few bytes
// per operation's worth of data: 256 -> 256 at 256^2 is ~300 operations a
// byte of its input and output, far above the memory roofline.
//
// Design: an implicit GEMM, M = N*H*W output pixels, N = C_out, K = 9*C_in
// in the weight's own (ci, ky, kx) order. A block of 256 threads computes
// a 128-channel tile of 128 pixels (8 x 8 outputs a thread, two blocks an
// SM) or 256 pixels (16 x 8, one block an SM, a quarter fewer shared-memory
// loads an FFMA; the wrapper picks it where its tiles fill the card); a
// thread's outputs are groups of 4 pixels by 4 channels, so its fragments
// are 16-byte shared-memory loads without bank conflicts. K is walked in
// chunks of 4 input channels (36 k values); each chunk's tiles come by
// 4-byte cp.async into a two-stage ring in shared memory: the input tile
// im2col'd on the fly (each k row is one (ci, ky, kx): a pixel row shifted
// by the tap, zero-filled outside the image or past C_in through the copy's
// ignore-src predicate), the weight tile transposed to k-major on the fly
// (a chunk's 36 values of a weight row are contiguous in device memory; a
// warp copies 8 consecutive k of 4 channels). No im2col buffer in device
// memory and no layout transposes around the call. Ragged pixels,
// channels and input channels are predicated. Bias and the optional ReLU
// are applied in the epilogue, which stores 4 consecutive pixels of a
// channel at a time. On the card the k loop is 128 (64) FFMA to 6 (4)
// LDS.128 a k step, and the chunk's copies ~4% of the instructions.
//
// Small grids (the heads' 8^2..32^2 levels) would leave most SMs idle, so
// the wrapper may split K over `splits` blocks per tile: each writes its
// partial tile to a workspace, and the last block of a tile to finish (a
// counter per tile, zeroed by the wrapper) sums the partials in split order,
// 0 first, and applies the epilogue. Every sum is taken in a fixed order, so
// a launch repeats itself bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;           // output channels of a block
constexpr int CC = 4;             // input channels of a chunk
constexpr int BK = 9 * CC;        // k values of a chunk
constexpr int THREADS = 256;
// Floats per k row of the weight tile: a warp's transposed stores (8 k by
// 4 channels) fall on 32 distinct banks.
constexpr int B_STRIDE = BN + 4;
constexpr int B_STAGE = BK * B_STRIDE;
constexpr int STAGES = 2;  // the ring's stages: one chunk lands while the other is computed (3 measured no faster)

// A block's tile: BM = 64 * MI output pixels by BN channels; a thread
// holds 4 * MI pixels by 8 channels. MI = 2: 128 registers a thread, two
// blocks an SM; MI = 4: a quarter fewer shared-memory loads an FFMA, one
// block an SM (~245 registers). UNROLL: the k steps unrolled at a time,
// the fastest on the card (MI = 2: 6 of 4, 6, 12 and 36, the last two
// spilling; MI = 4: 12 of 6, 12 and 18).
template <int MI> struct Tile {
  static constexpr int BM = 64 * MI;
  static constexpr int A_STAGE = BK * BM;
  static constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * static_cast<int>(sizeof(float));
  static constexpr int MIN_BLOCKS = MI == 2 ? 2 : 1;
  static constexpr int UNROLL = MI == 2 ? 6 : 12;
  static constexpr int A_ROWS = BK * BM / THREADS;  // k rows of the input tile a thread loads: 18 or 36
};

// A 4-byte copy into shared memory; where !valid (ignore-src), src is not
// read and the word is zero-filled, so src may lie outside the tensor.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n .reg .pred p;\n setp.eq.u32 p, %2, 0;\n"
      " cp.async.ca.shared.global [%0], [%1], 4, p;\n}\n" ::"r"(s), "l"(src), "r"(static_cast<unsigned>(valid)));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Params {
  const float* x;     // (n, cin, h, w)
  const float* w;     // (cout, cin, 3, 3)
  const float* bias;  // (cout,) or null
  float* y;           // (n, cout, h, w)
  float* workspace;   // (tiles, splits, BM * BN) partial sums, splits > 1
  int* counters;      // (tiles,) zeros, splits > 1
  int n, cin, h, w_, cout, relu, splits, chunks_per_split;
};

template <int MI>
__global__ void __launch_bounds__(THREADS, Tile<MI>::MIN_BLOCKS) conv3x3_f32_kernel(const Params p) {
  using T = Tile<MI>;
  constexpr int BM = T::BM;
  extern __shared__ __align__(16) float smem[];
  float* const a_s = smem;                        // [STAGES][BK][BM]
  float* const b_s = smem + STAGES * T::A_STAGE;  // [STAGES][BK][B_STRIDE]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int hw = p.h * p.w_;
  const long long pixels = static_cast<long long>(p.n) * hw;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int split = blockIdx.z;
  const int chunks = (p.cin + CC - 1) / CC;
  const int c_begin = split * p.chunks_per_split;
  const int c_end = min(chunks, c_begin + p.chunks_per_split);

  // Input loads: pixel m_ld of the tile, k rows [A_ROWS * (tid / BM),
  // + A_ROWS) of each chunk: channels c_ld + j / 9, all 9 taps.
  const int m_ld = tid % BM;
  const int row_ld = (tid / BM) * T::A_ROWS;
  const int c_ld = row_ld / 9;
  unsigned tap_ok = 0;  // bit ky * 3 + kx: the tap reads inside the image
  const float* x_pix = p.x;
  {
    const long long pix = m0 + m_ld;
    if (pix < pixels) {
      const long long img = pix / hw;
      const int rem = static_cast<int>(pix - img * hw);
      const int r = rem / p.w_, c = rem - r * p.w_;
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int rr = r + t / 3 - 1, cc = c + t % 3 - 1;
        if (rr >= 0 && rr < p.h && cc >= 0 && cc < p.w_) tap_ok |= 1u << t;
      }
      x_pix = p.x + img * p.cin * hw + rem + static_cast<long long>(c_ld) * hw;
    }
  }
  const int k9 = 9 * p.cin;
  // Weight loads: a warp reads 8 consecutive k of 4 channels (32-byte
  // sectors): k = 8 * (j / 4) + kl, channel 32 * (j % 4) + n_ld.
  const int kl = lane & 7;
  const int n_ld = 4 * warp + (lane >> 3);
  const float* w_row = p.w + static_cast<long long>(n0 + n_ld) * k9 + kl;
  const long long w_step = 32LL * k9;  // 32 channels on

  auto load_chunk = [&](int chunk, int stage) {
    const int ci0 = chunk * CC;
    float* a = a_s + stage * T::A_STAGE + row_ld * BM + m_ld;
#pragma unroll
    for (int j = 0; j < T::A_ROWS; ++j) {
      const int t = j % 9;
      const bool ok = ((tap_ok >> t) & 1u) && (ci0 + c_ld + j / 9 < p.cin);
      const float* src = x_pix + static_cast<long long>(ci0 + j / 9) * hw + (t / 3 - 1) * p.w_ + (t % 3 - 1);
      cp_async4(a + j * BM, src, ok);
    }
    const int k_left = k9 - 9 * ci0;  // k values of this chunk that exist
    float* b = b_s + stage * B_STAGE + kl * B_STRIDE + n_ld;
#pragma unroll
    for (int j = 0; j < 20; ++j) {  // 5 groups of 8 k (the last half empty) by 4 of 32 channels
      const int kk = 8 * (j / 4) + kl, n = 32 * (j % 4);
      if (j >= 16 && kk >= BK) continue;
      const bool ok = kk < k_left && n0 + n_ld + n < p.cout;
      cp_async4(b + 8 * (j / 4) * B_STRIDE + n, w_row + (j % 4) * w_step + 9LL * ci0 + 8 * (j / 4), ok);
    }
  };

  // Compute: pixels 4 * tm + 64 * g + {0..3} (g < MI), channels 4 * tn +
  // 64 * h + {0..3} (h < 2); a warp spans 8 tm by 4 tn, so that its
  // fragments are 16-byte loads of 128 and 64 contiguous bytes.
  const int tm = (warp & 1) * 8 + (lane & 7);
  const int tn = (warp >> 1) * 4 + (lane >> 3);
  float acc[4 * MI][8];
#pragma unroll
  for (int i = 0; i < 4 * MI; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // The ring: chunk c_begin + i in stage i % 2; the next chunk's copies fly
  // while this one is computed.
  if (c_begin < c_end) load_chunk(c_begin, 0);
  cp_async_commit();
  int stage = 0;
  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    cp_async_wait<0>();
    __syncthreads();  // the chunk has landed; every thread is done with the other stage
    if (chunk + 1 < c_end) load_chunk(chunk + 1, stage ^ 1);
    cp_async_commit();
    const float* a = a_s + stage * T::A_STAGE + 4 * tm;
    const float* b = b_s + stage * B_STAGE + 4 * tn;
#pragma unroll T::UNROLL
    for (int k = 0; k < BK; ++k) {
      float av[4 * MI], bv[8];
#pragma unroll
      for (int g = 0; g < MI; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(a + k * BM + 64 * g);
        av[4 * g] = v.x;
        av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z;
        av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(b + k * B_STRIDE + 64 * h);
        bv[4 * h] = v.x;
        bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z;
        bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * MI; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    stage ^= 1;
  }
  cp_async_wait<0>();

  if (p.splits > 1) {
    // Partial tile out; the tile's last block sums all of them in split order.
    constexpr int V = 2 * 4 * MI;  // float4s a thread holds
    __shared__ int last;
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float4* ws = reinterpret_cast<float4*>(p.workspace) + static_cast<long long>(tile) * p.splits * (BM * BN / 4);
#pragma unroll
    for (int i = 0; i < 4 * MI; ++i) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        ws[(static_cast<long long>(split) * V + 2 * i + g) * THREADS + tid] =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2], acc[i][4 * g + 3]);
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
#pragma unroll
    for (int i = 0; i < 4 * MI; ++i) {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < p.splits; ++s) {
          const float4 v = s == split ? make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                                                    acc[i][4 * g + 3])
                                      : __ldcg(ws + (static_cast<long long>(s) * V + 2 * i + g) * THREADS + tid);
          if (s == 0) {
            sum = v;
          } else {
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
          }
        }
        acc[i][4 * g] = sum.x;
        acc[i][4 * g + 1] = sum.y;
        acc[i][4 * g + 2] = sum.z;
        acc[i][4 * g + 3] = sum.w;
      }
    }
  }

  // Epilogue: acc[4 * g + i][4 * h + j] is pixel 4 * tm + 64 * g + i,
  // channel 4 * tn + 64 * h + j. Where hw % 4 == 0 a group of 4 pixels lies
  // in one image, contiguous and 16-byte aligned: one float4 store.
  const bool vec = hw % 4 == 0;
  long long img[MI], rem[MI];
#pragma unroll
  for (int g = 0; g < MI; ++g) {
    const long long pix = m0 + 4 * tm + 64 * g;
    img[g] = pix / hw;
    rem[g] = pix - img[g] * hw;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = n0 + 4 * tn + (j & 3) + 64 * (j >> 2);
    if (co >= p.cout) continue;
    const float bias = p.bias != nullptr ? p.bias[co] : 0.0f;
#pragma unroll
    for (int g = 0; g < MI; ++g) {
      const long long pix = m0 + 4 * tm + 64 * g;
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[i] = acc[4 * g + i][j] + bias;
        if (p.relu) v[i] = fmaxf(v[i], 0.0f);
      }
      if (vec) {
        if (pix < pixels) {
          *reinterpret_cast<float4*>(p.y + (img[g] * p.cout + co) * hw + rem[g]) = make_float4(v[0], v[1], v[2], v[3]);
        }
      } else {
        long long im = img[g], r = rem[g];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (pix + i < pixels) p.y[(im * p.cout + co) * hw + r] = v[i];
          if (++r == hw) {
            r = 0;
            ++im;
          }
        }
      }
    }
  }
}

template <int MI>
int launch(const Params& p, long long pixels, cudaStream_t stream) {
  using T = Tile<MI>;
  const long long m_tiles = (pixels + T::BM - 1) / T::BM;
  if (m_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_f32_kernel<MI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(conv3x3_f32_kernel<MI>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(m_tiles), (p.cout + BN - 1) / BN, p.splits);
  conv3x3_f32_kernel<MI><<<grid, THREADS, T::SMEM_BYTES, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = conv3x3(x, w) + bias (bias may be null), then max(y, 0) if relu, on
// `stream`, without synchronizing; returns cudaGetLastError(). x (n, cin,
// h, w), w (cout, cin, 3, 3) and y (n, cout, h, w) contiguous float32 on the
// current device; cin * h * w and cout * h * w below 2^31. tile_pixels: 128
// or 256, the block tile's pixels. With splits > 1 (blocks sharing a tile's
// K, each over chunks_per_split chunks of 4 input channels), workspace
// holds tiles * splits * tile_pixels * 128 floats and counters tiles ints
// that are zero.
int conv3x3_f32(const void* x, const void* w, const void* bias, void* y, int n, int cin, int h, int wd, int cout,
                int relu, int tile_pixels, int splits, int chunks_per_split, void* workspace, void* counters,
                void* stream) {
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.workspace = static_cast<float*>(workspace);
  p.counters = static_cast<int*>(counters);
  p.n = n;
  p.cin = cin;
  p.h = h;
  p.w_ = wd;
  p.cout = cout;
  p.relu = relu;
  p.splits = splits;
  p.chunks_per_split = chunks_per_split;
  const long long pixels = static_cast<long long>(n) * h * wd;
  if (pixels == 0 || cout == 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || chunks_per_split < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_pixels) {
    case 128: return launch<2>(p, pixels, s);
    case 256: return launch<4>(p, pixels, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
