// 2D rotary position embedding of an attention's q and k, sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves RoPE2D
// (styl3r_tpu/ops/rope.py::apply_rope2d) to XLA, which fuses it. In eager
// PyTorch the same function is ~17 small ops a tensor (ops/rope.py::_rope1d
// twice and a cat), about 70 launches an attention, and the serving path is
// bound by issuing them. The reference system ships a CUDA kernel for the
// same job (croco/curope/kernels.cu). This one rotates q and k in one
// launch: two descriptors, the second optional.
//
// Function (ops/rope.py): head dim d splits into a Y half (rotated by the
// token's y position) and an X half (by x); a half of size d/2 rotates the
// pairs (x1[f], x2[f]) = (t[f], t[f + d/4]) by the angle pos * inv_freq[f],
// f < d/4:  x1' = x1 c - x2 s,  x2' = x2 c + x1 s.  With `inverse` the angle
// is negated (s -> -s), which is the gradient: dx1 = g1 c + g2 s,
// dx2 = g2 c - g1 s.
//
// Rounding: as the plain version's separate elementwise ops round. The
// angle is one f32 product with the wrapper's inv_freq table (computed by
// the plain version's own expression); cos and sin are cosf / sinf (no fast
// math), rounded to the token type; each product is rounded to the token
// type before the sum, and the sum is rounded. __fmul_rn / __fadd_rn keep
// nvcc from contracting them into FMAs, so the outputs equal PyTorch's.
//
// What bounds it on this card: bytes. Each element of q and k is read once
// and written once, with ~3 flops; the cos/sin of a row are d/2 values
// shared by all its heads. So one block a (batch, token) row of q or k
// computes its row's cos/sin once into shared memory and then streams the
// row's heads with 16-byte loads and stores of matching x1 / x2 vectors;
// the input's batch and token strides are taken as they are (q and k of a
// qkv unbind are strided views), the output is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as a float.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

template <typename T> struct Side {
  const T* x;
  long long x_batch, x_token;  // element strides; heads and head dim contiguous
  const int* pos;              // (y, x) int32 pairs
  long long pos_batch, pos_token;
  T* out;                      // contiguous (batch, n, heads, d)
  int n;
};

template <typename T, int V>
__global__ void rope2d_kernel(Side<T> a, Side<T> b, const float* __restrict__ inv_freq,
                              int batch, int heads, int d, int inverse) {
  extern __shared__ float table[];  // cos[d/2], then sin[d/2]: Y half, X half
  int row = blockIdx.x;
  const int rows_a = batch * a.n;
  const Side<T> s = row < rows_a ? a : b;
  if (row >= rows_a) row -= rows_a;
  const int bi = row / s.n, t = row - bi * s.n;
  const int q4 = d / 4;

  const int* p = s.pos + bi * s.pos_batch + t * s.pos_token;
  for (int j = threadIdx.x; j < 2 * q4; j += blockDim.x) {
    const int half = j / q4;
    const float angle = __fmul_rn(static_cast<float>(p[half]), inv_freq[j - half * q4]);
    const float sn = round_to<T>(sinf(angle));
    table[j] = round_to<T>(cosf(angle));
    table[2 * q4 + j] = inverse ? -sn : sn;
  }
  __syncthreads();

  const T* x = s.x + bi * s.x_batch + t * s.x_token;
  T* out = s.out + static_cast<long long>(row) * heads * d;
  const int chunks = q4 / V;  // vectors in a quarter of a head
  const int units = heads * 2 * chunks;
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const int h = u / (2 * chunks);
    const int r = u - h * 2 * chunks;
    const int half = r / chunks;
    const int f = (r - half * chunks) * V;  // frequency of the vector's first element
    const int off = h * d + half * (d / 2) + f;
    const Vec<T, V> v1 = *reinterpret_cast<const Vec<T, V>*>(x + off);
    const Vec<T, V> v2 = *reinterpret_cast<const Vec<T, V>*>(x + off + q4);
    Vec<T, V> o1, o2;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float c = table[half * q4 + f + i];
      const float sn = table[2 * q4 + half * q4 + f + i];
      const float x1 = to_float(v1.v[i]), x2 = to_float(v2.v[i]);
      o1.v[i] = from_float<T>(__fadd_rn(round_to<T>(__fmul_rn(x1, c)), round_to<T>(__fmul_rn(-x2, sn))));
      o2.v[i] = from_float<T>(__fadd_rn(round_to<T>(__fmul_rn(x2, c)), round_to<T>(__fmul_rn(x1, sn))));
    }
    *reinterpret_cast<Vec<T, V>*>(out + off) = o1;
    *reinterpret_cast<Vec<T, V>*>(out + off + q4) = o2;
  }
}

template <typename T>
bool side_vectorizes(const Side<T>& s, int vec) {
  if (s.n == 0) return true;
  const uintptr_t bytes = sizeof(T) * vec;
  return reinterpret_cast<uintptr_t>(s.x) % bytes == 0 && reinterpret_cast<uintptr_t>(s.out) % bytes == 0 &&
         s.x_batch % vec == 0 && s.x_token % vec == 0;
}

template <typename T>
int launch(const void* const* ptrs, const long long* strides, const int* ns, const float* inv_freq,
           int batch, int heads, int d, int inverse, cudaStream_t stream) {
  Side<T> sides[2];
  for (int i = 0; i < 2; ++i) {
    sides[i] = Side<T>{static_cast<const T*>(ptrs[3 * i]), strides[4 * i], strides[4 * i + 1],
                       static_cast<const int*>(ptrs[3 * i + 1]), strides[4 * i + 2], strides[4 * i + 3],
                       static_cast<T*>(const_cast<void*>(ptrs[3 * i + 2])), ns[i]};
  }
  const int rows = batch * (sides[0].n + sides[1].n);
  if (rows == 0) return static_cast<int>(cudaGetLastError());
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = (d / 4) % kVec == 0 && side_vectorizes(sides[0], kVec) && side_vectorizes(sides[1], kVec);
  const int units = heads * 2 * ((d / 4) / (vec ? kVec : 1));
  const int threads = units >= 256 ? 256 : (units + 31) / 32 * 32;
  const size_t shared = sizeof(float) * d;
  if (vec) {
    rope2d_kernel<T, kVec><<<rows, threads, shared, stream>>>(sides[0], sides[1], inv_freq, batch, heads, d,
                                                              inverse);
  } else {
    rope2d_kernel<T, 1><<<rows, threads, shared, stream>>>(sides[0], sides[1], inv_freq, batch, heads, d,
                                                           inverse);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rotates side a, and side b where nb > 0, in one launch on `stream`,
// without synchronizing; returns cudaGetLastError(). dtype: 0 float32,
// 1 bfloat16. Both sides are (batch, n, heads, head_dim) with their own n;
// strides are in elements; head_dim % 4 == 0; inv_freq holds head_dim / 4
// floats on the device.
extern "C" int rope2d(int dtype, int batch, int heads, int head_dim, int inverse, const void* inv_freq,
                      const void* xa, long long xa_batch, long long xa_token, const void* pa,
                      long long pa_batch, long long pa_token, void* oa, int na, const void* xb,
                      long long xb_batch, long long xb_token, const void* pb, long long pb_batch,
                      long long pb_token, void* ob, int nb, void* stream) {
  const void* ptrs[6] = {xa, pa, oa, xb, pb, ob};
  const long long strides[8] = {xa_batch, xa_token, pa_batch, pa_token, xb_batch, xb_token, pb_batch, pb_token};
  const int ns[2] = {na, nb};
  const float* table = static_cast<const float*>(inv_freq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(ptrs, strides, ns, table, batch, heads, head_dim, inverse, s);
    case 1: return launch<__nv_bfloat16>(ptrs, strides, ns, table, batch, heads, head_dim, inverse, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
