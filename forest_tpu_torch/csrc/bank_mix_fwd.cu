// Fused directional bank + rank-R mixing, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in forest_tpu/ops/smoothing.py
// (reached through bank_mix -> _bank_mix_pallas -> _pallas_fwd_call). Per
// pixel (b, h, w) and channel c:
//
//   out[c] = sum_k f_k[c] * sum_r A[k, r] * B[c, r]
//
// where f_k is the mean of three taps of x along direction d = k / 2
// ((0,1), (1,0), (1,1), (1,-1)) at dilation 1 (k even) or `dc` (k odd),
// with zeros outside the image. Layout is NHWC for x / out, [B,H,W,K,R] for
// A and [B,H,W,C,R] for B, all contiguous; the TPU kernel's [rows, C, W]
// relayout existed only to fill TPU lanes and has no counterpart here.
//
// Bound on this card: bytes. Per pixel it reads C + K*R + C*R values and
// writes C; at [8,256,256,48], K=8, R=4 in f32 that is ~0.67 GB, ~0.2 ms at
// 3.35 TB/s, against ~(2K+1)(R+1)*C flops per pixel, far below the ridge.
// Design: one thread per output element, blocks laid over one image row
// (blockIdx.x = b*H + h) so neighbouring threads read neighbouring channels
// and pixels; the 2K off-centre taps and the per-pixel A row are re-read
// through L1/L2 instead of being staged in shared memory, and the [.., C, K]
// filtered tensor never exists. Accumulation is f32 for f32 and bf16 I/O.
// Staging the halo rows in shared memory and vectorised loads are later work.
//
// C interface (loaded with ctypes): every pointer and the stream is a
// void*, the function launches on `stream`, never synchronises, allocates
// nothing, and returns cudaGetLastError() after the launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBanks = 8;  // K = 2 * num_directions, num_directions <= 4
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bank_mix_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ b, T* __restrict__ out, int H,
                    int W, int C, int K, int R, int dc) {
  const int64_t row = blockIdx.x;  // b * H + h
  const int h = static_cast<int>(row % H);
  const int i = blockIdx.y * kThreads + threadIdx.x;  // w * C + c in the row
  if (i >= W * C) return;
  const int w = i / C;
  const int c = i - w * C;
  const int64_t row_stride = static_cast<int64_t>(W) * C;
  const T* x_row = x + row * row_stride;

  const float centre = to_f32(x_row[i]);
  float f[kMaxBanks];
#pragma unroll
  for (int k = 0; k < kMaxBanks; ++k) {
    f[k] = 0.f;
    if (k < K) {
      const int d = k >> 1;
      const int delta = (k & 1) ? dc : 1;
      const int dy = (d == 0 ? 0 : 1) * delta;
      const int dx = (d == 1 ? 0 : (d == 3 ? -1 : 1)) * delta;
      float lo = 0.f, hi = 0.f;
      if (h - dy >= 0 && h - dy < H && w - dx >= 0 && w - dx < W)
        lo = to_f32(x_row[-dy * row_stride - static_cast<int64_t>(dx) * C + i]);
      if (h + dy >= 0 && h + dy < H && w + dx >= 0 && w + dx < W)
        hi = to_f32(x_row[dy * row_stride + static_cast<int64_t>(dx) * C + i]);
      f[k] = (lo + centre + hi) * (1.0f / 3.0f);
    }
  }

  // sum_k f_k sum_r A[k,r] B[c,r] == sum_r B[c,r] sum_k f_k A[k,r]: the
  // r-outer order keeps f in registers for any rank R.
  const int64_t pix = row * W + w;
  const T* a_pix = a + pix * K * R;
  const T* b_pix = b + (pix * C + c) * R;
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxBanks; ++k)
      if (k < K) s += f[k] * to_f32(a_pix[k * R + r]);
    acc += to_f32(b_pix[r]) * s;
  }
  out[row * row_stride + i] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* x, const void* a, const void* b, void* out, int B,
           int H, int W, int C, int nd, int R, int dc, void* stream) {
  const int64_t rows = static_cast<int64_t>(B) * H;
  const int64_t row_elems = static_cast<int64_t>(W) * C;
  if (rows == 0 || row_elems == 0) return 0;
  const int64_t col_blocks = (row_elems + kThreads - 1) / kThreads;
  if (nd < 1 || 2 * nd > kMaxBanks || R < 1 || dc < 1 ||
      rows > 0x7fffffff || col_blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>(col_blocks));
  bank_mix_fwd_kernel<T><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(out), H, W, C, 2 * nd, R,
      dc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bank_mix_fwd_f32(const void* x, const void* a, const void* b,
                                void* out, int B, int H, int W, int C,
                                int nd, int R, int dc, void* stream) {
  return launch<float>(x, a, b, out, B, H, W, C, nd, R, dc, stream);
}

extern "C" int bank_mix_fwd_bf16(const void* x, const void* a,
                                 const void* b, void* out, int B, int H,
                                 int W, int C, int nd, int R, int dc,
                                 void* stream) {
  return launch<__nv_bfloat16>(x, a, b, out, B, H, W, C, nd, R, dc, stream);
}
