// One GatedResidualBlock of the phase TCN in inference, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs the TCN as flax Conv /
// GroupNorm / Dense layers that XLA fuses inside its jitted step. The port's
// composed block (models/tcn.py) makes separate passes for the dilated
// conv, the GroupNorm, the gate's 1x1 conv, the sigmoid, the ReLU and the
// residual mix, each over [N, 64, T] float32 tensors, besides permuting the
// input and the output. This kernel computes, for every series n (a pixel)
// and step t, in float32 multiply-adds (no TF32, no tensor cores):
//
//   u[t, o] = conv_b[o] + sum_{k<3, c} conv_w[o, c, k] x[t + (k - 1) d, c]
//             (zero outside 0 <= t + (k - 1) d < T, as Conv1d pads)
//   h       = GroupNorm(u): 8 channels a group, statistics over the group's
//             channels and the T steps of the series, the mean first and then
//             the centred squares; rstd = rsqrt(var + eps)
//   g       = sigmoid(gate_b + gate_w h)
//   y       = g relu(h) + (1 - g) res,  res = x, or proj_b + proj_w x
//
// and, with a head (the last block of the dense phase pathway), instead of
// y: z = head_b + head_w y [Z <= 8], then gamma[n] z + beta[n] with FiLM.
//
// Bound on this card: operations. The v1 model's block of 64 -> 64 channels
// is 2 (3 * 64 + 64) 64 = 32,768 FLOPs a step (conv taps inside the series
// only: ~29.9k at T 15), against 512 bytes read and written a step: ~60
// FLOPs a byte, three times the float32 rate's 20 FLOPs a byte at 3.35 TB/s.
//
// Design: a persistent block on each SM walks over tiles of 32 series.
//  - The weights are staged once a block in shared memory, transposed so
//    that the 8 output channels of a group lie together: every read of
//    them is a 16-byte broadcast (a warp's lanes all read the same group).
//  - Thread (warp w, lane p) owns group w's 8 channels of series p over all
//    T <= 15 steps: 120 accumulators in registers. The GroupNorm of the
//    thread's own values needs no exchange.
//  - The tile's inputs [32][T][C_in] are copied to shared memory with
//    cp.async, all in flight at once (series padded to 2 mod 4 words: a
//    warp's 8-byte loads of 32 series fall on distinct banks). The conv
//    reads each step's two channels once and applies all three taps from
//    registers: the dilation is a template argument, so the taps' offsets
//    and the series' edges are resolved at compile time.
//  - h goes to shared memory (over the inputs where the residual is the
//    input, which is then read again from device memory, mostly L2) for
//    the gate's product, which each thread takes over all 64 channels.
//  - y goes back over h. Without a head, the block stores the tile a
//    step's 64 channels by 16 lanes: a warp writes two whole rows (a
//    thread's own 32 bytes a step, stored from registers, cost 1.5 ms more
//    a batch of 8 in a block's 9.7). With a head, thread (w, p) computes the
//    head and FiLM of series p at steps w and w + 8, storing Z floats a
//    step: neighbouring series on neighbouring addresses where the output
//    is [B, T, H, W, Z].
//
// Measured on an H100 at the embedding cell's batch (x [8, 15, 256, 256,
// 13], 524,288 series): the three blocks 5.2, 9.1 and 8.4 ms against
// bounds of 1.7, 3.6 and 3.5 ms; the conv's and the gate's multiply-adds
// take 3.2 and 1.0 ms of the middle block's 9.1, the rest the tile's loads,
// GroupNorm, the residual and the stores, which one 190 KB block an SM
// cannot overlap with another tile's products.
//
// Inputs are read through strides: the series index n runs over (b, h, w)
// with a stride each (a 3-d input [N, T, C] has b and h of size 1), so the
// dense path's [B, T, H, W, C] is read in place, with no permute copy.
//
// Every other block (a width, group count, kernel size, dilation, length or
// head outside the kernel above: the small models of the tests and tools)
// runs tcn_block_any_kernel: a thread block a series in turn, its input, h
// and (with a head) y in shared memory, the weights read through the cache;
// the same float32 arithmetic, GroupNorm in two passes. The entry point
// picks the kernel; only a series too long for shared memory is refused.

#include <cuda_runtime.h>

#define TB_THREADS 256
#define TB_P 32          // series a tile: a warp's lanes
#define TB_TM 15         // most steps a series
#define TB_TC 5          // steps of the epilogue's residual loads at once
#define TB_C 64          // output channels
#define TB_G 8           // GroupNorm groups: the warps
#define TB_ZMAX 8        // most head outputs
#define TB_MAX_SMEM (227 * 1024)
#define TA_THREADS 128   // the general kernel's threads

struct TbArgs {
  const float* x;
  const float* conv_w;   // [64, cin, 3]
  const float* conv_b;   // [64]
  const float* norm_w;   // [64]
  const float* norm_b;   // [64]
  const float* gate_w;   // [64, 64]
  const float* gate_b;   // [64]
  const float* proj_w;   // [64, cin] or null: the residual is x
  const float* proj_b;
  const float* head_w;   // [z, 64] or null: no head
  const float* head_b;
  const float* gamma;    // [n, z] or null: no FiLM
  const float* beta;
  float* out;
  long long n0, n1, n2;             // the series' dims (b, h, w)
  long long xs0, xs1, xs2, xst, xsc;  // x's element strides
  long long os0, os1, os2, ost;       // out's (channel stride 1)
  long long n;                       // n0 n1 n2
  int t, cin, z, dilation;
  int c, groups, ksize;  // output width, GroupNorm's groups, conv taps
  float eps;
  int x_vec;     // x's rows are 16-byte aligned runs of cin floats
  int out_vec;   // out's rows are 16-byte aligned (always without a head)
};

static __host__ __device__ __forceinline__ int cin_pad(int cin) {
  return (cin + 1) & ~1;
}

// a series' row stride in shared memory, in words: 2 mod 4
static __host__ __device__ __forceinline__ int series_pad(int words) {
  return words + ((2 - words % 4) + 4) % 4;
}

// shared memory: weights, vectors, the tile's offsets, then x and h
static __host__ __device__ __forceinline__ long long weight_words(
    int cin, bool proj, bool head) {
  const int cp = cin_pad(cin);
  return (long long)cp * 3 * TB_C + TB_C * TB_C + (proj ? cp * TB_C : 0) +
         (head ? TB_C * TB_ZMAX : 0) + 5 * TB_C + TB_ZMAX;
}

static size_t smem_bytes(int cin, bool proj, bool head) {
  const long long xw = (long long)TB_P * series_pad(TB_TM * cin_pad(cin));
  const long long hw = (long long)TB_P * series_pad(TB_TM * TB_C);
  const long long tile = proj ? xw + hw : (xw > hw ? xw : hw);
  return (size_t)(weight_words(cin, proj, head) + tile) * 4 +
         2 * TB_P * sizeof(long long);
}

// acc[j] += v w[j], j < 8, w 16-byte aligned
__device__ __forceinline__ void fma8(float* acc, float v, const float* w) {
  const float4 a = *reinterpret_cast<const float4*>(w);
  const float4 b = *reinterpret_cast<const float4*>(w + 4);
  acc[0] = fmaf(v, a.x, acc[0]);
  acc[1] = fmaf(v, a.y, acc[1]);
  acc[2] = fmaf(v, a.z, acc[2]);
  acc[3] = fmaf(v, a.w, acc[3]);
  acc[4] = fmaf(v, b.x, acc[4]);
  acc[5] = fmaf(v, b.y, acc[5]);
  acc[6] = fmaf(v, b.z, acc[6]);
  acc[7] = fmaf(v, b.w, acc[7]);
}

__device__ __forceinline__ float sum8(const float* v) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// an asynchronous copy of 4 or 8 bytes to shared memory, zeros where
// ``valid`` is false (then nothing is read)
template <int N>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(valid ? N : 0));
}

__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int D>
__global__ void __launch_bounds__(TB_THREADS, 1)
    tcn_block_kernel(const TbArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int cin = a.cin, cp = cin_pad(cin), T = a.t;
  const bool proj = a.proj_w != nullptr, head = a.head_w != nullptr;
  const int psx = series_pad(TB_TM * cp), psh = series_pad(TB_TM * TB_C);
  float* wc = sm;                                  // [cp][3][64]
  float* wg = wc + cp * 3 * TB_C;                  // [64][64] (in, out)
  float* wp = wg + TB_C * TB_C;                    // [cp][64]
  float* wh = wp + (proj ? cp * TB_C : 0);         // [64][8]
  float* vec = wh + (head ? TB_C * TB_ZMAX : 0);   // biases and norm
  float* cb = vec, *nw = vec + TB_C, *nb = vec + 2 * TB_C;
  float* gb = vec + 3 * TB_C, *pb = vec + 4 * TB_C, *hb = vec + 5 * TB_C;
  long long* xbase = reinterpret_cast<long long*>(
      sm + weight_words(cin, proj, head));
  long long* obase = xbase + TB_P;
  float* xs = reinterpret_cast<float*>(obase + TB_P);
  float* hs = proj ? xs + TB_P * psx : xs;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < cp * 3 * TB_C; i += TB_THREADS) {
    const int ci = i / (3 * TB_C), k = (i / TB_C) % 3, co = i % TB_C;
    wc[i] = ci < cin ? a.conv_w[(co * cin + ci) * 3 + k] : 0.f;
  }
  for (int i = tid; i < TB_C * TB_C; i += TB_THREADS)
    wg[i] = a.gate_w[(i % TB_C) * TB_C + i / TB_C];
  if (proj)
    for (int i = tid; i < cp * TB_C; i += TB_THREADS) {
      const int ci = i / TB_C, co = i % TB_C;
      wp[i] = ci < cin ? a.proj_w[co * cin + ci] : 0.f;
    }
  if (head)
    for (int i = tid; i < TB_C * TB_ZMAX; i += TB_THREADS) {
      const int c = i / TB_ZMAX, j = i % TB_ZMAX;
      wh[i] = j < a.z ? a.head_w[j * TB_C + c] : 0.f;
    }
  if (tid < TB_C) {
    cb[tid] = a.conv_b[tid];
    nw[tid] = a.norm_w[tid];
    nb[tid] = a.norm_b[tid];
    gb[tid] = a.gate_b[tid];
    pb[tid] = proj ? a.proj_b[tid] : 0.f;
  }
  if (tid < TB_ZMAX) hb[tid] = head && tid < a.z ? a.head_b[tid] : 0.f;

  const int c0w = warp * 8, p = lane;   // the thread's channels, series
  const long long tiles = (a.n + TB_P - 1) / TB_P;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    __syncthreads();                    // the last tile is done with xs, hs
    if (tid < TB_P) {
      const long long n = tile * TB_P + tid;
      long long xb = -1, ob = -1;
      if (n < a.n) {
        const long long plane = a.n1 * a.n2;
        const long long b = n / plane, r = n - b * plane;
        const long long h = r / a.n2, w = r - h * a.n2;
        xb = b * a.xs0 + h * a.xs1 + w * a.xs2;
        ob = b * a.os0 + h * a.os1 + w * a.os2;
      }
      xbase[tid] = xb;
      obase[tid] = ob;
    }
    __syncthreads();
    // the tile's inputs, zero past T, past cin and past the last series:
    // every copy of the tile in flight at once
    if (a.x_vec) {
      const int q = cin >> 1;           // 8-byte pieces a row
      for (int e = tid; e < TB_P * TB_TM * q; e += TB_THREADS) {
        const int row = e / q, c2 = e - row * q;
        const int s = row / TB_TM, t = row - s * TB_TM;
        const bool ok = xbase[s] >= 0 && t < T;
        copy_async<8>(xs + s * psx + t * cp + 2 * c2,
                      ok ? a.x + xbase[s] + t * a.xst + 2 * c2 : a.x, ok);
      }
    } else {                            // series at a step side by side
      for (int e = tid; e < TB_P * TB_TM * cp; e += TB_THREADS) {
        const int row = e / cp, c = e - row * cp;
        const int t = row / TB_P, s = row - t * TB_P;
        const bool ok = xbase[s] >= 0 && t < T && c < cin;
        copy_async<4>(xs + s * psx + t * cp + c,
                      ok ? a.x + xbase[s] + t * a.xst + c * a.xsc : a.x, ok);
      }
    }
    copy_wait();
    __syncthreads();

    // the dilated conv: each step's two channels once, all three taps
    float acc[TB_TM][8];
#pragma unroll
    for (int t = 0; t < TB_TM; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[t][j] = cb[c0w + j];
    const float* xrow = xs + p * psx;
    for (int c0 = 0; c0 < cp; c0 += 2) {
      float2 xv[TB_TM];
#pragma unroll
      for (int t = 0; t < TB_TM; ++t)
        xv[t] = *reinterpret_cast<const float2*>(xrow + t * cp + c0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* wk = wc + c0 * 3 * TB_C + k * TB_C + c0w;
#pragma unroll
        for (int t = 0; t < TB_TM; ++t) {
          const int s = t + (k - 1) * D;
          if (s < 0 || s >= TB_TM) continue;
          fma8(acc[t], xv[s].x, wk);
          fma8(acc[t], xv[s].y, wk + 3 * TB_C);
        }
      }
    }

    // GroupNorm over the thread's 8 channels and the series' T steps: a
    // sum a channel, then across the 8 (short dependency chains)
    {
      float part[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j] = 0.f;
#pragma unroll
      for (int t = 0; t < TB_TM; ++t) {
        if (t >= T) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) part[j] += acc[t][j];
      }
      const float cnt = (float)(8 * T);
      const float mean = sum8(part) / cnt;
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j] = 0.f;
#pragma unroll
      for (int t = 0; t < TB_TM; ++t) {
        if (t >= T) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dv = acc[t][j] - mean;
          part[j] = fmaf(dv, dv, part[j]);
        }
      }
      const float rstd = rsqrtf(sum8(part) / cnt + a.eps);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sc = rstd * nw[c0w + j], sh = nb[c0w + j];
#pragma unroll
        for (int t = 0; t < TB_TM; ++t)
          acc[t][j] = t < T ? fmaf(acc[t][j] - mean, sc, sh) : 0.f;
      }
    }
    if (!proj) __syncthreads();         // h goes over the inputs
    float* hrow = hs + p * psh;
#pragma unroll
    for (int t = 0; t < TB_TM; ++t) {
      float2* d = reinterpret_cast<float2*>(hrow + t * TB_C + c0w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = make_float2(acc[t][2 * j], acc[t][2 * j + 1]);
    }
    __syncthreads();

    // the gate's product over all 64 channels of h
#pragma unroll
    for (int t = 0; t < TB_TM; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[t][j] = gb[c0w + j];
    for (int c0 = 0; c0 < TB_C; c0 += 2) {
      float2 hv[TB_TM];
#pragma unroll
      for (int t = 0; t < TB_TM; ++t)
        hv[t] = *reinterpret_cast<const float2*>(hrow + t * TB_C + c0);
      const float* wk = wg + c0 * TB_C + c0w;
#pragma unroll
      for (int t = 0; t < TB_TM; ++t) {
        fma8(acc[t], hv[t].x, wk);
        fma8(acc[t], hv[t].y, wk + TB_C);
      }
    }
    __syncthreads();                    // y goes over h

    // y = g relu(h) + (1 - g) res into h's place, TB_TC steps at a time:
    // their residuals loaded (or projected) together
    const long long xb = xbase[p];
#pragma unroll
    for (int t0 = 0; t0 < TB_TM; t0 += TB_TC) {
      float res[TB_TC][8];
      if (proj) {
#pragma unroll
        for (int u = 0; u < TB_TC; ++u)
#pragma unroll
          for (int j = 0; j < 8; ++j) res[u][j] = pb[c0w + j];
        const float* xr = xs + p * psx + t0 * cp;
        for (int ci = 0; ci < cp; ++ci) {
          const float* wk = wp + ci * TB_C + c0w;
#pragma unroll
          for (int u = 0; u < TB_TC; ++u) fma8(res[u], xr[u * cp + ci], wk);
        }
      } else {
#pragma unroll
        for (int u = 0; u < TB_TC; ++u) {
          const int t = t0 + u;
          if (xb < 0 || t >= T) {
#pragma unroll
            for (int j = 0; j < 8; ++j) res[u][j] = 0.f;
          } else if (a.x_vec) {
            const float4* xr = reinterpret_cast<const float4*>(
                a.x + xb + t * a.xst + c0w);
            const float4 r0 = __ldg(xr), r1 = __ldg(xr + 1);
            res[u][0] = r0.x; res[u][1] = r0.y; res[u][2] = r0.z;
            res[u][3] = r0.w; res[u][4] = r1.x; res[u][5] = r1.y;
            res[u][6] = r1.z; res[u][7] = r1.w;
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              res[u][j] = __ldg(a.x + xb + t * a.xst + (c0w + j) * a.xsc);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < TB_TC; ++u) {
        const int t = t0 + u;
        if (t >= T) continue;
        float2* hy = reinterpret_cast<float2*>(hrow + t * TB_C + c0w);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 h = hy[j];
          const float g0 = 1.f / (1.f + expf(-acc[t][2 * j]));
          const float g1 = 1.f / (1.f + expf(-acc[t][2 * j + 1]));
          hy[j] = make_float2(
              g0 * fmaxf(h.x, 0.f) + (1.f - g0) * res[u][2 * j],
              g1 * fmaxf(h.y, 0.f) + (1.f - g1) * res[u][2 * j + 1]);
        }
      }
    }
    __syncthreads();

    if (!head) {
      // the tile's y to the output, a step's 64 channels by 16 lanes
      for (int e = tid; e < TB_P * TB_TM * 16; e += TB_THREADS) {
        const int row = e >> 4, q = e & 15;
        const int s = row / TB_TM, t = row - s * TB_TM;
        if (obase[s] < 0 || t >= T) continue;
        const float2* src = reinterpret_cast<const float2*>(
            hs + s * psh + t * TB_C + 4 * q);
        const float2 v0 = src[0], v1 = src[1];
        *reinterpret_cast<float4*>(a.out + obase[s] + t * a.ost + 4 * q) =
            make_float4(v0.x, v0.y, v1.x, v1.y);
      }
      continue;
    }

    // the head and FiLM: series p at steps warp and warp + 8
    const long long ob = obase[p];
    for (int t = warp; t < T; t += TB_G) {
      float z[TB_ZMAX];
#pragma unroll
      for (int j = 0; j < TB_ZMAX; ++j) z[j] = hb[j];
      const float* yr = hrow + t * TB_C;
#pragma unroll 8
      for (int c0 = 0; c0 < TB_C; c0 += 2) {
        const float2 yv = *reinterpret_cast<const float2*>(yr + c0);
        fma8(z, yv.x, wh + c0 * TB_ZMAX);
        fma8(z, yv.y, wh + (c0 + 1) * TB_ZMAX);
      }
      if (ob < 0) continue;
      if (a.gamma != nullptr) {
        const long long n = tile * TB_P + p;
        const float* gr = a.gamma + n * a.z;
        const float* br = a.beta + n * a.z;
#pragma unroll
        for (int j = 0; j < TB_ZMAX; ++j)
          if (j < a.z) z[j] = fmaf(__ldg(gr + j), z[j], __ldg(br + j));
      }
      float* o = a.out + ob + t * a.ost;
      if (a.out_vec && a.z == TB_ZMAX) {
        reinterpret_cast<float4*>(o)[0] = make_float4(z[0], z[1], z[2], z[3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(z[4], z[5], z[6], z[7]);
      } else {
#pragma unroll
        for (int j = 0; j < TB_ZMAX; ++j)
          if (j < a.z) o[j] = z[j];
      }
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the general kernel's shared memory: x [T][cin], h [T][c], y [T][c] with
// a head, and each group's mean and rstd
static size_t any_smem_bytes(int t, int cin, int c, int groups, bool head) {
  return (size_t)((long long)t * cin + (long long)t * c * (head ? 2 : 1) +
                  2 * groups) * 4;
}

__global__ void __launch_bounds__(TA_THREADS)
    tcn_block_any_kernel(const TbArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int T = a.t, cin = a.cin, C = a.c, G = a.groups, K = a.ksize;
  const int cg = C / G, cnt = cg * T;
  const bool proj = a.proj_w != nullptr, head = a.head_w != nullptr;
  float* xs = sm;                         // [T][cin]
  float* hs = xs + T * cin;               // [T][C]
  float* ys = hs + T * C;                 // [T][C], with a head
  float* stat = ys + (head ? T * C : 0);  // a group's mean and rstd
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (long long n = blockIdx.x; n < a.n; n += gridDim.x) {
    const long long plane = a.n1 * a.n2;
    const long long b = n / plane, r = n - b * plane;
    const long long hh = r / a.n2, w = r - hh * a.n2;
    const long long xb = b * a.xs0 + hh * a.xs1 + w * a.xs2;
    const long long ob = b * a.os0 + hh * a.os1 + w * a.os2;
    __syncthreads();                      // the last series is done
    for (int e = tid; e < T * cin; e += TA_THREADS) {
      const int t = e / cin, ci = e - t * cin;
      xs[e] = __ldg(a.x + xb + t * a.xst + ci * a.xsc);
    }
    __syncthreads();
    // the dilated conv, zero outside the series
    for (int e = tid; e < T * C; e += TA_THREADS) {
      const int t = e / C, o = e - t * C;
      float acc = __ldg(a.conv_b + o);
      for (int k = 0; k < K; ++k) {
        const int s = t + (k - K / 2) * a.dilation;
        if (s < 0 || s >= T) continue;
        const float* wk = a.conv_w + (long long)o * cin * K + k;
        for (int ci = 0; ci < cin; ++ci)
          acc = fmaf(__ldg(wk + ci * K), xs[s * cin + ci], acc);
      }
      hs[e] = acc;
    }
    __syncthreads();
    // GroupNorm's statistics, a warp a group: the mean, then the centred
    // squares
    for (int g = warp; g < G; g += TA_THREADS / 32) {
      float sum = 0.f;
      for (int i = lane; i < cnt; i += 32)
        sum += hs[(i / cg) * C + g * cg + i % cg];
      const float mean = warp_sum(sum) / (float)cnt;
      float sq = 0.f;
      for (int i = lane; i < cnt; i += 32) {
        const float dv = hs[(i / cg) * C + g * cg + i % cg] - mean;
        sq = fmaf(dv, dv, sq);
      }
      sq = warp_sum(sq);
      if (lane == 0) {
        stat[2 * g] = mean;
        stat[2 * g + 1] = rsqrtf(sq / (float)cnt + a.eps);
      }
    }
    __syncthreads();
    for (int e = tid; e < T * C; e += TA_THREADS) {
      const int o = e % C, g = o / cg;
      hs[e] = fmaf(hs[e] - stat[2 * g], stat[2 * g + 1] * __ldg(a.norm_w + o),
                   __ldg(a.norm_b + o));
    }
    __syncthreads();
    // the gate, the residual (or its projection) and the mix
    for (int e = tid; e < T * C; e += TA_THREADS) {
      const int t = e / C, o = e - t * C;
      float gv = __ldg(a.gate_b + o);
      const float* wg = a.gate_w + (long long)o * C;
      for (int c = 0; c < C; ++c) gv = fmaf(__ldg(wg + c), hs[t * C + c], gv);
      float res;
      if (proj) {
        res = __ldg(a.proj_b + o);
        const float* wp = a.proj_w + (long long)o * cin;
        for (int ci = 0; ci < cin; ++ci)
          res = fmaf(__ldg(wp + ci), xs[t * cin + ci], res);
      } else {
        res = xs[t * cin + o];
      }
      const float g = 1.f / (1.f + expf(-gv));
      const float y = g * fmaxf(hs[e], 0.f) + (1.f - g) * res;
      if (head)
        ys[e] = y;
      else
        a.out[ob + t * a.ost + o] = y;
    }
    if (!head) continue;
    __syncthreads();
    // the head, and FiLM
    for (int e = tid; e < T * a.z; e += TA_THREADS) {
      const int t = e / a.z, j = e - t * a.z;
      float zv = __ldg(a.head_b + j);
      const float* wh = a.head_w + (long long)j * C;
      for (int c = 0; c < C; ++c) zv = fmaf(__ldg(wh + c), ys[t * C + c], zv);
      if (a.gamma != nullptr)
        zv = fmaf(__ldg(a.gamma + n * a.z + j), zv,
                  __ldg(a.beta + n * a.z + j));
      a.out[ob + t * a.ost + j] = zv;
    }
  }
}

// set once a device: the shared memory a block of ``kernel`` may ask for;
// -> a cudaError_t, and the device's SMs in ``sms``
template <typename Kernel>
static int prepare(Kernel kernel, bool* raised, int* sms_of, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TB_MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    raised[dev] = true;
  }
  if (sms_of[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = sms_of[dev];
  return 0;
}

template <int D>
static int launch(const TbArgs& a, size_t smem, cudaStream_t s) {
  static bool raised[64];
  static int sms_of[64];
  int sms = 0;
  const int err = prepare(tcn_block_kernel<D>, raised, sms_of, &sms);
  if (err != 0) return err;
  const long long tiles = (a.n + TB_P - 1) / TB_P;
  const long long blocks = tiles < sms ? tiles : sms;
  tcn_block_kernel<D><<<(unsigned)blocks, TB_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

static int launch_any(const TbArgs& a, size_t smem, cudaStream_t s) {
  static bool raised[64];
  static int sms_of[64];
  int sms = 0;
  const int err = prepare(tcn_block_any_kernel, raised, sms_of, &sms);
  if (err != 0) return err;
  const long long most = 16LL * sms;
  const long long blocks = a.n < most ? a.n : most;
  tcn_block_any_kernel<<<(unsigned)blocks, TA_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// whether the kernel above takes the block
static bool tiled_takes(const TbArgs& a, bool proj, bool head) {
  return a.t <= TB_TM && a.c == TB_C && a.groups == TB_G && a.ksize == 3 &&
         (a.dilation == 1 || a.dilation == 2 || a.dilation == 4) &&
         a.z <= TB_ZMAX && (!a.x_vec || a.cin % 4 == 0) && (head || a.out_vec) &&
         smem_bytes(a.cin, proj, head) <= TB_MAX_SMEM;
}

extern "C" {

int sizeof_args(void) { return (int)sizeof(TbArgs); }

// -> a cudaError_t: 0, or why the launch was refused
int tcn_block(const TbArgs* args, void* stream) {
  const TbArgs a = *args;
  if (a.n <= 0 || a.t <= 0) return 0;
  const bool proj = a.proj_w != nullptr, head = a.head_w != nullptr;
  if (a.cin < 1 || a.c < 1 || a.groups < 1 || a.c % a.groups != 0 ||
      a.ksize < 1 || a.ksize % 2 == 0 || a.dilation < 1 || a.z < 0 ||
      (head && a.z < 1) || (!proj && a.cin != a.c))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiled_takes(a, proj, head)) {
    const size_t smem = smem_bytes(a.cin, proj, head);
    switch (a.dilation) {
      case 1: return launch<1>(a, smem, s);
      case 2: return launch<2>(a, smem, s);
      default: return launch<4>(a, smem, s);
    }
  }
  const size_t smem = any_smem_bytes(a.t, a.cin, a.c, a.groups, head);
  if (smem > TB_MAX_SMEM) return (int)cudaErrorInvalidValue;
  return launch_any(a, smem, s);
}

}  // extern "C"
