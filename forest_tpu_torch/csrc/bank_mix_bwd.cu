// Fused directional bank + rank-R mixing, backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in forest_tpu/ops/smoothing.py
// (reached through _bank_mix_bwd -> _pallas_bwd_call). With the forward
//
//   out[p, c] = sum_k f_k[p, c] * M_k[p, c],  M_k[p, c] = sum_r A[p,k,r] B[p,c,r]
//
// (f_k = mean of three taps of x along direction k / 2 at dilation 1 or `dc`,
// zero outside the image) and g the cotangent of out, it computes
//
//   dx[p, c]    = sum_k bank_k(g * M_k)[p, c]
//   dA[p, k, r] = sum_c g[p, c] f_k[p, c] B[p, c, r]
//   dB[p, c, r] = g[p, c] sum_k f_k[p, c] A[p, k, r]
//
// The bank is symmetric, so its adjoint is the same 3-tap mean applied to
// P_k = g * M_k: a tap position outside the image contributes nothing. f_k
// is recomputed from x. Layout as in the forward: NHWC x / g / dx,
// [B,H,W,K,R] A / dA, [B,H,W,C,R] B / dB, all contiguous. The TPU kernel's
// [rows, C, W] relayout, its three-view halos and its batch chunking have no
// counterpart here.
//
// Bound on this card: bytes. Per pixel 3C + 2KR + 2CR values move (x, g, dx;
// A, dA; B, dB): 592 at C = 48, K = 8, R = 4, i.e. 1.86 GB in f32 at
// [12,256,256,48] = 0.56 ms at 3.35 TB/s (0.28 ms in bf16).
//
// Design: ONE kernel, one pass, no atomics, deterministic. A block owns a
// strip of TW pixel columns (plus dc halo columns on each side) and a
// segment of S rows of one image, and walks down the rows q of the segment
// (plus dc halo rows above and below). Eight threads share a pixel column;
// on the main path (R = 4, K = 8, C even, aligned pointers) thread t takes
// the channel pairs {2t, 2t + 1}, {2t + 16, 2t + 17}, ... At row q a thread
//  - reads g, A and B of its pixel ONCE, straight into registers, three
//    channel pairs' loads started before the first use (A and B with 16-byte
//    loads; in bf16 A with 8-byte ones), and forms
//    P_k = g * sum_r A[k,r] B[c,r] for the K banks; P_k of this one row
//    goes to shared memory (halo columns included);
//  - on its own columns and rows forms f_k from a ring of 2 dc + 2 rows of x
//    in shared memory (filled one row ahead, each x value read once per
//    strip), writes dB with 16-byte stores and sums dA over its channels in
//    registers; the eight threads of the pixel then add their partial sums
//    with warp shuffles, in a fixed order;
//  - after a barrier, gathers the row's P_k at the 17 tap positions (8-byte
//    shared-memory loads, a channel pair each) into a ring of 2 dc + 1 rows
//    of dx accumulators in shared memory (each entry owned by one thread):
//    row q feeds dx rows q, q +- 1, q +- dc. dx row q - dc is then complete:
//    it is scaled by 1/3, rounded once and stored.
// Taps outside the image read zeros: columns outside the image keep P = 0
// and x = 0 in shared memory, rows outside are never produced.
// So x, g, A and B leave device memory once, apart from the halo: dc columns
// on each side of a strip (g, A, B, x) and dc rows on each side of a segment
// (g, A, B for P only). Everything is staged as f32, so f32 and bf16 use the
// same shared memory.
//
// Tile at [12,256,256,48], K 8, R 4, dc 3: TW 32 (38 columns with the halo,
// 320 threads), S 64, so 12 * 8 * 4 = 384 blocks, 2.9 waves of one block per
// SM; shared memory per column is the P row (K*C = 384 padded to 400
// floats) plus 7 + 8 ring rows of C = 48 floats, 4,480 bytes, 170,240 bytes
// a block. The halo re-reads g, A, B 1.19x in columns and 1.09x in rows.
// Bank conflicts are met by padding, not by a swizzle: a warp holds four
// pixel columns of eight lanes; with two words a lane the columns lie 16
// (mod 32) words apart, so each half-warp's 16 lanes fall into 32 distinct
// banks; with one word a lane (the other path) 8 (mod 16) words apart.
// While a row is worked on, the next row's g, A and B are asked into L2
// (prefetch.global.L2), which costs no registers.
// Where C is 48, the shipped model's z_type width, the kernel is compiled
// with C as a constant: the channel loops unroll and the offsets within a
// pixel become constants. The address arithmetic that this takes away was a
// quarter of all instructions (2,330 -> 1,710 per thread and row).
// What holds it back (NVIDIA H100 80GB HBM3, 700.00 W): 0.98-0.99 ms in f32
// and 1.06-1.08 ms in bf16 (1.15-1.18 / 1.22-1.23 ms with C read at run
// time) against 4.45 / 4.57 ms for the two kernels this replaces and bounds
// of 0.56 / 0.28 ms. A thread executes some 285 instructions per (pixel,
// channel), of which 96 are the FFMAs of the three small products (P_k and
// dA both go through g * B, and the pixel's eight lanes add their dA sums by
// halving, 28 shuffles instead of 96). No unit is full: the warps start an
// instruction in half of the cycles, shared memory is busy in two fifths,
// the FP32 pipes in three tenths. One block of 10 warps per SM leaves the
// latencies uncovered: g, A and B come straight into registers at the start
// of a row, when every warp waits (without the L2 prefetch f32 loses 6 %,
// bf16 20 %); two of the ten warps hold halo columns only and idle in the
// second half of each row. Dropping the second barrier changes nothing;
// two blocks of 22 columns per SM gain 3 %. bf16 executes 5 % more (the
// conversions) and is 8 % slower than f32. A version bound by its bytes
// needs more warps per SM (fewer registers a thread) and asynchronous
// copies a row ahead in place of loads to registers.
//
// Limits (cudaErrorInvalidValue otherwise): num_directions 1..4, R >= 1,
// dc >= 1, and a strip of at least one column with its halo must fit
// 232,448 bytes of shared memory and 320 threads:
// (1 + 2 dc) * 4 * (pad(K*C) + (4 dc + 3) * pad(C)) <= 232,448 and dc <= 19,
// pad(n) = n rounded up to 8 (mod 16), or to 16 (mod 32) on the main path.
// Any other R, K or an odd C runs a scalar path, one channel at a time and
// the ranks in masked passes of four, which recomputes P's sum over the
// ranks from device memory for R > 4 and is slow there.
//
// C interface (loaded with ctypes): every pointer and the stream is a void*,
// the function launches the one kernel on `stream`, never synchronises,
// allocates nothing, and returns cudaGetLastError() (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBanks = 8;  // K = 2 * num_directions, num_directions <= 4
constexpr int kLanes = 8;     // threads per pixel column
static_assert(kLanes == kMaxBanks, "lane t of a pixel ends with dA of bank t");
constexpr int kChunk = 4;     // ranks per pass
constexpr int kBatch = 3;     // channel steps a thread loads before it computes
constexpr int kMaxThreads = 320;
constexpr int kStrip = 32;    // TW: own pixel columns of a strip, at most
constexpr int kSegment = 64;  // S: own rows of a segment
constexpr int kMaxSharedBytes = 232448;
constexpr int kModelC = 48;  // z_type of the shipped model: C at compile time

struct Tile {
  int H, W, C, K, R, dc;
  int TW, TWh, S, PS, CS;  // PS, CS: padded K*C and C, in floats
  int nstrip, nseg;
};

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

// four consecutive values, the pointer aligned to four of them
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  // a bf16 is the upper half of the f32 of the same value
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned packed;  // one rounding each, hi in the upper half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(packed) : "f"(hi), "f"(lo));
  return packed;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

// ranks r0 .. r0 + 3 of a run of R values; kVector: R = 4, r0 = 0, aligned
template <typename T, bool kVector>
__device__ __forceinline__ void load_ranks(const T* p, int r0, int R,
                                           float* v) {
  if constexpr (kVector) {
    load4(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      v[j] = r0 + j < R ? to_f32(p[r0 + j]) : 0.f;
  }
}
template <typename T, bool kVector>
__device__ __forceinline__ void store_ranks(T* p, int r0, int R,
                                            const float* v) {
  if constexpr (kVector) {
    store4(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j)
      if (r0 + j < R) p[r0 + j] = from_f32<T>(v[j]);
  }
}

// the ranks of CP consecutive channels: v[e][j] = p[e * R + r0 + j]
template <typename T, bool kMain>
__device__ __forceinline__ void load_ranks_of(const T* p, int r0, int R,
                                              float (*v)[kChunk]) {
  load_ranks<T, kMain>(p, r0, R, v[0]);
  if constexpr (kMain) load_ranks<T, kMain>(p + kChunk, r0, R, v[1]);
}
template <>
__device__ __forceinline__ void load_ranks_of<__nv_bfloat16, true>(
    const __nv_bfloat16* p, int, int, float (*v)[kChunk]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);  // 2 channels x 4 ranks
  v[0][0] = __uint_as_float(q.x << 16);
  v[0][1] = __uint_as_float(q.x & 0xffff0000u);
  v[0][2] = __uint_as_float(q.y << 16);
  v[0][3] = __uint_as_float(q.y & 0xffff0000u);
  v[1][0] = __uint_as_float(q.z << 16);
  v[1][1] = __uint_as_float(q.z & 0xffff0000u);
  v[1][2] = __uint_as_float(q.w << 16);
  v[1][3] = __uint_as_float(q.w & 0xffff0000u);
}
template <typename T, bool kMain>
__device__ __forceinline__ void store_ranks_of(T* p, int r0, int R,
                                               const float (*v)[kChunk]) {
  store_ranks<T, kMain>(p, r0, R, v[0]);
  if constexpr (kMain) store_ranks<T, kMain>(p + kChunk, r0, R, v[1]);
}
template <>
__device__ __forceinline__ void store_ranks_of<__nv_bfloat16, true>(
    __nv_bfloat16* p, int, int, const float (*v)[kChunk]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0][0], v[0][1]), pack_bf16(v[0][2], v[0][3]),
                 pack_bf16(v[1][0], v[1][1]), pack_bf16(v[1][2], v[1][3]));
}

// (dy, dx) of bank k: direction k / 2 at dilation 1 (k even) or dc (k odd)
__device__ __forceinline__ void bank_offset(int k, int dc, int* dy, int* dx) {
  const int d = k >> 1;
  const int delta = (k & 1) ? dc : 1;
  *dy = (d == 0 ? 0 : 1) * delta;
  *dx = (d == 1 ? 0 : (d == 3 ? -1 : 1)) * delta;
}

// ask L2 for the line at p: the next row's loads then wait for L2, not for
// device memory
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

// CP consecutive values of shared memory, the address aligned to CP floats
template <int CP>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (CP == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}
template <int CP>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (CP == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// CP consecutive channels of device memory, the address aligned to CP values
template <int CP>
__device__ __forceinline__ void load_channels(const float* p, float* v) {
  lds<CP>(p, v);
}
template <int CP>
__device__ __forceinline__ void load_channels(const __nv_bfloat16* p,
                                              float* v) {
  if constexpr (CP == 2) {
    const unsigned q = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(q << 16);
    v[1] = __uint_as_float(q & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}
template <int CP>
__device__ __forceinline__ void store_channels(float* p, const float* v) {
  sts<CP>(p, v);
}
template <int CP>
__device__ __forceinline__ void store_channels(__nv_bfloat16* p,
                                               const float* v) {
  if constexpr (CP == 2) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// n rounded up to `residue` modulo `modulus` floats: the stride between the
// pixel columns of a warp that spreads its lanes over all 32 banks
__host__ __device__ constexpr int pad_to(int64_t n, int residue, int modulus) {
  return static_cast<int>((n - residue + modulus - 1) / modulus * modulus +
                          residue);
}

// kMain: R = 4, K = 8, C even, every pointer aligned for the vector
// accesses; a thread then takes its channels in pairs (CP = 2). Otherwise R,
// K and C are read at run time, channels go one by one and ranks in masked
// passes of four. kC > 0 (with kMain): C is kC, known to the compiler, so the
// channel loops unroll and the offsets within a pixel become constants; the
// address arithmetic they replace was two fifths of all instructions.
template <typename T, bool kMain, int kC>
__global__ void __launch_bounds__(kMaxThreads)
bank_mix_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const T* __restrict__ a, const T* __restrict__ b,
                    T* __restrict__ dx, T* __restrict__ dA,
                    T* __restrict__ dB, const Tile tile) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CP = kMain ? 2 : 1;  // channels a thread takes together
  const int H = tile.H, W = tile.W, dc = tile.dc;
  const int C = kC > 0 ? kC : tile.C;
  const int K = kMain ? kMaxBanks : tile.K;
  const int R = kMain ? kChunk : tile.R;
  const int TWh = tile.TWh;
  const int PS = kC > 0 ? pad_to(kMaxBanks * kC, 16, 32) : tile.PS;
  const int CS = kC > 0 ? pad_to(kC, 16, 32) : tile.CS;
  const int RD = 2 * dc + 1;  // rows of the dx ring
  const int XD = RD + 1;      // rows of the x ring: one is being filled
  float* const prow = smem;                    // [TWh][PS]: P_k, [k][c]
  float* const acc = prow + TWh * PS;          // [RD][TWh][CS]
  float* const xring = acc + RD * TWh * CS;    // [XD][TWh][CS]

  const int col = threadIdx.x / kLanes;  // column of the strip, halo first
  const int t = threadIdx.x % kLanes;
  const bool active = col < TWh;  // the block is padded to whole warps
  const int strip = blockIdx.x % tile.nstrip;
  const int seg = (blockIdx.x / tile.nstrip) % tile.nseg;
  const int64_t img = blockIdx.x / (tile.nstrip * tile.nseg);
  const int gcol = strip * tile.TW - dc + col;
  const bool in_image = active && gcol >= 0 && gcol < W;
  const bool own = in_image && col >= dc && col < dc + tile.TW;
  const int h0 = seg * tile.S;
  const int h1 = min(h0 + tile.S, H);
  const int q0 = max(0, h0 - dc);
  const int64_t img_row0 = img * H;
  const int KR = K * R;
  // this thread's channels: c, .., c + CP - 1 for c = c_first + i * c_step
  const int c_first = t * CP;
  constexpr int c_step = kLanes * CP;
  // every thread then has a channel at each of its steps below C
  constexpr bool kWhole = kC > 0 && kC % c_step == 0;

  // prologue: clear the own dx accumulators, stage x rows q0 - dc .. q0 + dc
  // into slots 0 .. 2 dc (zeros outside the image)
  if (active) {
#pragma unroll 3
    for (int c0 = 0; c0 < C; c0 += c_step) {
      const int c = c0 + c_first;
      if (!kWhole && c >= C) break;
      const float zero[2] = {0.f, 0.f};
      for (int s = 0; s < RD; ++s) {
        sts<CP>(acc + (s * TWh + col) * CS + c, zero);
        const int r = q0 - dc + s;
        float v[2] = {0.f, 0.f};
        if (in_image && r >= 0 && r < H)
          load_channels<CP>(x + ((img_row0 + r) * W + gcol) * C + c, v);
        sts<CP>(xring + (s * TWh + col) * CS + c, v);
      }
    }
  }
  __syncthreads();

  int sx = dc;             // x-ring slot of row q
  int sa = q0 - h0 + dc;   // dx-ring slot of row q
  for (int q = q0; q < h1 + dc; ++q) {
    const bool produce = q < H;
    const bool consume = q >= h0 && q < h1;
    const int64_t pix = (img_row0 + q) * W + gcol;
    if (produce) {
      const int xrow = q + dc + 1;
      const bool load_x = in_image && xrow < H;
      const T* x_new = x + ((img_row0 + xrow) * W + gcol) * C;
      float* xs_new = xring + (wrap(sx + dc + 1, XD) * TWh + col) * CS;
      // x-ring offsets of the taps of f_k for this thread's column
      int lo_off[kMaxBanks], hi_off[kMaxBanks];
#pragma unroll
      for (int k = 0; k < kMaxBanks; ++k) {
        int dy, dxx;
        bank_offset(k, dc, &dy, &dxx);
        lo_off[k] = (wrap(sx - dy, XD) * TWh + col - dxx) * CS;
        hi_off[k] = (wrap(sx + dy, XD) * TWh + col + dxx) * CS;
      }
      const int c_off = (sx * TWh + col) * CS;
      const bool next_row = q + 1 < H && q + 1 < h1 + dc;

      for (int r0 = 0; r0 < R; r0 += kChunk) {
        float av[kMaxBanks][kChunk];
#pragma unroll
        for (int k = 0; k < kMaxBanks; ++k) {
#pragma unroll
          for (int j = 0; j < kChunk; ++j) av[k][j] = 0.f;
          if (k < K && in_image)
            load_ranks<T, kMain>(a + pix * KR + k * R, r0, R, av[k]);
        }
        if (kMain && next_row && in_image && t < 2)
          prefetch_l2(a + (pix + W) * KR + t * (KR / 2));
        float da[kMaxBanks][kChunk];
#pragma unroll
        for (int k = 0; k < kMaxBanks; ++k)
#pragma unroll
          for (int j = 0; j < kChunk; ++j) da[k][j] = 0.f;

        if (active) {
          // kBatch steps at a time: every load of the batch is started
          // before the first use, so one round trip to device memory is
          // waited for, not one per channel
#pragma unroll 1
          for (int cb0 = 0; cb0 < C; cb0 += c_step * kBatch) {
            const int cb = cb0 + c_first;
            float gv[kBatch][CP], xv[kBatch][CP], bv[kBatch][CP][kChunk];
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
              const int c = cb + i * c_step;
#pragma unroll
              for (int e = 0; e < CP; ++e) {
                gv[i][e] = 0.f;
                xv[i][e] = 0.f;
#pragma unroll
                for (int j = 0; j < kChunk; ++j) bv[i][e][j] = 0.f;
              }
              if ((kWhole || c < C) && in_image) {
                load_channels<CP>(g + pix * C + c, gv[i]);
                load_ranks_of<T, kMain>(b + (pix * C + c) * R, r0, R, bv[i]);
                if (r0 == 0 && load_x) load_channels<CP>(x_new + c, xv[i]);
                if (kMain && next_row) {
                  prefetch_l2(g + (pix + W) * C + c);
                  prefetch_l2(b + ((pix + W) * C + c) * R);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
              const int c = cb + i * c_step;
              if (!kWhole && c >= C) break;
              // g B[c, r]: P_k and dA are both sums over it
              float gb[CP][kChunk];
#pragma unroll
              for (int e = 0; e < CP; ++e)
#pragma unroll
                for (int j = 0; j < kChunk; ++j)
                  gb[e][j] = gv[i][e] * bv[i][e][j];
              if (r0 == 0) {
                float pv[kMaxBanks][CP];  // P_k = sum_r A[k, r] g B[c, r]
#pragma unroll
                for (int k = 0; k < kMaxBanks; ++k)
#pragma unroll
                  for (int e = 0; e < CP; ++e) {
                    pv[k][e] = 0.f;
#pragma unroll
                    for (int j = 0; j < kChunk; ++j)
                      pv[k][e] += av[k][j] * gb[e][j];
                  }
                if (!kMain) {  // the ranks beyond the first pass (CP = 1)
                  for (int r1 = kChunk; r1 < R && in_image; r1 += kChunk) {
                    float b2[kChunk], a2[kChunk];
                    load_ranks<T, false>(b + (pix * C + c) * R, r1, R, b2);
#pragma unroll
                    for (int k = 0; k < kMaxBanks; ++k) {
                      if (k < K) {
                        load_ranks<T, false>(a + pix * KR + k * R, r1, R, a2);
#pragma unroll
                        for (int j = 0; j < kChunk; ++j)
                          pv[k][0] += a2[j] * (gv[i][0] * b2[j]);
                      }
                    }
                  }
                }
#pragma unroll
                for (int k = 0; k < kMaxBanks; ++k)
                  if (k < K) sts<CP>(prow + col * PS + k * C + c, pv[k]);
                // the slot being filled is read by nobody in this iteration
                sts<CP>(xs_new + c, xv[i]);
              }
              if (consume && own) {
                // f[k] is three times f_k; the third goes into g for dB and
                // into dA after its sum
                float centre[CP], f[kMaxBanks][CP], g3[CP];
                lds<CP>(xring + c_off + c, centre);
#pragma unroll
                for (int k = 0; k < kMaxBanks; ++k) {
                  float lo[CP], hi[CP];
#pragma unroll
                  for (int e = 0; e < CP; ++e) f[k][e] = 0.f;
                  if (k < K) {
                    lds<CP>(xring + lo_off[k] + c, lo);
                    lds<CP>(xring + hi_off[k] + c, hi);
#pragma unroll
                    for (int e = 0; e < CP; ++e)
                      f[k][e] = lo[e] + centre[e] + hi[e];
                  }
                }
                float db[CP][kChunk];
#pragma unroll
                for (int e = 0; e < CP; ++e) {
                  g3[e] = gv[i][e] * (1.0f / 3.0f);
#pragma unroll
                  for (int j = 0; j < kChunk; ++j) {
                    float sum = 0.f;
#pragma unroll
                    for (int k = 0; k < kMaxBanks; ++k)
                      sum += f[k][e] * av[k][j];
                    db[e][j] = g3[e] * sum;
                  }
#pragma unroll
                  for (int k = 0; k < kMaxBanks; ++k)
#pragma unroll
                    for (int j = 0; j < kChunk; ++j)
                      da[k][j] += f[k][e] * gb[e][j];
                }
                store_ranks_of<T, kMain>(dB + (pix * C + c) * R, r0, R, db);
              }
            }
          }
        }
        if (consume) {  // block-uniform: whole warps take the shuffles
          // The pixel's eight lanes add their sums while they halve what each
          // keeps: the lanes with bit 2 set keep banks 4..7 and hand over
          // 0..3, then bit 1 and bit 0 likewise, so lane t ends with bank t
          // summed over all eight, in an order fixed by t.
          float half[kMaxBanks / 2][kChunk], quarter[kMaxBanks / 4][kChunk];
          float mine[kChunk];
#pragma unroll
          for (int k = 0; k < kMaxBanks / 2; ++k)
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const float lo = da[k][j], hi = da[k + kMaxBanks / 2][j];
              half[k][j] = ((t & 4) ? hi : lo) +
                           __shfl_xor_sync(0xffffffffu, (t & 4) ? lo : hi, 4);
            }
#pragma unroll
          for (int k = 0; k < kMaxBanks / 4; ++k)
#pragma unroll
            for (int j = 0; j < kChunk; ++j) {
              const float lo = half[k][j], hi = half[k + kMaxBanks / 4][j];
              quarter[k][j] = ((t & 2) ? hi : lo) + __shfl_xor_sync(
                                  0xffffffffu, (t & 2) ? lo : hi, 2);
            }
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const float lo = quarter[0][j], hi = quarter[1][j];
            mine[j] = (((t & 1) ? hi : lo) +
                       __shfl_xor_sync(0xffffffffu, (t & 1) ? lo : hi, 1)) *
                      (1.0f / 3.0f);
          }
          if (own && t < K)
            store_ranks<T, kMain>(dA + pix * KR + t * R, r0, R, mine);
        }
      }
    }
    __syncthreads();  // the row's P_k is in shared memory

    if (own) {
      // Row q feeds dx rows q, q +- 1 and q +- dc. Row q + dc gets its first
      // contribution here, so its slot is stored, not added to (the rows
      // q0 .. q0 + dc - 1, which no row q - dc precedes, start from the
      // prologue's zeros); row q - dc gets its last and leaves. A target
      // outside the segment lands in a slot that is free (its row has left,
      // or will be stored afresh), so nothing here branches on the target.
      // The order of the five accesses holds for dc = 1, where the +-1 and
      // +-dc slots coincide.
      const int r_done = q - dc;
      const bool flush = r_done >= h0;  // then r_done < h1 by the loop bound
      float* acc_mid = acc + (sa * TWh + col) * CS;
      float* acc_up1 = acc + (wrap(sa + 1, RD) * TWh + col) * CS;
      float* acc_dn1 = acc + (wrap(sa - 1, RD) * TWh + col) * CS;
      float* acc_upd = acc + (wrap(sa + dc, RD) * TWh + col) * CS;
      float* acc_dnd = acc + (wrap(sa - dc, RD) * TWh + col) * CS;
      T* dx_row = dx + ((img_row0 + r_done) * W + gcol) * C;
#pragma unroll 3
      for (int c0 = 0; c0 < C; c0 += c_step) {
        const int c = c0 + c_first;
        if (!kWhole && c >= C) break;
        float mid[CP], up1[CP], dn1[CP], upd[CP], dnd[CP];
#pragma unroll
        for (int e = 0; e < CP; ++e)
          mid[e] = up1[e] = dn1[e] = upd[e] = dnd[e] = 0.f;
        if (produce) {
          const float* p = prow + col * PS + c;
#pragma unroll
          for (int k = 0; k < kMaxBanks; ++k) {
            if (k < K) {
              int dy, dxx;
              bank_offset(k, dc, &dy, &dxx);
              const float* pk = p + k * C;
              // row q is p - delta_k of target q + dy and p + delta_k of
              // target q - dy
              float here[CP], from_lo[CP], from_hi[CP];
              lds<CP>(pk, here);
              lds<CP>(pk - dxx * PS, from_lo);
              lds<CP>(pk + dxx * PS, from_hi);
#pragma unroll
              for (int e = 0; e < CP; ++e) {
                mid[e] += here[e];
                if (dy == 0) {
                  mid[e] += from_lo[e] + from_hi[e];
                } else if (k & 1) {
                  upd[e] += from_lo[e];
                  dnd[e] += from_hi[e];
                } else {
                  up1[e] += from_lo[e];
                  dn1[e] += from_hi[e];
                }
              }
            }
          }
        }
        float old[CP];
        sts<CP>(acc_upd + c, upd);
        lds<CP>(acc_mid + c, old);
#pragma unroll
        for (int e = 0; e < CP; ++e) mid[e] += old[e];
        sts<CP>(acc_mid + c, mid);
        lds<CP>(acc_up1 + c, old);
#pragma unroll
        for (int e = 0; e < CP; ++e) up1[e] += old[e];
        sts<CP>(acc_up1 + c, up1);
        lds<CP>(acc_dn1 + c, old);
#pragma unroll
        for (int e = 0; e < CP; ++e) dn1[e] += old[e];
        sts<CP>(acc_dn1 + c, dn1);
        if (flush) {
          lds<CP>(acc_dnd + c, old);
#pragma unroll
          for (int e = 0; e < CP; ++e)
            old[e] = (old[e] + dnd[e]) * (1.0f / 3.0f);
          store_channels<CP>(dx_row + c, old);
        }
      }
    }
    __syncthreads();  // P row free again, the new x row visible
    sx = wrap(sx + 1, XD);
    sa = wrap(sa + 1, RD);
  }
}

template <typename T, bool kMain, int kC>
int launch_kernel(const void* x, const void* g, const void* a, const void* b,
                  void* dx, void* dA, void* dB, const Tile& tile,
                  int64_t blocks, int threads, size_t shared,
                  cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      bank_mix_bwd_kernel<T, kMain, kC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bank_mix_bwd_kernel<T, kMain, kC>
      <<<static_cast<unsigned>(blocks), threads, shared, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(g),
          static_cast<const T*>(a), static_cast<const T*>(b),
          static_cast<T*>(dx), static_cast<T*>(dA), static_cast<T*>(dB),
          tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* g, const void* a, const void* b,
           void* dx, void* dA, void* dB, int B, int H, int W, int C, int nd,
           int R, int dc, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (B < 0 || H < 0 || W < 0 || C < 0 || nd < 1 || 2 * nd > kMaxBanks ||
      R < 1 || dc < 1 || 2 * dc + 1 > kMaxThreads / kLanes)
    return static_cast<int>(cudaErrorInvalidValue);
  Tile tile;
  tile.H = H; tile.W = W; tile.C = C; tile.K = 2 * nd; tile.R = R;
  tile.dc = dc;
  const int64_t kc = static_cast<int64_t>(tile.K) * C;
  if (kc > (1 << 20)) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t quads = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(dA) |
                          reinterpret_cast<uintptr_t>(dB);
  const uintptr_t pairs = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(dx);
  const bool main_path = R == kChunk && tile.K == kMaxBanks && C % 2 == 0 &&
                         quads % (kChunk * sizeof(T)) == 0 &&
                         pairs % (2 * sizeof(T)) == 0;
  // a warp holds four pixel columns of eight lanes: one word a lane, the
  // columns 8 (mod 16) words apart; two words a lane, 16 (mod 32) apart
  tile.PS = main_path ? pad_to(kc, 16, 32) : pad_to(kc, 8, 16);
  tile.CS = main_path ? pad_to(C, 16, 32) : pad_to(C, 8, 16);
  const int64_t col_bytes =
      4 * (static_cast<int64_t>(tile.PS) +
           static_cast<int64_t>(4 * dc + 3) * tile.CS);
  int tw = kStrip < W ? kStrip : W;
  while (tw >= 1 && ((tw + 2 * dc) * col_bytes > kMaxSharedBytes ||
                     (tw + 2 * dc) * kLanes > kMaxThreads))
    --tw;
  if (tw < 1) return static_cast<int>(cudaErrorInvalidValue);
  tile.TW = tw;
  tile.TWh = tw + 2 * dc;
  tile.S = kSegment;
  tile.nstrip = (W + tw - 1) / tw;
  tile.nseg = (H + tile.S - 1) / tile.S;
  const int64_t blocks = static_cast<int64_t>(B) * tile.nstrip * tile.nseg;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (tile.TWh * kLanes + 31) / 32 * 32;
  const size_t shared = static_cast<size_t>(tile.TWh * col_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (main_path && C == kModelC)
    return launch_kernel<T, true, kModelC>(x, g, a, b, dx, dA, dB, tile,
                                           blocks, threads, shared, s);
  return main_path ? launch_kernel<T, true, 0>(x, g, a, b, dx, dA, dB, tile,
                                               blocks, threads, shared, s)
                   : launch_kernel<T, false, 0>(x, g, a, b, dx, dA, dB, tile,
                                                blocks, threads, shared, s);
}

}  // namespace

extern "C" int bank_mix_bwd_f32(const void* x, const void* g, const void* a,
                                const void* b, void* dx, void* dA, void* dB,
                                int B, int H, int W, int C, int nd, int R,
                                int dc, void* stream) {
  return launch<float>(x, g, a, b, dx, dA, dB, B, H, W, C, nd, R, dc, stream);
}

extern "C" int bank_mix_bwd_bf16(const void* x, const void* g, const void* a,
                                 const void* b, void* dx, void* dA, void* dB,
                                 int B, int H, int W, int C, int nd, int R,
                                 int dc, void* stream) {
  return launch<__nv_bfloat16>(x, g, a, b, dx, dA, dB, B, H, W, C, nd, R, dc,
                               stream);
}
