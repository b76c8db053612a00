// Fused directional bank + rank-R mixing, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in forest_tpu/ops/smoothing.py
// (reached through bank_mix -> _bank_mix_pallas -> _pallas_fwd_call). Per
// pixel p = (b, h, w) and channel c:
//
//   out[p, c] = sum_k f_k[p, c] * sum_r A[p, k, r] * B[p, c, r]
//
// where f_k is the mean of three taps of x along direction d = k / 2
// ((0,1), (1,0), (1,1), (1,-1)) at dilation 1 (k even) or `dc` (k odd),
// with zeros outside the image. Layout is NHWC for x / out, [B,H,W,K,R] for
// A and [B,H,W,C,R] for B, all contiguous; the TPU kernel's [rows, C, W]
// relayout existed only to fill TPU lanes and has no counterpart here. The
// sum is taken r-outer, sum_r B[c,r] (sum_k f_k A[k,r]), in float32 for
// float32 and bfloat16 I/O, and rounded once at the store.
//
// Bound on this card: bytes. Per pixel C + K R + C R values are read and C
// written: 320 at C = 48, K = 8, R = 4, so at [8,256,256,48] 0.67 GB in f32
// (0.200 ms at 3.35 TB/s) and 0.34 GB in bf16 (0.100 ms), against ~60
// float32 operations an element, far below the ridge. B is 60 % of the
// bytes, x 15 %, A 10 %.
//
// Design: every byte leaves device memory once, with few instructions. A
// block owns a strip of TW = 32 pixel columns (plus dc halo columns on each
// side) and a segment of S = 32 rows of one image, and walks down the rows.
// x lives in a ring of 2 dc + 2 rows of the strip in shared memory: the rows
// q - dc .. q + dc that row q's 17 taps read, and row q + dc + 1, which is
// copied in with `cp.async` (16-byte chunks where C allows) while row q is
// computed; one barrier a row. x thus leaves device memory once per strip
// and segment, apart from the halo (1.19x in columns, 1.19x in rows at
// dc = 3). A 2-D tile with a halo on all four sides would re-read more of x
// for the same shared memory and need a barrier per tile, not per row; the
// ring is the one K2 (bank_mix_bwd.cu) keeps. Eight lanes share a pixel; on
// the main path (R = 4, K = 8, C even, aligned pointers) lane t takes the
// channel pairs {2t, 2t + 1}, {2t + 16, 2t + 17}, ... At row q a lane
//  - loads the pixel's K R = 32 values of A with 16-byte loads (8 in f32, 4
//    in bf16) straight into registers: the pixel's eight lanes ask for the
//    same lines, which L1 serves as one (A read once per pixel, not once per
//    channel);
//  - loads B[p, c, 0:4] of its channels with 16-byte loads (a channel pair is
//    two loads in f32, one in bf16), all of a batch of three pairs started
//    before the first use;
//  - reads the 17 taps of a channel pair from the ring with one 8-byte (f32)
//    or 4-byte (bf16) shared load each, forms f_k and the sum, and stores the
//    pair with one vector store.
// Asking L2 for the next row's A and B ahead (prefetch.global.L2, as K2
// does) made f32 10 % slower and bf16 no faster here: left out.
// Where C is 48, the shipped model's z_type width, the kernel is compiled
// with C as a constant, as K2 is. Any other even C takes the same vector
// path with C read at run time; any other R, K or an odd C a scalar path in
// the same kernel (one channel a lane step, A and B read as scalars), chosen
// in the C function. The ring is padded so that the lanes of a warp fall in
// distinct banks: four pixel columns of eight lanes a warp, the column
// stride 16 (mod 32) words in f32 (two words a lane, a half-warp at a time)
// and 8 (mod 16) words in bf16 (one word a lane).
// No atomics: two runs give the same bits.
//
// What holds it back (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py):
// [8,256,256,48] f32 0.27 ms, bf16 0.19-0.21 ms, [12,256,256,48] bf16
// 0.26-0.30 ms: 1.35x, 1.9-2.1x and 1.8-2.0x the bounds (0.79, 0.83 and
// 1.16 ms before this design). The main path holds 120-128 registers a
// thread, so two blocks of eight warps share an SM; A and B come straight
// into registers at the start of a row, where the block's warps wait
// together, and bf16, which halves the bytes but not the instructions,
// reaches half its bound. Capping the registers for three or four blocks
// an SM (80 or 64) spills and is 1.2-3x slower; strips of 16 columns and
// segments of 16 or 64 rows change nothing beyond 3 %. Nearer the bound
// needs the next row's A and B copied to shared memory asynchronously, so
// that no registers wait.
//
// Limits (cudaErrorInvalidValue otherwise): num_directions 1..4, R >= 1,
// dc >= 1, and a strip of at least one column with its halo must fit
// 232,448 bytes of shared memory:
// (2 dc + 2) * (1 + 2 dc) * pad(C) * sizeof(T) <= 232,448, pad(C) being C
// rounded up to 8 (mod 16) elements (to 16 (mod 32) words in f32 and
// 8 (mod 16) words in bf16 on the main path); and B * ceil(W / TW) *
// ceil(H / S) < 2^31 blocks.
//
// C interface (loaded with ctypes): every pointer and the stream is a
// void*, the function launches the one kernel on `stream`, never
// synchronises, allocates nothing, and returns cudaGetLastError() after the
// launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBanks = 8;  // K = 2 * num_directions, num_directions <= 4
constexpr int kLanes = 8;     // threads per pixel column
constexpr int kRanks = 4;     // R of the main path
constexpr int kBatch = 3;     // channel steps whose B loads start together
constexpr int kStrip = 32;    // TW: own pixel columns of a strip, at most
constexpr int kSegment = 32;  // S: rows of a segment
constexpr int kThreads = kStrip * kLanes;
constexpr int kMaxSharedBytes = 232448;
constexpr int kModelC = 48;  // z_type of the shipped model: C at compile time

struct Tile {
  int H, W, C, K, R, dc;
  int TW, TWh, S, CS, XD;  // CS: padded C in elements; XD: ring rows
  int nstrip, nseg;
  int copy_bytes;          // 16 or 4: cp.async chunk; 0: element by element
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

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned packed;  // one rounding each, hi in the upper half
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(packed) : "f"(hi), "f"(lo));
  return packed;
}

// (dy, dx) of bank k: direction k / 2 at dilation 1 (k even) or dc (k odd)
__device__ __forceinline__ void bank_offset(int k, int dc, int* dy, int* dx) {
  const int d = k >> 1;
  const int delta = (k & 1) ? dc : 1;
  *dy = (d == 0 ? 0 : 1) * delta;
  *dx = (d == 1 ? 0 : (d == 3 ? -1 : 1)) * delta;
}

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Row r of image `img` into ring slot `slot`: the strip's TWh columns, zeros
// outside the image. Every thread of the block takes part.
template <typename T, int kC>
__device__ __forceinline__ void stage_row(const T* __restrict__ x, T* ring,
                                          const Tile& tile, int64_t img_row0,
                                          int r, int strip, int slot) {
  const int C = kC > 0 ? kC : tile.C;
  const int vec = tile.copy_bytes > 0
                      ? tile.copy_bytes / static_cast<int>(sizeof(T)) : 1;
  const int per_col = C / vec;
  const int n = tile.TWh * per_col;
  const bool row_in = r >= 0 && r < tile.H;
  T* dst_row = ring + static_cast<int64_t>(slot) * tile.TWh * tile.CS;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const int j = e / per_col;
    const int cc = (e - j * per_col) * vec;
    const int gcol = strip * tile.TW - tile.dc + j;
    T* dst = dst_row + j * tile.CS + cc;
    const bool in = row_in && gcol >= 0 && gcol < tile.W;
    const T* src = x + ((img_row0 + r) * tile.W + gcol) * C + cc;
    if (tile.copy_bytes == 16) {
      if (in) cp_async16(dst, src);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    } else if (tile.copy_bytes == 4) {
      if (in) cp_async4(dst, src);
      else *reinterpret_cast<unsigned*>(dst) = 0u;
    } else {
      *dst = in ? src[0] : from_f32<T>(0.f);
    }
  }
  cp_async_commit();
}

// CP consecutive ring values of one column, as float32
template <int CP>
__device__ __forceinline__ void ring_load(const float* p, float* v) {
  if constexpr (CP == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}
template <int CP>
__device__ __forceinline__ void ring_load(const __nv_bfloat16* p, float* v) {
  if constexpr (CP == 2) {
    const unsigned q = *reinterpret_cast<const unsigned*>(p);
    v[0] = __uint_as_float(q << 16);
    v[1] = __uint_as_float(q & 0xffff0000u);
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

// A[p, 0:8, 0:4] of the main path into av[k][r]
__device__ __forceinline__ void load_a(const float* p, float (*av)[kRanks]) {
#pragma unroll
  for (int k = 0; k < kMaxBanks; ++k) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + k);
    av[k][0] = q.x; av[k][1] = q.y; av[k][2] = q.z; av[k][3] = q.w;
  }
}
__device__ __forceinline__ void unpack8(const uint4 q, float* v) {
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
  v[4] = __uint_as_float(q.z << 16);
  v[5] = __uint_as_float(q.z & 0xffff0000u);
  v[6] = __uint_as_float(q.w << 16);
  v[7] = __uint_as_float(q.w & 0xffff0000u);
}
__device__ __forceinline__ void load_a(const __nv_bfloat16* p,
                                       float (*av)[kRanks]) {
#pragma unroll
  for (int j = 0; j < kMaxBanks / 2; ++j)  // banks 2j and 2j + 1
    unpack8(__ldg(reinterpret_cast<const uint4*>(p) + j), av[2 * j]);
}

// B[p, c:c+2, 0:4] of the main path into bv[e][r]
__device__ __forceinline__ void load_b_pair(const float* p,
                                            float (*bv)[kRanks]) {
  const float4 q0 = __ldg(reinterpret_cast<const float4*>(p));
  const float4 q1 = __ldg(reinterpret_cast<const float4*>(p) + 1);
  bv[0][0] = q0.x; bv[0][1] = q0.y; bv[0][2] = q0.z; bv[0][3] = q0.w;
  bv[1][0] = q1.x; bv[1][1] = q1.y; bv[1][2] = q1.z; bv[1][3] = q1.w;
}
__device__ __forceinline__ void load_b_pair(const __nv_bfloat16* p,
                                            float (*bv)[kRanks]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(p)), bv[0]);
}

__device__ __forceinline__ void store_pair(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
}

// kMain: R = 4, K = 8, C even, every pointer aligned for the vector
// accesses; a lane then takes its channels in pairs. Otherwise R, K and C
// are read at run time and channels go one by one. kC > 0 (with kMain): C is
// kC, known to the compiler.
template <typename T, bool kMain, int kC>
__global__ void __launch_bounds__(kThreads)
bank_mix_fwd_kernel(const T* __restrict__ x, const T* __restrict__ a,
                    const T* __restrict__ b, T* __restrict__ out,
                    const Tile tile) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [XD][TWh][CS]
  constexpr int CP = kMain ? 2 : 1;  // channels a lane takes together
  constexpr int c_step = kLanes * CP;
  // every lane then has a channel at each of its steps below C
  constexpr bool kWhole = kC > 0 && kC % (c_step * kBatch) == 0;
  const int H = tile.H, W = tile.W, dc = tile.dc;
  const int C = kC > 0 ? kC : tile.C;
  const int K = kMain ? kMaxBanks : tile.K;
  const int R = kMain ? kRanks : tile.R;
  const int TWh = tile.TWh, CS = tile.CS, XD = tile.XD;

  const int col = threadIdx.x / kLanes;  // own column of the strip
  const int t = threadIdx.x % kLanes;
  const int strip = blockIdx.x % tile.nstrip;
  const int seg = (blockIdx.x / tile.nstrip) % tile.nseg;
  const int64_t img = blockIdx.x / (tile.nstrip * tile.nseg);
  const int w = strip * tile.TW + col;
  const bool own = col < tile.TW && w < W;
  const int h0 = seg * tile.S;
  const int h1 = min(h0 + tile.S, H);
  const int64_t img_row0 = img * H;
  const int KR = K * R;
  const int c_first = t * CP;

  // prologue: rows h0 - dc .. h0 + dc into slots 0 .. 2 dc
  for (int s = 0; s <= 2 * dc; ++s)
    stage_row<T, kC>(x, ring, tile, img_row0, h0 - dc + s, strip, s);
  cp_async_wait_all();
  __syncthreads();

  int sx = dc;  // ring slot of row q
  for (int q = h0; q < h1; ++q) {
    // row q + dc + 1 into the slot row q - dc - 1 left; nobody reads it now
    if (q + 1 < h1)
      stage_row<T, kC>(x, ring, tile, img_row0, q + dc + 1, strip,
                       wrap(sx + dc + 1, XD));
    if (own) {
      const int64_t pix = (img_row0 + q) * W + w;
      // ring offsets of this column's taps: f_k = (lo + centre + hi) / 3
      const T* centre_p = ring + (sx * TWh + dc + col) * CS;
      int lo_off[kMaxBanks], hi_off[kMaxBanks];
#pragma unroll
      for (int k = 0; k < kMaxBanks; ++k) {
        int dy, dxx;
        bank_offset(k, dc, &dy, &dxx);
        lo_off[k] = (wrap(sx - dy, XD) * TWh + dc + col - dxx) * CS;
        hi_off[k] = (wrap(sx + dy, XD) * TWh + dc + col + dxx) * CS;
      }
      T* const out_p = out + pix * C;
      if constexpr (kMain) {
        float av[kMaxBanks][kRanks];
        load_a(a + pix * KR, av);
#pragma unroll 1
        for (int cb0 = 0; cb0 < C; cb0 += c_step * kBatch) {
          const int cb = cb0 + c_first;
          float bv[kBatch][CP][kRanks];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int c = cb + i * c_step;
            if (kWhole || c < C) load_b_pair(b + (pix * C + c) * kRanks, bv[i]);
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int c = cb + i * c_step;
            if (!kWhole && c >= C) break;
            float centre[CP], f[kMaxBanks][CP];
            ring_load<CP>(centre_p + c, centre);
#pragma unroll
            for (int k = 0; k < kMaxBanks; ++k) {
              float lo[CP], hi[CP];
              ring_load<CP>(ring + lo_off[k] + c, lo);
              ring_load<CP>(ring + hi_off[k] + c, hi);
#pragma unroll
              for (int e = 0; e < CP; ++e)
                f[k][e] = (lo[e] + centre[e] + hi[e]) * (1.0f / 3.0f);
            }
            float acc[CP];
#pragma unroll
            for (int e = 0; e < CP; ++e) {
              acc[e] = 0.f;
#pragma unroll
              for (int r = 0; r < kRanks; ++r) {
                float s = 0.f;
#pragma unroll
                for (int k = 0; k < kMaxBanks; ++k) s += f[k][e] * av[k][r];
                acc[e] += bv[i][e][r] * s;
              }
            }
            store_pair(out_p + c, acc);
          }
        }
      } else {
        const T* a_pix = a + pix * KR;
        for (int c = c_first; c < C; c += c_step) {
          float centre[1], f[kMaxBanks];
          ring_load<1>(centre_p + c, centre);
#pragma unroll
          for (int k = 0; k < kMaxBanks; ++k) {
            f[k] = 0.f;
            if (k < K) {
              float lo[1], hi[1];
              ring_load<1>(ring + lo_off[k] + c, lo);
              ring_load<1>(ring + hi_off[k] + c, hi);
              f[k] = (lo[0] + centre[0] + hi[0]) * (1.0f / 3.0f);
            }
          }
          const T* b_pc = b + (pix * C + c) * R;
          float acc = 0.f;
          for (int r = 0; r < R; ++r) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < kMaxBanks; ++k)
              if (k < K) s += f[k] * to_f32(a_pix[k * R + r]);
            acc += to_f32(b_pc[r]) * s;
          }
          out_p[c] = from_f32<T>(acc);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the new row is in; row q - dc's slot is free
    sx = wrap(sx + 1, XD);
  }
}

// n rounded up to `residue` modulo `modulus`
constexpr int pad_to(int64_t n, int residue, int modulus) {
  return static_cast<int>((n - residue + modulus - 1) / modulus * modulus +
                          residue);
}

template <typename T, bool kMain, int kC>
int launch_kernel(const void* x, const void* a, const void* b, void* out,
                  const Tile& tile, int64_t blocks, int threads,
                  size_t shared, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      bank_mix_fwd_kernel<T, kMain, kC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  bank_mix_fwd_kernel<T, kMain, kC>
      <<<static_cast<unsigned>(blocks), threads, shared, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(a),
          static_cast<const T*>(b), static_cast<T*>(out), tile);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* a, const void* b, void* out, int B,
           int H, int W, int C, int nd, int R, int dc, void* stream) {
  if (B == 0 || H == 0 || W == 0 || C == 0) return 0;
  if (B < 0 || H < 0 || W < 0 || C < 0 || nd < 1 || 2 * nd > kMaxBanks ||
      R < 1 || dc < 1 || dc > (1 << 12))
    return static_cast<int>(cudaErrorInvalidValue);
  Tile tile;
  tile.H = H; tile.W = W; tile.C = C; tile.K = 2 * nd; tile.R = R;
  tile.dc = dc;
  constexpr int esize = static_cast<int>(sizeof(T));
  const uintptr_t quads = reinterpret_cast<uintptr_t>(a) |
                          reinterpret_cast<uintptr_t>(b);
  const bool main_path = R == kRanks && tile.K == kMaxBanks && C % 2 == 0 &&
                         quads % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % (2 * esize) == 0;
  // lanes of a warp in distinct banks (see the header); every column
  // 16-byte aligned for the copies
  if (main_path)
    tile.CS = esize == 4 ? pad_to(C, 16, 32) : 2 * pad_to(C / 2, 8, 16);
  else
    tile.CS = pad_to(C, 8, 16);
  tile.XD = 2 * dc + 2;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const int64_t row_bytes = static_cast<int64_t>(C) * esize;
  tile.copy_bytes = (row_bytes % 16 == 0 && xa % 16 == 0)  ? 16
                    : (row_bytes % 4 == 0 && xa % 4 == 0) ? 4
                                                          : 0;
  const int64_t col_bytes = static_cast<int64_t>(tile.XD) * tile.CS * esize;
  int tw = kStrip < W ? kStrip : W;
  while (tw >= 1 && (tw + 2 * dc) * col_bytes > kMaxSharedBytes) --tw;
  if (tw < 1) return static_cast<int>(cudaErrorInvalidValue);
  tile.TW = tw;
  tile.TWh = tw + 2 * dc;
  tile.S = kSegment;
  tile.nstrip = (W + tw - 1) / tw;
  tile.nseg = (H + tile.S - 1) / tile.S;
  const int64_t blocks = static_cast<int64_t>(B) * tile.nstrip * tile.nseg;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (tw * kLanes + 31) / 32 * 32;
  const size_t shared = static_cast<size_t>(tile.TWh * col_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (main_path && C == kModelC)
    return launch_kernel<T, true, kModelC>(x, a, b, out, tile, blocks,
                                           threads, shared, s);
  return main_path ? launch_kernel<T, true, 0>(x, a, b, out, tile, blocks,
                                               threads, shared, s)
                   : launch_kernel<T, false, 0>(x, a, b, out, tile, blocks,
                                                threads, shared, s);
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
