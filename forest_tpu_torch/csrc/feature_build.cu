// One FeatureBuilder build in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds features with jnp inside
// its jitted step, where XLA fuses the whole build. The port's composed
// build (data/feature_builder.py before this kernel) made about eight
// elementwise passes per channel, two stacks and a whitening product, some
// 250 launches a build. This kernel does the same arithmetic in one pass:
//
//   for every output row (a pixel, or a pixel at one timestep) and channel c:
//     v      = group[value slot][row, value channel]      (as float32)
//     valid  = isfinite(v) && (no mask || mask[row, mask channel] > 0)
//     v      = transform(v) where in its domain, else NaN; valid &= finite
//     v      = valid ? clamp(rescale((v - off) / scale)) : 0
//   and, for a whitened feature, with fin = valid && isfinite(v),
//     x[row, d] = fin[d] ? clip(sum_c W[d, c] * (fin[c] ? v[c] - mu[c] : 0))
//                        : 0
//   mask[row, c] = valid.
//
// The order of the operations is the composed build's: subtract, then a
// true division (not a product with the reciprocal); the rescale's product
// and sum are rounded one at a time (__fmul_rn, __fadd_rn: no fused
// multiply-add); the whitening sum runs over c in ascending order.
//
// Inputs: up to FB_MAX_GROUPS group tensors of any of ten dtypes, each with
// its own element strides over the output's row dims (0 where a mask is
// broadcast, over T or anything else), and a channel stride. With coords
// (B, N, 2, int32 or int64) the rows are (b, n[, t]) and each group is read
// at (row, col) = coords[b, n] through its H and W strides; a negative
// coordinate counts from the end, as a tensor index does, and one outside
// the grid makes the row invalid (x 0, mask false). The parameter table
// (itab [C, 6] int32, ftab [C, 8] float32, W [C, C] and mu [C] float32) lies
// on the device, built once per feature; layout in ops/feature_build.py.
//
// Bound on this card: bytes. The embedding's batch of 8 (static [8, 256,
// 256, 34] with its mask channel; annual [8, 15, 256, 256, 14] and its mask,
// 13 channels whitened) reads 549 MB and writes 600 MB: 0.34 ms at
// 3.35 TB/s. The whitening product is 2 C^2 FLOPs a row (~2.7 GFLOP there),
// far below the float32 rate.
//
// Design: a block owns 256 consecutive output rows, a thread one row.
//  - The thread turns its row's index into each group's element offset
//    (divisions over the row dims, which the wrapper has merged wherever
//    every group's strides allow: one dim for contiguous groups), reading
//    coords where there are any.
//  - It walks the feature's channels in order, four at a time: the four
//    values and masks are loaded before any is used. Every thread of the
//    block is at the same channel, so the table's fields are broadcasts
//    from shared memory, and a warp's 32 loads of one channel touch the
//    sectors that its next channels read again from L1.
//  - Each result goes to the row's slot in shared memory (rows P = C | 1
//    floats apart: the warp's 32 rows on distinct banks). Whitened with
//    C <= 16 (both benchmark features), the row's centred values stay in
//    registers and each output is a 16-term sum over W's zero-padded row,
//    read as four 16-byte broadcasts; wider, through shared memory.
//  - The block then writes its 256 C outputs and masks in the output's
//    order, neighbouring threads on neighbouring addresses.
//  - The kernel asks for 58 % of the SM's 228 KB as shared memory, so that
//    L1 keeps the rows its warps read channel by channel (without it the
//    34-channel build of the embedding read its rows again from L2).
//
// What it reaches (NVIDIA H100 80GB HBM3, 700 W, random stats and
// covariance, CUDA events over 20 back-to-back builds): the embedding's
// 34-channel type build 0.137-0.138 ms, its whitened 13-channel phase
// build 0.850-0.851 ms (the parent's composed builds 3.8 and 14.7 ms),
// 36 % and 35 % of the bytes bound. The wall is the L1 and shared-memory
// traffic of a thread a row: each warp load of one channel touches 32
// sectors. A layout of lanes over channels (every load coalesced, the
// table in registers, whitening by shuffles) ran 4x slower at 96-156
// registers a thread.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FB_MAX_GROUPS 8
#define FB_MAX_DIMS 6
#define FB_THREADS 256

// Mirrored field for field by ops/feature_build.py (_Group, _Args).
struct FbGroup {
  const void* ptr;
  long long stride[FB_MAX_DIMS];  // element strides over the row dims
  long long sh, sw;               // strides of the grid's rows and cols
  long long sc;                   // stride of the channel
  int dtype;
  int pad;
};

struct FbArgs {
  FbGroup group[FB_MAX_GROUPS];
  long long size[FB_MAX_DIMS];     // the row dims, outermost first
  long long cstride[FB_MAX_DIMS];  // coords' strides over the row dims
  long long cstride_last;          // from a coordinate's row to its col
  long long rows;
  long long h, w;                  // the grid, with coords
  const void* coords;              // null: the full grid
  const int* itab;
  const float* ftab;
  const float* wmat;               // null: not whitened
  const float* mu;
  float* out_x;
  unsigned char* out_m;
  float clip;
  int ndim, n_groups, c, coords_i64;
};

// dtype codes (ops/feature_build.py: DTYPE_CODES)
enum { kF32, kF64, kF16, kBF16, kU8, kI8, kI16, kI32, kI64, kBool };
// transform ids (ops/feature_build.py: TRANSFORM_IDS)
enum { kNone, kLog1p, kLog10, kSqrt, kCbrt, kNeg, kLog };
// normalisation flags
enum { kAffine = 1, kRescale = 2, kLo = 4, kHi = 8 };

__device__ __forceinline__ float load_as_float(const void* p, int dtype,
                                               long long i) {
  switch (dtype) {
    case kF32: return __ldg(static_cast<const float*>(p) + i);
    case kF64: return (float)__ldg(static_cast<const double*>(p) + i);
    case kF16: return __half2float(__ldg(static_cast<const __half*>(p) + i));
    case kBF16:
      return __bfloat162float(
          __ldg(static_cast<const __nv_bfloat16*>(p) + i));
    case kU8: return (float)__ldg(static_cast<const unsigned char*>(p) + i);
    case kI8: return (float)__ldg(static_cast<const signed char*>(p) + i);
    case kI16: return (float)__ldg(static_cast<const short*>(p) + i);
    case kI32: return (float)__ldg(static_cast<const int*>(p) + i);
    case kI64: return (float)__ldg(static_cast<const long long*>(p) + i);
    default:
      return __ldg(static_cast<const unsigned char*>(p) + i) ? 1.f : 0.f;
  }
}

// apply_transform: out of the domain -> NaN
__device__ __forceinline__ float transform(int id, float v, float eps) {
  bool ok = isfinite(v);
  switch (id) {
    case kLog1p: ok = ok && v > -1.f; return ok ? log1pf(v) : NAN;
    case kLog10: ok = ok && v > 0.f; return ok ? log10f(v) : NAN;
    case kSqrt: ok = ok && v >= 0.f; return ok ? sqrtf(v) : NAN;
    case kCbrt: {  // sign(x) * |x| ** (1/3), as the plain version
      if (!ok) return NAN;
      const float a = powf(fabsf(v), 1.0f / 3.0f);
      return (v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f)) * a;
    }
    case kNeg: return ok ? -v : NAN;
    case kLog: ok = ok && v > -eps; return ok ? logf(v + eps) : NAN;
    default: return ok ? v : NAN;
  }
}

// How a block whitens: not at all, with its row in registers (C <= 16),
// or through shared memory (C up to MAX_WHITENED_CHANNELS).
enum { kPlain, kWhitenSmall, kWhitenWide };
constexpr int kSmallC = 16;

// Shared memory of a block, in this order: the table (itab as [C][8] int,
// ftab [C][8] float), each group's row offsets [G][FB_THREADS] (8 bytes
// each), W [C][C] (kWhitenSmall: rows padded to 16) and mu [C] where
// whitened, the staged x [FB_THREADS][P] (float; P = C rounded up to an
// odd number, so that a warp's rows fall on distinct banks), the staged
// masks [FB_THREADS][P] (bytes), and for kWhitenWide the whitened rows
// [FB_THREADS][P] (float).
__host__ __device__ inline int pad_odd(int c) { return c | 1; }

__host__ __device__ inline size_t smem_bytes(int c, int g, int mode) {
  const size_t p = pad_odd(c);
  size_t b = 64 * (size_t)c + 8 * (size_t)g * FB_THREADS;
  if (mode == kWhitenSmall) b += 4 * ((size_t)c * kSmallC + c);
  if (mode == kWhitenWide) b += 4 * ((size_t)c * c + c);
  b += 4 * p * FB_THREADS;                        // x
  if (mode == kWhitenWide) b += 4 * p * FB_THREADS;
  return b + p * FB_THREADS;                      // masks
}

template <int kMode>
__global__ void __launch_bounds__(FB_THREADS)
feature_build_kernel(const FbArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.c, G = a.n_groups, P = pad_odd(C);
  int* s_itab = reinterpret_cast<int*>(smem);                 // [C][8]
  float* s_ftab = reinterpret_cast<float*>(s_itab + 8 * C);   // [C][8]
  long long* s_off = reinterpret_cast<long long*>(s_ftab + 8 * C);
  float* s_w = reinterpret_cast<float*>(s_off + G * FB_THREADS);
  float* s_mu = s_w + C * (kMode == kWhitenSmall ? kSmallC : C);
  float* s_x = kMode == kPlain ? s_w : s_mu + C;              // [TR][P]
  float* s_y = s_x + P * FB_THREADS;                          // wide only
  unsigned char* s_m = reinterpret_cast<unsigned char*>(
      kMode == kWhitenWide ? s_y + P * FB_THREADS : s_x + P * FB_THREADS);

  // the groups' fields that the channel loop indexes by slot, taken out of
  // the parameter space with constant indices
  __shared__ const void* s_ptr[FB_MAX_GROUPS];
  __shared__ long long s_sc[FB_MAX_GROUPS];
  __shared__ int s_dtype[FB_MAX_GROUPS];

  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * FB_THREADS;
  const int nrows = (int)min((long long)FB_THREADS, a.rows - row0);

#pragma unroll
  for (int g = 0; g < FB_MAX_GROUPS; ++g) {
    if (t == g) {
      s_ptr[g] = a.group[g].ptr;
      s_sc[g] = a.group[g].sc;
      s_dtype[g] = a.group[g].dtype;
    }
  }
  for (int i = t; i < 6 * C; i += FB_THREADS)
    s_itab[(i / 6) * 8 + i % 6] = a.itab[i];
  for (int i = t; i < 8 * C; i += FB_THREADS) s_ftab[i] = a.ftab[i];
  if (kMode == kWhitenSmall) {  // W's rows zero-padded to 16
    for (int i = t; i < C * kSmallC; i += FB_THREADS) {
      const int d = i / kSmallC, c = i - d * kSmallC;
      s_w[i] = c < C ? a.wmat[d * C + c] : 0.f;
    }
  } else if (kMode == kWhitenWide) {
    for (int i = t; i < C * C; i += FB_THREADS) s_w[i] = a.wmat[i];
  }
  if (kMode != kPlain)
    for (int i = t; i < C; i += FB_THREADS) s_mu[i] = a.mu[i];

  // this thread's row: its index over the row dims, then each group's
  // offset (every loop unrolled, so that nothing is indexed at run time)
  bool ok = t < nrows;
  if (ok) {
    long long q[FB_MAX_DIMS];
    if (a.rows <= 0x7fffffffLL) {  // 32-bit divisions where they suffice
      unsigned idx = (unsigned)(row0 + t);
#pragma unroll
      for (int d = FB_MAX_DIMS - 1; d >= 0; --d) {
        q[d] = 0;
        if (d < a.ndim) {
          q[d] = idx % (unsigned)a.size[d];
          idx /= (unsigned)a.size[d];
        }
      }
    } else {
      long long idx = row0 + t;
#pragma unroll
      for (int d = FB_MAX_DIMS - 1; d >= 0; --d) {
        q[d] = 0;
        if (d < a.ndim) {
          q[d] = idx % a.size[d];
          idx /= a.size[d];
        }
      }
    }
    long long y = 0, x = 0;
    if (a.coords != nullptr) {
      long long coff = 0;
#pragma unroll
      for (int d = 0; d < FB_MAX_DIMS; ++d) coff += q[d] * a.cstride[d];
      if (a.coords_i64) {
        const long long* cp = static_cast<const long long*>(a.coords);
        y = cp[coff];
        x = cp[coff + a.cstride_last];
      } else {
        const int* cp = static_cast<const int*>(a.coords);
        y = cp[coff];
        x = cp[coff + a.cstride_last];
      }
      if (y < 0) y += a.h;
      if (x < 0) x += a.w;
      if (y < 0 || y >= a.h || x < 0 || x >= a.w) {
        ok = false;
        y = x = 0;
      }
    }
#pragma unroll
    for (int g = 0; g < FB_MAX_GROUPS; ++g) {
      if (g < G) {
        long long off = y * a.group[g].sh + x * a.group[g].sw;
#pragma unroll
        for (int d = 0; d < FB_MAX_DIMS; ++d)
          off += q[d] * a.group[g].stride[d];
        s_off[g * FB_THREADS + t] = off;
      }
    }
  }
  __syncthreads();

  // The channels of the row, kChunk at a time, the same channel in every
  // thread of the block: the chunk's loads are all issued before any is
  // used; the table's fields are the same across the warp (broadcasts).
  // -> x (normalised, 0 where invalid) and valid, channels c0 .. c0 + 3.
  constexpr int kChunk = 4;
  auto chunk = [&](int c0, float (&x)[kChunk], bool (&valid)[kChunk]) {
    float m[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = c0 + k;
      x[k] = NAN;
      m[k] = 1.f;
      if (ok && c < C) {
        const int4 it = *reinterpret_cast<const int4*>(s_itab + 8 * c);
        x[k] = load_as_float(s_ptr[it.x], s_dtype[it.x],
                             s_off[it.x * FB_THREADS + t] + it.y * s_sc[it.x]);
        if (it.z >= 0)
          m[k] = load_as_float(s_ptr[it.z], s_dtype[it.z],
                               s_off[it.z * FB_THREADS + t] +
                                   it.w * s_sc[it.z]);
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int c = min(c0 + k, C - 1);
      const int2 tf = *reinterpret_cast<const int2*>(s_itab + 8 * c + 4);
      const float4 f0 = *reinterpret_cast<const float4*>(s_ftab + 8 * c);
      const float4 f1 = *reinterpret_cast<const float4*>(s_ftab + 8 * c + 4);
      valid[k] = isfinite(x[k]) && m[k] > 0.f;
      if (valid[k] && tf.x != kNone) {
        x[k] = transform(tf.x, x[k], f0.x);
        valid[k] = isfinite(x[k]);
      }
      if (valid[k]) {
        if (tf.y & kAffine) x[k] = __fdiv_rn(__fsub_rn(x[k], f0.y), f0.z);
        if (tf.y & kRescale) x[k] = __fadd_rn(__fmul_rn(x[k], f0.w), f1.x);
        if ((tf.y & kLo) && x[k] < f1.y) x[k] = f1.y;
        if ((tf.y & kHi) && x[k] > f1.z) x[k] = f1.z;
      } else {
        x[k] = 0.f;
      }
    }
  };
  float* xrow = s_x + t * P;
  unsigned char* mrow = s_m + t * P;
  float x[kChunk];
  bool valid[kChunk];
  if (kMode == kWhitenSmall) {
    // the row's centred values in registers; whitened from W's rows of
    // 16 (zero-padded) read as four 16-byte broadcasts:
    // x[d] = fin[d] ? clip(sum_c W[d, c] xc[c]) : 0, c ascending
    float xc[kSmallC];
    unsigned fin_bits = 0, valid_bits = 0;
#pragma unroll
    for (int c0 = 0; c0 < kSmallC; c0 += kChunk) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) xc[c0 + k] = 0.f;
      if (c0 < C) {
        chunk(c0, x, valid);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int c = c0 + k;
          const bool fin = c < C && valid[k] && isfinite(x[k]);
          xc[c] = fin ? __fsub_rn(x[k], s_mu[min(c, C - 1)]) : 0.f;
          fin_bits |= (unsigned)fin << c;
          valid_bits |= (unsigned)(c < C && valid[k]) << c;
        }
      }
    }
    for (int d = 0; d < C; ++d) {
      const float4* wd = reinterpret_cast<const float4*>(s_w + d * kSmallC);
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kSmallC / 4; ++j) {
        const float4 w4 = wd[j];
        acc = fmaf(xc[4 * j], w4.x, acc);
        acc = fmaf(xc[4 * j + 1], w4.y, acc);
        acc = fmaf(xc[4 * j + 2], w4.z, acc);
        acc = fmaf(xc[4 * j + 3], w4.w, acc);
      }
      acc = acc < -a.clip ? -a.clip : (acc > a.clip ? a.clip : acc);
      xrow[d] = (fin_bits >> d) & 1 ? acc : 0.f;
      mrow[d] = (valid_bits >> d) & 1;
    }
  } else {
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      chunk(c0, x, valid);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int c = c0 + k;
        if (c < C) {
          if (kMode == kPlain) {
            xrow[c] = x[k];
            mrow[c] = valid[k];
          } else {  // the centred value, and whether it is finite
            const bool fin = valid[k] && isfinite(x[k]);
            xrow[c] = fin ? __fsub_rn(x[k], s_mu[c]) : 0.f;
            mrow[c] = valid[k] | (fin << 1);
          }
        }
      }
    }
    if (kMode == kWhitenWide) {
      // x[d] = fin[d] ? clip(sum_c W[d, c] xc[c]) : 0, c ascending
      float* yrow = s_y + t * P;
      for (int d = 0; d < C; ++d) {
        const float* wd = s_w + d * C;
        float acc = 0.f;
        for (int c = 0; c < C; ++c) acc = fmaf(xrow[c], wd[c], acc);
        acc = acc < -a.clip ? -a.clip : (acc > a.clip ? a.clip : acc);
        yrow[d] = (mrow[d] & 2) ? acc : 0.f;
      }
    }
  }
  __syncthreads();

  // the tile out, in the output's order: thread t writes elements t,
  // t + FB_THREADS, ... of the tile's nrows * C, (row, channel) stepped
  // without a division
  const float* out_src = kMode == kWhitenWide ? s_y : s_x;
  const int n = nrows * C;
  const long long out0 = row0 * C;
  const int dr = FB_THREADS / C, dc = FB_THREADS - dr * C;
  int r = t / C, c = t - r * C;
  for (int e = t; e < n; e += FB_THREADS) {
    a.out_x[out0 + e] = out_src[r * P + c];
    a.out_m[out0 + e] = s_m[r * P + c] & 1;
    c += dc;
    r += dr;
    if (c >= C) {
      c -= C;
      ++r;
    }
  }
}

// the shared memory an SM sets aside, in % of 228 KB: L1 keeps the rest
#define FB_CARVEOUT 58

template <int kMode>
static int launch(const FbArgs& a, size_t smem, cudaStream_t s) {
  // the function's attributes, set once a device: the carveout, and the
  // shared memory raised to what a call needs
  static bool carved[64];
  static size_t allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!carved[dev]) {
    err = cudaFuncSetAttribute(feature_build_kernel<kMode>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               FB_CARVEOUT);
    if (err != cudaSuccess) return (int)err;
    carved[dev] = true;
  }
  if (smem > 48 * 1024 && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(feature_build_kernel<kMode>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  const long long blocks = (a.rows + FB_THREADS - 1) / FB_THREADS;
  feature_build_kernel<kMode><<<(unsigned)blocks, FB_THREADS, smem, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" {

int sizeof_args(void) { return (int)sizeof(FbArgs); }

// -> a cudaError_t: 0, or why the launch was refused
int feature_build(const FbArgs* args, void* stream) {
  const FbArgs a = *args;
  if (a.rows <= 0) return 0;
  if ((a.rows + FB_THREADS - 1) / FB_THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  const int mode = a.wmat == nullptr ? kPlain
                   : (a.c <= kSmallC ? kWhitenSmall : kWhitenWide);
  const size_t smem = smem_bytes(a.c, a.n_groups, mode);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kPlain: return launch<kPlain>(a, smem, s);
    case kWhitenSmall: return launch<kWhitenSmall>(a, smem, s);
    default: return launch<kWhitenWide>(a, smem, s);
  }
}

}  // extern "C"
