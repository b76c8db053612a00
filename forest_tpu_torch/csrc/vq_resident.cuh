// The resident-codebook products of the VQ assignment for Hopper (sm_90a),
// shared by vq_assign.cu (K4 vq_core's product runs resident_tile, K5
// vq_assign both products) and vq_variants.cu (K7, the transposed variant
// of the sweep).
//
// Both keep the whole codebook in shared memory and run persistent blocks
// that walk tiles of RES_ROWS = 64 rows of x; the next tile is copied in
// with cp.async while the current one is computed. The index-only launches
// take their block count from the caller (ops.vq.persistent_blocks:
// min(tiles, SMs)); any count >= 1 covers every tile.
// x is read as [N, D] or, with XT, as [D, N] (64 columns of a depth row are
// 256 contiguous bytes in float32).
//
// * resident_tile: float32 operands, the product on the FMA units. A thread
//   keeps 8 rows x 8 codes of a 256-code slab in registers and sums every
//   distance as one fmaf chain in ascending d, so every layout gives the same
//   bits (K4's, K5's and K7's indices agree on finite data). Row-major x
//   gives a thread the rows rg + 8 i and float4 reads along d; [D, N] x gives
//   it the rows 8 rg + i and float4 reads along the rows.
//
// * vq_mma_kernel: operands rounded to bfloat16 (round to nearest even, as
//   torch.Tensor.bfloat16()), the product on the tensor cores with
//   mma.sync.m16n8k16 (float32 accumulation), fragments by ldmatrix. One
//   launch before it forms ||C_k||^2 from the stored codebook and rounds the
//   codebook once; every block copies the rounded codebook into shared
//   memory by cp.async. Each tile of x lands by cp.async as stored (float32
//   or bfloat16, MMA_STAGES tiles in flight) and is rounded into a bfloat16
//   tile, row-major for ldmatrix or, with XT, as [D, 64] for
//   ldmatrix.trans. A warp owns 32 rows x 64 codes of a 256-code slab; each
//   accumulator becomes ||C_k||^2 - 2 acc, compared in ascending code order
//   within a lane, then by (distance, index) across the lanes and warps of a
//   row. A NaN distance is never smaller than anything, so it is never
//   chosen: a row with no comparable distance keeps (+inf, K), which the NaN
//   rule turns into index 0, as +inf for NaN and the lowest index would.
//
// A code past K gets ||C||^2 = +inf on the tensor-core path and is never
// chosen; on the FMA path the padded codes are skipped.
//
// MIN_ONLY (the sweep's argmin = 0, K6): the same products, but each row
// writes its smallest distance converted to int32 by truncation toward zero
// (static_cast, as numpy's / torch's astype(int32)) in place of its index.

#pragma once

#include "vq_tile.cuh"

namespace vq {

constexpr int RES_ROWS = 64;        // rows of x per tile
constexpr int RES_CODES = 256;      // codes per slab
constexpr int RES_THREADS = 256;    // 8 warps
constexpr int RES_STATIC_BYTES = 4096;  // static shared memory, at most
constexpr int MAX_SHARED_BYTES = 232448;
constexpr int MMA_STAGES = 3;       // tiles of x in flight by cp.async
constexpr int MMA_PAD = 8;          // bf16 per row: rows 16 mod 128 bytes apart
constexpr int MMA_XT_LD = RES_ROWS + MMA_PAD;  // [D, 64] tile's row, in bf16

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// float32 padded row length of the resident codebook and x tiles: 4 mod 32
// floats, so that the lanes of a warp read distinct banks
__host__ __device__ inline int res_ld(int D) {
  return D + (4 - D % 32 + 32) % 32;
}
__host__ __device__ inline int res_kp(int K) {
  return (K + RES_CODES - 1) / RES_CODES * RES_CODES;
}
__host__ __device__ inline int mma_dp(int D) { return (D + 15) / 16 * 16; }

// dynamic shared memory of the FMA path: the codebook, two tiles of x
inline int64_t resident_shared_bytes(int D, int K, bool xt) {
  const int64_t tile = xt ? static_cast<int64_t>(D) * RES_ROWS
                          : static_cast<int64_t>(RES_ROWS) * res_ld(D);
  return 4 * (static_cast<int64_t>(res_kp(K)) * res_ld(D) + 2 * tile);
}
// ... of the tensor-core path: the rounded codebook, the rounded tile, the
// landing tiles as stored (esize bytes an element), the code norms
inline int64_t mma_shared_bytes(int D, int K, bool xt, int esize) {
  const int64_t dp = mma_dp(D), kp = res_kp(K);
  const int64_t cbs = kp * (dp + MMA_PAD) * 2;
  const int64_t xa = xt ? dp * MMA_XT_LD * 2 : RES_ROWS * (dp + MMA_PAD) * 2;
  const int64_t land = static_cast<int64_t>(MMA_STAGES) * RES_ROWS * D * esize;
  return cbs + xa + land + 4 * kp;
}
inline bool fits_shared(int64_t bytes) {
  return bytes <= MAX_SHARED_BYTES - RES_STATIC_BYTES;
}

// the codebook into cs [Kp][LD] by cp.async, zeros past K; not committed
__device__ __forceinline__ void stage_codebook(const float* __restrict__ cb,
                                               float* cs, int K, int Kp,
                                               int D, int LD) {
  const int quads = D / 4;
  for (int e = threadIdx.x; e < Kp * quads; e += RES_THREADS) {
    const int code = e / quads, d4 = (e - code * quads) * 4;
    float* dst = cs + code * LD + d4;
    if (code < K)
      cp_async16(dst, cb + static_cast<int64_t>(code) * D + d4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// rows row0 .. row0 + RES_ROWS - 1 of x [N, D] into xs [RES_ROWS][LD]; zeros
// past N; commits a group
__device__ __forceinline__ void stage_rows(const float* __restrict__ x,
                                           float* xs, int64_t row0,
                                           int64_t N, int D, int LD) {
  const int quads = D / 4;
  for (int e = threadIdx.x; e < RES_ROWS * quads; e += RES_THREADS) {
    const int r = e / quads, d4 = (e - r * quads) * 4;
    float* dst = xs + r * LD + d4;
    if (row0 + r < N)
      cp_async16(dst, x + (row0 + r) * D + d4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

// columns col0 .. col0 + RES_ROWS - 1 of xt [D, N] (N a multiple of 4) into
// xs [D][RES_ROWS]; zeros past N; commits a group
__device__ __forceinline__ void stage_cols(const float* __restrict__ xt,
                                           float* xs, int64_t col0,
                                           int64_t N, int D) {
  constexpr int per_row = RES_ROWS / 4;
  for (int e = threadIdx.x; e < D * per_row; e += RES_THREADS) {
    const int d = e / per_row, m4 = (e - d * per_row) * 4;
    float* dst = xs + d * RES_ROWS + m4;
    if (col0 + m4 < N)
      cp_async16(dst, xt + static_cast<int64_t>(d) * N + col0 + m4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  cp_async_commit();
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// One tile of the FMA path: rows row0 .. row0 + RES_ROWS - 1, whose x is in
// xt (row-major [RES_ROWS][LD], or [D][RES_ROWS] with XT), against the
// resident codebook cs [Kp][LD]. A thread keeps 8 rows x 8 codes of a
// 256-code slab in registers: codes cg + 32 j with cg = 8 (warp % 4) +
// lane % 8, rows rg + 8 i (row-major) or 8 rg + i (XT) with rg = 4 (warp /
// 4) + lane / 8; per 4 depth entries it reads 16 float4 from shared memory
// for 256 fmaf. Writes each row's best code to idx[row0 + r] for rows below
// N and, where idx_s is not null, to idx_s[r] for an epilogue (with
// NAN_RULE a row without any comparable distance takes 0; with MIN_ONLY the
// row's smallest distance, truncated to int32, goes to idx). All threads call
// it; it ends with a __syncthreads().
template <bool XT, bool NAN_RULE, bool MIN_ONLY = false>
__device__ __forceinline__ void resident_tile(
    const float* cs, const float* xt, const float* __restrict__ c2,
    int32_t* __restrict__ idx, int64_t row0, int64_t N, int D, int K,
    int Kp, int LD, float (*pd)[RES_ROWS], int (*pi)[RES_ROWS], int* idx_s) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lc = lane % 8;
  const int wc = warp % 4;
  const int rg = (warp / 4) * 4 + lane / 8;
  const int cg = wc * 8 + lc;
  const float* xb = XT ? xt + rg * 8 : xt + rg * LD;
  float best_d[8];
  int best_i[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_d[i] = CUDART_INF_F;
    best_i[i] = K;
  }
  for (int slab0 = 0; slab0 < Kp; slab0 += RES_CODES) {
    const float* cp = cs + (slab0 + cg) * LD;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 cv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        cv[j] = *reinterpret_cast<const float4*>(cp + 32 * j * LD + d);
      if (XT) {
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {  // ascending d in every chain
          const float4 x0 =
              *reinterpret_cast<const float4*>(xb + (d + dd) * RES_ROWS);
          const float4 x1 =
              *reinterpret_cast<const float4*>(xb + (d + dd) * RES_ROWS + 4);
          const float xa[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[i][j] = fmaf(xa[i], lane4(cv[j], dd), acc[i][j]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xb + 8 * i * LD + d);
#pragma unroll
          for (int j = 0; j < 8; ++j) {  // ascending d in every chain
            acc[i][j] = fmaf(xv.x, cv[j].x, acc[i][j]);
            acc[i][j] = fmaf(xv.y, cv[j].y, acc[i][j]);
            acc[i][j] = fmaf(xv.z, cv[j].z, acc[i][j]);
            acc[i][j] = fmaf(xv.w, cv[j].w, acc[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int code = slab0 + cg + 32 * j;
      if (code < K) {
        const float c2v = c2[code];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float dd = c2v - 2.0f * acc[i][j];
          if (NAN_RULE && isnan(dd)) dd = CUDART_INF_F;
          if (better(dd, code, best_d[i], best_i[i])) {
            best_d[i] = dd;
            best_i[i] = code;
          }
        }
      }
    }
  }
  // the eight lanes of a row group, then the four warps of a row
#pragma unroll
  for (int m = 1; m <= 4; m <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[i], m);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[i], m);
      if (better(od, oi, best_d[i], best_i[i])) {
        best_d[i] = od;
        best_i[i] = oi;
      }
    }
  }
  if (lc == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = XT ? 8 * rg + i : rg + 8 * i;
      pd[wc][r] = best_d[i];
      pi[wc][r] = best_i[i];
    }
  }
  __syncthreads();
  if (tid < RES_ROWS) {
    float bd = pd[0][tid];
    int bi = pi[0][tid];
    for (int w = 1; w < 4; ++w)
      if (better(pd[w][tid], pi[w][tid], bd, bi)) {
        bd = pd[w][tid];
        bi = pi[w][tid];
      }
    if (NAN_RULE) bi = bi >= K ? 0 : bi;  // backstop, as vq_core_kernel
    if (idx_s) idx_s[tid] = bi;
    if (row0 + tid < N)
      idx[row0 + tid] = MIN_ONLY ? static_cast<int32_t>(bd) : bi;
  }
  __syncthreads();
}

// Index only, the FMA path: x [N, D] (or [D, N] with XT) float32 -> idx.
template <bool XT, bool NAN_RULE, bool MIN_ONLY = false>
__global__ void __launch_bounds__(RES_THREADS, 1)
vq_resident_assign_kernel(const float* __restrict__ x,
                          const float* __restrict__ cb,
                          const float* __restrict__ c2,
                          int32_t* __restrict__ idx, int64_t N, int D, int K,
                          int Kp, int LD) {
  extern __shared__ __align__(16) float smem[];
  float* const cs = smem;                // [Kp][LD]
  float* const xs = smem + Kp * LD;      // [2][tile]
  const int tile_floats = XT ? D * RES_ROWS : RES_ROWS * LD;
  __shared__ float pd[4][RES_ROWS];
  __shared__ int pi[4][RES_ROWS];
  const int64_t ntiles = (N + RES_ROWS - 1) / RES_ROWS;

  stage_codebook(cb, cs, K, Kp, D, LD);
  int64_t tile = blockIdx.x;
  if (XT)
    stage_cols(x, xs, tile * RES_ROWS, N, D);
  else
    stage_rows(x, xs, tile * RES_ROWS, N, D, LD);
  int buf = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile (and the codebook) in; the other buffer free
    const int64_t next = tile + gridDim.x;
    if (next < ntiles) {
      float* nb = xs + (buf ^ 1) * tile_floats;
      if (XT)
        stage_cols(x, nb, next * RES_ROWS, N, D);
      else
        stage_rows(x, nb, next * RES_ROWS, N, D, LD);
    }
    resident_tile<XT, NAN_RULE, MIN_ONLY>(cs, xs + buf * tile_floats, c2, idx,
                                tile * RES_ROWS, N, D, K, Kp, LD, pd, pi,
                                nullptr);
    buf ^= 1;
  }
}

// Once per device and kernel, the dynamic shared memory a kernel may ask
// for: cached, so that a launch costs the host one cudaGetDevice. One cache
// per kernel: Kernel is the function itself, not its type, which
// instantiations of one template share.
template <auto Kernel>
inline cudaError_t prepare_launch(int64_t bytes) {
  constexpr int kDevices = 64;
  static int64_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidValue;
  if (bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}

template <bool XT, bool NAN_RULE, bool MIN_ONLY = false>
inline cudaError_t launch_resident_assign(const float* x, const float* cb,
                                          const float* c2, int32_t* idx,
                                          int64_t N, int D, int K,
                                          unsigned blocks, cudaStream_t st) {
  const int64_t bytes = resident_shared_bytes(D, K, XT);
  if (D % 4 != 0 || !fits_shared(bytes) || (XT && N % 4 != 0) ||
      blocks < 1 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(cb)) %
              16 != 0)
    return cudaErrorInvalidValue;
  const cudaError_t err =
      prepare_launch<vq_resident_assign_kernel<XT, NAN_RULE, MIN_ONLY>>(
          bytes);
  if (err != cudaSuccess) return err;
  vq_resident_assign_kernel<XT, NAN_RULE, MIN_ONLY>
      <<<blocks, RES_THREADS, bytes, st>>>(x, cb, c2, idx, N, D, K,
                                           res_kp(K), res_ld(D));
  return cudaGetLastError();
}

// ------------------------------------------------------ tensor-core path
// c2[k] = sum_d C[k, d]^2 in float32 exactly as code_norms_kernel forms it
// (the same lane-strided fmaf chains and shuffle tree), and the codebook
// rounded to bfloat16 into cb16 [K][D]: the tensor-core path's one pass over
// the stored codebook.
template <typename T>
__global__ void code_norms_round_kernel(const T* __restrict__ cb,
                                        float* __restrict__ c2,
                                        __nv_bfloat16* __restrict__ cb16,
                                        int K, int D) {
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= K) return;   // a whole warp leaves together
  float s = 0.0f;
  for (int d = lane; d < D; d += 32) {
    const float v = load_f32(cb + warp * D + d);
    s = fmaf(v, v, s);
    cb16[warp * D + d] = __float2bfloat16_rn(v);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) c2[warp] = s;
}

// four elements of T at src, rounded to bfloat16, into dst (8 bytes)
__device__ __forceinline__ void round4(const float* src, __nv_bfloat16* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}
__device__ __forceinline__ void round4(const __nv_bfloat16* src,
                                       __nv_bfloat16* dst) {
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bfloat16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the tile of x after `row0` as stored into land (row-major [64][D], or
// [D][64] with XT); zeros past N; not committed. EPV elements of T make 16
// bytes: D (row-major) or N (XT) is a multiple of EPV.
template <typename T, bool XT>
__device__ __forceinline__ void stage_landing(const T* __restrict__ x,
                                              T* land, int64_t row0,
                                              int64_t N, int D) {
  constexpr int EPV = 16 / sizeof(T);
  if (XT) {
    constexpr int per_row = RES_ROWS / EPV;
    for (int e = threadIdx.x; e < D * per_row; e += RES_THREADS) {
      const int d = e / per_row, m = (e - d * per_row) * EPV;
      T* dst = land + d * RES_ROWS + m;
      if (row0 + m < N)
        cp_async16(dst, x + static_cast<int64_t>(d) * N + row0 + m);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int per_row = D / EPV;
    for (int e = threadIdx.x; e < RES_ROWS * per_row; e += RES_THREADS) {
      const int r = e / per_row, d = (e - r * per_row) * EPV;
      T* dst = land + r * D + d;
      if (row0 + r < N)
        cp_async16(dst, x + (row0 + r) * D + d);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Index only, the tensor-core path: x [N, D] (or [D, N] with XT) stored as
// T (float or __nv_bfloat16), rounded to bfloat16 here; cb16 [K, D] the
// codebook rounded by code_norms_round_kernel, c2 [K] float32 -> idx.
template <typename T, bool XT, bool NAN_RULE, bool MIN_ONLY = false>
__global__ void __launch_bounds__(RES_THREADS, 1)
vq_mma_kernel(const T* __restrict__ x, const __nv_bfloat16* __restrict__ cb16,
              const float* __restrict__ c2, int32_t* __restrict__ idx,
              int64_t N, int D, int K, int Kp, int DP) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SB = DP + MMA_PAD;                      // codebook row, bf16
  __nv_bfloat16* const cbs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* const xa = cbs + Kp * SB;          // the rounded tile
  const int xa_elems = XT ? DP * MMA_XT_LD : RES_ROWS * SB;
  T* const land = reinterpret_cast<T*>(xa + xa_elems);  // [STAGES][64 * D]
  float* const c2s = reinterpret_cast<float*>(land + MMA_STAGES * RES_ROWS * D);
  __shared__ float pd[4][RES_ROWS];
  __shared__ int pi[4][RES_ROWS];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int wr = warp / 4, wc = warp % 4;  // rows 32 wr.., codes 64 wc..
  const int j = lane / 8, r = lane % 8;    // ldmatrix: matrix, row
  const int64_t ntiles = (N + RES_ROWS - 1) / RES_ROWS;
  const int64_t grid = gridDim.x;

  // the rounded codebook by cp.async (zeros past K and D), in the first
  // group with the first tile; ||C||^2 +inf past K; the rounded tile's
  // padding zero
  const int q_per_code = DP / 4;
  for (int e = tid; e < Kp * q_per_code; e += RES_THREADS) {
    const int code = e / q_per_code, d = (e - code * q_per_code) * 4;
    __nv_bfloat16* dst = cbs + code * SB + d;
    if (code < K && d < D)
      cp_async8(dst, cb16 + static_cast<int64_t>(code) * D + d);
    else
      *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
  }
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    const int64_t t = blockIdx.x + s * grid;
    if (t < ntiles)
      stage_landing<T, XT>(x, land + s * RES_ROWS * D, t * RES_ROWS, N, D);
    cp_async_commit();
  }
  for (int e = tid; e < Kp; e += RES_THREADS)
    c2s[e] = e < K ? c2[e] : CUDART_INF_F;
  for (int e = tid * 4; e < xa_elems; e += RES_THREADS * 4)
    *reinterpret_cast<uint2*>(xa + e) = make_uint2(0u, 0u);

  int stage = 0;
  for (int64_t tile = blockIdx.x; tile < ntiles; tile += grid) {
    cp_async_wait<MMA_STAGES - 2>();
    __syncthreads();  // this tile landed; the rounded tile is free
    {
      const int64_t t = tile + (MMA_STAGES - 1) * grid;
      const int s = (stage + MMA_STAGES - 1) % MMA_STAGES;
      if (t < ntiles)
        stage_landing<T, XT>(x, land + s * RES_ROWS * D, t * RES_ROWS, N, D);
      cp_async_commit();
    }
    // round the landed tile into xa, keeping its layout
    const T* lt = land + stage * RES_ROWS * D;
    if (XT) {
      for (int e = tid; e < D * (RES_ROWS / 4); e += RES_THREADS) {
        const int d = e / (RES_ROWS / 4), m = (e % (RES_ROWS / 4)) * 4;
        round4(lt + d * RES_ROWS + m, xa + d * MMA_XT_LD + m);
      }
    } else {
      const int quads = D / 4;
      for (int e = tid; e < RES_ROWS * quads; e += RES_THREADS) {
        const int rr = e / quads, d = (e - rr * quads) * 4;
        round4(lt + rr * D + d, xa + rr * SB + d);
      }
    }
    __syncthreads();

    float best_d[4];  // slot 2 mt + h: row 32 wr + 16 mt + 8 h + g
    int best_i[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      best_d[s] = CUDART_INF_F;
      best_i[s] = K;
    }
    for (int slab0 = 0; slab0 < Kp; slab0 += RES_CODES) {
      float acc[2][8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.0f;
      const __nv_bfloat16* bp =
          cbs + (slab0 + wc * 64 + r + (j / 2) * 8) * SB + (j % 2) * 8;
      for (int k0 = 0; k0 < DP; k0 += 16) {
        // every fragment of the step first, then its 16 products
        unsigned a[2][4], b[4][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int m0 = wr * 32 + mt * 16;
          if (XT)
            ldmatrix_x4_trans(
                a[mt], xa + (k0 + r + (j / 2) * 8) * MMA_XT_LD + m0 +
                           (j % 2) * 8);
          else
            ldmatrix_x4(a[mt],
                        xa + (m0 + r + (j % 2) * 8) * SB + k0 + (j / 2) * 8);
        }
#pragma unroll
        for (int np = 0; np < 4; ++np)
          ldmatrix_x4(b[np], bp + np * 16 * SB + k0);
#pragma unroll
        for (int np = 0; np < 4; ++np)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(acc[mt][2 * np], a[mt], b[np][0], b[np][1]);
            mma_bf16(acc[mt][2 * np + 1], a[mt], b[np][2], b[np][3]);
          }
      }
      // codes in ascending order within the lane: strict < keeps the lowest
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int code = slab0 + wc * 64 + nt * 8 + 2 * c + q;
          const float c2v = c2s[code];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float dd = c2v - 2.0f * acc[mt][nt][2 * h + q];
              if (dd < best_d[2 * mt + h]) {
                best_d[2 * mt + h] = dd;
                best_i[2 * mt + h] = code;
              }
            }
        }
      }
    }
    // the four lanes of a row, then the four warps of a row
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float od = __shfl_xor_sync(0xffffffffu, best_d[s], m);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i[s], m);
        if (better(od, oi, best_d[s], best_i[s])) {
          best_d[s] = od;
          best_i[s] = oi;
        }
      }
    }
    if (c == 0) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int row = wr * 32 + (s / 2) * 16 + (s % 2) * 8 + g;
        pd[wc][row] = best_d[s];
        pi[wc][row] = best_i[s];
      }
    }
    __syncthreads();
    if (tid < RES_ROWS) {
      float bd = pd[0][tid];
      int bi = pi[0][tid];
      for (int w = 1; w < 4; ++w)
        if (better(pd[w][tid], pi[w][tid], bd, bi)) {
          bd = pd[w][tid];
          bi = pi[w][tid];
        }
      if (NAN_RULE) bi = bi >= K ? 0 : bi;
      const int64_t row = tile * RES_ROWS + tid;
      if (row < N) idx[row] = MIN_ONLY ? static_cast<int32_t>(bd) : bi;
    }
    stage = (stage + 1) % MMA_STAGES;
  }
}

// c2 [K] float32 and cb16 [K * D] bfloat16 are the caller's scratch
template <typename T, bool XT, bool NAN_RULE, bool MIN_ONLY = false>
inline cudaError_t launch_mma_assign(const T* x, const T* cb, float* c2,
                                     __nv_bfloat16* cb16, int32_t* idx,
                                     int64_t N, int D, int K, unsigned blocks,
                                     cudaStream_t st) {
  constexpr int EPV = 16 / sizeof(T);
  const int64_t bytes = mma_shared_bytes(D, K, XT, sizeof(T));
  if (D % 4 != 0 || !fits_shared(bytes) || (XT ? N : D) % EPV != 0 ||
      blocks < 1 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(cb16) % 8 != 0)
    return cudaErrorInvalidValue;
  cudaError_t err =
      prepare_launch<vq_mma_kernel<T, XT, NAN_RULE, MIN_ONLY>>(bytes);
  if (err != cudaSuccess) return err;
  const int warps_per_block = 8;
  code_norms_round_kernel<T>
      <<<(K + warps_per_block - 1) / warps_per_block, warps_per_block * 32, 0,
         st>>>(cb, c2, cb16, K, D);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vq_mma_kernel<T, XT, NAN_RULE, MIN_ONLY>
      <<<blocks, RES_THREADS, bytes, st>>>(x, cb16, c2, idx, N, D, K,
                                           res_kp(K), mma_dp(D));
  return cudaGetLastError();
}

}  // namespace vq
