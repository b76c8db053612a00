// Vector-quantisation assignment for Hopper (sm_90a): the fused pass of the
// VQ-VAE's quantiser and its index-only form.
//
// Replaces two Pallas TPU kernels of forest_tpu/ops/vq.py:
//   `_vq_kernel` (reached through vq_core -> _vq_core_pallas):
//       idx[n] = lowest-index argmin_k of ||C_k||^2 - 2 x_n . C_k (float32,
//       a NaN distance counts as +inf), q[n] = C[idx[n]], counts[k] = number
//       of rows assigned to k, sums[k] = sum of those rows of x, and
//       optionally sum_n q[n] . x[n];
//   `_vq_assign_kernel` (vq_assign -> _vq_assign_pallas): idx only, with the
//       option of rounding both operands of the product to bfloat16.
// x [N, D], C [K, D] float32 contiguous, any N, D, K >= 1. The TPU versions
// padded D and K to 128 lanes and N to the tile, ran the grid in order and
// carried counts and sums in VMEM from one grid step to the next; blocks run
// in no order here.
//
// Bound on this card: operations. 2 N K D float32 operations outside the
// tensor cores (8.6 GFLOP at N 131072, D 128, K 256: 0.128 ms at 67
// TFLOP/s) against x read and q and idx written once (135 MB: 0.040 ms).
//
// Every distance is one float32 fmaf chain over ascending d, with ||C_k||^2
// from code_norms_kernel's fixed order (vq_tile.cuh), and pairs are compared
// as (distance, index): so vq_core's indices equal vq_assign's bit for bit
// on either of vq_core's two paths, and every output is the same in every
// run (no float atomics).
//
// Two paths, chosen in the C function:
//
// * N <= 128 (one row tile; the VQ-VAE step's N = 64) and K <= 2048: ONE
//   launch, vq_small_kernel, cooperative (every block resident). Its blocks
//   split the codebook into slabs of 16 codes; each computes its codes'
//   norms, the distances of all N rows to them (x and the slab staged
//   through shared memory 64 depth entries at a time, each thread an fmaf
//   chain for up to 8 rows of one code) and the per-row best of its slab
//   by warp shuffles. After a grid barrier every block reduces the slabs'
//   partials in slab order; block b then writes idx and q of the rows
//   r = b (mod blocks) and the counts and sums of its own 16 codes, each
//   sum over its rows in row order; the last block to finish adds the
//   blocks' partials of sum(q * x) in block order.
//
// * N > 128: four launches. code_norms_kernel; the product and argmin,
//   then q = C[idx] and the block's partial of sum(q * x): where the
//   codebook and two tiles of 64 rows of x fit shared memory (K 256, D 128:
//   198 KB) and D is a multiple of 4, vq_resident_kernel (persistent blocks,
//   one per SM, the codebook copied in once, x tiles double-buffered with
//   cp.async, 8 x 8 distances a thread: 16 shared float4 loads for 256
//   fmaf), else vq_core_kernel (vq_tile.cuh's slab tile, 128 rows a block,
//   which re-stages x for every slab of 64 codes and waits at two barriers
//   per 16 depth entries); code_stats_kernel, which reads idx and x ONCE:
//   a block owns a segment of rows and keeps the sums of up to 32,768
//   (code, depth) entries in shared memory (at K 256, D 128 all of them);
//   the segment's x streams through shared memory in tiles of 64 rows,
//   copied with cp.async a tile ahead; a warp owns a slice of 32 depth
//   entries for a class of codes, finds the rows of its codes in a tile by
//   ballots and adds them in row order; and code_stats_reduce_kernel, which
//   adds the segments' partials in segment order and, in one more block,
//   the partials of sum(q * x).
//
// What holds it back (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py): at
// N 131072, D 128, K 256 the four launches take 0.33 ms on the device
// (0.62 before), 2.6x the bound: the resident product 0.259 ms, half the
// float32 peak with one block of eight warps and 248 registers a thread a
// SM; the statistics 0.059 ms against 0.020 for their bytes, each warp
// adding its hits one after another. At N 64 the one launch takes 20 us
// (62 before, in four launches): sixteen blocks on sixteen SMs, each
// waiting on its loads of x and of the codebook, a grid barrier and a
// second round of loads; unrolling the loads did not shorten it.
//
// C interface (loaded with ctypes): pointers and the stream are void*, every
// function launches on `stream`, never synchronises, allocates nothing (the
// caller passes outputs and scratch) and returns cudaGetLastError().

#include "vq_tile.cuh"

using namespace vq;

namespace {

constexpr int SMALL_CODES = 16;     // codes per block of the small path
constexpr int SMALL_THREADS = 256;  // 16 row groups x 16 codes
constexpr int SMALL_ROWS = BM;      // the small path's largest N
constexpr int SMALL_RPT = SMALL_ROWS / (SMALL_THREADS / SMALL_CODES);
constexpr int SMALL_DK = 64;        // depth entries per staged chunk
constexpr int SMALL_MAX_SLABS = 128;  // K <= 2048: every block resident
constexpr int RES_ROWS = 64;        // rows per tile of the resident path
constexpr int RES_CODES = 256;      // codes per slab of the resident path
constexpr int RES_THREADS = 256;    // 2 x 4 warps; a thread 8 rows x 8 codes
constexpr int RES_STATIC_BYTES = 4096;  // its static shared memory, at most
constexpr int MAX_SHARED_BYTES = 232448;
constexpr int STAT_THREADS = 512;   // 16 warps
constexpr int STAT_WARPS = STAT_THREADS / 32;
constexpr int STAT_CHUNK = 2048;    // indices staged per pass
constexpr int STAT_ROWS = 64;       // rows of x per tile in shared memory
constexpr int STAT_SUM_FLOATS = 32768;  // (code, depth) sums per block

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// sum over the block of one float per thread: warp shuffles, then the warps
// in order; the result lands in thread 0
__device__ __forceinline__ float block_sum(float part, float* red) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    part += __shfl_xor_sync(0xffffffffu, part, m);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = part;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w)
      total += red[w];
  return total;
}

// ------------------------------------------------------------ small path
// All blocks wait here for each other: sync[0] counts arrivals, the last
// block to arrive sets it back to 0 and bumps the generation sync[1] that
// the others wait on. Needs every block resident at once: the kernel is
// launched cooperatively.
__device__ __forceinline__ void grid_barrier(int32_t* sync) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int32_t* gen = sync + 1;
    const int32_t g = *gen;
    __threadfence();
    if (atomicAdd(sync, 1) == static_cast<int>(gridDim.x) - 1) {
      sync[0] = 0;
      __threadfence();
      atomicExch(sync + 1, g + 1);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// Block b owns codes [16 b, 16 b + 16). Phase 1: its codes' norms (as
// code_norms_kernel forms them: a warp per code, lane-strided fmaf chains, a
// shuffle tree), the distances of all N rows to them (x and the slab staged
// through shared memory SMALL_DK depth entries at a time; each thread an
// fmaf chain for up to 8 rows of one code) and each row's best of the slab
// by warp shuffles, into part_d / part_i. Grid barrier. Phase 2, in every
// block: each row's best over the slabs in slab order; then block b writes
// idx and q of the rows r = b (mod blocks) and its partial of sum(q * x),
// and the counts and sums of its own codes, each sum over its rows in row
// order. The last block to finish adds the partials of sum(q * x) in block
// order.
__global__ void __launch_bounds__(SMALL_THREADS)
vq_small_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                int32_t* __restrict__ idx, float* __restrict__ q,
                float* __restrict__ counts, float* __restrict__ sums,
                float* __restrict__ qx, float* part_d, int32_t* part_i,
                float* qx_part, int32_t* sync, int N, int D, int K,
                int with_qx) {
  __shared__ float xs[SMALL_DK][SMALL_ROWS + 1];
  __shared__ float cs[SMALL_DK][SMALL_CODES + 1];
  __shared__ float c2s[SMALL_CODES];
  __shared__ int32_t idx_s[SMALL_ROWS], mine[SMALL_ROWS];
  __shared__ int n_mine_s;
  __shared__ float red[SMALL_THREADS / 32];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int j = tid % SMALL_CODES;  // code of the slab
  const int rg = tid / SMALL_CODES; // rows rg, rg + 16, ...
  const int code0 = blockIdx.x * SMALL_CODES;
  const int nslab = gridDim.x;

  for (int cc = tid / 32; cc < SMALL_CODES; cc += SMALL_THREADS / 32) {
    const int code = code0 + cc;
    if (code >= K) break;  // warp-uniform
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float v = __ldg(cb + static_cast<int64_t>(code) * D + d);
      s = fmaf(v, v, s);
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    if (lane == 0) c2s[cc] = s;
  }

  constexpr int groups = SMALL_THREADS / SMALL_CODES;
  const int mrows = (N + groups - 1) / groups;  // rows per thread in use
  float acc[SMALL_RPT];
#pragma unroll
  for (int m = 0; m < SMALL_RPT; ++m) acc[m] = 0.0f;
  for (int d0 = 0; d0 < D; d0 += SMALL_DK) {
    for (int e = tid; e < mrows * groups * SMALL_DK; e += SMALL_THREADS) {
      const int r = e / SMALL_DK, k = e % SMALL_DK;
      xs[k][r] = r < N && d0 + k < D
                     ? __ldg(x + static_cast<int64_t>(r) * D + d0 + k)
                     : 0.0f;
    }
    for (int e = tid; e < SMALL_CODES * SMALL_DK; e += SMALL_THREADS) {
      const int c = e / SMALL_DK, k = e % SMALL_DK;
      const int code = code0 + c;
      cs[k][c] = code < K && d0 + k < D
                     ? __ldg(cb + static_cast<int64_t>(code) * D + d0 + k)
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < SMALL_DK; ++k) {
      const float cv = cs[k][j];
#pragma unroll
      for (int m = 0; m < SMALL_RPT; ++m)
        if (m < mrows) acc[m] = fmaf(xs[k][rg + m * groups], cv, acc[m]);
    }
    __syncthreads();
  }
  // the slab's best code of every row: the 16 threads of a row group are
  // neighbouring lanes of one warp
  const int code = code0 + j;
#pragma unroll
  for (int m = 0; m < SMALL_RPT; ++m) {
    float bd = CUDART_INF_F;
    int bi = K;
    if (code < K) {
      float d = c2s[j] - 2.0f * acc[m];
      if (isnan(d)) d = CUDART_INF_F;
      bd = d;
      bi = code;
    }
#pragma unroll
    for (int s = 8; s >= 1; s >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, s);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, s);
      if (better(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int row = rg + m * groups;
    if (j == 0 && row < N) {
      part_d[blockIdx.x * N + row] = bd;
      part_i[blockIdx.x * N + row] = bi;
    }
  }

  grid_barrier(sync);

  // every slab's best of every row, loaded at once into xs (free now) where
  // they fit, then each row's best over the slabs in slab order
  const bool staged = 2 * nslab * N <= SMALL_DK * (SMALL_ROWS + 1);
  float* const pd_s = staged ? &xs[0][0] : part_d;
  int* const pi_s = staged ? reinterpret_cast<int*>(&xs[0][0]) + nslab * N
                           : part_i;
  if (staged) {
    for (int e = tid; e < nslab * N; e += SMALL_THREADS) {
      pd_s[e] = __ldcg(part_d + e);
      pi_s[e] = __ldcg(part_i + e);
    }
  }
  __syncthreads();
  if (tid < N) {  // the (distance, index) rule
    float bd = CUDART_INF_F;
    int bi = K;
    for (int s = 0; s < nslab; ++s) {
      const float od = staged ? pd_s[s * N + tid] : __ldcg(pd_s + s * N + tid);
      const int oi = staged ? pi_s[s * N + tid] : __ldcg(pi_s + s * N + tid);
      if (better(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    idx_s[tid] = bi >= K ? 0 : bi;  // backstop, as vq_core_kernel
    if (tid % nslab == static_cast<int>(blockIdx.x)) idx[tid] = idx_s[tid];
  }
  __syncthreads();
  // q = C[idx] of this block's rows and their part of sum(q * x)
  const int my_rows = (N - static_cast<int>(blockIdx.x) + nslab - 1) / nslab;
  float part = 0.0f;
  for (int e = tid; e < my_rows * D; e += SMALL_THREADS) {
    const int r = blockIdx.x + (e / D) * nslab, d = e % D;
    const float v = __ldg(cb + static_cast<int64_t>(idx_s[r]) * D + d);
    q[static_cast<int64_t>(r) * D + d] = v;
    if (with_qx)
      part = fmaf(v, __ldg(x + static_cast<int64_t>(r) * D + d), part);
  }
  // this block's codes: the rows that chose one of them, in row order
  if (tid < 32) {
    int n_mine = 0;
    for (int r0 = 0; r0 < N; r0 += 32) {
      const int r = r0 + tid;
      const bool in = r < N && idx_s[r] >= code0 &&
                      idx_s[r] < code0 + SMALL_CODES;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (in) mine[n_mine + __popc(m & ((1u << tid) - 1))] = r;
      n_mine += __popc(m);
    }
    if (tid == 0) n_mine_s = n_mine;
  }
  __syncthreads();
  // their counts, and per depth entry the sum of their rows in row order;
  // the rows' x is read through shared memory in chunks, loaded at once
  const int n_mine = n_mine_s;
  for (int d0 = 0; d0 < D; d0 += SMALL_DK) {
    float* const xm = &xs[0][0];  // [n_mine][SMALL_DK]
    __syncthreads();
    for (int e = tid; e < n_mine * SMALL_DK; e += SMALL_THREADS) {
      const int i = e / SMALL_DK, d = d0 + e % SMALL_DK;
      xm[e] = d < D ? __ldg(x + static_cast<int64_t>(mine[i]) * D + d)
                    : 0.0f;
    }
    __syncthreads();
    for (int e = tid; e < SMALL_CODES * SMALL_DK; e += SMALL_THREADS) {
      const int k = code0 + e / SMALL_DK, dl = e % SMALL_DK, d = d0 + dl;
      if (k >= K || d >= D) continue;
      float sum = 0.0f;
      int c = 0;
      for (int i = 0; i < n_mine; ++i) {
        if (idx_s[mine[i]] == k) {
          sum += xm[i * SMALL_DK + dl];
          ++c;
        }
      }
      sums[static_cast<int64_t>(k) * D + d] = sum;
      if (d == 0) counts[k] = static_cast<float>(c);
    }
  }
  if (!with_qx) return;
  const float total = block_sum(part, red);
  if (tid == 0) {
    qx_part[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(sync, 1) == nslab - 1;
  }
  __syncthreads();
  if (last && tid < 32) {  // lane-strided sums, then a fixed tree
    float a = 0.0f;
    for (int b = tid; b < nslab; b += 32) a += __ldcg(qx_part + b);
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) a += __shfl_xor_sync(0xffffffffu, a, m);
    if (tid == 0) {
      sync[0] = 0;  // ready for the next launch
      qx[0] = a;
    }
  }
}

// ------------------------------------------------------------ large path
__global__ void __launch_bounds__(THREADS)
vq_core_kernel(const float* __restrict__ x, const float* __restrict__ cb,
               const float* __restrict__ c2, int32_t* __restrict__ idx,
               float* __restrict__ q, float* __restrict__ qx_part, int64_t N,
               int D, int K, int with_qx) {
  __shared__ __align__(16) float xs[BK][XS_LD];
  __shared__ __align__(16) float cs[BK][CS_LD];
  __shared__ int idx_s[BM];
  __shared__ float red[THREADS / 32];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  float best_d[TM];
  int best_i[TM];
  assign_tile<float, false, false, true>(x, cb, c2, row0, N, D, K, xs, cs,
                                         best_d, best_i);
  if (tid % 16 == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = (tid / 16) * TM + i;
      // backstop: the NaN rule leaves every row a comparable distance
      const int bi = best_i[i] >= K ? 0 : best_i[i];
      idx_s[r] = bi;
      if (row0 + r < N) idx[row0 + r] = bi;
    }
  }
  __syncthreads();
  const int rows = static_cast<int>(min64(BM, N - row0));
  float part = 0.0f;
  for (int e = tid; e < rows * D; e += THREADS) {
    const int r = e / D;
    const int d = e - r * D;
    const float v = __ldg(cb + static_cast<int64_t>(idx_s[r]) * D + d);
    const int64_t off = (row0 + r) * D + d;
    q[off] = v;
    if (with_qx) part = fmaf(v, __ldg(x + off), part);
  }
  if (with_qx) {
    const float total = block_sum(part, red);
    if (tid == 0) qx_part[blockIdx.x] = total;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" ::: "memory");
}

// rows row0 .. row0 + RES_ROWS - 1 of x into xs [RES_ROWS][LD]; zeros
// past N
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
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The product and argmin with the whole codebook resident in shared memory
// (padded rows of LD floats, LD = 4 mod 32, so that the lanes of a warp read
// distinct banks), persistent blocks walking tiles of 64 rows of x, the
// next tile copied in with cp.async while the current one is computed. A
// thread keeps 8 rows x 8 codes of a 256-code slab in registers: rows
// rg + 8 i, codes cg + 32 j, with rg = 4 (warp / 4) + lane / 8 and
// cg = 8 (warp % 4) + lane % 8; per 4 depth entries it reads 16 float4 from
// shared memory for 256 fmaf. Then q = C[idx] from the resident codebook
// and the block's partial of sum(q * x) over all its tiles.
__global__ void __launch_bounds__(RES_THREADS, 1)
vq_resident_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                   const float* __restrict__ c2, int32_t* __restrict__ idx,
                   float* __restrict__ q, float* __restrict__ qx_part,
                   int64_t N, int D, int K, int Kp, int LD, int with_qx) {
  extern __shared__ __align__(16) float smem[];
  float* const cs = smem;               // [Kp][LD]
  float* const xs = smem + Kp * LD;     // [2][RES_ROWS][LD]
  __shared__ float pd[4][RES_ROWS];
  __shared__ int pi[4][RES_ROWS];
  __shared__ int idx_s[RES_ROWS];
  __shared__ float red[RES_THREADS / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lc = lane % 8;
  const int wc = warp % 4;
  const int rg = (warp / 4) * 4 + lane / 8;
  const int cg = wc * 8 + lc;
  const int quads = D / 4;
  const int64_t ntiles = (N + RES_ROWS - 1) / RES_ROWS;

  for (int e = tid; e < Kp * quads; e += RES_THREADS) {
    const int code = e / quads, d4 = (e - code * quads) * 4;
    float* dst = cs + code * LD + d4;
    if (code < K)
      cp_async16(dst, cb + static_cast<int64_t>(code) * D + d4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int64_t tile = blockIdx.x;
  stage_rows(x, xs, tile * RES_ROWS, N, D, LD);
  int buf = 0;
  float part = 0.0f;
  for (; tile < ntiles; tile += gridDim.x) {
    cp_async_wait_all();
    __syncthreads();  // this tile (and the codebook) in; the other buffer free
    const int64_t next = tile + gridDim.x;
    if (next < ntiles)
      stage_rows(x, xs + (buf ^ 1) * RES_ROWS * LD, next * RES_ROWS, N, D,
                 LD);
    const int64_t row0 = tile * RES_ROWS;
    const float* xb = xs + buf * RES_ROWS * LD + rg * LD;
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
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int code = slab0 + cg + 32 * j;
        if (code < K) {
          const float c2v = c2[code];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float dd = c2v - 2.0f * acc[i][j];
            if (isnan(dd)) dd = CUDART_INF_F;
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
        pd[wc][rg + 8 * i] = best_d[i];
        pi[wc][rg + 8 * i] = best_i[i];
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
      bi = bi >= K ? 0 : bi;  // backstop, as vq_core_kernel
      idx_s[tid] = bi;
      if (row0 + tid < N) idx[row0 + tid] = bi;
    }
    __syncthreads();
    const int rows = static_cast<int>(min64(RES_ROWS, N - row0));
    const float* xt = xs + buf * RES_ROWS * LD;
    for (int e = tid; e < rows * quads; e += RES_THREADS) {
      const int r = e / quads, d4 = (e - r * quads) * 4;
      const float4 v =
          *reinterpret_cast<const float4*>(cs + idx_s[r] * LD + d4);
      *reinterpret_cast<float4*>(q + (row0 + r) * D + d4) = v;
      if (with_qx) {
        const float4 xv = *reinterpret_cast<const float4*>(xt + r * LD + d4);
        part = fmaf(v.x, xv.x, part);
        part = fmaf(v.y, xv.y, part);
        part = fmaf(v.z, xv.z, part);
        part = fmaf(v.w, xv.w, part);
      }
    }
    buf ^= 1;
  }
  if (with_qx) {
    const float total = block_sum(part, red);
    if (tid == 0) qx_part[blockIdx.x] = total;
  }
}

template <bool ROUND>
__global__ void __launch_bounds__(THREADS)
vq_assign_kernel(const float* __restrict__ x, const float* __restrict__ cb,
                 const float* __restrict__ c2, int32_t* __restrict__ idx,
                 int64_t N, int D, int K) {
  __shared__ __align__(16) float xs[BK][XS_LD];
  __shared__ __align__(16) float cs[BK][CS_LD];
  const int tid = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  float best_d[TM];
  int best_i[TM];
  assign_tile<float, false, ROUND, true>(x, cb, c2, row0, N, D, K, xs, cs,
                                         best_d, best_i);
  if (tid % 16 == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t row = row0 + (tid / 16) * TM + i;
      if (row < N) idx[row] = best_i[i] >= K ? 0 : best_i[i];
    }
  }
}

// x rows c0 + r0 .. c0 + r0 + STAT_ROWS - 1 (fewer at the end), depth
// entries d0 .. d0 + DC - 1, into xb [STAT_ROWS][DC] with cp.async; zeros
// past D. vec: 16-byte copies (D and the pointer allow them), else 4-byte.
__device__ __forceinline__ void stage_stat_rows(const float* __restrict__ x,
                                                float* xb, int64_t row0,
                                                int rows, int D, int d0,
                                                int DC, bool vec) {
  const int step = vec ? 4 : 1;
  const int per_row = DC / step;
  for (int e = threadIdx.x; e < rows * per_row; e += STAT_THREADS) {
    const int r = e / per_row, dl = (e - r * per_row) * step;
    float* dst = xb + r * DC + dl;
    const float* src = x + (row0 + r) * D + d0 + dl;
    if (d0 + dl >= D) {
      if (vec)
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      else
        *dst = 0.0f;
    } else if (vec) {
      cp_async16(dst, src);
    } else {
      const unsigned sd = static_cast<unsigned>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(sd),
                   "l"(src));
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Block (s, kc, dc): rows [s * seg_rows, (s + 1) * seg_rows), codes
// [kc * KC, (kc + 1) * KC), depth entries [dc * DC, (dc + 1) * DC), DC in
// {32, 64, 128}. The rows' x streams through shared memory in tiles of
// STAT_ROWS rows, copied with cp.async one tile ahead. Warp w takes the 32
// depth entries (w % (DC / 32)) * 32 + lane of the codes k with
// (k - kc * KC) % classes == w / (DC / 32): every (code, depth) sum has one
// owner, which finds its rows of a tile by ballots and adds them in row
// order. The owner with the first slice also counts the rows.
__global__ void __launch_bounds__(STAT_THREADS)
code_stats_kernel(const float* __restrict__ x,
                  const int32_t* __restrict__ idx,
                  int32_t* __restrict__ cnt_part,
                  float* __restrict__ sum_part, int64_t N, int D, int K,
                  int64_t seg_rows, int KC, int DC, int vec) {
  extern __shared__ __align__(16) float sums_s[];  // [KC][DC], then x tiles
  float* const xbuf = sums_s + KC * DC;            // [2][STAT_ROWS][DC]
  __shared__ int32_t idx_s[STAT_CHUNK];
  __shared__ int32_t cnt_s[STAT_SUM_FLOATS / 32];
  const int s = blockIdx.x;
  const int k0 = blockIdx.y * KC;
  const int k1 = min(k0 + KC, K);
  const int d0 = blockIdx.z * DC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slices = DC / 32;
  const int classes = STAT_WARPS / slices;  // a power of two
  const int slice = warp % slices, cls = warp / slices;
  const int dl = slice * 32 + lane;         // depth entry in the block
  const bool counter = slice == 0 && lane == 0;
  for (int e = threadIdx.x; e < KC * DC; e += STAT_THREADS) sums_s[e] = 0.0f;
  for (int e = threadIdx.x; e < KC; e += STAT_THREADS) cnt_s[e] = 0;
  const int64_t begin = s * seg_rows;
  const int64_t end = min64(N, begin + seg_rows);
  for (int64_t c0 = begin; c0 < end; c0 += STAT_CHUNK) {
    const int n = static_cast<int>(min64(STAT_CHUNK, end - c0));
    __syncthreads();  // the previous chunk's indices and tiles are read
    for (int jj = threadIdx.x; jj < n; jj += STAT_THREADS)
      idx_s[jj] = idx[c0 + jj];
    stage_stat_rows(x, xbuf, c0, min(STAT_ROWS, n), D, d0, DC, vec);
    for (int t0 = 0, buf = 0; t0 < n; t0 += STAT_ROWS, buf ^= 1) {
      if (t0 + STAT_ROWS < n) {
        stage_stat_rows(x, xbuf + (buf ^ 1) * STAT_ROWS * DC,
                        c0 + t0 + STAT_ROWS, min(STAT_ROWS, n - t0 - STAT_ROWS),
                        D, d0, DC, vec);
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();  // tile t0 (and the indices) in
      const float* xt = xbuf + buf * STAT_ROWS * DC;
      for (int h = 0; h < STAT_ROWS / 32; ++h) {
        const int jj = t0 + 32 * h + lane;
        const int k = jj < n ? idx_s[jj] : -1;
        unsigned mask = __ballot_sync(
            0xffffffffu,
            k >= k0 && k < k1 && ((k - k0) & (classes - 1)) == cls);
        while (mask) {  // warp-uniform, rows in order
          const int r = 32 * h + __ffs(mask) - 1;
          mask &= mask - 1;
          const int kl = idx_s[t0 + r] - k0;
          sums_s[kl * DC + dl] += xt[r * DC + dl];
          if (counter) cnt_s[kl] += 1;
        }
      }
      __syncthreads();  // tile t0's buffer is free for tile t0 + 2
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (k1 - k0) * DC; e += STAT_THREADS) {
    const int kl = e / DC, dd = d0 + e % DC;
    if (dd < D)
      sum_part[(static_cast<int64_t>(s) * K + k0 + kl) * D + dd] = sums_s[e];
  }
  if (blockIdx.z == 0)
    for (int e = threadIdx.x; e < k1 - k0; e += STAT_THREADS)
      cnt_part[static_cast<int64_t>(s) * K + k0 + e] = cnt_s[e];
}

// counts and sums: the segments' partials added in segment order; with
// qx_blocks > 0, the last block adds the product's partials of sum(q * x)
__global__ void __launch_bounds__(256)
code_stats_reduce_kernel(const int32_t* __restrict__ cnt_part,
                         const float* __restrict__ sum_part,
                         const float* __restrict__ qx_part,
                         float* __restrict__ counts, float* __restrict__ sums,
                         float* __restrict__ qx, int K, int D, int S,
                         int qx_blocks) {
  if (qx_blocks > 0 && blockIdx.x == gridDim.x - 1) {
    __shared__ float sh[256];
    float a = 0.0f;
    for (int i = threadIdx.x; i < qx_blocks; i += 256) a += qx_part[i];
    sh[threadIdx.x] = a;
    __syncthreads();
    for (int st = 128; st >= 1; st >>= 1) {
      if (threadIdx.x < st) sh[threadIdx.x] += sh[threadIdx.x + st];
      __syncthreads();
    }
    if (threadIdx.x == 0) qx[0] = sh[0];
    return;
  }
  const int64_t total = static_cast<int64_t>(K) * D;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e < total) {
    float a = 0.0f;
    for (int s = 0; s < S; ++s) a += sum_part[s * total + e];
    sums[e] = a;
  }
  if (e < K) {
    int c = 0;
    for (int s = 0; s < S; ++s) c += cnt_part[static_cast<int64_t>(s) * K + e];
    counts[e] = static_cast<float>(c);
  }
}

}  // namespace

// x [N, D], cb [K, D] float32 -> idx [N] int32, q [N, D], counts [K],
// sums [K, D], qx [1] (when with_qx). Scratch, laid out by the caller
// (forest_tpu_torch.ops.vq.vq_core_scratch):
//   N <= 128 (and K <= 2048): part_d [ceil(K / 16) * N] float32, part_i
//     [same] int32, qx_part [ceil(K / 16)] float32, and `sync`, two int32
//     that are {0, any} before the launch and {0, any} after it;
//   N > 128: c2 [K] float32, cnt_part [S, K] int32, sum_part [S, K, D]
//     float32, qx_part [ceil(N / 64)] float32; S segments of seg_rows rows
//     cover N. part_d, part_i and sync are not read.
extern "C" int vq_core_f32(const void* x, const void* cb, void* idx, void* q,
                           void* counts, void* sums, void* qx, void* part_d,
                           void* part_i, void* sync, void* c2,
                           void* cnt_part, void* sum_part, void* qx_part,
                           long long N, int D, int K, int S,
                           long long seg_rows, int with_qx, void* stream) {
  if (vq::bad_shape(N, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slabs = (K + SMALL_CODES - 1) / SMALL_CODES;
  if (N <= SMALL_ROWS && slabs <= SMALL_MAX_SLABS) {
    const float* xp = static_cast<const float*>(x);
    const float* cp = static_cast<const float*>(cb);
    int32_t* ip = static_cast<int32_t*>(idx);
    float* qp = static_cast<float*>(q);
    float* np = static_cast<float*>(counts);
    float* sp = static_cast<float*>(sums);
    float* xq = static_cast<float*>(qx);
    float* pd = static_cast<float*>(part_d);
    int32_t* pi = static_cast<int32_t*>(part_i);
    float* pq = static_cast<float*>(qx_part);
    int32_t* sy = static_cast<int32_t*>(sync);
    int n = static_cast<int>(N);
    void* args[] = {&xp, &cp, &ip, &qp, &np, &sp, &xq, &pd, &pi, &pq, &sy,
                    &n, &D, &K, &with_qx};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(vq_small_kernel), dim3(slabs),
        dim3(SMALL_THREADS), args, 0, st));
  }
  const int DC = D <= 32 ? 32 : (D <= 64 ? 64 : 128);
  const int KC = K < STAT_SUM_FLOATS / DC ? K : STAT_SUM_FLOATS / DC;
  const int nk = (K + KC - 1) / KC;
  const int nd = (D + DC - 1) / DC;
  if (S < 1 || S > 65535 || nk > 65535 || nd > 65535 || seg_rows < 1 ||
      seg_rows * S < N)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared =
      static_cast<size_t>(KC + 2 * STAT_ROWS) * DC * sizeof(float);
  const int stat_vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      code_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the resident path: the whole codebook and two tiles of x in shared
  // memory, 16-byte accesses
  const int LD = D + (4 - D % 32 + 32) % 32;  // 4 mod 32 floats
  const int Kp = (K + RES_CODES - 1) / RES_CODES * RES_CODES;
  const int64_t res_bytes =
      4LL * LD * (static_cast<int64_t>(Kp) + 2 * RES_ROWS);
  const uintptr_t vec = reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(cb) |
                        reinterpret_cast<uintptr_t>(q);
  const bool resident = D % 4 == 0 && vec % 16 == 0 &&
                        res_bytes <= MAX_SHARED_BYTES - RES_STATIC_BYTES;
  unsigned blocks = static_cast<unsigned>((N + BM - 1) / BM);
  if (resident) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(vq_resident_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(res_bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t tiles = (N + RES_ROWS - 1) / RES_ROWS;
    blocks = static_cast<unsigned>(tiles < sms ? tiles : sms);
  }
  vq::launch_code_norms<float>(cb, c2, K, D, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (resident)
    vq_resident_kernel<<<blocks, RES_THREADS, res_bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(cb),
        static_cast<const float*>(c2), static_cast<int32_t*>(idx),
        static_cast<float*>(q), static_cast<float*>(qx_part), N, D, K, Kp, LD,
        with_qx);
  else
    vq_core_kernel<<<blocks, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(cb),
        static_cast<const float*>(c2), static_cast<int32_t*>(idx),
        static_cast<float*>(q), static_cast<float*>(qx_part), N, D, K,
        with_qx);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  code_stats_kernel<<<dim3(S, nk, nd), STAT_THREADS, shared, st>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(cnt_part), static_cast<float*>(sum_part), N, D, K,
      seg_rows, KC, DC, stat_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(K) * D;
  const int qx_blocks = with_qx ? static_cast<int>(blocks) : 0;
  code_stats_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256 +
                                                   (with_qx ? 1 : 0)),
                             256, 0, st>>>(
      static_cast<const int32_t*>(cnt_part),
      static_cast<const float*>(sum_part),
      static_cast<const float*>(qx_part), static_cast<float*>(counts),
      static_cast<float*>(sums), static_cast<float*>(qx), K, D, S, qx_blocks);
  return static_cast<int>(cudaGetLastError());
}

// x [N, D], cb [K, D] float32 -> idx [N] int32; scratch c2 [K] float32
// (from the float32 codebook also when mxu_bf16 rounds the operands).
extern "C" int vq_assign_f32(const void* x, const void* cb, void* c2,
                             void* idx, long long N, int D, int K,
                             int mxu_bf16, void* stream) {
  if (vq::bad_shape(N, D, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((N + BM - 1) / BM);
  vq::launch_code_norms<float>(cb, c2, K, D, st);
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(cb);
  const float* c2p = static_cast<const float*>(c2);
  int32_t* ip = static_cast<int32_t*>(idx);
  if (mxu_bf16)
    vq_assign_kernel<true><<<blocks, THREADS, 0, st>>>(xp, cp, c2p, ip, N, D,
                                                       K);
  else
    vq_assign_kernel<false><<<blocks, THREADS, 0, st>>>(xp, cp, c2p, ip, N, D,
                                                        K);
  return static_cast<int>(cudaGetLastError());
}
