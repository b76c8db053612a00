// The variant sweep of the VQ assignment for Hopper (sm_90a): the index-only
// kernel with the knobs whose cost the sweep separates.
//
// Replaces the two Pallas TPU kernels of scripts/bench_vq_variants.py:
//   `_kernel` (reached through make_assign): x row-major [N, D]; knobs:
//       operands of the product rounded to bfloat16 (`mxu_bf16`), x and C
//       stored in bfloat16 (`io_dtype`; ||C_k||^2 then comes from the stored
//       C, in float32), rows per grid step, and `argmin` = 0, which writes
//       the row's smallest distance converted to int32 instead of its index;
//   `_kernel_t` (make_assign_t): the same on x given as [D, N].
// Like the TPU kernels, and unlike vq_assign.cu, these have no NaN rule: a
// NaN distance never compares as smaller, and the checks use finite data.
//
// Bound on this card: 2 N K D operations (float32 outside the tensor cores:
// 0.128 ms at N 131072, D 128, K 256) with float32 operands; with bfloat16
// operands the product could run on the tensor cores (0.009 ms at 989
// TFLOP/s), which leaves the bytes: x read and idx written once, 0.020 ms
// from float32 x, 0.010 ms from bfloat16 x.
//
// K6 (vq_variant_rows) is K7's row-major twin, with x in K5's layout: the
// same two products of vq_resident.cuh over tiles of 64 rows of [N, D], each
// row landing by 16-byte cp.async (512 bytes in float32, 256 in bfloat16 at
// D 128), in min(tiles, SMs) persistent blocks (the count the caller
// passes, ops.vq_variants.launch_grid). Float32 operands take K5's float32
// path (vq_assign_f32's resident fmaf chains, the same order), so on finite
// data K6's indices equal K5's bit for bit; rounded operands (mxu_bf16) take
// K5's tensor-core product, ldmatrix fragments from the row-major tile, and
// give K5 bf16's indices; bfloat16 storage lands x as stored and skips the
// rounding (||C_k||^2 then comes from the stored bfloat16 codebook).
// argmin = 0 runs the products' MIN_ONLY epilogue. As for K7, the TPU's
// `tile` is checked and has no say in the launch; shapes the persistent
// products do not take (D not a multiple of 16 bytes' worth of elements, a
// row not on 16 bytes, a codebook past shared memory) run the slab tile of
// vq_tile.cuh, one block per 128 rows. On the device (NVIDIA H100 80GB
// HBM3, 700.00 W, N 131072, D 128, K 256, ops/vq_timing.py single calls)
// f32 0.290-0.298 ms and bf16 operands 0.119 ms, where the slab tile took
// 0.417-0.449 and 0.417-0.468 in the same runs: what holds K6 back is
// what holds K5 back.
//
// K7 (vq_variant_cols) runs the products of vq_resident.cuh, which K5 runs
// too: the whole codebook resident in shared memory, min(tiles of 64
// columns, SMs) persistent blocks (the count the caller passes), each
// depth row of a tile of [D, N] a 256-byte (float32) or 128-byte (bfloat16)
// run copied by 16-byte cp.async.
// Float32 operands take the fmaf chains of K5's float32 path in the same
// order, so on finite data K7's indices equal K5's bit for bit; rounded
// operands (mxu_bf16, or bfloat16 storage) take K5's tensor-core product,
// fed by ldmatrix.trans from the [D, 64] tile. The TPU kernel's `tile` (its
// VMEM block, a knob of the sweep) is checked and has no say in the launch:
// every tile gives the same grid and the same indices. Shapes the persistent
// products do not take (D not a multiple of 4, N not a multiple of 16 bytes'
// worth of columns, a codebook past shared memory) run the slab tile, one
// block per 128 columns.
//
// What holds K7 back: the two products of K5 (vq_assign.cu). On the
// device (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py
// --profile-vq-assign, N 131072, D 128, K 256) float32 0.238 ms against
// K5's 0.237 (the transposed staging costs nothing measurable), the rounded
// variant 0.057 against 0.062; the sweep's float32 times at the tiles 512
// to 4096 lie within 10 % of each other in every run (0.249-0.326 ms by
// events, the hosts' spread), where the grid once followed the tile
// (0.46-3.25 ms).
//
// C interface as in vq_assign.cu.

#include "vq_resident.cuh"

using namespace vq;

namespace {

using B16 = __nv_bfloat16;

template <typename T, bool TRANSPOSED, bool ROUND>
__global__ void __launch_bounds__(THREADS)
assign_variant_kernel(const T* __restrict__ x, const T* __restrict__ cb,
                      const float* __restrict__ c2, int32_t* __restrict__ out,
                      int64_t N, int D, int K, int tile, int argmin) {
  __shared__ __align__(16) float xs[BK][XS_LD];
  __shared__ __align__(16) float cs[BK][CS_LD];
  const int tid = threadIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t end = begin + tile < N ? begin + tile : N;
  float best_d[TM];
  int best_i[TM];
  for (int64_t row0 = begin; row0 < end; row0 += BM) {
    assign_tile<T, TRANSPOSED, ROUND, false>(x, cb, c2, row0, N, D, K, xs, cs,
                                             best_d, best_i);
    if (tid % 16 == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int64_t row = row0 + (tid / 16) * TM + i;
        if (row < N)
          out[row] = argmin ? best_i[i] : static_cast<int32_t>(best_d[i]);
      }
    }
  }
}

// K6's persistent products, index (MIN_ONLY false) or row minimum (true)
template <bool MIN_ONLY>
cudaError_t launch_rows_persistent(const void* x, const void* cb, float* c2,
                                   __nv_bfloat16* cb16, int32_t* out,
                                   int64_t N, int D, int K, int is_bf16,
                                   int path, unsigned blocks,
                                   cudaStream_t st) {
  using B = __nv_bfloat16;
  if (path == 2)
    return is_bf16 ? launch_mma_assign<B, false, false, MIN_ONLY>(
                         static_cast<const B*>(x), static_cast<const B*>(cb),
                         c2, cb16, out, N, D, K, blocks, st)
                   : launch_mma_assign<float, false, false, MIN_ONLY>(
                         static_cast<const float*>(x),
                         static_cast<const float*>(cb), c2, cb16, out, N, D,
                         K, blocks, st);
  launch_code_norms<float>(cb, c2, K, D, st);
  return launch_resident_assign<false, false, MIN_ONLY>(
      static_cast<const float*>(x), static_cast<const float*>(cb), c2, out, N,
      D, K, blocks, st);
}

int launch_rows(const void* x, const void* cb, void* c2, void* cb16,
                void* out, long long N, int D, int K, int tile, int is_bf16,
                int mxu_bf16, int argmin, int path, int blocks,
                void* stream) {
  const bool rounded = is_bf16 || mxu_bf16;
  if (bad_shape(N, D, K) || tile < BM || tile % BM != 0 || path < 0 ||
      path > 2 || (path == 1 && rounded) || (path == 2 && !rounded) ||
      (path != 0 && blocks < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* c2p = static_cast<float*>(c2);
  int32_t* op = static_cast<int32_t*>(out);
  B16* cbr = static_cast<B16*>(cb16);
  if (path != 0)
    return static_cast<int>(
        argmin ? launch_rows_persistent<false>(x, cb, c2p, cbr, op, N, D, K,
                                               is_bf16, path, blocks, st)
               : launch_rows_persistent<true>(x, cb, c2p, cbr, op, N, D, K,
                                              is_bf16, path, blocks, st));
  // the slab tile: one block per 128 rows
  const unsigned tiles = static_cast<unsigned>((N + BM - 1) / BM);
  if (is_bf16) {
    launch_code_norms<B16>(cb, c2, K, D, st);
    assign_variant_kernel<B16, false, false><<<tiles, THREADS, 0, st>>>(
        static_cast<const B16*>(x), static_cast<const B16*>(cb), c2p, op, N,
        D, K, BM, argmin);
  } else {
    launch_code_norms<float>(cb, c2, K, D, st);
    const float* xp = static_cast<const float*>(x);
    const float* cp = static_cast<const float*>(cb);
    if (mxu_bf16)
      assign_variant_kernel<float, false, true>
          <<<tiles, THREADS, 0, st>>>(xp, cp, c2p, op, N, D, K, BM, argmin);
    else
      assign_variant_kernel<float, false, false>
          <<<tiles, THREADS, 0, st>>>(xp, cp, c2p, op, N, D, K, BM, argmin);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [N, D], cb [K, D], both float32 or both bfloat16 (is_bf16) -> out [N]
// int32 (the index, or with argmin = 0 the row minimum truncated); scratch
// c2 [K] float32 and, on path 2, cb16 [K, D] bfloat16. `tile` is checked (a
// positive multiple of 128) and has no say in the launch. `path` as for
// vq_variant_cols (ops.vq_variants.rows_path): 0 the slab tile, one block
// per 128 rows; 1 the resident float32 product; 2 the tensor cores. Paths 1
// and 2 run `blocks` persistent blocks.
extern "C" int vq_variant_rows(const void* x, const void* cb, void* c2,
                               void* cb16, void* out, long long N, int D,
                               int K, int tile, int is_bf16, int mxu_bf16,
                               int argmin, int path, int blocks,
                               void* stream) {
  return launch_rows(x, cb, c2, cb16, out, N, D, K, tile, is_bf16, mxu_bf16,
                     argmin, path, blocks, stream);
}

// xt [D, N], cb [K, D] -> idx [N] int32; scratch c2 [K] float32 and, on
// path 2, cb16 [K, D] bfloat16. `tile` is checked (a positive multiple of
// 128, the TPU kernel's grid step) and has no say in the launch. `path` is
// the caller's choice (forest_tpu_torch.ops.vq_variants.cols_path): 0 the
// slab tile, one block per 128 columns; 1 the resident float32 product,
// float32 operands; 2 the tensor cores, for rounded operands (mxu_bf16 or
// bfloat16 storage). Paths 1 and 2 run `blocks` persistent blocks
// (ops.vq_variants.launch_grid: min(tiles of 64 columns, SMs)).
extern "C" int vq_variant_cols(const void* xt, const void* cb, void* c2,
                               void* cb16, void* out, long long N, int D,
                               int K, int tile, int is_bf16, int mxu_bf16,
                               int path, int blocks, void* stream) {
  const bool rounded = is_bf16 || mxu_bf16;
  if (bad_shape(N, D, K) || tile < BM || tile % BM != 0 || path < 0 ||
      path > 2 || (path == 1 && rounded) || (path == 2 && !rounded))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* c2p = static_cast<float*>(c2);
  int32_t* op = static_cast<int32_t*>(out);
  using B = __nv_bfloat16;
  B* cbr = static_cast<B*>(cb16);
  if (path == 2)
    return static_cast<int>(
        is_bf16 ? launch_mma_assign<B, true, false>(
                      static_cast<const B*>(xt), static_cast<const B*>(cb),
                      c2p, cbr, op, N, D, K, static_cast<unsigned>(blocks),
                      st)
                : launch_mma_assign<float, true, false>(
                      static_cast<const float*>(xt),
                      static_cast<const float*>(cb), c2p, cbr, op, N, D, K,
                      static_cast<unsigned>(blocks), st));
  if (is_bf16)
    launch_code_norms<B>(cb, c2, K, D, st);
  else
    launch_code_norms<float>(cb, c2, K, D, st);
  if (path == 1)
    return static_cast<int>(launch_resident_assign<true, false>(
        static_cast<const float*>(xt), static_cast<const float*>(cb), c2p, op,
        N, D, K, static_cast<unsigned>(blocks), st));
  const unsigned tiles = static_cast<unsigned>((N + BM - 1) / BM);
  if (is_bf16)
    assign_variant_kernel<B, true, false><<<tiles, THREADS, 0, st>>>(
        static_cast<const B*>(xt), static_cast<const B*>(cb), c2p, op, N, D,
        K, BM, 1);
  else if (mxu_bf16)
    assign_variant_kernel<float, true, true><<<tiles, THREADS, 0, st>>>(
        static_cast<const float*>(xt), static_cast<const float*>(cb), c2p, op,
        N, D, K, BM, 1);
  else
    assign_variant_kernel<float, true, false><<<tiles, THREADS, 0, st>>>(
        static_cast<const float*>(xt), static_cast<const float*>(cb), c2p, op,
        N, D, K, BM, 1);
  return static_cast<int>(cudaGetLastError());
}
