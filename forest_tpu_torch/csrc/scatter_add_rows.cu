// Row scatter-add, the backward of batched row extraction, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_scatter_kernel` in
// forest_tpu/ops/scatter.py (reached through scatter_add_rows ->
// _scatter_pallas):
//
//   out[b, p, c] = sum over j with idx[b, j] == p of dz[b, j, c]
//
// dz [B, N, C] float32, idx [B, N] int32 or int64, out [B, R, C] float32,
// all contiguous. The TPU version grouped the rows by destination tile,
// permuted them with a one-hot matmul and accumulated each tile through the
// matrix unit; none of that is rebuilt here.
//
// Bound on this card: bytes. out is written once (B*R*C*4 bytes, 151 MB at
// B 12, R 65536, C 48), dz and idx are read once (4.7 MB): 0.046 ms at
// 3.35 TB/s.
//
// Design: ONE kernel and no scratch memory. Every row of out is written
// exactly once and never read, there is no atomic of any kind, and rows that
// share a destination are added in ascending j, so the result is the same
// bit for bit in every run.
//  - A block owns a tile of kRowsEach * (kThreads / width) consecutive output
//    rows of one sample (168 rows, 32 KB, at C = 48), width = threads per
//    row, one 16-byte vector each (one element where C is not a multiple of
//    4 or a pointer is not 16-byte aligned: the scalar path). A thread keeps
//    its kRowsEach vectors of the tile in registers, cleared.
//  - The block scans the sample's N indices itself, kScan * kThreads = 2,048
//    a step, every thread's kScan loads in flight together; the indices of
//    a sample are read by each of its tiles, from L2. A warp ballot per 32
//    indices says which of them land in the tile; the ballots go to shared
//    memory, word w for the indices j0 + 32 w .. j0 + 32 w + 31.
//  - After a barrier every thread walks the set bits in ascending j (a few
//    per tile: N / tiles per sample on average, 5 here). The threads that
//    hold the destination row load dz[b, j] and add it to their register.
//    The order of the adds is the order of the walk, the same in every
//    thread and every run. There is one barrier a scan step (two sets of
//    ballots, taken in turn), so a warp that waits for dz holds no other
//    warp back.
//  - The tile is stored: zeros where nothing landed, without a branch on the
//    data. The stores are a pure stream.
//  - An index outside [0, R) matches no tile, so nothing is ever written
//    outside out. Every block sees all the indices of its sample; the block
//    of the sample's first tile stores bad[b] = 1 if any was out of range,
//    else 0, so the flags need no clearing either.
// The scan makes B * tiles * N index loads, where the rows themselves make
// B * N: it is cheap while a sample's indices (N * 4 or 8 bytes) are small
// beside a tile's bytes (rows * C * 4), as at the training shape (16 KB of
// int64 against 32 KB). From N ~ 10^4 on at C = 48 the scan moves more bytes
// through L2 than the stores move to device memory and the kernel slows in
// proportion to N; a map from destination to rows, built by a kernel of its
// own, would then be the better design.
//
// What it reaches (NVIDIA H100 80GB HBM3, 700.00 W, the shape above, 4 blocks
// of 53-62 registers a thread per SM): 55-59 us with dz in L2, 67 us inside
// the training step, where PyTorch's fill of the same 151 MB takes 46-47 us
// and the same kernel without its loads of dz 48 us. The wait for the few
// rows of dz, under a saturated stream of stores, is what is left: copying
// them a tile ahead into shared memory, storing the empty rows first, a
// warp's own scan of the indices for each row that is hit (no registers for
// the tile, 6-8 blocks per SM: 73-98 us), and more blocks per SM with
// spilled registers were each slower. Calls back to
// back take 0.057-0.064 ms each against 0.061-0.062 ms for torch.zeros plus
// one index_add_; a single call with the device idle before it 0.08-0.10 ms
// against 0.07 ms, the 25 us the host needs before the one launch showing.
//
// C interface (loaded with ctypes): every pointer and the stream is a void*,
// the function launches the one kernel on `stream`, never synchronises,
// allocates nothing, and returns cudaGetLastError() (0 = success). After the
// stream has run, bad[b] != 0 says that an index of sample b was out of
// range (its row was left out of the sum).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 8;      // indices a thread loads per scan step
constexpr int kRowsEach = 8;  // output rows a thread holds and stores
constexpr int kStep = kScan * kThreads;  // indices of one scan step
constexpr int kWords = kScan * kWarps;   // ballots of one scan step
constexpr int kMinBlocks = 4;  // blocks per SM the registers must allow

__device__ __forceinline__ void add_to(float4& a, const float4 v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}
__device__ __forceinline__ void add_to(float& a, const float v) { a += v; }
__device__ __forceinline__ void clear(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void clear(float& a) { a = 0.f; }
// out is far larger than L2 and nothing here reads it back: streaming stores
__device__ __forceinline__ void store_out(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void store_out(float* p, float v) { __stcs(p, v); }

// V = float4 (a row is CV = C / 4 vectors) or float (CV = C). Block
// (b, tile, part): rows tile * tile_rows .. of sample b, and of each row the
// vectors part * width .. (parts > 1 only where CV > kThreads). Thread i
// takes vector i % width of the rows i / width + u * rows_per_pass of the
// tile, u < kRowsEach: consecutive threads store consecutive vectors.
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scatter_rows_kernel(const V* __restrict__ dz, const I* __restrict__ idx,
                    V* __restrict__ out, int32_t* __restrict__ bad, int N,
                    int R, int CV, int width, int rows_per_pass, int tiles,
                    int parts) {
  // two sets of ballots, taken in turn: one barrier a scan step is enough,
  // and a warp that waits for a row of dz holds no other warp back
  __shared__ __align__(16) uint32_t hits[2][kWords];
  const int part = blockIdx.x % parts;
  const int tile = (blockIdx.x / parts) % tiles;
  const int64_t b = blockIdx.x / parts / tiles;
  const int tile_rows = kRowsEach * rows_per_pass;
  const int64_t row0 = static_cast<int64_t>(tile) * tile_rows;
  const int lo = static_cast<int>(row0);  // R < 2^31
  const int hi = row0 + tile_rows < R ? lo + tile_rows : R;
  const int local = static_cast<int>(threadIdx.x) / width;
  const int v = part * width + static_cast<int>(threadIdx.x) - local * width;
  const bool live = local < rows_per_pass && v < CV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const I* idx_b = idx + b * N;
  const V* dz_b = dz + b * N * CV;
  bool out_of_range = false;
  V acc[kRowsEach];
#pragma unroll
  for (int u = 0; u < kRowsEach; ++u) clear(acc[u]);

  int turn = 0;
  for (int64_t j0 = 0; j0 < N; j0 += kStep, turn ^= 1) {
    uint32_t* words = hits[turn];
    int p[kScan];  // -1: out of range or beyond N
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int64_t j = j0 + u * kThreads + threadIdx.x;
      const I wide = j < N ? idx_b[j] : static_cast<I>(0);
      const bool outside = wide < 0 || wide >= static_cast<I>(R);
      out_of_range |= outside;
      p[u] = outside || j >= N ? -1 : static_cast<int>(wide);
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const unsigned mask =
          __ballot_sync(0xffffffffu, p[u] >= lo && p[u] < hi);
      if (lane == 0) words[u * kWarps + warp] = mask;
    }
    __syncthreads();
    for (int w4 = 0; w4 < kWords; w4 += 4) {
      const uint4 four = *reinterpret_cast<const uint4*>(words + w4);
      if ((four.x | four.y | four.z | four.w) == 0) continue;
      const uint32_t word[4] = {four.x, four.y, four.z, four.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // ascending j, the same walk in every thread
        for (uint32_t left = word[i]; left; left &= left - 1) {
          const int64_t j = j0 + 32 * (w4 + i) + __ffs(left) - 1;
          const int in_tile = static_cast<int>(idx_b[j]) - lo;
          const int pass = in_tile / rows_per_pass;
          if (live && in_tile - pass * rows_per_pass == local) {
            const V row = dz_b[j * CV + v];
#pragma unroll
            for (int u = 0; u < kRowsEach; ++u)
              if (u == pass) add_to(acc[u], row);
          }
        }
      }
    }
  }

  if (live) {
    V* out_b = out + (b * R + row0) * CV + v;
#pragma unroll
    for (int u = 0; u < kRowsEach; ++u) {
      const int in_tile = local + u * rows_per_pass;
      if (lo + in_tile < hi)
        store_out(out_b + static_cast<int64_t>(in_tile) * CV, acc[u]);
    }
  }
  if (tile == 0 && part == 0) {  // block-uniform
    const int any = __syncthreads_or(out_of_range);
    if (threadIdx.x == 0) bad[b] = any;
  }
}

template <typename V, typename I>
int launch_kernel(const void* dz, const void* idx, void* out, void* bad,
                  int B, int N, int R, int cv, cudaStream_t s) {
  const int width = cv < kThreads ? cv : kThreads;
  const int rows_per_pass = kThreads / width;
  const int tile_rows = kRowsEach * rows_per_pass;
  const int64_t tiles = (static_cast<int64_t>(R) + tile_rows - 1) / tile_rows;
  const int64_t parts = (cv + width - 1) / width;
  const int64_t blocks = B * tiles * parts;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  scatter_rows_kernel<V, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const V*>(dz), static_cast<const I*>(idx),
      static_cast<V*>(out), static_cast<int32_t*>(bad), N, R, cv, width,
      rows_per_pass, static_cast<int>(tiles), static_cast<int>(parts));
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch(const void* dz, const void* idx, void* out, void* bad, int B,
           int N, int R, int C, cudaStream_t s) {
  const bool vec = C % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(dz) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_kernel<float4, I>(dz, idx, out, bad, B, N, R, C / 4, s)
             : launch_kernel<float, I>(dz, idx, out, bad, B, N, R, C, s);
}

}  // namespace

// idx_is_64: 0 for int32 indices, 1 for int64. bad: int32 [B], written here.
// B, N, R, C >= 1.
extern "C" int scatter_add_rows_f32(const void* dz, const void* idx,
                                    int idx_is_64, void* out, void* bad,
                                    int B, int N, int R, int C,
                                    void* stream) {
  if (B < 1 || N < 1 || R < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx_is_64 ? launch<int64_t>(dz, idx, out, bad, B, N, R, C, s)
                   : launch<int32_t>(dz, idx, out, bad, B, N, R, C, s);
}
