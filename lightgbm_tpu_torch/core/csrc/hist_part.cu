// Partitioned-layout gradient histograms on Hopper (sm_90a).
//
// Replaces the TPU kernel _hist_part_kernel of
// lightgbm_tpu/core/histogram_pallas.py:264 (pallas_call :371), entered
// through build_histogram_part_tiles :327: the histogram pass of
// partitioned batched growth (tpu_batched_part=true,
// lightgbm_tpu_torch/core/grow_batched_part.py), one launch per step.
//
// Computes, for X [F, Np] uint8 feature-major, sel [Np] f32 in {0, 1},
// vals [3, Np] f32 and tile_slot [T] int32 (T = Np / row_tile):
//   out[s, f, b, k]     = sum_n [s'(n) == s] [X[f, n] == b] vals[k, n] sel[n]
//   out[s, f, b, 3 + k] = ...                      vals[k, n] (1 - sel[n])
// where s'(n) = min(tile_slot[n / row_tile], S - 1) and a tile with a
// negative slot adds nothing. The caller's layout keeps every slot's tiles
// one contiguous run of tiles (the rows are grouped by leaf into
// tile-aligned segments), as the TPU kernel requires too. Every output
// cell is written: a slot that owns no tile comes out zero, where the TPU
// kernel leaves its block uninitialised. Bins b >= B are dropped.
//
// Bound on this card: bytes. The function must read the F bin bytes, the
// selector and the three values of every row of an active tile, the two
// tile maps, and write 4*S*F*B*6 bytes; it does 6 additions per (row,
// feature), far below any compute roof.
//
// Design. The TPU kernel sends each row tile's digit contraction to the
// output block of the tile's slot through a scalar-prefetched index map and
// relies on the grid running in order. On Hopper blocks run in parallel,
// and since the layout already groups rows by slot, no counting sort is
// needed (hist_slots.cu's count, scan and scatter launches go):
//   plan     one block numbers the runs of equal slot in tile order
//            (run_of_tile[T]; a run begins where the slot changes) and,
//            for each slot, its run and the first and last chunk the run
//            touches;
//   hist     grid (feature tile, chunk of consecutive row tiles). The
//            block skips a tile whose slot is negative before reading its
//            bytes. For the others it reads each feature's row_tile bytes
//            as 16-byte vectors (neighbouring threads on neighbouring
//            rows) and the rows' selector and values as float4, and adds
//            into a [Ft, B, 6] f32 sub-histogram in shared memory (48 KB
//            at most; shared atomics). A selector of 0 or 1 picks the
//            row's channel triple by address, so every lane runs the same
//            three atomics whichever side its row goes; a row whose three
//            values are zero (padding, masked out) is skipped. Each time
//            the run changes it writes
//            the open piece to partial piece c + r (chunk c, run r). Run
//            ordinals grow along the tiles, so the ids are unique, and a
//            slot owns one run, so there are at most C + S - 1 pieces;
//   reduce   one thread per output cell sums its slot's run's pieces in
//            chunk order; a slot with no run gets zero.
// tile_first (the JAX signature's first-tile-of-a-run map) is implied by
// tile_slot and not read. One call is three launches, scratch is sized by
// the caller from T, S and the chunk count, nothing is read back, and no
// float atomics touch global memory. A run numbered S or above (a slot in
// two runs, outside the contract) is skipped, so memory stays safe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlanThreads = 1024;
constexpr int kChannels = 6;
constexpr size_t kMaxSmemBytes = 48 * 1024;

__device__ __forceinline__ int folded(const int32_t* tile_slot, int t,
                                      int num_slots) {
  const int s = tile_slot[t];
  return s < 0 ? -1 : min(s, num_slots - 1);
}

__device__ __forceinline__ bool run_starts(const int32_t* tile_slot, int t,
                                           int num_slots) {
  const int s = folded(tile_slot, t, num_slots);
  return s >= 0 && (t == 0 || folded(tile_slot, t - 1, num_slots) != s);
}

__global__ void __launch_bounds__(kPlanThreads)
part_plan_kernel(const int32_t* __restrict__ tile_slot,
                 int* __restrict__ run_of_tile, int* __restrict__ slot_run,
                 int* __restrict__ run_c0, int* __restrict__ run_c1,
                 int n_tiles, int num_slots, int tiles_per_chunk) {
  __shared__ int sums[kPlanThreads];
  const int t = threadIdx.x;
  for (int s = t; s < num_slots; s += kPlanThreads) slot_run[s] = -1;
  const int per = (n_tiles + kPlanThreads - 1) / kPlanThreads;
  const int a = min(n_tiles, t * per);
  const int z = min(n_tiles, a + per);
  int local = 0;
  for (int i = a; i < z; ++i) local += run_starts(tile_slot, i, num_slots);
  sums[t] = local;
  __syncthreads();
  for (int d = 1; d < kPlanThreads; d <<= 1) {
    const int v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  // the ordinal of the run open before tile a (-1: none yet)
  int ord = sums[t] - local - 1;
  for (int i = a; i < z; ++i) {
    const int s = folded(tile_slot, i, num_slots);
    if (s < 0) {
      run_of_tile[i] = -1;
      continue;
    }
    if (run_starts(tile_slot, i, num_slots)) {
      ++ord;
      if (ord < num_slots) {
        slot_run[s] = ord;
        run_c0[ord] = i / tiles_per_chunk;
      }
    }
    run_of_tile[i] = ord;
    if (ord < num_slots &&
        (i == n_tiles - 1 || folded(tile_slot, i + 1, num_slots) != s))
      run_c1[ord] = i / tiles_per_chunk;
  }
}

__device__ __forceinline__ void add_rows(float* sh, int feature_cell0,
                                         unsigned word, float4 l, float4 g,
                                         float4 h, float4 m, int num_bins) {
  const float ls[4] = {l.x, l.y, l.z, l.w};
  const float gs[4] = {g.x, g.y, g.z, g.w};
  const float hs[4] = {h.x, h.y, h.z, h.w};
  const float ms[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = (word >> (8 * q)) & 0xff;
    const float v3[3] = {gs[q], hs[q], ms[q]};
    // padding and masked-out rows add nothing
    if (b >= num_bins || (v3[0] == 0.f && v3[1] == 0.f && v3[2] == 0.f))
      continue;
    float* cell = sh + (feature_cell0 + b) * kChannels;
    const float sel = ls[q];
    if (sel == 0.f || sel == 1.f) {
      // the go-left selector picks one channel triple: three atomics, the
      // same instructions on every lane whichever side its row goes
      float* side = cell + (sel == 1.f ? 0 : 3);
#pragma unroll
      for (int k = 0; k < 3; ++k) atomicAdd(side + k, v3[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        atomicAdd(cell + k, v3[k] * sel);
        atomicAdd(cell + 3 + k, v3[k] * (1.f - sel));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
part_hist_kernel(const uint8_t* __restrict__ x, const float* __restrict__ sel,
                 const float* __restrict__ vals,
                 const int* __restrict__ run_of_tile,
                 float* __restrict__ partial, long long np, int num_features,
                 int num_bins, int num_slots, int feature_tile, int row_tile,
                 int n_tiles, int tiles_per_chunk) {
  extern __shared__ float sh[];
  const int c = blockIdx.y;
  const int t0 = c * tiles_per_chunk;
  const int t1 = min(n_tiles, t0 + tiles_per_chunk);
  const int f0 = blockIdx.x * feature_tile;
  const int ft = min(feature_tile, num_features - f0);
  const int cells = ft * num_bins * kChannels;
  const long long piece = (long long)num_features * num_bins * kChannels;
  const int groups = row_tile / 16;             // 16 rows = one uint4 of bins
  const int items = ft * groups;

  auto flush = [&](int run) {
    __syncthreads();
    // [F, B, 6] is feature-major: this tile of features is one run of cells
    float* dst = partial + (long long)(c + run) * piece
                 + (long long)f0 * num_bins * kChannels;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = sh[i];
    __syncthreads();
  };

  int cur = -1;
  for (int t = t0; t < t1; ++t) {
    const int r = run_of_tile[t];              // uniform across the block
    if (r < 0 || r >= num_slots) continue;
    if (r != cur) {
      if (cur >= 0) flush(cur);
      for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
      __syncthreads();
      cur = r;
    }
    const long long tile_row0 = (long long)t * row_tile;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int j = i / groups;
      const long long row0 = tile_row0 + (long long)(i - j * groups) * 16;
      const uint4 bins = *reinterpret_cast<const uint4*>(
          x + (long long)(f0 + j) * np + row0);
      const unsigned words[4] = {bins.x, bins.y, bins.z, bins.w};
      const float4* s4 = reinterpret_cast<const float4*>(sel + row0);
      const float4* g4 = reinterpret_cast<const float4*>(vals + row0);
      const float4* h4 = reinterpret_cast<const float4*>(vals + np + row0);
      const float4* m4 = reinterpret_cast<const float4*>(vals + 2 * np + row0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        add_rows(sh, j * num_bins, words[q], __ldg(s4 + q), __ldg(g4 + q),
                 __ldg(h4 + q), __ldg(m4 + q), num_bins);
      }
    }
  }
  if (cur >= 0) flush(cur);
}

__global__ void __launch_bounds__(kThreads)
part_reduce_kernel(const float* __restrict__ partial,
                   const int* __restrict__ slot_run,
                   const int* __restrict__ run_c0,
                   const int* __restrict__ run_c1, float* __restrict__ out,
                   int num_slots, long long piece) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)num_slots * piece) return;
  const int s = (int)(i / piece);
  const long long e = i - (long long)s * piece;
  const int r = slot_run[s];
  float acc = 0.f;
  if (r >= 0) {
    for (int c = run_c0[r]; c <= run_c1[r]; ++c)
      acc += partial[(long long)(c + r) * piece + e];
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// Launch the whole pass on `stream`. x [F, np], sel [np], vals [3, np] and
// tile_slot [n_tiles] with np = n_tiles * row_tile, row_tile a multiple of
// 16 and every pointer 16-byte aligned. ints must hold n_tiles + 3 * S
// int32 (run_of_tile, slot_run, run_c0, run_c1); partial must hold
// (num_chunks + S - 1) * F * B * 6 floats and out S * F * B * 6, with
// num_chunks * tiles_per_chunk >= n_tiles. Returns the first CUDA error, 0
// on success.
int lgbt_hist_part_launch(const void* x, const void* sel, const void* vals,
                          const void* tile_slot, void* ints, void* partial,
                          void* out, long long np, int num_features,
                          int num_bins, int num_slots, int row_tile,
                          int n_tiles, int feature_tile, int num_chunks,
                          int tiles_per_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (np <= 0 || num_features <= 0 || num_bins <= 0 || num_bins > 256 ||
      num_slots <= 0 || row_tile <= 0 || row_tile % 16 != 0 ||
      n_tiles <= 0 || (long long)n_tiles * row_tile != np ||
      feature_tile <= 0 || num_chunks <= 0 || num_chunks > 65535 ||
      tiles_per_chunk <= 0 ||
      (long long)num_chunks * tiles_per_chunk < n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)feature_tile * num_bins * kChannels * sizeof(float);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);

  int* run_of_tile = static_cast<int*>(ints);
  int* slot_run = run_of_tile + n_tiles;
  int* run_c0 = slot_run + num_slots;
  int* run_c1 = run_c0 + num_slots;
  const int32_t* ts = static_cast<const int32_t*>(tile_slot);
  cudaError_t err;
  part_plan_kernel<<<1, kPlanThreads, 0, s>>>(ts, run_of_tile, slot_run,
                                               run_c0, run_c1, n_tiles,
                                               num_slots, tiles_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  float* p = static_cast<float*>(partial);
  const dim3 grid((num_features + feature_tile - 1) / feature_tile,
                  num_chunks);
  part_hist_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(sel),
      static_cast<const float*>(vals), run_of_tile, p, np, num_features,
      num_bins, num_slots, feature_tile, row_tile, n_tiles, tiles_per_chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const long long piece = (long long)num_features * num_bins * kChannels;
  const long long cells = (long long)num_slots * piece;
  part_reduce_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                       kThreads, 0, s>>>(p, slot_run, run_c0, run_c1,
                                         static_cast<float*>(out), num_slots,
                                         piece);
  return static_cast<int>(cudaGetLastError());
}

const char* lgbt_part_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
