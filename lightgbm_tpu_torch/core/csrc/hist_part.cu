// Partitioned-layout gradient histograms on Hopper (sm_90a).
//
// Replaces the TPU kernel _hist_part_kernel of
// lightgbm_tpu/core/histogram_pallas.py:264 (pallas_call :371), entered
// through build_histogram_part_tiles :327: the histogram pass of
// partitioned batched growth (tpu_batched_part=true,
// lightgbm_tpu_torch/core/grow_batched_part.py), one call per step.
//
// Computes, for X [F, Np] uint8 feature-major, sel [Np] f32, vals [3, Np]
// f32 and tile_slot [T] int32 (T = Np / row_tile):
//   out[s, f, b, k]     = sum_n [s'(n) == s] [X[f, n] == b] vals[k, n] sel[n]
//   out[s, f, b, 3 + k] = ...                      vals[k, n] (1 - sel[n])
// where s'(n) = min(tile_slot[n / row_tile], S - 1) and a tile with a
// negative slot adds nothing. The caller's layout keeps every slot's tiles
// one contiguous run of tiles (the rows are grouped by leaf into
// tile-aligned segments), as the TPU kernel requires; this kernel adds
// correctly without it too. Every output cell is written: a slot that owns
// no tile comes out zero, where the TPU kernel leaves its block
// uninitialised. Bins b >= B are dropped. tile_first (the JAX signature's
// first-tile-of-a-run map) is implied by tile_slot and not read.
//
// Bound on this card: bytes. The function must read the F bin bytes, the
// selector and the three values of every row of an active tile, the two
// tile maps, and write 4*S*F*B*6 bytes (core/kernels.py part_hist_bytes);
// it does 6 additions per (row, feature), far below any compute roof. At
// Np = 1,525,760, F = 28, B = 255, S = 16 with half of the 489 row-holding
// tiles active that is 24.9 MB, 7.4 us at 3.35 TB/s.
//
// Design. The TPU kernel sends each row tile's digit contraction to the
// output block of the tile's slot through a scalar-prefetched index map and
// relies on the grid running in order. On Hopper the histogram is a
// scatter-reduction into shared memory, as in hist_slots.cu; the layout is
// already grouped by slot, so no sort is needed. A call is one memset and
// two launches, whatever S is:
//   memset    `out`;
//   list      one block lists the active tiles in tile order with their
//             folded slots, and their count A; nothing is read back, so
//             the host sizes the grid from T and F alone;
//   run_hist  a grid of one 1,024-thread block an SM, times the feature
//             tiles where F*B*7 words exceed the 227 KB opt-in (one tile
//             at F = 28, B = 255). The A * row_tile active row positions
//             are cut into equal shares at multiples of 4 rows, one a
//             block, so a block meets the same number of rows at S = 1 and
//             at S = 254. For each run of one slot that its share meets
//             (at most 65,532 rows at a time), the block adds the run's
//             rows into its [Ft, B, 6] histogram, then adds the non-zero
//             cells into out[s] with 16-byte global reductions
//             (red.global.add.v4.f32; scalar ones at the edges of a slot
//             that is not 16-byte aligned), zeroing the histogram for the
//             next run as it goes.
// The add phase:
//   items     4 consecutive rows (one float4 each of sel, g, h and m, read
//             once for the item's features) and every fsplit-th feature
//             from j < fsplit; an item reads one 4-byte word of 4 bins a
//             feature. Each piece picks the fsplit that gives its threads
//             the fewest steps, passes times features an item (an item's
//             own work counted as half a feature), so a piece a little
//             over 1,024 groups of 4 rows leaves no second pass of a few
//             threads walking all 28 features.
//   stagger   groups of 4 neighbouring items start their walk over the
//             features at neighbouring features, so the 32 lanes of a
//             warp add into 8 features at each step and a group reads 16
//             bytes of a feature's bins. Lanes rarely hit one cell, which
//             would send the compare-and-swap loop of a shared f32 add
//             round again where most of a feature's rows share a bin
//             (lanes in step were 4x slower on 80-98% skewed bins), and a
//             warp reads as few sectors as in step (an item a feature of
//             its own was 15% slower at S = 1).
//   rows      a row whose three values are zero (segment padding, masked
//             rows) adds nothing and is skipped once for all features. A
//             0/1 selector picks the child's channel triple by address; a
//             selector strictly between 0 and 1 adds both triples.
//   counts    a row whose count value m is exactly 1 and whose selector is
//             0 or 1 (every real row of the main path) adds g and h with
//             two shared f32 atomics and counts itself with one native
//             integer atomic into a [Ft, B] uint32 beside the histogram
//             (the left child in the low 16 bits, the right in the high
//             16); other rows add m in f32. Before each flush the counts
//             are added into the count channels and zeroed; 65,532 rows a
//             piece keep them from wrapping.
// The shared histogram keeps the cells of the block's features in out's
// order after a lead of up to 3 floats, which puts them at the 16-byte
// phase of their cells in out, so a flush reads, zeroes and reduces 16
// bytes at a time. Shared memory at F = 28, B = 255: 171,376 bytes of
// histogram and 28,560 of counts. No device scratch but the int32
// [1 + 2T] of the list.
//
// Atomics: the shared f32 adds compile to compare-and-swap loops (LDS,
// FADD, ATOMS.CAST.SPIN); they bound the pass. Counting in integers keeps
// the numbers the growers see: a sum of ones is exact in f32 too. Integer
// accumulation of g and h would change them.
//
// Order of additions: not fixed. Shared and global atomics add in the
// order the hardware serves them, so a cell's f32 sum may move by a few
// ulps from run to run. A count channel of 0/1 values is exact below 2^24
// rows, in integers or f32 alike.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kListThreads = 1024;
constexpr int kHistThreads = 1024;
constexpr int kChannels = 6;
constexpr size_t kMaxSmemBytes = 232448;   // sm_90: 227 KB a block
constexpr int kMaxPieceRows = 65532;        // a multiple of 4 below 2^16

// floats of the shared histogram of feature_tile features after a lead of
// up to 3 floats, a multiple of 4
__host__ __device__ __forceinline__ int hist_floats(int feature_tile,
                                                    int num_bins) {
  return (feature_tile * num_bins * kChannels + 3 + 3) & ~3;
}

// ints[0] = A, the active tiles; ints[1 + a] the a-th active tile in tile
// order; ints[1 + T + a] its slot, folded into [0, S).
__global__ void __launch_bounds__(kListThreads)
part_list_kernel(const int32_t* __restrict__ tile_slot,
                 int* __restrict__ ints, int n_tiles, int num_slots) {
  __shared__ int sums[kListThreads];
  const int t = threadIdx.x;
  const int per = (n_tiles + kListThreads - 1) / kListThreads;
  const int a = min(n_tiles, t * per);
  const int z = min(n_tiles, a + per);
  int local = 0;
  for (int i = a; i < z; ++i) local += tile_slot[i] >= 0;
  sums[t] = local;
  __syncthreads();
  for (int d = 1; d < kListThreads; d <<= 1) {
    const int v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int* act_tile = ints + 1;
  int* act_slot = ints + 1 + n_tiles;
  int ord = sums[t] - local;
  for (int i = a; i < z; ++i) {
    const int s = tile_slot[i];
    if (s < 0) continue;
    act_tile[ord] = i;
    act_slot[ord] = min(s, num_slots - 1);
    ++ord;
  }
  if (t == kListThreads - 1) ints[0] = sums[t];
}

// Adds a row's (g, h, m) into the cell: into the left triple for a
// selector l of 1, the right for 0, else times l and times 1 - l into both.
__device__ __forceinline__ void add_row(float* cell, float l, float g,
                                        float h, float m) {
  if (l == 1.f || l == 0.f) {
    // the go-left selector picks one channel triple: three atomics, the
    // same instructions on every lane whichever side its row goes
    float* side = cell + (l == 1.f ? 0 : 3);
    atomicAdd(side, g);
    atomicAdd(side + 1, h);
    atomicAdd(side + 2, m);
  } else {
    const float r = 1.f - l;
    atomicAdd(cell, g * l);
    atomicAdd(cell + 1, h * l);
    atomicAdd(cell + 2, m * l);
    atomicAdd(cell + 3, g * r);
    atomicAdd(cell + 4, h * r);
    atomicAdd(cell + 5, m * r);
  }
}

// The features an item takes, every fsplit-th: the fsplit in [1, fw]
// with the fewest steps a thread, passes * (2 * features an item + 1),
// the smallest on a tie. The lanes of each warp try fsplit = lane + 1,
// lane + 33, ... and agree on the best with shuffles; the block runs
// kHistThreads threads, so every thread gets the same answer.
__device__ __forceinline__ int pick_fsplit(int groups, int fw) {
  unsigned long long best = ~0ull;           // cost << 32 | fsplit
  for (int fs = (threadIdx.x & 31) + 1; fs <= fw; fs += 32) {
    const unsigned long long passes =
        ((unsigned long long)groups * fs + kHistThreads - 1) / kHistThreads;
    const unsigned long long cost = passes * (2 * ((fw + fs - 1) / fs) + 1);
    best = min(best, cost << 32 | (unsigned)fs);
  }
  for (int d = 16; d > 0; d >>= 1)
    best = min(best, __shfl_xor_sync(0xffffffffu, best, d));
  return (int)(best & 0xffffffffu);
}

// Adds the active positions [seg0, seg0 + 4 * groups) into the shared
// histogram of features [f0, f0 + fw) (feature f's cells from
// sh[f * B * 6]) and the counts of its rows whose count value is 1 into
// counts[f * B + b] (left in the low 16 bits, right in the high 16).
// Position p is row act_tile[p / row_tile] * row_tile + p % row_tile.
__device__ __forceinline__ void add_piece(const uint8_t* __restrict__ x,
                                          const float* __restrict__ sel,
                                          const float* __restrict__ vals,
                                          const int* __restrict__ act_tile,
                                          float* sh, unsigned* counts,
                                          long long seg0, int groups,
                                          long long np, int num_bins, int f0,
                                          int fw, int row_tile) {
  const int stride = num_bins * kChannels;
  const int fsplit = pick_fsplit(groups, fw);
  const int items = groups * fsplit;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int q4 = i / fsplit;
    const int j = i - q4 * fsplit;
    const long long p = seg0 + 4ll * q4;
    const long long a = p / row_tile;
    const long long row0 =
        (long long)__ldg(act_tile + a) * row_tile + (p - a * row_tile);
    const float4 g = __ldg(reinterpret_cast<const float4*>(vals + row0));
    const float4 h =
        __ldg(reinterpret_cast<const float4*>(vals + np + row0));
    const float4 m =
        __ldg(reinterpret_cast<const float4*>(vals + 2 * np + row0));
    const float4 l = __ldg(reinterpret_cast<const float4*>(sel + row0));
    const float gs[4] = {g.x, g.y, g.z, g.w};
    const float hs[4] = {h.x, h.y, h.z, h.w};
    const float ms[4] = {m.x, m.y, m.z, m.w};
    const float ls[4] = {l.x, l.y, l.z, l.w};
    unsigned live = 0, counted = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (gs[q] != 0.f || hs[q] != 0.f || ms[q] != 0.f) live |= 1u << q;
      // a row of count 1 that feeds one child counts in an integer
      if (ms[q] == 1.f && (ls[q] == 0.f || ls[q] == 1.f)) counted |= 1u << q;
    }
    if (!live) continue;                     // padding: adds nothing
    // features j, j + fsplit, ...: cnt of them, walked from the
    // (q4 / 4)-th on
    const int cnt = (fw - j + fsplit - 1) / fsplit;
    int step = (q4 >> 2) % cnt;
    const uint8_t* xr = x + row0;
    unsigned next = __ldg(reinterpret_cast<const unsigned*>(
        xr + (long long)(f0 + j + step * fsplit) * np));
    for (int k = 0; k < cnt; ++k) {
      const int f = j + step * fsplit;
      const unsigned word = next;
      if (++step == cnt) step = 0;
      if (k + 1 < cnt)
        next = __ldg(reinterpret_cast<const unsigned*>(
            xr + (long long)(f0 + j + step * fsplit) * np));
      float* fh = sh + f * stride;
      unsigned* fc = counts + f * num_bins;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = (word >> (8 * q)) & 0xff;
        if (!((live >> q) & 1u) || b >= num_bins) continue;
        if ((counted >> q) & 1u) {
          // two shared f32 adds and one native integer add
          float* side = fh + b * kChannels + (ls[q] == 1.f ? 0 : 3);
          atomicAdd(side, gs[q]);
          atomicAdd(side + 1, hs[q]);
          atomicAdd(fc + b, ls[q] == 1.f ? 1u : 0x10000u);
        } else {
          add_row(fh + b * kChannels, ls[q], gs[q], hs[q], ms[q]);
        }
      }
    }
  }
}

// Adds the integer counts (the (f, b) cell's left and right halves) into
// the count channels of the shared histogram (cell c at sh[c]) and zeroes
// them: one thread a (feature, bin), so plain adds.
__device__ __forceinline__ void fold_counts(float* sh, unsigned* counts,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned w = counts[i];
    if (!w) continue;
    counts[i] = 0;
    sh[i * kChannels + 2] += (float)(w & 0xffffu);
    sh[i * kChannels + 5] += (float)(w >> 16);
  }
}

// Adds the shared histogram (cell c at sh[lead + c]) into dst[0, cells),
// dst - lead being 16-byte aligned, and zeroes it: groups4 groups of four
// floats, one vector reduction per non-zero group inside [0, cells), scalar
// ones for the groups at its edges.
__device__ __forceinline__ void flush_piece(float4* sh4, int groups4,
                                            int lead, int cells,
                                            float* __restrict__ dst) {
  float4* dst4 = reinterpret_cast<float4*>(dst - lead);
  for (int g = threadIdx.x; g < groups4; g += blockDim.x) {
    const float4 v = sh4[g];
    sh4[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    const int c = 4 * g - lead;               // the cell of v.x
    if (c >= 0 && c + 4 <= cells) {
      if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
        atomicAdd(dst4 + g, v);
    } else if (c < cells) {
      const float part[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q >= 0 && c + q < cells && part[q] != 0.f)
          atomicAdd(dst + c + q, part[q]);
    }
  }
}

// grid (blocks sharing the active rows, feature tiles)
__global__ void __launch_bounds__(kHistThreads, 1)
part_run_hist_kernel(const uint8_t* __restrict__ x,
                     const float* __restrict__ sel,
                     const float* __restrict__ vals,
                     const int* __restrict__ ints, float* __restrict__ out,
                     long long np, int num_features, int num_bins,
                     int row_tile, int n_tiles, int feature_tile) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const long long total = (long long)__ldg(ints) * row_tile;
  const long long p0 = total * blockIdx.x / gridDim.x & ~3ll;
  const long long p1 = total * (blockIdx.x + 1) / gridDim.x & ~3ll;
  if (p0 >= p1) return;                   // uniform: the whole block leaves
  const int* act_tile = ints + 1;
  const int* act_slot = ints + 1 + n_tiles;
  const int f0 = blockIdx.y * feature_tile;
  const int fw = min(feature_tile, num_features - f0);
  const int cells = fw * num_bins * kChannels;
  const int groups4 = hist_floats(fw, num_bins) / 4;
  // the counts after the histogram of a whole feature tile
  unsigned* counts =
      reinterpret_cast<unsigned*>(sh + hist_floats(feature_tile, num_bins));
  for (int i = threadIdx.x; i < groups4; i += blockDim.x)
    sh4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = threadIdx.x; i < fw * num_bins; i += blockDim.x)
    counts[i] = 0;
  __syncthreads();

  for (long long seg0 = p0; seg0 < p1;) {
    // the run of one slot from seg0: active tiles a .. end - 1
    long long a = seg0 / row_tile;
    const int s = __ldg(act_slot + a);
    long long end = a + 1;
    while (end * row_tile < p1 && __ldg(act_slot + end) == s) ++end;
    // at most kMaxPieceRows rows a piece, so 16-bit counts cannot wrap
    const long long seg1 =
        min(min(p1, end * row_tile), seg0 + kMaxPieceRows);
    const long long dst =
        ((long long)s * num_features + f0) * num_bins * kChannels;
    const int lead = (int)(dst & 3);
    add_piece(x, sel, vals, act_tile, sh + lead, counts, seg0,
              (int)((seg1 - seg0) / 4), np, num_bins, f0, fw, row_tile);
    __syncthreads();
    fold_counts(sh + lead, counts, fw * num_bins);
    __syncthreads();
    flush_piece(sh4, groups4, lead, cells, out + dst);
    __syncthreads();
    seg0 = seg1;
  }
}

// the largest dynamic shared memory part_run_hist_kernel was opted in to, by
// device (an opt-in holds for the current device only)
constexpr int kMaxDevices = 64;
size_t g_smem_opt_in[kMaxDevices] = {};

cudaError_t opt_in(size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > g_smem_opt_in[dev]) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(part_run_hist_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    g_smem_opt_in[dev] = smem;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch the whole pass on `stream`. x [F, np], sel [np], vals [3, np] and
// tile_slot [n_tiles] with np = n_tiles * row_tile, row_tile a multiple of
// 4, x, sel, vals and out 16-byte aligned. ints must hold 1 + 2 * n_tiles
// int32 and out S * F * B * 6 floats. hist runs hist_blocks blocks for
// each feature tile of feature_tile features, each with smem_bytes of
// dynamic shared memory (4 * (hist_floats(feature_tile, B) +
// feature_tile * B)). Returns the first CUDA error, 0 on success.
int lgbt_hist_part_launch(const void* x, const void* sel, const void* vals,
                          const void* tile_slot, void* ints, void* out,
                          long long np, int num_features, int num_bins,
                          int num_slots, int row_tile, int n_tiles,
                          int feature_tile, int hist_blocks,
                          long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (np <= 0 || num_features <= 0 || num_bins <= 0 || num_bins > 256 ||
      num_slots <= 0 || row_tile <= 0 || row_tile % 4 != 0 ||
      n_tiles <= 0 || (long long)n_tiles * row_tile != np ||
      feature_tile <= 0 || feature_tile > num_features || hist_blocks <= 0 ||
      smem_bytes != 4ll * (hist_floats(feature_tile, num_bins) +
                           feature_tile * num_bins) ||
      (size_t)smem_bytes > kMaxSmemBytes ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(sel) |
       reinterpret_cast<uintptr_t>(vals) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (num_features + feature_tile - 1) / feature_tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);

  float* o = static_cast<float*>(out);
  int* in = static_cast<int*>(ints);
  cudaError_t err = cudaMemsetAsync(
      o, 0, sizeof(float) * num_slots * num_features * (size_t)num_bins *
                kChannels, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  part_list_kernel<<<1, kListThreads, 0, s>>>(
      static_cast<const int32_t*>(tile_slot), in, n_tiles, num_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if ((err = opt_in((size_t)smem_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  part_run_hist_kernel<<<dim3(hist_blocks, tiles), kHistThreads,
                     (size_t)smem_bytes, s>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(sel),
      static_cast<const float*>(vals), in, o, np, num_features, num_bins,
      row_tile, n_tiles, feature_tile);
  return static_cast<int>(cudaGetLastError());
}

const char* lgbt_part_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
