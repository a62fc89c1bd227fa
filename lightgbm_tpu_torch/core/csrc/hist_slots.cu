// Per-slot gradient histograms on Hopper (sm_90a).
//
// Replaces two TPU kernels of lightgbm_tpu/core/histogram_pallas.py:
//   _hist_slot_kernel :384 (its tile body _hist_slot_tile :425; pallas_call
//     :483), entered through build_histogram_slots :449 and its alias
//     build_histogram_frontier_pallas :504: the frontier wave's histogram
//     pass and the tpu_batched_pack batched step (K = 3);
//   _hist_slot6_kernel :175 (pallas_call :242), entered through
//     build_histogram_slots6 :218: the default batched step, both children
//     of every splitting parent in one pass (K = 6).
//
// Computes, for X [n, F] uint8 row-major, slot [n] int32, vals [n, 3] f32
// row-major and (K = 6 only) sel [n] f32:
//   K = 3: out[s, f, b, k]     = sum_n [s'(n) == s] [X[n, f] == b] vals[n, k]
//   K = 6: out[s, f, b, k]     = ... vals[n, k] * sel[n]          (k < 3)
//          out[s, f, b, 3 + k] = ... vals[n, k] * (1 - sel[n])
// where s'(n) = min(slot[n], S - 1) (the TPU kernel's clamp) and a negative
// slot marks an inactive row that adds nothing. Every output cell is
// written: a slot no row carries comes out zero. Bins b >= B are dropped.
// Any S >= 1 works; n * F < 2^31.
//
// Bound on this card: bytes. The function must read the n slot ids, the
// F bin bytes and 12 value bytes of each active row (4 more bytes of sel a
// row for K = 6) and write 4*S*F*B*K bytes; it does active*F*K additions,
// far below any compute roof. At 1M rows, half of them active, F = 28,
// B = 255, K = 3 that is 24 MB at S = 2 (7 us at 3.35 TB/s) and 46 MB at
// S = 254, where the output is 21.8 MB of it.
//
// Design. The TPU kernels contract a slot one-hot with a digit-factorised
// bin one-hot on the MXU; on Hopper the histogram is a scatter-reduction
// into shared memory, as in histogram.cu. One slot's [F, B, K] f32
// histogram (85,680 bytes at K = 3, 171,360 at K = 6) fits a block's
// opted-in shared memory, the [S, F, B, K] output does not, so the active
// rows are first grouped by slot with a counting sort and one pass then
// reads each active row once. A call is two memsets and four launches,
// whatever S is:
//   memset   the S slot totals, and `out`;
//   count    blocks of 2,048 consecutive rows count their rows by folded
//            slot in shared memory (native shared integer atomics, one per
//            warp and slot: lanes of a slot are aggregated with
//            __match_any_sync), then add each non-zero count to the slot's
//            total: one global atomic per (block, slot the block saw), not
//            one per (warp, slot);
//   scan     one block turns the totals into segment offsets[S + 1] (an
//            exclusive prefix sum; offsets[S] is the active-row count) and
//            a copy of them as cursors;
//   scatter  each block counts its rows again, claims its range in each
//            slot's segment with one global atomic per (block, slot) on the
//            cursors, then ranks its rows inside that range with shared
//            atomics and writes their row ids to perm there;
//   hist     a grid of one 1,024-thread block an SM (times the feature
//            tiles where F*B*K*4 bytes exceed the 227 KB opt-in; one tile
//            at F = 28). The sorted positions [0, offsets[S]) are cut into
//            equal shares, one a block, so every block has the same number
//            of rows at S = 1 (one segment spread over every SM) and at
//            S = 254 (a share crossing two or three segments). For each
//            segment its share meets, the block zeroes its histogram (in
//            two replicas at K = 3; warp w adds into replica w % 2), adds
//            the piece's rows, then adds the non-zero cells into out[s]
//            with 16-byte global reductions (red.global.add.v4.f32, scalar
//            ones at the edges of a slot that is not 16-byte aligned).
//            Thread t takes the items t, t + 1,024, ... of the piece, an
//            item being one 4-byte word of a row's bins (7 words a row at
//            F = 28), so every thread is busy however short the piece; a
//            row's id comes from perm, its values from one load each.
// No device scratch but the int32 [3S + 1 + n] of counts, offsets, cursors
// and perm; nothing is read back to the host and nothing synchronises.
//
// Atomics: the shared f32 adds compile to compare-and-swap loops (LDS,
// FADD, ATOMS.CAST.SPIN), three a (row, feature) at K = 3 and at K = 6
// (a 0/1 selector picks the child's triple by address, as in histogram.cu
// and hist_part.cu; a selector strictly between 0 and 1 adds both). They
// bound the pass; integer accumulation would change the numbers the
// growers see.
//
// Order of additions: not fixed. Rows of a slot land in its segment in
// the order the blocks claim their ranges, and shared and global atomics
// add in the order the hardware serves them, so a cell's f32 sum may move
// by a few ulps from run to run. A channel of 0/1 values (the count) is
// exact in any order below 2^24 rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSortThreads = 512;
constexpr int kSortSlots = 4096;    // slots one count/scatter pass covers
constexpr int kScanThreads = 1024;
constexpr int kHistThreads = 1024;
constexpr size_t kMaxSmemBytes = 232448;   // sm_90: 227 KB a block

// The folded slot of `row` as an index into this pass's slot window
// [s0, s0 + ns), or -1: past the block's rows, inactive, or outside.
__device__ __forceinline__ int window_slot(const int32_t* __restrict__ slot,
                                           long long row, long long r1,
                                           int num_slots, int s0, int ns) {
  if (row >= r1) return -1;
  const int s = slot[row];
  if (s < 0) return -1;
  const int w = min(s, num_slots - 1) - s0;
  return (unsigned)w < (unsigned)ns ? w : -1;
}

// Every lane of the warp calls this with its slot (-1: none). Lanes of one
// slot share one atomicAdd on counter[s]; each gets counter's old value
// plus its rank among them (-1 for s < 0).
__device__ __forceinline__ int claim(int* counter, int s) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(0xffffffffu, s);
  const int leader = __ffs(peers) - 1;
  const int rank = __popc(peers & ((1u << lane) - 1u));
  int base = 0;
  if (s >= 0 && lane == leader) base = atomicAdd(counter + s, __popc(peers));
  base = __shfl_sync(0xffffffffu, base, leader);
  return s >= 0 ? base + rank : -1;
}

// Counts the block's rows [r0, r1) by slot of the window into local[]
// (zeroed here). The loop bound is uniform across a warp, so every lane
// reaches claim.
__device__ __forceinline__ void count_rows(const int32_t* __restrict__ slot,
                                           int* local, long long r0,
                                           long long r1, int num_slots,
                                           int s0, int ns) {
  for (int i = threadIdx.x; i < ns; i += blockDim.x) local[i] = 0;
  __syncthreads();
  for (long long base = r0 + (threadIdx.x & ~31); base < r1;
       base += blockDim.x)
    claim(local, window_slot(slot, base + (threadIdx.x & 31), r1, num_slots,
                             s0, ns));
  __syncthreads();
}

// grid (row blocks, slot windows of kSortSlots)
__global__ void __launch_bounds__(kSortThreads)
count_kernel(const int32_t* __restrict__ slot, int* __restrict__ counts,
             long long n, int num_slots, int rows_per_block) {
  __shared__ int local[kSortSlots];
  const int s0 = blockIdx.y * kSortSlots;
  const int ns = min(kSortSlots, num_slots - s0);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  count_rows(slot, local, r0, min(n, r0 + rows_per_block), num_slots, s0,
             ns);
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    if (local[i]) atomicAdd(counts + s0 + i, local[i]);
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ counts, int* __restrict__ offsets,
            int* __restrict__ cursor, int num_slots) {
  __shared__ int sums[kScanThreads];
  const int t = threadIdx.x;
  const int per = (num_slots + kScanThreads - 1) / kScanThreads;
  const int s0 = min(num_slots, t * per);
  const int s1 = min(num_slots, s0 + per);
  int local = 0;
  for (int s = s0; s < s1; ++s) local += counts[s];
  sums[t] = local;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int v = t >= d ? sums[t - d] : 0;
    __syncthreads();
    sums[t] += v;
    __syncthreads();
  }
  int run = sums[t] - local;
  for (int s = s0; s < s1; ++s) {
    offsets[s] = run;
    cursor[s] = run;
    run += counts[s];
  }
  if (t == kScanThreads - 1) offsets[num_slots] = sums[t];
}

// grid as count_kernel's; the same blocks see the same rows
__global__ void __launch_bounds__(kSortThreads)
scatter_kernel(const int32_t* __restrict__ slot, int* __restrict__ cursor,
               int* __restrict__ perm, long long n, int num_slots,
               int rows_per_block) {
  __shared__ int local[kSortSlots];
  const int s0 = blockIdx.y * kSortSlots;
  const int ns = min(kSortSlots, num_slots - s0);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  count_rows(slot, local, r0, r1, num_slots, s0, ns);
  // the block's range in each slot's segment
  for (int i = threadIdx.x; i < ns; i += blockDim.x)
    if (local[i]) local[i] = atomicAdd(cursor + s0 + i, local[i]);
  __syncthreads();
  for (long long base = r0 + (threadIdx.x & ~31); base < r1;
       base += blockDim.x) {
    const long long row = base + (threadIdx.x & 31);
    const int pos = claim(local, window_slot(slot, row, r1, num_slots, s0,
                                             ns));
    if (pos >= 0) perm[pos] = (int)row;
  }
}

// floats of one shared replica: a [feature_tile, B, K] histogram after a
// lead of up to 3 floats, which puts its cells at the 16-byte phase of
// their cells in `out`; a multiple of 4
__host__ __device__ __forceinline__ int replica_floats(int feature_tile,
                                                       int num_bins, int k) {
  return (feature_tile * num_bins * k + 3 + 3) & ~3;
}

// Adds the sorted positions [seg0, seg0 + rows) into hist ([fw, B, K]
// cells of features [f0, f0 + fw)). Item j is word j % words of row
// perm[seg0 + j / words]: the aligned 4-byte words that cover the row's
// bytes of the tile, of which a last one may hold none (skipped).
template <int K, bool kSel>
__device__ __forceinline__ void add_piece(const uint8_t* __restrict__ x,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ sel,
                                          const int* __restrict__ perm,
                                          float* hist, int seg0, int rows,
                                          int num_features, int num_bins,
                                          int f0, int fw, int words) {
  const unsigned long long base = reinterpret_cast<uintptr_t>(x);
  const unsigned items = (unsigned)rows * (unsigned)words;
  for (unsigned j = threadIdx.x; j < items; j += blockDim.x) {
    const unsigned i = j / words;
    const int w = (int)(j - i * words);
    const long long row = __ldg(perm + seg0 + i);
    const float* v = vals + row * 3;
    const float v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
    if (v0 == 0.f && v1 == 0.f && v2 == 0.f) continue;   // adds nothing
    // the triple at channel offset `off`; at K = 6 a selector strictly
    // between 0 and 1 also adds the right triple c0..c2
    float a0 = v0, a1 = v1, a2 = v2, c0 = 0.f, c1 = 0.f, c2 = 0.f;
    int off = 0;
    bool both = false;
    if (kSel) {
      const float l = __ldg(sel + row);
      if (l == 0.f) {
        off = 3;
      } else if (l != 1.f) {
        a0 = v0 * l; a1 = v1 * l; a2 = v2 * l;
        c0 = v0 * (1.f - l); c1 = v1 * (1.f - l); c2 = v2 * (1.f - l);
        both = true;
      }
    }
    const unsigned long long b0 = base + row * num_features + f0;
    const unsigned long long wa = (b0 & ~3ull) + 4ull * w;
    if (wa >= b0 + fw) continue;              // the spare last word
    const unsigned word = __ldg(reinterpret_cast<const unsigned*>(wa));
    const int e0 = (int)((long long)wa - (long long)b0);   // >= -3
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int jf = e0 + q;
      if (jf < 0 || jf >= fw) continue;
      const int b = (word >> (8 * q)) & 0xff;
      if (b >= num_bins) continue;
      float* cell = hist + (jf * num_bins + b) * K;
      atomicAdd(cell + off, a0);
      atomicAdd(cell + off + 1, a1);
      atomicAdd(cell + off + 2, a2);
      if (K == 6 && both) {
        atomicAdd(cell + 3, c0);
        atomicAdd(cell + 4, c1);
        atomicAdd(cell + 5, c2);
      }
    }
  }
}

// Adds the sum of `replicas` shared histograms (`stride` floats apart;
// cell c at sh[lead + c]) into dst[0, cells), dst - lead being 16-byte
// aligned: one vector reduction per non-zero group of four cells inside
// [0, cells), scalar ones for the groups at its edges.
__device__ __forceinline__ void flush_piece(const float* sh, int stride,
                                            int replicas, int lead,
                                            int cells,
                                            float* __restrict__ dst) {
  const int groups = (lead + cells + 3) >> 2;
  const float4* sh4 = reinterpret_cast<const float4*>(sh);
  float4* dst4 = reinterpret_cast<float4*>(dst - lead);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float4 s = sh4[g];
    for (int r = 1; r < replicas; ++r) {
      const float4 t = sh4[r * (stride >> 2) + g];
      s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
    }
    const int c = 4 * g - lead;               // the cell of s.x
    if (c >= 0 && c + 4 <= cells) {
      if (s.x != 0.f || s.y != 0.f || s.z != 0.f || s.w != 0.f)
        atomicAdd(dst4 + g, s);
    } else {
      const float part[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q >= 0 && c + q < cells && part[q] != 0.f)
          atomicAdd(dst + c + q, part[q]);
    }
  }
}

// grid (blocks sharing the sorted rows, feature tiles)
template <int K, bool kSel>
__global__ void __launch_bounds__(kHistThreads, 1)
slot_hist_kernel(const uint8_t* __restrict__ x,
                 const float* __restrict__ vals,
                 const float* __restrict__ sel,
                 const int* __restrict__ perm,
                 const int* __restrict__ offsets, float* __restrict__ out,
                 int num_features, int num_bins, int num_slots,
                 int feature_tile, int replicas) {
  extern __shared__ float4 sh4[];
  float* sh = reinterpret_cast<float*>(sh4);
  const int total = offsets[num_slots];
  const int p0 = (int)((long long)total * blockIdx.x / gridDim.x);
  const int p1 = (int)((long long)total * (blockIdx.x + 1) / gridDim.x);
  if (p0 >= p1) return;                   // uniform: the whole block leaves
  const int f0 = blockIdx.y * feature_tile;
  const int fw = min(feature_tile, num_features - f0);
  const int cells = fw * num_bins * K;
  const int stride = replica_floats(feature_tile, num_bins, K);
  // words a row: one more where rows do not all start on a word
  const bool aligned = (reinterpret_cast<uintptr_t>(x) + f0) % 4 == 0 &&
                       num_features % 4 == 0;
  const int words = (fw + 3) / 4 + (aligned ? 0 : 1);
  float* mine = sh + (threadIdx.x / 32 % replicas) * stride;

  // the slot whose segment holds p0: the last s with offsets[s] <= p0
  int s = 0, hi = num_slots - 1;
  while (s < hi) {
    const int mid = (s + hi + 1) >> 1;
    if (offsets[mid] <= p0) s = mid; else hi = mid - 1;
  }
  for (; s < num_slots; ++s) {
    const int seg0 = max(p0, offsets[s]);
    const int seg1 = min(p1, offsets[s + 1]);
    if (seg0 >= p1) break;
    if (seg0 >= seg1) continue;             // an empty slot
    const long long dst = ((long long)s * num_features + f0) * num_bins * K;
    const int lead = (int)(dst & 3);
    for (int i = threadIdx.x; i < stride * replicas / 4; i += blockDim.x)
      sh4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    add_piece<K, kSel>(x, vals, sel, perm, mine + lead, seg0, seg1 - seg0,
                       num_features, num_bins, f0, fw, words);
    __syncthreads();
    flush_piece(sh, stride, replicas, lead, cells, out + dst);
    __syncthreads();
  }
}

// the largest dynamic shared memory each hist kernel (K=3, K=6) was opted
// in to, by device (an opt-in holds for the current device only)
constexpr int kMaxDevices = 64;
size_t g_smem_opt_in[kMaxDevices][2] = {};

// Opts `fn` in to `smem` bytes of dynamic shared memory where that is
// above the default 48 KB and above what it was opted in to before.
cudaError_t opt_in(const void* fn, int which, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  size_t& opted = g_smem_opt_in[dev][which];
  if (smem > 48 * 1024 && smem > opted) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  return cudaSuccess;
}

template <int K, bool kSel>
cudaError_t launch_hist(dim3 grid, size_t smem, cudaStream_t s,
                        const uint8_t* x, const float* vals, const float* sel,
                        const int* perm, const int* offsets, float* out,
                        int num_features, int num_bins, int num_slots,
                        int feature_tile, int replicas) {
  const cudaError_t err = opt_in(
      reinterpret_cast<const void*>(slot_hist_kernel<K, kSel>), K == 6, smem);
  if (err != cudaSuccess) return err;
  slot_hist_kernel<K, kSel><<<grid, kHistThreads, smem, s>>>(
      x, vals, sel, perm, offsets, out, num_features, num_bins, num_slots,
      feature_tile, replicas);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the whole pass on `stream`. k = 3 takes vals [n, 3] and no sel
// (sel may be null); k = 6 takes vals [n, 3] and sel [n]. ints must hold
// 3 * S + 1 + n int32 (counts, offsets, cursors, perm) and out S * F * B * k
// floats, 16-byte aligned. count and scatter run sort_blocks blocks of
// rows_per_sort_block rows (covering n) for each of slot_windows windows
// of 4,096 slots (covering S); hist runs hist_blocks blocks a feature tile
// of feature_tile features, each with smem_bytes of dynamic shared memory:
// replicas copies of replica_floats(feature_tile, B, k) floats. Needs
// n * F < 2^31. Returns the first CUDA error, 0 on success.
int lgbt_hist_slots_launch(const void* x, const void* slot, const void* vals,
                           const void* sel, void* ints, void* out, int n,
                           int num_features, int num_bins, int num_slots,
                           int k, int sort_blocks, int rows_per_sort_block,
                           int slot_windows, int hist_blocks,
                           int feature_tile, int replicas,
                           long long smem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || num_features <= 0 || num_bins <= 0 || num_bins > 256 ||
      num_slots <= 0 || (long long)n * num_features >= (1ll << 31) ||
      sort_blocks <= 0 || rows_per_sort_block <= 0 ||
      (long long)sort_blocks * rows_per_sort_block < n || hist_blocks <= 0 ||
      feature_tile <= 0 || feature_tile > num_features || replicas <= 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (num_features + feature_tile - 1) / feature_tile;
  if (smem_bytes != (long long)replicas *
                        replica_floats(feature_tile, num_bins, k) * 4 ||
      (size_t)smem_bytes > kMaxSmemBytes || tiles > 65535 ||
      slot_windows != (num_slots + kSortSlots - 1) / kSortSlots ||
      slot_windows > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k != 3 && !(k == 6 && sel != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);

  int* counts = static_cast<int*>(ints);
  int* offsets = counts + num_slots;
  int* cursor = offsets + num_slots + 1;
  int* perm = cursor + num_slots;
  const int32_t* sl = static_cast<const int32_t*>(slot);
  float* o = static_cast<float*>(out);

  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * num_slots, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(o, 0, sizeof(float) * num_slots * num_features *
                                  (size_t)num_bins * k, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 sort_grid(sort_blocks, slot_windows);
  count_kernel<<<sort_grid, kSortThreads, 0, s>>>(sl, counts, n, num_slots,
                                                  rows_per_sort_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offsets, cursor, num_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<sort_grid, kSortThreads, 0, s>>>(
      sl, cursor, perm, n, num_slots, rows_per_sort_block);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(hist_blocks, tiles);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const float* v = static_cast<const float*>(vals);
  err = k == 3
      ? launch_hist<3, false>(grid, (size_t)smem_bytes, s, xb, v, nullptr,
                              perm, offsets, o, num_features, num_bins,
                              num_slots, feature_tile, replicas)
      : launch_hist<6, true>(grid, (size_t)smem_bytes, s, xb, v,
                             static_cast<const float*>(sel), perm, offsets,
                             o, num_features, num_bins, num_slots,
                             feature_tile, replicas);
  return static_cast<int>(err);
}

const char* lgbt_slots_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
