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
// row-major and (K = 6 only) sel [n] f32 in {0, 1}:
//   K = 3: out[s, f, b, k]     = sum_n [s'(n) == s] [X[n, f] == b] vals[n, k]
//   K = 6: out[s, f, b, k]     = ... vals[n, k] * sel[n]          (k < 3)
//          out[s, f, b, 3 + k] = ... vals[n, k] * (1 - sel[n])
// where s'(n) = min(slot[n], S - 1) (the TPU kernel's clamp) and a negative
// slot marks an inactive row that adds nothing. Every output cell is
// written: a slot no row carries comes out zero. Bins b >= B are dropped.
//
// Bound on this card: bytes. The function must read the n slot ids, the
// F bin bytes and 12 value bytes of each active row (4 more bytes of sel a
// row for K = 6) and write 4*S*F*B*K bytes; it does active*F*K additions,
// far below any compute roof.
//
// Design. The TPU kernels contract a slot one-hot with a digit-factorised
// bin one-hot on the MXU; on Hopper the histogram is a scatter-reduction,
// as in histogram.cu. One (slot, feature) histogram is B*K*4 bytes (3,060
// at K = 3, 6,120 at K = 6), so the [S, F, B, K] output (21.8 MB at
// S = 254) cannot sit in shared memory, and a block that scans every row
// for the few of its own slot spends its time skipping (the first version
// of this file did that: 2.3 ms at S = 254). So the active rows are first
// grouped by slot with a counting sort, and the histogram pass then reads
// each active row once:
//   count    every row's folded slot is counted into counts[S] with
//            warp-aggregated integer atomics;
//   scan     one block turns the counts into segment offsets[S + 1] (an
//            exclusive prefix sum; offsets[S] is the active-row count) and
//            a copy of them as scatter cursors;
//   scatter  every active row claims a position in its slot's segment from
//            the cursors (warp-aggregated integer atomics) and writes its
//            row id to perm there;
//   hist     grid (feature tile, chunk of the sorted rows). A chunk of L
//            sorted positions spans one or more slot segments; for each,
//            the block builds the [Ft, B, K] f32 sub-histogram of that
//            piece in shared memory (48 KB at most, no opt-in; shared
//            atomics as in histogram.cu) and writes it to partial piece
//            c + s. Pieces are unique: a later chunk never meets an earlier
//            slot. So partial holds at most C + S - 1 pieces of F*B*K.
//   reduce   one thread per output cell sums its slot's pieces, chunk by
//            chunk in order; an empty slot gets zero.
// One call is these five launches and one memset whatever S is; all
// scratch is sized from n and S by the caller, nothing is read back. No
// float atomics outside shared memory. The order of rows inside a slot's
// segment, like the order of shared atomics inside a block, may differ
// from run to run; sums then differ in the last bits only.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kMaxRowBlocks = 4096;
constexpr size_t kMaxSmemBytes = 48 * 1024;

__device__ __forceinline__ int folded_slot(const int32_t* slot, long long row,
                                           long long n, int num_slots) {
  if (row >= n) return -1;
  const int s = slot[row];
  return s < 0 ? -1 : min(s, num_slots - 1);
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

__global__ void __launch_bounds__(kThreads)
count_kernel(const int32_t* __restrict__ slot, int* __restrict__ counts,
             long long n, int num_slots) {
  // the loop bound is uniform across a warp, so every lane reaches claim
  const long long warp0 = (long long)blockIdx.x * blockDim.x
                          + (threadIdx.x & ~31);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = warp0; base < n; base += stride) {
    claim(counts, folded_slot(slot, base + (threadIdx.x & 31), n,
                              num_slots));
  }
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

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int32_t* __restrict__ slot, int* __restrict__ cursor,
               int* __restrict__ perm, long long n, int num_slots) {
  const long long warp0 = (long long)blockIdx.x * blockDim.x
                          + (threadIdx.x & ~31);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = warp0; base < n; base += stride) {
    const long long row = base + (threadIdx.x & 31);
    const int pos = claim(cursor, folded_slot(slot, row, n, num_slots));
    if (pos >= 0) perm[pos] = (int)row;
  }
}

template <int K, bool kSel>
__global__ void __launch_bounds__(kThreads)
piece_hist_kernel(const uint8_t* __restrict__ x,
                  const float* __restrict__ vals,
                  const float* __restrict__ sel,
                  const int* __restrict__ perm,
                  const int* __restrict__ offsets,
                  float* __restrict__ partial,
                  int num_features, int num_bins, int num_slots,
                  int feature_tile, int rows_per_chunk) {
  extern __shared__ float sh[];
  const int total = offsets[num_slots];
  const int c = blockIdx.y;
  const long long start_ll = (long long)c * rows_per_chunk;
  if (start_ll >= total) return;          // uniform: the whole block leaves
  const int start = (int)start_ll;
  const int end = (int)min((long long)total, start_ll + rows_per_chunk);
  const int f0 = blockIdx.x * feature_tile;
  const int ft = min(feature_tile, num_features - f0);
  const int cells = ft * num_bins * K;
  const long long piece = (long long)num_features * num_bins * K;

  // the slot whose segment holds `start`: the last s with offsets[s] <= start
  int lo = 0, hi = num_slots - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= start) lo = mid; else hi = mid - 1;
  }
  for (int s = lo; s < num_slots; ++s) {
    const int seg0 = max(start, offsets[s]);
    const int seg1 = min(end, offsets[s + 1]);
    if (seg0 < seg1) {
      for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
      __syncthreads();
      for (int i = seg0 + threadIdx.x; i < seg1; i += blockDim.x) {
        const long long row = perm[i];
        float v[K];
        if (kSel) {
          const float l = sel[row];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float g = vals[row * 3 + k];
            v[k] = g * l;
            v[k + 3] = g * (1.f - l);
          }
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = vals[row * K + k];
        }
        const uint8_t* xr = x + row * num_features + f0;
        for (int j = 0; j < ft; ++j) {
          const int b = xr[j];
          if (b >= num_bins) continue;
          float* cell = sh + (j * num_bins + b) * K;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (v[k] != 0.f) atomicAdd(cell + k, v[k]);
          }
        }
      }
      __syncthreads();
      // [F, B, K] is feature-major: this tile is one contiguous run
      float* dst = partial + (long long)(c + s) * piece
                   + (long long)f0 * num_bins * K;
      for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = sh[i];
      __syncthreads();
    }
    if (offsets[s + 1] >= end) break;
  }
}

__global__ void __launch_bounds__(kThreads)
piece_reduce_kernel(const float* __restrict__ partial,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int num_slots, long long piece, int rows_per_chunk) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)num_slots * piece) return;
  const int s = (int)(i / piece);
  const long long e = i - (long long)s * piece;
  const int lo = offsets[s], hi = offsets[s + 1];
  float acc = 0.f;
  if (lo < hi) {
    const int c0 = lo / rows_per_chunk, c1 = (hi - 1) / rows_per_chunk;
    for (int c = c0; c <= c1; ++c) acc += partial[(long long)(c + s) * piece + e];
  }
  out[i] = acc;
}

template <int K, bool kSel>
int launch_hist(dim3 grid, size_t smem, cudaStream_t s, const uint8_t* x,
                const float* vals, const float* sel, const int* perm,
                const int* offsets, float* partial, int num_features,
                int num_bins, int num_slots, int feature_tile,
                int rows_per_chunk) {
  piece_hist_kernel<K, kSel><<<grid, kThreads, smem, s>>>(
      x, vals, sel, perm, offsets, partial, num_features, num_bins,
      num_slots, feature_tile, rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the whole pass on `stream`. k = 3 takes vals [n, 3] and no sel
// (sel may be null); k = 6 takes vals [n, 3] and sel [n]. ints must hold
// 3 * S + 1 + n int32 (counts, offsets, cursors, perm); partial must hold
// (num_chunks + S - 1) * F * B * k floats and out S * F * B * k, with
// num_chunks * rows_per_chunk >= n. Returns the first CUDA error, 0 on
// success.
int lgbt_hist_slots_launch(const void* x, const void* slot, const void* vals,
                           const void* sel, void* ints, void* partial,
                           void* out, int n, int num_features, int num_bins,
                           int num_slots, int k, int feature_tile,
                           int num_chunks, int rows_per_chunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || num_features <= 0 || num_bins <= 0 || num_bins > 256 ||
      num_slots <= 0 || feature_tile <= 0 || num_chunks <= 0 ||
      num_chunks > 65535 || rows_per_chunk <= 0 ||
      (long long)num_chunks * rows_per_chunk < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)feature_tile * num_bins * k * sizeof(float);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (k != 3 && !(k == 6 && sel != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);

  int* counts = static_cast<int*>(ints);
  int* offsets = counts + num_slots;
  int* cursor = offsets + num_slots + 1;
  int* perm = cursor + num_slots;
  const int32_t* sl = static_cast<const int32_t*>(slot);
  const unsigned row_blocks =
      (unsigned)std::min<long long>(kMaxRowBlocks, (n + kThreads - 1) / kThreads);

  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * num_slots, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  count_kernel<<<row_blocks, kThreads, 0, s>>>(sl, counts, n, num_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_kernel<<<1, kScanThreads, 0, s>>>(counts, offsets, cursor, num_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<row_blocks, kThreads, 0, s>>>(sl, cursor, perm, n,
                                                 num_slots);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((num_features + feature_tile - 1) / feature_tile,
                  num_chunks);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const float* v = static_cast<const float*>(vals);
  float* p = static_cast<float*>(partial);
  const int rc = k == 3
      ? launch_hist<3, false>(grid, smem, s, xb, v, nullptr, perm, offsets,
                              p, num_features, num_bins, num_slots,
                              feature_tile, rows_per_chunk)
      : launch_hist<6, true>(grid, smem, s, xb, v,
                             static_cast<const float*>(sel), perm, offsets,
                             p, num_features, num_bins, num_slots,
                             feature_tile, rows_per_chunk);
  if (rc != 0) return rc;

  const long long piece = (long long)num_features * num_bins * k;
  const long long cells = (long long)num_slots * piece;
  piece_reduce_kernel<<<(unsigned)((cells + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(p, offsets,
                                          static_cast<float*>(out),
                                          num_slots, piece, rows_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* lgbt_slots_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
