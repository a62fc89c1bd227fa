// Per-feature gradient histograms on Hopper (sm_90a).
//
// Replaces the TPU kernel `_hist_kernel` of
// lightgbm_tpu/core/histogram_pallas.py:67 (its pallas_call at :159),
// entered there through build_histogram_pallas (K=3, the root of a tree)
// and build_histogram_pallas_vals (K=6, both children of a split).
//
// Computes, for X [n, F] uint8 row-major and vals [n, K] f32 row-major:
//     out[f, b, k] = sum_n [X[n, f] == b] * vals[n, k]      out [F, B, K] f32
// Bins b >= B are dropped, as the TPU kernel drops bins past num_bins.
// Every function is templated on the value type: the float64 variant
// (gpu_use_dp, exact growth) sums vals [n, K] f64 into out f64, where the
// JAX package sums f64 histograms in XLA (core/histogram.py:51 scatter on
// the CPU, :34 one-hot matmul on a TPU), not in a Pallas kernel. `if
// constexpr` keeps the f32 vector reductions out of the f64 instantiation.
//
// Bound on this card: bytes. The function must read n*F + 4*n*K bytes and
// write 4*F*B*K; it does n*F*K additions, far below any compute roof. At
// the root shape (n=1e6, F=28, K=3) that is 40 MB, ~12 us at 3.35 TB/s; a
// split pass of 4,096 rows moves 0.3 MB, ~0.1 us, so there the launch and
// the grid's fill bound it instead.
//
// One call is a memset of `out` and one kernel, of one of two variants
// that the caller's plan picks by the number of rows (core/kernels.py
// hist_launch_plan; HIST_DIRECT_MAX_ROWS = 8,192, where the two variants'
// device times cross on the H100 between 4,096 and 16,384 rows):
//
//   direct  (n <= 8,192: about half of exact growth's split passes)  a
//           grid that scales with n*F. Each thread reads aligned 4-byte
//           words of the flat [n*F] bin array (neighbouring threads on
//           neighbouring words), takes the four (row, feature) elements of
//           its word and adds each row's values straight into `out` with
//           global atomics. No sub-histogram to zero or flush, no partial.
//           Bound by the rate at which the L2 serves scattered reductions.
//   block   (n > 8,192: the root and the larger splits)  one block of 1,024
//           threads per SM. It keeps the whole [F, B, K] f32 histogram in
//           dynamic shared memory (171 KB at F=28, B=255, K=6; the launcher
//           opts in above 48 KB), in as many replicas as fit (two at K=3;
//           warp w adds into replica w % R), reads its contiguous slice of
//           rows once as aligned words in the same way, and at the end adds
//           the sum of its replicas' non-zero cells into `out` with
//           coalesced 16-byte global atomics. Scratch in device memory:
//           none. Where F*B*K*4 bytes exceed the 227 KB a block may hold,
//           blocks split the features into tiles and each reads the rows
//           again (not on the main path: F=28). Bound by the shared f32
//           atomics.
//
// Atomics, from `cuobjdump -sass` of this library (sm_90a, CUDA 12.8):
//   direct  each triple is REDG.E.ADD.F32x2.FTZ.RN.STRONG.GPU (its
//           8-byte-aligned pair) and REDG.E.ADD.F32.FTZ.RN.STRONG.GPU (the
//           third channel): native reductions, executed at the L2; f64:
//           three REDG.E.ADD.F64.RN.STRONG.GPU, native too;
//   block   the shared adds are compare-and-swap loops (LDS, FADD,
//           ATOMS.CAST.SPIN, branch), three a row; the flush is
//           REDG.E.ADD.F32x4.FTZ.RN.STRONG.GPU. f64: 64-bit loops
//           (ATOMS.CAST.SPIN.64), one replica at F=28, B=255 (171 KB at
//           K=3; K=6 takes two feature tiles of 14), and a scalar
//           REDG.E.ADD.F64.RN.STRONG.GPU flush. On the H100 the f64 root
//           takes 1.33x the f32 time (0.34 against 0.26 ms), a split pass
//           of 4,096 rows about the same, one of 262,144 rows 1.8x.
// Tried on the H100 and dropped, slower at every shape: a 64-bit
// compare-and-swap over a channel pair in shared memory (ATOMS.CAS.64;
// two loops a row instead of three, but ~2x slower at the root), and
// warps that each own one feature's cells and add without atomics, lanes
// taking turns where their bins meet (__match_any_sync). Reading 16 bytes
// a thread in the block variant gained ~4% at the root and lost at 16k
// rows. The global f32 atomics flush subnormal values to zero, within the
// stated tolerance of 1e-5 * sum_bin|v| + 1e-6.
//
// Channels: at K=6 a row feeds one child, so one of its two triples is
// zero. The row picks the non-zero triple by address (offset 0 when the
// left triple has a non-zero value, else 3), so every lane runs the same
// atomics whichever side it goes; a row whose values are all zero
// (masked out) adds nothing, and a row with both triples non-zero (outside
// the partition's contract, but the function allows it) adds the right
// triple in a second, rarely taken branch.
//
// Order of additions: neither variant fixes it. Shared atomics within a
// block, the flush of the blocks into `out` and the direct variant's
// global atomics all land in whatever order the hardware serves them, so
// a cell's f32 sum may differ by a few ulps from run to run (chip_smoke.py
// phase 5 holds the trees to the f32 tie rule). A channel of 0/1 values
// (the count) stays exact in any order below 2^24 rows. f64 sums round
// at 2^-53 in any order: phase 5 holds the f64 trees node for node.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDirectThreads = 128;
constexpr int kBlockThreads = 1024;

// One row's values as the atomics take them: the triple `a0..a2` at
// channel offset `off` (the non-zero one at K=6), and at K=6 the right
// triple `c0..c2` when both are non-zero.
template <typename T, int K>
struct RowVals {
  T a0, a1, a2, c0, c1, c2;
  int off;
  bool any, both;
};

template <typename T, int K>
__device__ __forceinline__ void load_row(const T* __restrict__ vals,
                                         unsigned row, RowVals<T, K>& r) {
  const T* v = vals + (size_t)row * K;
  const T v0 = __ldg(v), v1 = __ldg(v + 1), v2 = __ldg(v + 2);
  const bool left = v0 != T(0) || v1 != T(0) || v2 != T(0);
  if (K == 3) {
    r.a0 = v0; r.a1 = v1; r.a2 = v2;
    r.off = 0;
    r.any = left;
    r.both = false;
  } else {
    const T w0 = __ldg(v + 3), w1 = __ldg(v + 4), w2 = __ldg(v + 5);
    const bool right = w0 != T(0) || w1 != T(0) || w2 != T(0);
    r.a0 = left ? v0 : w0; r.a1 = left ? v1 : w1; r.a2 = left ? v2 : w2;
    r.c0 = w0; r.c1 = w1; r.c2 = w2;
    r.off = left ? 0 : 3;
    r.any = left || right;
    r.both = left && right;
  }
}

// Adds row r's values into the cell whose channel 0 is hist[cell] (hist
// 8-byte aligned), the triple at channel offset r.off.
//   shared  three scalar atomics (f32: each a LDS, FADD, ATOMS.CAST.SPIN
//           loop; f64: see the header);
//   global  f32: the triple's 8-byte-aligned pair as one vector reduction
//           and the third channel as a scalar one. The triple starts at an
//           even float (K=6 left; K=3 even cells), so the pair is channels
//           0-1, or at an odd one (K=6 right; K=3 odd cells), so it is
//           channels 1-2. Every lane runs the same two reductions, with
//           per-lane addresses and values selected without a branch.
//           f64: three scalar reductions (there is no vector f64 one).
template <typename T, int K, bool SHARED>
__device__ __forceinline__ void add_cell(T* hist, size_t cell,
                                         const RowVals<T, K>& r) {
  if (!r.any) return;
  const size_t at = cell + r.off;
  T* p = hist + at;
  if constexpr (SHARED || sizeof(T) == 8) {
    atomicAdd(p, r.a0);
    atomicAdd(p + 1, r.a1);
    atomicAdd(p + 2, r.a2);
    if (K == 6 && r.both) {
      atomicAdd(hist + cell + 3, r.c0);
      atomicAdd(hist + cell + 4, r.c1);
      atomicAdd(hist + cell + 5, r.c2);
    }
  } else {
    const bool even = (at & 1) == 0;
    atomicAdd(reinterpret_cast<float2*>(even ? p : p + 1),
              make_float2(even ? r.a0 : r.a1, even ? r.a1 : r.a2));
    atomicAdd(even ? p + 2 : p, even ? r.a2 : r.a0);
    // the right triple of a row that feeds both (channel 3 is odd)
    if (K == 6 && r.both) {
      atomicAdd(reinterpret_cast<float2*>(hist + cell + 4),
                make_float2(r.c1, r.c2));
      atomicAdd(hist + cell + 3, r.c0);
    }
  }
}

// Adds the elements e in [e0, e1) of the flat [n * F] bin array whose
// feature lies in [f0, f0 + fw) into hist ([fw, B, K] cells). The range is
// cut into aligned 4-byte words; thread t of nt takes the words t, t + nt,
// ..., loading the next one before it adds the current one (an aligned word
// that holds a byte of the array lies in the array's allocation, and its
// bytes outside the range are skipped). A word that runs into the next row
// loads that row's values up front too.
template <typename T, int K, bool SHARED>
__device__ __forceinline__ void add_range(const uint8_t* __restrict__ x,
                                          const T* __restrict__ vals,
                                          T* hist, unsigned e0,
                                          unsigned e1, int num_features,
                                          int f0, int fw, int num_bins,
                                          unsigned t, unsigned nt) {
  if (e0 >= e1) return;
  const unsigned long long base = reinterpret_cast<uintptr_t>(x);
  const unsigned long long first = (base + e0) & ~3ull;
  const unsigned words = (unsigned)((base + e1 - first + 3) >> 2);
  const unsigned last_row = (e1 - 1) / num_features;
  const unsigned* w4 = reinterpret_cast<const unsigned*>(first);
  unsigned cur = t < words ? __ldg(w4 + t) : 0u;
  for (unsigned w = t; w < words; w += nt) {
    const unsigned next = w + nt < words ? __ldg(w4 + w + nt) : 0u;
    const long long e = (long long)(first + 4ull * w) - (long long)base;
    const int q0 = e < (long long)e0 ? (int)((long long)e0 - e) : 0;
    const unsigned e_first = (unsigned)(e + q0);
    unsigned row = e_first / num_features;
    int f = (int)(e_first - row * num_features);
    RowVals<T, K> r, rn;
    load_row<T, K>(vals, row, r);
    const bool crosses = f + (4 - q0) > num_features && row < last_row;
    if (crosses) load_row<T, K>(vals, row + 1, rn);
    bool use_rn = crosses;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < q0) continue;
      if (e + q >= (long long)e1) break;
      const int b = (cur >> (8 * q)) & 0xff;
      const int j = f - f0;
      if ((unsigned)j < (unsigned)fw && b < num_bins)
        add_cell<T, K, SHARED>(hist, ((size_t)j * num_bins + b) * K, r);
      if (++f == num_features) {
        f = 0;
        ++row;
        if (use_rn) {
          r = rn;
          use_rn = false;
        } else if (q < 3 && e + q + 1 < (long long)e1) {
          load_row<T, K>(vals, row, r);   // F < 4: a word spans 3+ rows
        }
      }
    }
    cur = next;
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kDirectThreads)
hist_direct_kernel(const uint8_t* __restrict__ x,
                   const T* __restrict__ vals, T* __restrict__ out,
                   int n, int num_features, int num_bins) {
  add_range<T, K, false>(x, vals, out, 0, (unsigned)n * num_features,
                         num_features, 0, num_features, num_bins,
                         blockIdx.x * blockDim.x + threadIdx.x,
                         gridDim.x * blockDim.x);
}

// Zeroes `vecs` 16-byte words of shared memory.
__device__ __forceinline__ void zero_shared(float4* sh4, int vecs) {
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    sh4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Adds the sum of `replicas` shared [fw, B, K] histograms (`stride` floats
// apart, a multiple of 4) into out's cells of features [f0, f0 + fw),
// 16 bytes at a time where they are 16-byte aligned, skipping zeros: one
// coalesced vector reduction per non-zero group of four cells.
template <int K>
__device__ __forceinline__ void flush(const float* sh, int stride,
                                      int replicas, float* __restrict__ out,
                                      int f0, int fw, int num_bins) {
  // [F, B, K] is feature-major, so the tile is one contiguous run of cells
  float* dst = out + (size_t)f0 * num_bins * K;
  const int cells = fw * num_bins * K;
  const int c4 = ((size_t)f0 * num_bins * K) % 4 == 0 ? cells / 4 : 0;
  const float4* sh4 = reinterpret_cast<const float4*>(sh);
  for (int i = threadIdx.x; i < c4; i += blockDim.x) {
    float4 s = sh4[i];
    for (int r = 1; r < replicas; ++r) {
      const float4 t = sh4[r * (stride / 4) + i];
      s.x += t.x; s.y += t.y; s.z += t.z; s.w += t.w;
    }
    if (s.x != 0.f || s.y != 0.f || s.z != 0.f || s.w != 0.f)
      atomicAdd(reinterpret_cast<float4*>(dst) + i, s);
  }
  for (int i = c4 * 4 + threadIdx.x; i < cells; i += blockDim.x) {
    float s = sh[i];
    for (int r = 1; r < replicas; ++r) s += sh[r * stride + i];
    if (s != 0.f) atomicAdd(dst + i, s);
  }
}

// f64: the sum of the replicas' cells, one scalar reduction per non-zero
// cell (there is no vector f64 reduction)
template <int K>
__device__ __forceinline__ void flush(const double* sh, int stride,
                                      int replicas, double* __restrict__ out,
                                      int f0, int fw, int num_bins) {
  double* dst = out + (size_t)f0 * num_bins * K;
  const int cells = fw * num_bins * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    double s = sh[i];
    for (int r = 1; r < replicas; ++r) s += sh[r * stride + i];
    if (s != 0.0) atomicAdd(dst + i, s);
  }
}

// elements of one shared [feature_tile, B, K] replica, padded to 16 bytes
// (a multiple of 4 floats or 2 doubles) so that every replica starts
// 16-byte aligned
template <typename T, int K>
__device__ __forceinline__ int replica_elems(int feature_tile,
                                             int num_bins) {
  constexpr int per16 = 16 / sizeof(T);
  return (feature_tile * num_bins * K + per16 - 1) & ~(per16 - 1);
}

template <typename T, int K>
__global__ void __launch_bounds__(kBlockThreads, 1)
hist_block_kernel(const uint8_t* __restrict__ x,
                  const T* __restrict__ vals, T* __restrict__ out,
                  int n, int num_features, int num_bins, int feature_tile,
                  int rows_per_block, int replicas) {
  extern __shared__ float4 sh4[];
  T* sh = reinterpret_cast<T*>(sh4);
  const int f0 = blockIdx.x * feature_tile;
  const int fw = min(feature_tile, num_features - f0);
  const int stride = replica_elems<T, K>(feature_tile, num_bins);
  zero_shared(sh4, stride * replicas / (16 / (int)sizeof(T)));
  __syncthreads();

  const unsigned row0 = blockIdx.y * (unsigned)rows_per_block;
  const unsigned row1 = min((unsigned)n, row0 + rows_per_block);
  T* mine = sh + (threadIdx.x / 32 % replicas) * stride;
  add_range<T, K, true>(x, vals, mine, row0 * num_features,
                        row1 * num_features, num_features, f0, fw, num_bins,
                        threadIdx.x, blockDim.x);
  __syncthreads();
  flush<K>(sh, stride, replicas, out, f0, fw, num_bins);
}

// the largest dynamic shared memory each block kernel (f32 K=3, K=6, f64
// K=3, K=6) was opted in to, by device (an opt-in holds for the current
// device only)
constexpr int kMaxDevices = 64;
size_t g_smem_opt_in[kMaxDevices][4] = {};

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

template <typename T, int K>
cudaError_t launch(int variant, const uint8_t* x, const T* v, T* out,
                   int n, int num_features, int num_bins, int grid_x,
                   int grid_y, int feature_tile, int rows_per_block,
                   int replicas, size_t smem, cudaStream_t s) {
  if (variant == 0) {
    hist_direct_kernel<T, K><<<grid_x, kDirectThreads, 0, s>>>(
        x, v, out, n, num_features, num_bins);
  } else {
    const cudaError_t err = opt_in(
        reinterpret_cast<const void*>(hist_block_kernel<T, K>),
        (K == 6) + 2 * (sizeof(T) == 8), smem);
    if (err != cudaSuccess) return err;
    hist_block_kernel<T, K><<<dim3(grid_x, grid_y), kBlockThreads, smem, s>>>(
        x, v, out, n, num_features, num_bins, feature_tile, rows_per_block,
        replicas);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 float64 (vals and out). variant: 0 direct, 1 block.
// Zeroes out (F * B * K values) on `stream` and launches the variant
// there: direct with grid_x blocks of 128 threads; block with (grid_x
// feature tiles, grid_y row slices) blocks of 1,024 threads and
// smem_bytes of dynamic shared memory (replicas copies of a
// [feature_tile, B, K] histogram of the dtype, each padded to 16 bytes).
// Needs n * F < 2^31. Returns the first CUDA error (of the memset, the
// opt-in or the launch), 0 on success.
int lgbt_hist_launch(const void* x, const void* vals, void* out, int n,
                     int num_features, int num_bins, int k, int dtype,
                     int variant, int grid_x, int grid_y, int feature_tile,
                     int rows_per_block, int replicas, long long smem_bytes,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long elem = dtype == 1 ? 8 : 4;
  if (n <= 0 || num_features <= 0 || num_bins <= 0 || num_bins > 256 ||
      (k != 3 && k != 6) || (dtype != 0 && dtype != 1) || grid_x <= 0 ||
      grid_y <= 0 || variant < 0 || variant > 1 ||
      (long long)n * num_features >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (variant == 1 &&
      (feature_tile <= 0 || rows_per_block <= 0 || replicas <= 0 ||
       smem_bytes != replicas * (((long long)feature_tile * num_bins * k *
                                  elem + 15) / 16 * 16) ||
       (long long)grid_x * feature_tile < num_features ||
       (long long)grid_y * rows_per_block < n))
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)num_features * num_bins * k * elem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)smem_bytes;
  if (dtype == 0) {
    const float* v = static_cast<const float*>(vals);
    float* o = static_cast<float*>(out);
    err = k == 3 ? launch<float, 3>(variant, xb, v, o, n, num_features,
                                    num_bins, grid_x, grid_y, feature_tile,
                                    rows_per_block, replicas, smem, s)
                 : launch<float, 6>(variant, xb, v, o, n, num_features,
                                    num_bins, grid_x, grid_y, feature_tile,
                                    rows_per_block, replicas, smem, s);
  } else {
    const double* v = static_cast<const double*>(vals);
    double* o = static_cast<double*>(out);
    err = k == 3 ? launch<double, 3>(variant, xb, v, o, n, num_features,
                                     num_bins, grid_x, grid_y, feature_tile,
                                     rows_per_block, replicas, smem, s)
                 : launch<double, 6>(variant, xb, v, o, n, num_features,
                                     num_bins, grid_x, grid_y, feature_tile,
                                     rows_per_block, replicas, smem, s);
  }
  return static_cast<int>(err);
}

const char* lgbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
