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
//
// Bound on this card: bytes. The function must read n*F + 4*n*K bytes and
// write 4*F*B*K; it does n*F*K additions, far below any compute roof. At
// the root shape (n=1e6, F=28, K=3) that is 40 MB, ~12 us at 3.35 TB/s.
//
// Design, simple and exact first (the TPU kernel's digit-factorised MXU
// contraction has no counterpart worth copying here):
//   pass 1  each block owns a tile of Ft features and a contiguous slice of
//           rows. It keeps an [Ft, B, K] f32 sub-histogram in shared memory
//           (at most 48 KB, so no opt-in is needed and several blocks share
//           an SM), reads each of its rows once, and adds the row's K values
//           into the bin of each of its features with shared-memory atomics
//           (the workgroup-local histogram of the reference's
//           ocl/histogram256.cl). Zero values are skipped: in the K=6 split
//           pass a row feeds only one child, so half the channels are zero.
//           The block then writes its sub-histogram to partial [R, F, B, K].
//   pass 2  one thread per output cell sums the R partials in a fixed order.
// No global atomics, so the only run-to-run variation is the order of the
// shared-memory atomics inside a block; accumulation stays f32 throughout
// (tighter than the TPU kernel's two-term bf16 split). What bounds it for
// now is the partial round trip (R*F*B*K*4 bytes written and read again)
// and shared-atomic throughput, not the n*F + 4*n*K bytes of the bound;
// wgmma/TMA or a feature-major layout are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
hist_partial_kernel(const uint8_t* __restrict__ x,
                    const float* __restrict__ vals,
                    float* __restrict__ partial,
                    int n, int num_features, int num_bins,
                    int feature_tile, int rows_per_block) {
  extern __shared__ float sh[];
  const int f0 = blockIdx.x * feature_tile;
  const int ft = min(feature_tile, num_features - f0);
  const int r = blockIdx.y;
  const int cells = ft * num_bins * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  const long long row0 = (long long)r * rows_per_block;
  const long long row1 = min((long long)n, row0 + rows_per_block);
  for (long long row = row0 + threadIdx.x; row < row1; row += blockDim.x) {
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = vals[row * K + k];
    const uint8_t* xr = x + row * (long long)num_features + f0;
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

  // [F, B, K] is feature-major, so this block's features are one
  // contiguous run of `cells` floats inside partial[r]
  float* dst = partial + ((long long)r * num_features + f0) * num_bins * K;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) dst[i] = sh[i];
}

__global__ void __launch_bounds__(kThreads)
hist_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                   int num_row_blocks, long long cells) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cells) return;
  float s = 0.f;
  for (int r = 0; r < num_row_blocks; ++r) s += partial[r * cells + i];
  out[i] = s;
}

}  // namespace

extern "C" {

// Launch both passes on `stream`. partial must hold
// num_row_blocks * F * B * K floats and out F * B * K floats. Returns the
// first CUDA error (cudaGetLastError after each launch), 0 on success.
int lgbt_hist_launch(const void* x, const void* vals, void* partial,
                     void* out, int n, int num_features, int num_bins, int k,
                     int feature_tile, int num_row_blocks, int rows_per_block,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || num_features <= 0 || num_bins <= 0 || num_bins > 256 ||
      feature_tile <= 0 || num_row_blocks <= 0 || rows_per_block <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)feature_tile * num_bins * k * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_features + feature_tile - 1) / feature_tile,
                  num_row_blocks);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  const float* v = static_cast<const float*>(vals);
  float* p = static_cast<float*>(partial);
  if (k == 3) {
    hist_partial_kernel<3><<<grid, kThreads, smem, s>>>(
        xb, v, p, n, num_features, num_bins, feature_tile, rows_per_block);
  } else if (k == 6) {
    hist_partial_kernel<6><<<grid, kThreads, smem, s>>>(
        xb, v, p, n, num_features, num_bins, feature_tile, rows_per_block);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cells = (long long)num_features * num_bins * k;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  hist_reduce_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      p, static_cast<float*>(out), num_row_blocks, cells);
  return static_cast<int>(cudaGetLastError());
}

const char* lgbt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
