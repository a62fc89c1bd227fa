// Stable in-tile row partition on Hopper (sm_90a).
//
// Replaces the TPU kernel _partition_tile_kernel of
// lightgbm_tpu/core/repack_pallas.py:31 (pallas_call :71), entered through
// partition_tiles :54. For rows [N, C] uint8 and go_left [N] (bytes, 0 or
// not), every row_tile tile of rows is partitioned stably: its go-left rows
// first, in their order, then its go-right rows, in theirs; counts[t] is
// tile t's number of go-left rows. The result is exact (bytes are moved,
// never computed on).
//
// Bound on this card: bytes. The function reads every row and its go-left
// byte once and writes every row and the T counts once, 2*N*C + N + 4*T
// bytes, and does no arithmetic on the payload.
//
// Design. The TPU kernel builds the [tile, tile] permutation one-hot and
// applies it on the MXU, with the prefix count as a triangular matvec: a
// matrix-unit device that does not carry over. Here one block takes one
// tile. A first loop over the tile, 256 rows at a time, gives each row its
// rank among the go-left rows: a warp ballot and __popc inside the warp,
// then the warps' counts scanned in shared memory, plus the go-left rows of
// the earlier rounds. Each row's destination goes to shared memory
// (row_tile ints). A second loop moves the rows as 16-byte vectors,
// neighbouring threads on neighbouring vectors of a row: a go-left row to
// its rank, a go-right row to n_left plus its rank among the go-right rows.
// Reads are fully coalesced; writes are whole 16-byte vectors. One launch a
// call; the count is written once by the block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the [row_tile] int32 destinations stay within the 48 KB a block gets
// without opting in, beside the static shared memory
constexpr int kMaxRowTile = 8192;

__global__ void __launch_bounds__(kThreads)
partition_tile_kernel(const uint4* __restrict__ rows,
                      const uint8_t* __restrict__ go_left,
                      uint4* __restrict__ out, int32_t* __restrict__ counts,
                      int row_tile, int vecs) {
  extern __shared__ int dest[];                 // [row_tile]
  __shared__ int warp_base[kWarps];
  __shared__ int round_total;
  const long long base = (long long)blockIdx.x * row_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  int before = 0;         // go-left rows of this tile in earlier rounds
  for (int i0 = 0; i0 < row_tile; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool left = i < row_tile && go_left[base + i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, left);
    const int lane_rank = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_base[warp] = __popc(ballot);
    __syncthreads();
    if (threadIdx.x == 0) {
      int run = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int v = warp_base[w];
        warp_base[w] = run;
        run += v;
      }
      round_total = run;
    }
    __syncthreads();
    // go-left rows of the tile before row i
    const int lefts_before = before + warp_base[warp] + lane_rank;
    if (i < row_tile)
      dest[i] = left ? lefts_before : -1 - (i - lefts_before);
    before += round_total;
    __syncthreads();      // warp_base and round_total are rewritten next round
  }
  const int n_left = before;
  if (threadIdx.x == 0) counts[blockIdx.x] = n_left;

  const long long items = (long long)row_tile * vecs;
  for (long long it = threadIdx.x; it < items; it += kThreads) {
    const int i = (int)(it / vecs);
    const int v = (int)(it - (long long)i * vecs);
    const int d = dest[i];
    const int pos = d >= 0 ? d : n_left + (-1 - d);
    out[(base + pos) * vecs + v] = rows[(base + i) * vecs + v];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: rows and out [n_tiles * row_tile, c] uint8 with c a
// multiple of 16 and both 16-byte aligned, go_left [n_tiles * row_tile]
// bytes, counts [n_tiles] int32, row_tile <= kMaxRowTile. Returns the
// first CUDA error, 0 on success.
int lgbt_partition_tiles_launch(const void* rows, const void* go_left,
                                void* out, void* counts, int n_tiles,
                                int row_tile, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0 || row_tile <= 0 || row_tile > kMaxRowTile || c <= 0 ||
      c % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)row_tile * sizeof(int);
  partition_tile_kernel<<<n_tiles, kThreads, smem, s>>>(
      static_cast<const uint4*>(rows), static_cast<const uint8_t*>(go_left),
      static_cast<uint4*>(out), static_cast<int32_t*>(counts), row_tile,
      c / 16);
  return static_cast<int>(cudaGetLastError());
}

const char* lgbt_repack_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
