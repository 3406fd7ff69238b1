// Kernel K1 for Hopper (sm_90a): f32 histogram of (grad, hess, count)
// over a row-major [S, F] uint8 bin block.
//
// Replaces: lightgbm_tpu/ops/hist_pallas.py::_hist_kernel, reached through
// hist_pallas_rm (hist_rowmajor(backend="pallas"), f32 mode). The TPU
// kernel builds a one-hot expansion in VMEM and contracts it on the matrix
// unit, splitting f32 gh into bf16 hi/mid/lo triples and padding channels
// to 16 and tiles to (8, 128). None of that carries over: on Hopper this
// is a plain f32 scatter.
//
//   out[f, b, c] = sum_r gh[r, c] * [bins[r, f] == b]
//   bins: uint8 [S, F] contiguous, every value < num_bin <= 256
//   gh:   f32 [S, 3] contiguous
//   out:  f32 [F, num_bin, 3], zeroed by the caller
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are S*F (bins)
// + 12*S (gh) + 12*F*num_bin (out); about 40 MB at S = 1M, F = 28, i.e.
// about 12 us. Its 3*S*F f32 adds are far below the card's f32 rate, so
// memory bounds it.
//
// Design: each block keeps a privatised histogram of its feature tile in
// dynamic shared memory (F*num_bin*12 B = 86,016 B at F = 28, num_bin =
// 256; feature tiles over gridDim.y keep it under ~100 KB), zeroes it,
// walks its slice of rows with neighbouring threads on neighbouring bytes
// (one coalesced pass over the bin block), accumulates with shared-memory
// atomicAdd, and flushes the non-empty slots into the output with global
// atomicAdd. One block per SM keeps the flush (one atomic per slot per
// block) small next to the scatter. The order of the float additions
// depends on scheduling, so two launches agree exactly only where every
// partial sum is exact (dyadic gh, counts).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kChannels = 3;
constexpr int kSharedBudget = 100 * 1024;

__global__ void __launch_bounds__(kThreads)
hist_rowmajor_kernel(const uint8_t* __restrict__ bins,
                     const float* __restrict__ gh,
                     float* __restrict__ out,
                     long long S, int F, int num_bin, int f_tile,
                     long long rows_per_block) {
  extern __shared__ float hist[];  // [ft, num_bin, 3]
  const int f0 = blockIdx.y * f_tile;
  const int ft = min(f_tile, F - f0);
  const int n_slots = ft * num_bin * kChannels;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const long long r_begin = (long long)blockIdx.x * rows_per_block;
  const long long r_end = min(S, r_begin + rows_per_block);
  if (r_begin < r_end) {
    // cell e = (r - r_begin) * ft + fl of this block's row slice; the
    // thread's (row, feature) pair advances by blockDim cells per step
    // without a division in the loop
    const int step_rows = blockDim.x / ft;
    const int step_cols = blockDim.x % ft;
    long long r = r_begin + threadIdx.x / ft;
    int fl = threadIdx.x % ft;
    const uint8_t* row_bins = bins + f0;
    while (r < r_end) {
      const int b = row_bins[r * F + fl];
      if (b < num_bin) {
        const float* g = gh + r * kChannels;
        float* h = hist + (fl * num_bin + b) * kChannels;
        atomicAdd(h + 0, __ldg(g + 0));
        atomicAdd(h + 1, __ldg(g + 1));
        atomicAdd(h + 2, __ldg(g + 2));
      }
      r += step_rows;
      fl += step_cols;
      if (fl >= ft) {
        fl -= ft;
        ++r;
      }
    }
  }
  __syncthreads();

  float* o = out + (long long)f0 * num_bin * kChannels;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    const float v = hist[i];
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
int lgbm_hist_rowmajor_f32(const void* bins, const void* gh, void* out,
                           long long S, int F, int num_bin, void* stream) {
  if (S <= 0 || F <= 0) return 0;
  if (num_bin < 1 || num_bin > 256) return (int)cudaErrorInvalidValue;
  const int bytes_per_feature = num_bin * kChannels * (int)sizeof(float);
  int f_tile = kSharedBudget / bytes_per_feature;
  if (f_tile < 1) f_tile = 1;
  if (f_tile > F) f_tile = F;
  const int n_ftiles = (F + f_tile - 1) / f_tile;
  const int smem = f_tile * bytes_per_feature;

  cudaError_t err = cudaFuncSetAttribute(
      hist_rowmajor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return (int)err;

  // one block per SM over all feature tiles, but no block with fewer
  // than ~16 cells per thread: small leaves take few blocks, so zeroing
  // and flushing the shared histogram stays cheap next to the scatter
  const long long min_rows = (16LL * kThreads + f_tile - 1) / f_tile;
  long long blocks_x = (S + min_rows - 1) / min_rows;
  long long cap = sms / n_ftiles;
  if (cap < 1) cap = 1;
  if (blocks_x > cap) blocks_x = cap;
  if (blocks_x < 1) blocks_x = 1;
  const long long rows_per_block = (S + blocks_x - 1) / blocks_x;

  dim3 grid((unsigned)blocks_x, (unsigned)n_ftiles);
  hist_rowmajor_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const float*)gh, (float*)out, S, F, num_bin,
      f_tile, rows_per_block);
  return (int)cudaGetLastError();
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
