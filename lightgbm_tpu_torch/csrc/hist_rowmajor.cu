// Kernel K1 for Hopper (sm_90a): histogram of (grad, hess, count) over a
// row-major [S, F] uint8 bin block, in three modes.
//
// Replaces: lightgbm_tpu/ops/hist_pallas.py::_hist_kernel, reached through
// hist_pallas_rm (hist_rowmajor(backend="pallas")): its f32 mode, its
// int8 -> int32 mode (quantized gradients, :81-82) and its bf16 mode
// (tpu_hist_dtype=bfloat16, ops/histogram.py:129-134). The TPU kernel
// builds a one-hot expansion in VMEM and contracts it on the matrix unit,
// splitting f32 gh into bf16 hi/mid/lo triples and padding channels to
// 16 and tiles to (8, 128). None of that carries over: on Hopper this is
// a scatter into shared memory (hist_common.cuh).
//
//   out[f, b, c] = sum_r gh[r, c] * [bins[r, f] == b]
//   bins: uint8 [S, F] contiguous, values >= num_bin are skipped
//   gh:   [S, 3] contiguous, f32 / bf16 / int8
//   out:  [F, num_bin, 3], f32 (int32 for int8 gh); every slot written
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are S*F (bins)
// + S*3*sizeof(gh) + 12*F*num_bin (out). At S = 1M, F = 28, num_bin =
// 255: about 40 MB (f32, ~12 us), 34 MB (bf16, ~10 us), 31 MB (int8,
// ~9 us). Its 3*S*F adds are far below the card's rate, so memory bounds
// it.
//
// Design (hist_common.cuh): one warp per block, lane = feature, a private
// [3][num_bin][32] histogram per block (98,304 B at num_bin = 256, so two
// blocks per SM), rows in order within a block. A leaf of S rows takes
// min(S / 256, resident blocks) blocks over row slices, as the wrapper
// (ops/hist_cuda.py) picks them, and one feature tile of up to 32
// features (more tiles over gridDim.y for wider data). With
// one block the histogram goes straight to `out`; with more, each block
// writes its partial histogram and reduce_partials sums them in block
// order. No float atomics anywhere: two launches on the same input give
// the same bits, in every mode.
#include "hist_common.cuh"

namespace {

using namespace lgbm;

template <typename G>
__global__ void __launch_bounds__(kLanes)
hist_rowmajor_kernel(const uint8_t* __restrict__ bins,
                     const G* __restrict__ gh,
                     typename Gh<G>::Acc* __restrict__ out,
                     typename Gh<G>::Acc* __restrict__ partials, long long S,
                     int F, int ft, int num_bin, long long rows_per_block) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const int f0 = blockIdx.y * ft;
  const int ftl = min(ft, F - f0);
  zero_hist(hist, num_bin);
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(S, p0 + rows_per_block);
  accumulate<G>(bins, gh, nullptr, p0, p1, F, f0, ftl, num_bin, hist);
  if (gridDim.x == 1) {
    write_out(hist, out, f0, ftl, num_bin);
  } else {
    const long long part =
        static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y;
    write_partial(hist, partials + part * tile_slots(num_bin), num_bin);
  }
}

bool g_shared_ok[3][kMaxDevices];   // per mode, per device

template <typename G>
int resident(int num_bin, int mode, long long* blocks) {
  return static_cast<int>(resident_blocks(hist_rowmajor_kernel<G>,
                                          g_shared_ok[mode], num_bin,
                                          blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, void* out, void* partials,
           long long S, int F, int num_bin, int mode, long long blocks,
           cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  int ft = 0, n_ftiles = 0;
  feature_tiles(F, &ft, &n_ftiles);
  cudaError_t err = allow_shared(hist_rowmajor_kernel<G>, g_shared_ok[mode]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_block = (S + blocks - 1) / blocks;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_ftiles));
  hist_rowmajor_kernel<G><<<grid, kLanes, shared_bytes(num_bin), stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const G*>(gh),
      static_cast<Acc*>(out), static_cast<Acc*>(partials), S, F, ft, num_bin,
      rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  constexpr int kReduceThreads = 256;
  dim3 rgrid((tile_slots(num_bin) + kReduceThreads - 1) / kReduceThreads,
             static_cast<unsigned>(n_ftiles), 1);
  reduce_partials<Acc><<<rgrid, kReduceThreads, 0, stream>>>(
      static_cast<const Acc*>(partials), static_cast<Acc*>(out), nullptr,
      blocks, F, ft, n_ftiles, num_bin);
  return static_cast<int>(cudaGetLastError());
}

bool valid_bins(int num_bin, int mode) {
  return num_bin >= 1 && num_bin <= 256 && mode >= kF32 && mode <= kInt8;
}

}  // namespace

extern "C" {

// Blocks of the kernel in `mode` resident on the current device at once,
// at num_bin bins (written to *blocks); the caller sizes its grid with it.
// Returns a cudaError_t.
int lgbm_hist_rowmajor_resident(int num_bin, int mode, long long* blocks) {
  if (!valid_bins(num_bin, mode)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kF32: return resident<float>(num_bin, mode, blocks);
    case kBF16: return resident<uint16_t>(num_bin, mode, blocks);
    default: return resident<int8_t>(num_bin, mode, blocks);
  }
}

// Launches the histogram over `blocks` row slices (and, for blocks > 1,
// the reduction of their partials: the caller allocates blocks *
// ceil(F / 32) * 3 * num_bin * 32 accumulators) on `stream`; returns
// cudaGetLastError() (0 = ok).
int lgbm_hist_rowmajor(const void* bins, const void* gh, void* out,
                       void* partials, long long S, int F, int num_bin,
                       int mode, long long blocks, void* stream) {
  if (!valid_bins(num_bin, mode) || S <= 0 || F <= 0 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch<float>(bins, gh, out, partials, S, F, num_bin, mode,
                           blocks, st);
    case kBF16:
      return launch<uint16_t>(bins, gh, out, partials, S, F, num_bin, mode,
                              blocks, st);
    default:
      return launch<int8_t>(bins, gh, out, partials, S, F, num_bin, mode,
                            blocks, st);
  }
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
