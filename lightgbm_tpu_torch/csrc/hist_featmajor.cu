// Kernel B2 for Hopper (sm_90a): histogram of (grad, hess, count) over
// all R rows of FEATURE-major [F, R] uint8 bins, with gh masked to one
// leaf by the caller (zeros elsewhere), in two modes.
//
// Replaces: lightgbm_tpu/ops/hist_pallas.py::hist_pallas (the Pallas
// kernel _hist_kernel over feature-major bins), which the full/leaf row
// scheduler calls through make_hist_fn("pallas") for the root and for
// the smaller child of every split (core/grower.py leaf_hist). Its f32
// mode, and its int8 -> int32 mode (quantized gradients). The full path
// never builds bf16 histograms (GrowerConfig.hist_dtype is read only on
// the compact path), so neither does this kernel. The TPU kernel's
// transpose of gh, its channel padding to 16/32, its (8, 128) tiles and
// its bf16 hi/mid/lo split of f32 gh serve the matrix unit; none of that
// carries over.
//
//   out[f, b, c] = sum_r gh[r, c] * [bins[f * ld + r] == b]
//   bins: uint8, row f of the [F, R] matrix at bins + f * ld (ld >= R);
//         values >= num_bin are skipped
//   gh:   [R, 3] contiguous, f32 / int8
//   out:  [F, num_bin, 3], f32 (int32 for int8 gh); every slot written
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are R*F (bins)
// + R*3*sizeof(gh) + 12*F*num_bin (out). At R = 1M, F = 28, num_bin =
// 255: about 40 MB (f32, ~12 us) or 31 MB (int8, ~9 us), whatever the
// leaf's size: every call is a full pass over all rows, as on the TPU.
// Its 3*R*F adds are far below the card's rate, so memory bounds it.
//
// Design: the block body of K1 and K2 (hist_common.cuh: one warp per
// block, lane l owns feature f0 + l, a private [3][num_bin][32] shared
// histogram, rows added in order, partials summed in block order by
// reduce_partials; no float atomics, so two launches give the same
// bits). What differs is the load. In the feature-major layout lane l's
// 32 bytes of a 32-row batch are contiguous, so each lane reads them as
// two 16-byte vectors instead of 32 strided bytes; this needs bins + f*ld
// + base 16-byte aligned, which holds when the pointer is, ld % 16 == 0
// (feature_major_bins in ops/hist_cuda.py pads the device copy's row
// stride to 16; the padding is never read) and base % 32 == 0
// (rows_per_block is a multiple of 32).
// Otherwise, and for the ragged last batch of a block, the lane reads
// byte by byte within its rows. The next batch's loads are in flight
// while a batch is added.
#include "hist_common.cuh"

namespace {

using namespace lgbm;

constexpr int kWords = kBatch / 4;   // 32 bins in 8 words per lane

// Lane's bins of rows [base, base + 32) of its feature into w (byte j of
// the batch is byte j % 4 of w[j / 4]); rows at or past p1 read as 0.
__device__ __forceinline__ void fetch_bins(const uint8_t* col, long long base,
                                           long long p1, bool vec,
                                           uint32_t (&w)[kWords]) {
  if (vec && base + kBatch <= p1) {
    const uint4* p = reinterpret_cast<const uint4*>(col + base);
    const uint4 a = __ldg(p);
    const uint4 b = __ldg(p + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint32_t v = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long r = base + 4 * k + i;
      if (r < p1) v |= static_cast<uint32_t>(__ldg(col + r)) << (8 * i);
    }
    w[k] = v;
  }
}

// Lane j's (grad, hess, count) of row base + j (zeros at or past p1).
template <typename G>
__device__ __forceinline__ void fetch_gh(const G* gh, long long base,
                                         long long p1,
                                         typename Gh<G>::Acc& v0,
                                         typename Gh<G>::Acc& v1,
                                         typename Gh<G>::Acc& v2) {
  using Acc = typename Gh<G>::Acc;
  const long long row = base + threadIdx.x;
  v0 = v1 = v2 = Acc(0);
  if (row < p1) {
    const G* g = gh + row * kChannels;
    v0 = Gh<G>::load(g);
    v1 = Gh<G>::load(g + 1);
    v2 = Gh<G>::load(g + 2);
  }
}

template <typename G>
__global__ void __launch_bounds__(kLanes)
hist_featmajor_kernel(const uint8_t* __restrict__ bins,
                      const G* __restrict__ gh,
                      typename Gh<G>::Acc* __restrict__ out,
                      typename Gh<G>::Acc* __restrict__ partials, long long R,
                      long long ld, int F, int ft, int num_bin,
                      long long rows_per_block, bool vec) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const int lane = threadIdx.x;
  const int f0 = blockIdx.y * ft;
  const int ftl = min(ft, F - f0);
  const bool active = lane < ftl;
  zero_hist(hist, num_bin);
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(R, p0 + rows_per_block);
  // inactive lanes read feature f0's row and add nothing
  const uint8_t* col = bins + static_cast<long long>(f0 + (active ? lane : 0))
                                  * ld;
  Acc* h0 = hist + lane;
  const int cstride = num_bin * kLanes;

  Acc c0, c1, c2;
  uint32_t cw[kWords];
  fetch_gh<G>(gh, p0, p1, c0, c1, c2);
  fetch_bins(col, p0, p1, vec, cw);
  for (long long base = p0; base < p1; base += kBatch) {
    Acc n0, n1, n2;
    uint32_t nw[kWords];
    fetch_gh<G>(gh, base + kBatch, p1, n0, n1, n2);
    fetch_bins(col, base + kBatch, p1, vec, nw);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const Acc g0 = __shfl_sync(kFull, c0, j);
      const Acc g1 = __shfl_sync(kFull, c1, j);
      const Acc g2 = __shfl_sync(kFull, c2, j);
      const int b = static_cast<int>((cw[j / 4] >> (8 * (j % 4))) & 0xffu);
      if (active && b < num_bin) {
        Acc* h = h0 + b * kLanes;
        const Acc a0 = h[0], a1 = h[cstride], a2 = h[2 * cstride];
        h[0] = a0 + g0;
        h[cstride] = a1 + g1;
        h[2 * cstride] = a2 + g2;
      }
    }
    c0 = n0;
    c1 = n1;
    c2 = n2;
#pragma unroll
    for (int k = 0; k < kWords; ++k) cw[k] = nw[k];
  }
  __syncwarp();
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
  return static_cast<int>(resident_blocks(hist_featmajor_kernel<G>,
                                          g_shared_ok[mode], num_bin,
                                          blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, void* out, void* partials,
           long long R, long long ld, int F, int num_bin, int mode,
           long long blocks, long long rows_per_block, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  int ft = 0, n_ftiles = 0;
  feature_tiles(F, &ft, &n_ftiles);
  cudaError_t err =
      allow_shared(hist_featmajor_kernel<G>, g_shared_ok[mode]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(bins) % 16 == 0) &&
                   (ld % 16 == 0);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_ftiles));
  hist_featmajor_kernel<G><<<grid, kLanes, shared_bytes(num_bin), stream>>>(
      static_cast<const uint8_t*>(bins), static_cast<const G*>(gh),
      static_cast<Acc*>(out), static_cast<Acc*>(partials), R, ld, F, ft,
      num_bin, rows_per_block, vec);
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

// f32 and int8 gh only: the full path never builds bf16 histograms.
bool valid_mode(int num_bin, int mode) {
  return num_bin >= 1 && num_bin <= 256 && (mode == kF32 || mode == kInt8);
}

}  // namespace

extern "C" {

// Blocks of the kernel in `mode` resident on the current device at once,
// at num_bin bins (written to *blocks); the caller sizes its grid with it.
// Returns a cudaError_t.
int lgbm_hist_featmajor_resident(int num_bin, int mode, long long* blocks) {
  if (!valid_mode(num_bin, mode)) return (int)cudaErrorInvalidValue;
  return mode == kF32 ? resident<float>(num_bin, mode, blocks)
                      : resident<int8_t>(num_bin, mode, blocks);
}

// Launches the histogram over `blocks` row slices of rows_per_block rows
// (a multiple of 32; blocks * rows_per_block >= R) and, for blocks > 1,
// the reduction of their partials (the caller allocates blocks *
// ceil(F / 32) * 3 * num_bin * 32 accumulators) on `stream`; returns
// cudaGetLastError() (0 = ok).
int lgbm_hist_featmajor(const void* bins, const void* gh, void* out,
                        void* partials, long long R, long long ld, int F,
                        int num_bin, int mode, long long blocks,
                        long long rows_per_block, void* stream) {
  if (!valid_mode(num_bin, mode) || R <= 0 || ld < R || F <= 0 ||
      blocks < 1 || rows_per_block < kBatch || rows_per_block % kBatch != 0 ||
      blocks * rows_per_block < R) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kF32) {
    return launch<float>(bins, gh, out, partials, R, ld, F, num_bin, mode,
                         blocks, rows_per_block, st);
  }
  return launch<int8_t>(bins, gh, out, partials, R, ld, F, num_bin, mode,
                        blocks, rows_per_block, st);
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
