// Kernel K1 for Hopper (sm_90a): histogram of (grad, hess, count) over a
// row-major [S, F] block of bins (one leaf's rows, gathered by the
// compact grower), in three gh modes and two bin widths.
//
// Replaces: lightgbm_tpu/ops/hist_pallas.py::_hist_kernel, reached through
// hist_pallas_rm (hist_rowmajor(backend="pallas")): its f32 mode, its
// int8 -> int32 mode (quantized gradients, :81-82) and its bf16 mode
// (tpu_hist_dtype=bfloat16, ops/histogram.py:129-134), over uint8 or
// uint16 bins (widened to int32 at :168). The TPU kernel builds a one-hot
// expansion in VMEM and contracts it on the matrix unit, splitting f32 gh
// into bf16 hi/mid/lo triples and padding channels to 16 and tiles to
// (8, 128); it falls back to an einsum where no tile fits (more than
// about 4,095 bins). None of that carries over: on Hopper this is a
// scatter into shared memory, for any number of bins.
//
//   out[f, b, c] = sum_r gh[r, c] * [bins[r, f] == b]
//   bins: uint8 or uint16 [S, F] contiguous, values >= num_bin skipped
//   gh:   [S, 3] contiguous, f32 / bf16 / int8
//   out:  [F, num_bin, 3], f32 (int32 for int8 gh); every slot written
//   (bins and gh 16-byte aligned and readable up to the next multiple of
//   16 bytes past their end, as every allocation of torch's caching
//   allocator is)
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are S*F*w
// (bins of w bytes) + S*3*sizeof(gh) + 12*F*num_bin (out). At S = 1M,
// F = 28, num_bin = 255, u8: about 40 MB (f32, ~12 us), 34 MB (bf16, ~10
// us), 31 MB (int8, ~9 us); u16 at 1,023 bins, f32: about 68 MB (~20
// us; at 4,095 bins about 69 MB, ~21 us). Its 3*S*F adds are far below
// the card's rate: memory bounds it.
//
// Design. Three paths, chosen by the caller from the leaf's row count,
// which the host knows, and the bin width:
//
// - Dense (hist_rowmajor_kernel), u8 bins: the grouped body of
//   hist_grouped.cuh. A leaf of S rows takes min(S / 256, one wave)
//   blocks over row slices per feature tile; each block zeroes its
//   [num_bin][32][3] shared histogram with 16-byte stores, stages its
//   rows into the cp.async ring (a batch of 32 rows at F = 28 is 896
//   contiguous bytes in u8, 1,792 in u16) and adds them four at a time.
//   A block whose first batch puts most rows of a feature in a few bins
//   adds those bins' rows in f64 registers instead (LaneHot).
//   With one block the histogram goes straight to `out`; with more, each
//   block writes its partial (16 bytes a lane) and reduce_flagged sums
//   them in block order, in f64, runs of blocks in parallel. (A body
//   that adds a lane's rows one after another, each waiting on the one
//   before, its bins loaded a byte a lane one batch ahead, ran about
//   1.7x slower per row than this one in K2 and B2.)
// - Wide (hist_rowmajor_wide), the dense path over u16 bins: the wide
//   body of hist_grouped.cuh, a
//   warp per feature of a tile of up to 16, lane = row, 12 bytes a bin
//   and feature, so a block holds all of a tile's bins (4 features of
//   4,095 bins, 14 of 1,023) and reads the rows once per tile instead of
//   once per 512-bin window. A leaf takes min(S / 512, one wave) blocks
//   over row slices per column (feature tile x window); partials and
//   reduce_flagged as in the dense path.
// - Small (hist_rowmajor_small): a leaf of a few hundred rows does not
//   pay for zeroing and writing a 98 KB histogram per block and reducing
//   them. One block per (feature, bin window) gathers the leaf's bins of
//   its feature and its gh into shared memory, zeroes the window's
//   [win][3] histogram there, and warp 0 adds the rows 32 at a time: the
//   rows of a batch that share a bin (__match_any_sync) are summed in row
//   order by the first of them, which alone adds the sum to the slot.
//   The block then writes its window of the output. Its cost grows with
//   S, not with the leaf's share of the wave.
//
// No float atomics anywhere: every slot has one owner and a fixed order
// of adds, so two launches on the same input give the same bits, in every
// mode.
#include "hist_grouped.cuh"

namespace {

using namespace lgbm;

template <typename G>
inline int dense_shared_bytes(int num_bin, int F) {
  return hist_bytes(num_bin) + rm_fixed_bytes<G, uint8_t>(F);
}

template <typename G, typename BinT>
__global__ void __launch_bounds__(kLanes)
hist_rowmajor_kernel(const BinT* __restrict__ bins,
                     const G* __restrict__ gh,
                     typename Gh<G>::Acc* __restrict__ out,
                     typename Gh<G>::Acc* __restrict__ partials, long long S,
                     Cols cols, long long rows_per_block) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const int t = blockIdx.y;
  zero_hist_vec(hist, cols.win);
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(S, p0 + rows_per_block);
  add_rows_rowmajor<G, BinT>(hist, smem_raw + hist_bytes(cols.win), bins,
                             gh, p0, p1, cols, t);
  if (gridDim.x == 1) {
    write_out_slots(hist, out, cols, t);
  } else {
    const long long part =
        static_cast<long long>(blockIdx.x) * gridDim.y + t;
    write_partial_vec(hist, partials + part * tile_slots(cols.win),
                      cols.win);
  }
}

// The dense path over u16 bins: the wide body
// (hist_grouped.cuh add_rows_wide), ft warps a block, one per feature of
// the column's tile, over the block's row slice; partials and their
// reduction as in hist_rowmajor_kernel.
template <typename G, typename BinT>
__global__ void __launch_bounds__(kWideMaxWarps * kLanes)
hist_rowmajor_wide(const BinT* __restrict__ bins, const G* __restrict__ gh,
                   typename Gh<G>::Acc* __restrict__ out,
                   typename Gh<G>::Acc* __restrict__ partials, long long S,
                   WideCols cols, long long rows_per_block) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const int t = blockIdx.y;
  const int slots = col_slots(cols);
  zero_hist_block(hist, slots);
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(S, p0 + rows_per_block);
  add_rows_wide<G, BinT>(hist, smem_raw + slots * 4,
                         smem_raw + slots * 4 + wide_tag_bytes(cols), bins,
                         gh, p0, p1, cols, t);
  __syncthreads();
  if (gridDim.x == 1) {
    write_out_wide(hist, out, cols, t);
  } else {
    const long long part =
        static_cast<long long>(blockIdx.x) * gridDim.y + t;
    write_partial_block(hist, partials + part * slots, slots);
  }
}

constexpr int kSmallThreads = 256;
constexpr int kSmallMaxWin = 8192;    // bins of the small path's window

// Shared memory of the small path: the window's [win][3] histogram, then
// the leaf's S gh rows (widened) and its S bins of the block's feature.
inline int small_shared_bytes(int win, int S) {
  return (win * kChannels + S * kChannels) * 4 + S * 4;
}

template <typename G, typename BinT>
__global__ void __launch_bounds__(kSmallThreads)
hist_rowmajor_small(const BinT* __restrict__ bins, const G* __restrict__ gh,
                    typename Gh<G>::Acc* __restrict__ out, int S, int F,
                    int num_bin, int win) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);
  Acc* s_gh = s_hist + win * kChannels;
  int* s_bin = reinterpret_cast<int*>(s_gh + S * kChannels);
  const int f = blockIdx.x;
  const int b0 = blockIdx.y * win;
  const int nb = min(win, num_bin - b0);
  for (int q = threadIdx.x; q < nb * kChannels; q += blockDim.x) {
    s_hist[q] = Acc(0);
  }
  // every load of the leaf's rows in flight at once
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    s_bin[i] = static_cast<int>(__ldg(bins + static_cast<long long>(i) * F +
                                      f));
#pragma unroll
    for (int c = 0; c < kChannels; ++c) {
      s_gh[i * kChannels + c] =
          Gh<G>::load(gh + static_cast<long long>(i) * kChannels + c);
    }
  }
  __syncthreads();
  if (threadIdx.x < kLanes) {
    const int lane = threadIdx.x;
    for (int k0 = 0; k0 < S; k0 += kLanes) {
      const int i = k0 + lane;
      const int lb = i < S ? s_bin[i] - b0 : -1;
      const bool adds = in_window(lb, nb);
      // rows that add nothing each get a key of their own
      const unsigned peers = __match_any_sync(kFull, adds ? lb : -1 - lane);
      if (adds && (peers & ((1u << lane) - 1u)) == 0u) {
        Acc x0 = s_gh[i * kChannels], x1 = s_gh[i * kChannels + 1],
            x2 = s_gh[i * kChannels + 2];
        for (unsigned m = peers & (peers - 1u); m != 0u; m &= m - 1u) {
          const int j = k0 + __ffs(m) - 1;
          x0 += s_gh[j * kChannels];
          x1 += s_gh[j * kChannels + 1];
          x2 += s_gh[j * kChannels + 2];
        }
        s_hist[lb * kChannels] += x0;
        s_hist[lb * kChannels + 1] += x1;
        s_hist[lb * kChannels + 2] += x2;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  Acc* o = out + (static_cast<long long>(f) * num_bin + b0) * kChannels;
  for (int q = threadIdx.x; q < nb * kChannels; q += blockDim.x) {
    o[q] = s_hist[q];
  }
}

int g_dense_set[3][kMaxDevices];   // per mode, device (u8 bins)
int g_small_set[3][2][kMaxDevices];   // per mode, bin width, device
int g_wide_set[3][kMaxDevices];    // per mode, device (u16 bins)

template <typename G>
int plan(int num_bin, int F, int mode, long long* blocks) {
  return static_cast<int>(resident_with(
      hist_rowmajor_kernel<G, uint8_t>, g_dense_set[mode],
      dense_shared_bytes<G>(num_bin, F), blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, void* out, void* partials,
           long long S, int F, int num_bin, int mode, long long blocks,
           cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  using BinT = uint8_t;
  const Cols cols = make_cols(F, num_bin, num_bin);
  const int smem = dense_shared_bytes<G>(num_bin, F);
  cudaError_t err = allow_bytes(hist_rowmajor_kernel<G, BinT>,
                                g_dense_set[mode], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_block = (S + blocks - 1) / blocks;
  dim3 grid(static_cast<unsigned>(blocks),
            static_cast<unsigned>(cols.count()));
  hist_rowmajor_kernel<G, BinT><<<grid, kLanes, smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const G*>(gh),
      static_cast<Acc*>(out), static_cast<Acc*>(partials), S, cols,
      rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  constexpr int kPerBlock = 4 * kReduceSlots;   // accumulators a block sums
  dim3 rgrid((tile_slots(num_bin) + kPerBlock - 1) / kPerBlock,
             static_cast<unsigned>(cols.count()), 1);
  err = launch_after(reduce_flagged<Acc>, rgrid, dim3(kSegs * kReduceSlots),
                     0, stream, static_cast<const Acc*>(partials),
                     static_cast<const int*>(nullptr), static_cast<Acc*>(out),
                     static_cast<int>(blocks), cols);
  return static_cast<int>(err);
}

template <typename G>
int plan_wide(int F, int mode, int ft, int win, int wpf, int stage_rows,
              int* optin, long long* blocks) {
  return static_cast<int>(wide_plan<G, uint16_t>(
      hist_rowmajor_wide<G, uint16_t>, g_wide_set[mode], F, ft, win, wpf,
      stage_rows, optin, blocks));
}

template <typename G>
int launch_wide(const void* bins, const void* gh, void* out, void* partials,
                long long S, int F, int num_bin, int mode, int ft, int win,
                int wpf, int stage_rows, long long blocks,
                cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  using BinT = uint16_t;
  const WideCols cols = make_wide_cols(F, num_bin, ft, win, wpf,
                                       stage_rows);
  const int smem = wide_shared_bytes<G, BinT>(cols);
  cudaError_t err = allow_bytes(hist_rowmajor_wide<G, BinT>,
                                g_wide_set[mode], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows_per_block = (S + blocks - 1) / blocks;
  dim3 grid(static_cast<unsigned>(blocks),
            static_cast<unsigned>(cols.count()));
  hist_rowmajor_wide<G, BinT><<<grid, cols.warps() * kLanes, smem, stream>>>(
      static_cast<const BinT*>(bins), static_cast<const G*>(gh),
      static_cast<Acc*>(out), static_cast<Acc*>(partials), S, cols,
      rows_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  constexpr int kPerBlock = 4 * kReduceSlots;   // accumulators a block sums
  dim3 rgrid((col_slots(cols) + kPerBlock - 1) / kPerBlock,
             static_cast<unsigned>(cols.count()), 1);
  err = launch_after(reduce_flagged<Acc, WideCols>, rgrid,
                     dim3(kSegs * kReduceSlots), 0, stream,
                     static_cast<const Acc*>(partials),
                     static_cast<const int*>(nullptr), static_cast<Acc*>(out),
                     static_cast<int>(blocks), cols);
  return static_cast<int>(err);
}

template <typename G, typename BinT>
int launch_small(const void* bins, const void* gh, void* out, int S, int F,
                 int num_bin, int mode, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  const int n_win = (num_bin + kSmallMaxWin - 1) / kSmallMaxWin;
  const int win = (num_bin + n_win - 1) / n_win;
  const int smem = small_shared_bytes(win, S);
  cudaError_t err = allow_bytes(hist_rowmajor_small<G, BinT>,
                                g_small_set[mode][sizeof(BinT) - 1], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  hist_rowmajor_small<G, BinT><<<dim3(F, n_win), kSmallThreads, smem,
                                 stream>>>(
      static_cast<const BinT*>(bins), static_cast<const G*>(gh),
      static_cast<Acc*>(out), S, F, num_bin, win);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The dense path's plan on `device` at num_bin u8 bins and F features:
// the blocks resident on the device at once (*blocks), with which the
// caller sizes its grid. Returns a cudaError_t.
int lgbm_hist_rowmajor_plan(int num_bin, int F, int mode, int device,
                            long long* blocks) {
  if (!valid_args(num_bin, mode, 1) || F <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(plan, mode, num_bin, F, mode, blocks);
}

// The dense path over u8 bins: the histogram over `blocks` row slices
// per feature tile and, for blocks > 1, the reduction of their partials
// (the caller allocates blocks * ceil(F / 32) * 3 * num_bin * 32
// accumulators), on `stream` of `device` (the device current before the
// call is current again after it); returns cudaGetLastError() (0 = ok).
int lgbm_hist_rowmajor(const void* bins, const void* gh, void* out,
                       void* partials, long long S, int F, int num_bin,
                       int mode, long long blocks, int device, void* stream) {
  if (!valid_args(num_bin, mode, 1) || S <= 0 || F <= 0 || blocks < 1 ||
      blocks > kMaxParts ||
      reinterpret_cast<uintptr_t>(bins) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gh) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(launch, mode, bins, gh, out, partials, S, F,
                            num_bin, mode, blocks,
                            static_cast<cudaStream_t>(stream));
}

// The wide dense path's plan on `device` (u16 bins): the opt-in shared
// bytes of a block (*optin) and, for ft > 0, the blocks of the geometry
// (ft features a tile, windows of win bins, wpf warps a feature,
// stage_rows rows a stage, at F features) resident on the device at once
// (*blocks). Returns a cudaError_t.
int lgbm_hist_rowmajor_wide_plan(int F, int mode, int ft, int win, int wpf,
                                 int stage_rows, int device, int* optin,
                                 long long* blocks) {
  if (!valid_args(1, mode, 2) ||
      (ft > 0 && !valid_wide(F, 1, ft, win, wpf, stage_rows))) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(plan_wide, mode, F, mode, ft, win, wpf,
                            stage_rows, optin, blocks);
}

// The wide dense path (u16 bins): the histogram over `blocks` row
// slices per column (ft features a tile x window of win bins, wpf warps
// a feature) and, for blocks > 1, the reduction of their partials (the
// caller allocates blocks * ceil(F / ft) * ceil(num_bin / win) * 3 * ft
// * win accumulators), on `stream` of `device`; returns
// cudaGetLastError() (0 = ok).
int lgbm_hist_rowmajor_wide(const void* bins, const void* gh, void* out,
                            void* partials, long long S, int F, int num_bin,
                            int mode, int ft, int win, int wpf,
                            int stage_rows, long long blocks, int device,
                            void* stream) {
  if (!valid_args(num_bin, mode, 2) ||
      !valid_wide(F, num_bin, ft, win, wpf, stage_rows) || S <= 0 ||
      blocks < 1 || blocks > kMaxParts ||
      reinterpret_cast<uintptr_t>(bins) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gh) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(launch_wide, mode, bins, gh, out, partials, S,
                            F, num_bin, mode, ft, win, wpf, stage_rows,
                            blocks, static_cast<cudaStream_t>(stream));
}

// The small path for a leaf of S rows (S * 16 bytes of shared memory
// beside the window's histogram: S <= 8,192), on `stream` of `device`;
// returns cudaGetLastError() (0 = ok).
int lgbm_hist_rowmajor_small(const void* bins, const void* gh, void* out,
                             int S, int F, int num_bin, int mode,
                             int bin_bytes, int device, void* stream) {
  if (!valid_args(num_bin, mode, bin_bytes) || S <= 0 || S > 8192 || F <= 0 ||
      F > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH3(launch_small, mode, bin_bytes, bins, gh, out, S, F,
                       num_bin, mode, static_cast<cudaStream_t>(stream));
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
