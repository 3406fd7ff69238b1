// Kernel K2 for Hopper (sm_90a): the histograms of every node of one
// tree level in one launch, over rows in node order, over uint8 or
// uint16 bins.
//
// Replaces: lightgbm_tpu/ops/hist_level_pallas.py::_hist_level_kernel,
// reached through hist_level (:208) and _hist_level_impl (pallas_call at
// :189), in its f32, bf16 and int8 -> int32 modes, over uint8 or uint16
// bins (:216). The TPU kernel pads
// every node's segment to a multiple of block_rows so that each grid step
// has one owner node, prefetches the owners as scalars and keeps the
// owner's accumulator pinned in VMEM; it contracts a one-hot on the
// matrix unit with f32 gh split into bf16 hi/mid/lo triples. On Hopper
// none of that is needed: a block reads its node and row range from the
// segment offsets itself, and scatters into shared memory.
//
//   out[v, f, b, c] = sum over rows r of node v of gh[r, c] * [bins[r, f] == b]
//   bins:  uint8 or uint16 [R, F], values >= num_bin skipped; gh: [R, 3]
//          (f32 / bf16 / int8); both gathered
//          into node order (position p holds the p-th row of the order),
//          16-byte aligned, each buffer readable up to the next multiple
//          of 16 bytes
//   seg:   int64 [n_nodes + 1], node v's rows are at positions
//          seg[v] .. seg[v + 1] - 1
//   first: int64 [n_nodes + 1], node v owns blocks [first[v], first[v+1]),
//          ceil((seg[v+1] - seg[v]) / rows_per_block) of them
//   out:   [n_nodes, F, num_bin, 3], f32 (int32 for int8 gh); empty nodes
//          are exact zeros
//
// Bound on an H100 SXM (3.35 TB/s): R*F*w bin bytes (w = 1 or 2),
// R*3*sizeof(gh), the 8*R bytes of the node order and
// 12*n_nodes*F*num_bin of output. At R = 1M, F = 28, num_bin = 255, 512
// nodes: about 28 + 12 + 8 + 44 = 92 MB in f32, about 27 us; at 1,023
// u16 bins the output alone is 176 MB. The adds are far below the card's
// rate.
//
// Design. The node order is carried from level to level (no sort): after
// each level's split the level grower partitions each parent's segment
// stably into its children's (pack_flags and place_rows below: positions
// from one cumulative sum over packed left/right flags, then one
// scatter), and the wrapper (ops/hist_level_cuda.py) gathers bins and gh
// into that order once per level, so that a node's rows are consecutive
// rows (28 bytes at F = 28 in u8). Over u8 bins the block body is K1's
// (hist_grouped.cuh add_rows_rowmajor): one warp, lane = feature, a
// private [num_bin][32][3] shared histogram of its feature tile; a
// batch of 32 rows (its bins and gh bytes, whole 16-byte chunks) is
// copied into a shared-memory ring with cp.async, kStages batches ahead
// of the one being added, and the rows are added four at a time, their
// slots loaded together and sums of the same slot forwarded in row order
// (lane l reads bin l of each staged row, every lane the row's gh).
// Reading the rows through the order instead of gathering them was
// tried and dropped: rows at random positions cannot be copied 16 bytes
// at a time, and their byte loads bound the kernel as they bound K1.
// Each block owns
// at most rows_per_block rows of ONE node (sized so that a level whose
// rows sit in one node fills one wave of resident blocks). A node with
// one block gets its histogram straight from that block; the blocks of a
// larger node write partials that reduce_nodes sums in block order; a
// node with no rows gets zeros from reduce_nodes. The grid is sized by
// the bound R / rows_per_block + n_nodes, so the host never waits for the
// device to learn the block count: blocks past the last node's exit at
// once. Skewed bins take the body's f64 hot sums (LaneHot), and
// reduce_nodes sums in f64. No float atomics: f32 and bf16 results do
// not depend on scheduling.
//
// u16 bins take hist_level_wide: the same blocks, nodes and reductions
// over the wide body of hist_grouped.cuh (a warp per feature of a tile,
// lane = row, all of a tile's bins in one block), which reads a node's
// rows once per feature tile where the grouped body read them once per
// 512-bin window;
// at 512 nodes and 4,095 bins the output alone, 704 MB, bounds it at
// about 0.21 ms.
#include "hist_grouped.cuh"

namespace {

using namespace lgbm;

template <typename G>
inline int level_shared_bytes(int num_bin, int F) {
  return hist_bytes(num_bin) + rm_fixed_bytes<G, uint8_t>(F);
}

template <typename G, typename BinT>
__global__ void __launch_bounds__(kLanes)
hist_level_kernel(const BinT* __restrict__ bins, const G* __restrict__ gh,
                  const long long* __restrict__ seg,
                  const long long* __restrict__ first,
                  typename Gh<G>::Acc* __restrict__ out,
                  typename Gh<G>::Acc* __restrict__ partials, Cols cols,
                  int n_nodes, long long rows_per_block) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const long long g = blockIdx.x;
  if (g >= first[n_nodes]) return;
  // the node of block g: the last v with first[v] <= g (it has >= 1 block)
  int lo = 0, hi = n_nodes;   // first[lo] <= g < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= g) lo = mid; else hi = mid;
  }
  const int v = lo;
  const long long k = g - first[v];
  const long long p0 = seg[v] + k * rows_per_block;
  const long long p1 = min(seg[v + 1], p0 + rows_per_block);
  const int t = blockIdx.y;
  zero_hist_vec(hist, cols.win);
  add_rows_rowmajor<G, BinT>(hist, smem_raw + hist_bytes(cols.win), bins,
                             gh, p0, p1, cols, t);
  if (first[v + 1] - first[v] == 1) {
    write_out_slots(hist,
                    out + static_cast<long long>(v) * cols.F * cols.num_bin *
                              kChannels,
                    cols, t);
  } else {
    const long long part = g * gridDim.y + t;
    write_partial_vec(hist, partials + part * tile_slots(cols.win),
                      cols.win);
  }
}

// The level histogram over u16 bins: the wide body
// (hist_grouped.cuh add_rows_wide), ft warps a block, one per feature of
// the column's tile; a block's node and rows as in hist_level_kernel.
template <typename G, typename BinT>
__global__ void __launch_bounds__(kWideMaxWarps * kLanes)
hist_level_wide(const BinT* __restrict__ bins, const G* __restrict__ gh,
                const long long* __restrict__ seg,
                const long long* __restrict__ first,
                typename Gh<G>::Acc* __restrict__ out,
                typename Gh<G>::Acc* __restrict__ partials, WideCols cols,
                int n_nodes, long long rows_per_block) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const long long g = blockIdx.x;
  if (g >= first[n_nodes]) return;
  int lo = 0, hi = n_nodes;   // first[lo] <= g < first[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (first[mid] <= g) lo = mid; else hi = mid;
  }
  const int v = lo;
  const long long k = g - first[v];
  const long long p0 = seg[v] + k * rows_per_block;
  const long long p1 = min(seg[v + 1], p0 + rows_per_block);
  const int t = blockIdx.y;
  const int slots = col_slots(cols);
  zero_hist_block(hist, slots);
  add_rows_wide<G, BinT>(hist, smem_raw + slots * 4,
                         smem_raw + slots * 4 + wide_tag_bytes(cols), bins,
                         gh, p0, p1, cols, t);
  __syncthreads();
  if (first[v + 1] - first[v] == 1) {
    write_out_wide(hist,
                   out + static_cast<long long>(v) * cols.F * cols.num_bin *
                             kChannels,
                   cols, t);
  } else {
    write_partial_block(hist, partials + (g * gridDim.y + t) * slots, slots);
  }
}

// The partition of one level's rows into the next level's node order
// (the plain version is ops/hist_level.carry_order). Position p of this
// level's order holds row order[p]; a row that descends goes to child 2v
// (go_left) or 2v + 1 of its node v. pack_flags writes, by position, 2^32
// for a row going left, 1 for one going right, 0 otherwise, and, by row
// id, 1 for a row leaving the level; the caller takes the inclusive
// cumulative sums cum (of the packed flags: left count in the high 32
// bits, right count in the low ones) and cum_out (of the leaving rows).
constexpr long long kLeft = 1LL << 32;
constexpr long long kLow = kLeft - 1;

__global__ void pack_flags(const long long* __restrict__ order,
                           const bool* __restrict__ go_left,
                           const bool* __restrict__ descend,
                           long long* __restrict__ packed,
                           long long* __restrict__ leaving, long long R) {
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < R; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = order[p];
    packed[p] = descend[r] ? (go_left[r] ? kLeft : 1) : 0;
    leaving[p] = descend[p] ? 0 : 1;
  }
}

// Exclusive prefix of the packed flags at position x.
__device__ __forceinline__ long long prefix_at(const long long* cum,
                                               long long x) {
  return x > 0 ? cum[x - 1] : 0;
}

// Writes the next level's order nxt [R] (left rows of each parent, then
// its right rows, parents in node order; then the leaving rows in row-id
// order) and its segment bounds new_seg [2n + 1].
__global__ void place_rows(const long long* __restrict__ order,
                           const long long* __restrict__ seg,
                           const long long* __restrict__ local,
                           const bool* __restrict__ descend,
                           const long long* __restrict__ packed,
                           const long long* __restrict__ cum,
                           const long long* __restrict__ cum_out,
                           long long* __restrict__ nxt,
                           long long* __restrict__ new_seg, long long R,
                           int n) {
  const long long last = cum[R - 1];
  const long long total = (last >> 32) + (last & kLow);  // rows descending
  const long long end = max(R, static_cast<long long>(n) + 1);
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < end; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pk = p < R ? packed[p] : 0;
    if (pk != 0) {
      const long long r = order[p];
      const long long excl = cum[p] - pk;
      const int v = static_cast<int>(min(max(local[r], 0LL),
                                         static_cast<long long>(n - 1)));
      // left: the descending rows of the parents before v, then v's left
      // rows before p; right: every left row up to v's end, then the
      // right rows before p
      nxt[pk == kLeft ? (excl >> 32) + (prefix_at(cum, seg[v]) & kLow)
                      : (prefix_at(cum, seg[v + 1]) >> 32) + (excl & kLow)] =
          r;
    }
    if (p < R && !descend[p]) nxt[total + cum_out[p] - 1] = p;
    if (p <= n) {
      if (p == n) {
        new_seg[2 * n] = total;
      } else {
        const long long ps = prefix_at(cum, seg[p]);
        const long long pe = prefix_at(cum, seg[p + 1]);
        new_seg[2 * p] = (ps >> 32) + (ps & kLow);
        new_seg[2 * p + 1] = (pe >> 32) + (ps & kLow);
      }
    }
  }
}

int g_shared_set[3][kMaxDevices];   // per mode, device (u8 bins)
int g_wide_set[3][kMaxDevices];     // per mode, device (u16 bins)

template <typename G>
int plan(int num_bin, int F, int mode, long long* blocks) {
  return static_cast<int>(resident_with(
      hist_level_kernel<G, uint8_t>, g_shared_set[mode],
      level_shared_bytes<G>(num_bin, F), blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, const void* seg,
           const void* first, void* out, void* partials, int F, int num_bin,
           int n_nodes, int mode, long long rows_per_block,
           long long max_blocks, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  using BinT = uint8_t;
  const Cols cols = make_cols(F, num_bin, num_bin);
  const int smem = level_shared_bytes<G>(num_bin, F);
  cudaError_t err = allow_bytes(hist_level_kernel<G, BinT>,
                                g_shared_set[mode], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* first_p = static_cast<const long long*>(first);
  if (max_blocks > 0) {
    dim3 grid(static_cast<unsigned>(max_blocks),
              static_cast<unsigned>(cols.count()));
    hist_level_kernel<G, BinT><<<grid, kLanes, smem, stream>>>(
        static_cast<const BinT*>(bins), static_cast<const G*>(gh),
        static_cast<const long long*>(seg), first_p, static_cast<Acc*>(out),
        static_cast<Acc*>(partials), cols, n_nodes, rows_per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kReduceThreads = 256;
  dim3 rgrid((tile_slots(num_bin) + kReduceThreads - 1) / kReduceThreads,
             static_cast<unsigned>(cols.count()),
             static_cast<unsigned>(min(n_nodes, 64)));
  reduce_nodes<Acc><<<rgrid, kReduceThreads, 0, stream>>>(
      static_cast<const Acc*>(partials), static_cast<Acc*>(out), first_p,
      n_nodes, cols);
  return static_cast<int>(cudaGetLastError());
}

template <typename G>
int plan_wide(int F, int mode, int ft, int win, int wpf, int stage_rows,
              int* optin, long long* blocks) {
  return static_cast<int>(wide_plan<G, uint16_t>(
      hist_level_wide<G, uint16_t>, g_wide_set[mode], F, ft, win, wpf,
      stage_rows, optin, blocks));
}

template <typename G>
int launch_wide(const void* bins, const void* gh, const void* seg,
                const void* first, void* out, void* partials, int F,
                int num_bin, int n_nodes, int mode, int ft, int win,
                int wpf, int stage_rows, long long rows_per_block,
                long long max_blocks, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  using BinT = uint16_t;
  const WideCols cols = make_wide_cols(F, num_bin, ft, win, wpf,
                                       stage_rows);
  const int smem = wide_shared_bytes<G, BinT>(cols);
  cudaError_t err = allow_bytes(hist_level_wide<G, BinT>,
                                g_wide_set[mode], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* first_p = static_cast<const long long*>(first);
  if (max_blocks > 0) {
    dim3 grid(static_cast<unsigned>(max_blocks),
              static_cast<unsigned>(cols.count()));
    hist_level_wide<G, BinT><<<grid, cols.warps() * kLanes, smem, stream>>>(
        static_cast<const BinT*>(bins), static_cast<const G*>(gh),
        static_cast<const long long*>(seg), first_p, static_cast<Acc*>(out),
        static_cast<Acc*>(partials), cols, n_nodes, rows_per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kReduceThreads = 256;
  dim3 rgrid((col_slots(cols) + kReduceThreads - 1) / kReduceThreads,
             static_cast<unsigned>(cols.count()),
             static_cast<unsigned>(min(n_nodes, 64)));
  reduce_nodes<Acc, WideCols><<<rgrid, kReduceThreads, 0, stream>>>(
      static_cast<const Acc*>(partials), static_cast<Acc*>(out), first_p,
      n_nodes, cols);
  return static_cast<int>(cudaGetLastError());
}

int grid_for(long long R) {
  return static_cast<int>(min((R + 255) / 256, 4096LL));
}

}  // namespace

extern "C" {

// The plan of the kernel in `mode` on `device` at num_bin u8 bins and F
// features: the blocks resident on the device at once (*blocks), with
// which the caller sizes rows_per_block. Returns a cudaError_t.
int lgbm_hist_level_plan(int num_bin, int F, int mode, int device,
                         long long* blocks) {
  if (!valid_args(num_bin, mode, 1) || F <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(plan, mode, num_bin, F, mode, blocks);
}

// Launches the level histogram over u8 bins on a grid of max_blocks (>=
// first[n]) blocks per feature tile, and the reduction of its partials
// (the caller allocates max_blocks * ceil(F / 32) * 3 * num_bin * 32
// accumulators), on `stream` of `device` (the device current before the
// call is current again after it); returns cudaGetLastError() (0 = ok).
int lgbm_hist_level(const void* bins, const void* gh, const void* seg,
                    const void* first, void* out, void* partials, int F,
                    int num_bin, int n_nodes, int mode,
                    long long rows_per_block, long long max_blocks,
                    int device, void* stream) {
  if (!valid_args(num_bin, mode, 1) || F <= 0 || n_nodes < 1 ||
      n_nodes > 65535 || rows_per_block < 1 || max_blocks < 0 ||
      reinterpret_cast<uintptr_t>(bins) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gh) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(launch, mode, bins, gh, seg, first, out,
                            partials, F, num_bin, n_nodes, mode,
                            rows_per_block, max_blocks,
                            static_cast<cudaStream_t>(stream));
}

// The wide level histogram's plan on `device` (u16 bins): the opt-in
// shared bytes of a block (*optin) and, for ft > 0, the blocks of the
// geometry (ft features a tile, windows of win bins, wpf warps a feature,
// stage_rows rows a stage, at F features) resident on the device at once
// (*blocks). Returns a cudaError_t.
int lgbm_hist_level_wide_plan(int F, int mode, int ft, int win, int wpf,
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

// The level histogram over u16 bins, on the wide body: as
// lgbm_hist_level, with columns of ft features x win bins, wpf warps a
// feature and stage_rows rows a stage (the caller allocates max_blocks *
// ceil(F / ft) * ceil(num_bin / win) * 3 * ft * win accumulators of
// partials).
int lgbm_hist_level_wide(const void* bins, const void* gh, const void* seg,
                         const void* first, void* out, void* partials, int F,
                         int num_bin, int n_nodes, int mode, int ft, int win,
                         int wpf, int stage_rows, long long rows_per_block,
                         long long max_blocks, int device, void* stream) {
  if (!valid_args(num_bin, mode, 2) ||
      !valid_wide(F, num_bin, ft, win, wpf, stage_rows) || n_nodes < 1 ||
      n_nodes > 65535 || rows_per_block < 1 || max_blocks < 0 ||
      reinterpret_cast<uintptr_t>(bins) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(gh) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_MODE(launch_wide, mode, bins, gh, seg, first, out,
                            partials, F, num_bin, n_nodes, mode, ft, win,
                            wpf, stage_rows, rows_per_block, max_blocks,
                            static_cast<cudaStream_t>(stream));
}

// The first step of the partition: packed [R] and leaving [R] int64 (see
// pack_flags) on `stream` of `device`; returns cudaGetLastError().
int lgbm_level_pack_flags(const void* order, const void* go_left,
                          const void* descend, void* packed, void* leaving,
                          long long R, int device, void* stream) {
  if (R < 1) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  pack_flags<<<grid_for(R), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(order), static_cast<const bool*>(go_left),
      static_cast<const bool*>(descend), static_cast<long long*>(packed),
      static_cast<long long*>(leaving), R);
  return static_cast<int>(cudaGetLastError());
}

// The second step, given the inclusive cumulative sums of both: the next
// level's order nxt [R] and segment bounds new_seg [2n + 1], on `stream`
// of `device`; returns cudaGetLastError().
int lgbm_level_place_rows(const void* order, const void* seg,
                          const void* local, const void* descend,
                          const void* packed, const void* cum,
                          const void* cum_out, void* nxt, void* new_seg,
                          long long R, int n, int device, void* stream) {
  if (R < 1 || n < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  const int grid = max(grid_for(R), (n + 256) / 256);
  place_rows<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(order),
      static_cast<const long long*>(seg), static_cast<const long long*>(local),
      static_cast<const bool*>(descend), static_cast<const long long*>(packed),
      static_cast<const long long*>(cum),
      static_cast<const long long*>(cum_out), static_cast<long long*>(nxt),
      static_cast<long long*>(new_seg), R, n);
  return static_cast<int>(cudaGetLastError());
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
