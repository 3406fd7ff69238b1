// Kernel K2 for Hopper (sm_90a): the histograms of every node of one
// tree level in one launch, over rows sorted by node.
//
// Replaces: lightgbm_tpu/ops/hist_level_pallas.py::_hist_level_kernel,
// reached through hist_level (:208) and _hist_level_impl (pallas_call at
// :189), in its f32, bf16 and int8 -> int32 modes. The TPU kernel pads
// every node's segment to a multiple of block_rows so that each grid step
// has one owner node, prefetches the owners as scalars and keeps the
// owner's accumulator pinned in VMEM; it contracts a one-hot on the
// matrix unit with f32 gh split into bf16 hi/mid/lo triples. On Hopper
// none of that is needed: a block reads its node and row range from the
// segment offsets itself, and scatters into shared memory.
//
//   out[v, f, b, c] = sum over rows r of node v of gh[r, c] * [bins[r, f] == b]
//   bins:  uint8 [R, F] contiguous (the training matrix, not gathered)
//   gh:    [R, 3] contiguous, f32 / bf16 / int8
//   order: int64 [R], row ids sorted by node (stable); rows of no node
//          sort after node n_nodes - 1 and are never read
//   seg:   int64 [n_nodes + 1], node v's rows are order[seg[v]:seg[v+1]]
//   first: int64 [n_nodes + 1], node v owns blocks [first[v], first[v+1]),
//          ceil((seg[v+1] - seg[v]) / rows_per_block) of them
//   out:   [n_nodes, F, num_bin, 3], f32 (int32 for int8 gh); empty nodes
//          are exact zeros
//
// Bound on an H100 SXM (3.35 TB/s): R*F bin bytes, R*3*sizeof(gh), the
// 8*R bytes of the sort order and 12*n_nodes*F*num_bin of output. At R =
// 1M, F = 28, num_bin = 255, 512 nodes: about 28 + 12 + 8 + 44 = 92 MB
// in f32, about 27 us. The adds are far below the card's rate.
//
// Design (hist_common.cuh): one warp per block, lane = feature, a private
// [3][num_bin][32] shared histogram (98,304 B at num_bin = 256: two
// blocks per SM), rows in sorted order within a block. Each block owns at
// most rows_per_block rows of ONE node (the wrapper, ops/hist_level_cuda.py,
// sets rows_per_block so that a level whose rows sit in one node fills one
// wave of resident blocks). A
// node with one block gets its histogram straight from that block; the
// blocks of a larger node write partials that reduce_partials sums in
// block order; a node with no rows gets zeros from reduce_partials. The
// grid is sized by the bound R / rows_per_block + n_nodes, so the host
// never waits for the device to learn the block count: blocks past the
// last node's exit at once. No float atomics: f32 and bf16 results do
// not depend on scheduling.
#include "hist_common.cuh"

namespace {

using namespace lgbm;

template <typename G>
__global__ void __launch_bounds__(kLanes)
hist_level_kernel(const uint8_t* __restrict__ bins, const G* __restrict__ gh,
                  const long long* __restrict__ order,
                  const long long* __restrict__ seg,
                  const long long* __restrict__ first,
                  typename Gh<G>::Acc* __restrict__ out,
                  typename Gh<G>::Acc* __restrict__ partials, int F, int ft,
                  int num_bin, int n_nodes, long long rows_per_block) {
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
  const int f0 = blockIdx.y * ft;
  const int ftl = min(ft, F - f0);
  zero_hist(hist, num_bin);
  accumulate<G>(bins, gh, order, p0, p1, F, f0, ftl, num_bin, hist);
  if (first[v + 1] - first[v] == 1) {
    write_out(hist, out + static_cast<long long>(v) * F * num_bin * kChannels,
              f0, ftl, num_bin);
  } else {
    const long long part = g * gridDim.y + blockIdx.y;
    write_partial(hist, partials + part * tile_slots(num_bin), num_bin);
  }
}

bool g_shared_ok[3][kMaxDevices];   // per mode, per device

template <typename G>
int resident(int num_bin, int mode, long long* blocks) {
  return static_cast<int>(resident_blocks(hist_level_kernel<G>,
                                          g_shared_ok[mode], num_bin,
                                          blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, const void* order,
           const void* seg, const void* first, void* out, void* partials,
           int F, int num_bin, int n_nodes, int mode,
           long long rows_per_block, long long max_blocks,
           cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  int ft = 0, n_ftiles = 0;
  feature_tiles(F, &ft, &n_ftiles);
  cudaError_t err = allow_shared(hist_level_kernel<G>, g_shared_ok[mode]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* first_p = static_cast<const long long*>(first);
  if (max_blocks > 0) {
    dim3 grid(static_cast<unsigned>(max_blocks),
              static_cast<unsigned>(n_ftiles));
    hist_level_kernel<G><<<grid, kLanes, shared_bytes(num_bin), stream>>>(
        static_cast<const uint8_t*>(bins), static_cast<const G*>(gh),
        static_cast<const long long*>(order),
        static_cast<const long long*>(seg), first_p, static_cast<Acc*>(out),
        static_cast<Acc*>(partials), F, ft, num_bin, n_nodes,
        rows_per_block);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  constexpr int kReduceThreads = 256;
  dim3 rgrid((tile_slots(num_bin) + kReduceThreads - 1) / kReduceThreads,
             static_cast<unsigned>(n_ftiles), static_cast<unsigned>(n_nodes));
  reduce_partials<Acc><<<rgrid, kReduceThreads, 0, stream>>>(
      static_cast<const Acc*>(partials), static_cast<Acc*>(out), first_p, 0,
      F, ft, n_ftiles, num_bin);
  return static_cast<int>(cudaGetLastError());
}

bool valid_bins(int num_bin, int mode) {
  return num_bin >= 1 && num_bin <= 256 && mode >= kF32 && mode <= kInt8;
}

}  // namespace

extern "C" {

// Blocks of the kernel in `mode` resident on the current device at once,
// at num_bin bins (written to *blocks); the caller sizes rows_per_block
// with it. Returns a cudaError_t.
int lgbm_hist_level_resident(int num_bin, int mode, long long* blocks) {
  if (!valid_bins(num_bin, mode)) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case kF32: return resident<float>(num_bin, mode, blocks);
    case kBF16: return resident<uint16_t>(num_bin, mode, blocks);
    default: return resident<int8_t>(num_bin, mode, blocks);
  }
}

// Launches the level histogram over a grid of max_blocks (>= first[n])
// blocks, and the reduction of its partials (the caller allocates
// max_blocks * ceil(F / 32) * 3 * num_bin * 32 accumulators), on
// `stream`; returns cudaGetLastError() (0 = ok).
int lgbm_hist_level(const void* bins, const void* gh, const void* order,
                    const void* seg, const void* first, void* out,
                    void* partials, int F, int num_bin, int n_nodes, int mode,
                    long long rows_per_block, long long max_blocks,
                    void* stream) {
  if (!valid_bins(num_bin, mode) || F <= 0 || n_nodes < 1 ||
      n_nodes > 65535 || rows_per_block < 1 || max_blocks < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      return launch<float>(bins, gh, order, seg, first, out, partials, F,
                           num_bin, n_nodes, mode, rows_per_block, max_blocks,
                           st);
    case kBF16:
      return launch<uint16_t>(bins, gh, order, seg, first, out, partials, F,
                              num_bin, n_nodes, mode, rows_per_block,
                              max_blocks, st);
    default:
      return launch<int8_t>(bins, gh, order, seg, first, out, partials, F,
                            num_bin, n_nodes, mode, rows_per_block,
                            max_blocks, st);
  }
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
