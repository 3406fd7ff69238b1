// Shared body of the port's histogram kernels (K1 hist_rowmajor.cu, K2
// hist_level.cu; B2 hist_featmajor.cu shares all of it but the row
// loads of fetch/accumulate) for Hopper (sm_90a).
//
// One block is one warp. Its 32 lanes own the features of a feature tile
// (lane l <-> feature f0 + l, at most 32 per tile), and the block keeps
// one private histogram of the tile in dynamic shared memory, laid out
// [channel][bin][lane] so that lane l always hits bank l: the scatter has
// no bank conflicts whatever the bins are. Each slot has exactly one
// owner (its lane) and the lane adds its rows in row order, so a block's
// sums never depend on scheduling, and no atomics are needed. The block's
// rows are fetched 32 at a time: lane j loads row j's (grad, hess, count)
// and, through the row id broadcast by shuffle, every lane loads its own
// byte of each of the 32 rows (one coalesced read of the row's tile
// bytes); the next batch's loads are in flight while a batch is added.
//
// Blocks that share an output (a leaf's histogram in K1, a node's in K2)
// write their histograms to a partials buffer in the shared-memory layout
// (coalesced), and reduce_partials sums them in block order. A block that
// is the only one of its output writes it directly. Both paths are
// deterministic: two launches on the same input give the same bits.
//
// gh types: f32; bf16 (raw bits, widened on load: the bf16 value is exact
// in f32); int8 (summed exactly in int32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kLanes = 32;      // threads per block = features per tile
constexpr int kChannels = 3;    // grad, hess, count
constexpr int kBatch = 32;      // rows fetched per step
constexpr unsigned kFull = 0xffffffffu;

enum GhMode { kF32 = 0, kBF16 = 1, kInt8 = 2 };

template <typename G> struct Gh;
template <> struct Gh<float> {
  using Acc = float;
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
};
template <> struct Gh<uint16_t> {  // bf16 bits
  using Acc = float;
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
  }
};
template <> struct Gh<int8_t> {
  using Acc = int;
  static __device__ __forceinline__ int load(const int8_t* p) {
    return static_cast<int>(__ldg(reinterpret_cast<const signed char*>(p)));
  }
};

// Shared-memory histogram of one block: [3][num_bin][32] accumulators.
__host__ __device__ inline int tile_slots(int num_bin) {
  return kChannels * num_bin * kLanes;
}

template <typename Acc>
__device__ __forceinline__ void zero_hist(Acc* hist, int num_bin) {
  const int n = tile_slots(num_bin);
  for (int i = threadIdx.x; i < n; i += kLanes) hist[i] = Acc(0);
  __syncwarp();
}

// Row id at position p (through `order` when it is not null), or -1 past
// the block's last position.
__device__ __forceinline__ long long row_at(const long long* order,
                                            long long p, long long p1) {
  if (p >= p1) return -1;
  return order != nullptr ? __ldg(order + p) : p;
}

// Issue the loads of one batch: lane j's row id `row` (-1: none) and its
// (grad, hess, count) into v0..v2, and each lane's byte of all 32 rows
// into b (num_bin where there is nothing to add).
template <typename G>
__device__ __forceinline__ void fetch(const uint8_t* col, const G* gh,
                                      long long row, int F, bool active,
                                      int num_bin, typename Gh<G>::Acc& v0,
                                      typename Gh<G>::Acc& v1,
                                      typename Gh<G>::Acc& v2,
                                      int (&b)[kBatch]) {
  using Acc = typename Gh<G>::Acc;
  v0 = v1 = v2 = Acc(0);
  if (row >= 0) {
    const G* g = gh + row * kChannels;
    v0 = Gh<G>::load(g);
    v1 = Gh<G>::load(g + 1);
    v2 = Gh<G>::load(g + 2);
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const long long rj = __shfl_sync(kFull, row, j);
    b[j] = (active && rj >= 0) ? static_cast<int>(__ldg(col + rj * F))
                               : num_bin;
  }
}

// Add rows p0..p1-1 (through `order` when it is not null) of the feature
// tile [f0, f0 + ft) into `hist`. Software-pipelined: while a batch is
// added, the next batch's loads and the row ids of the one after are in
// flight. Each row's three slots are read before any is written (the
// compiler cannot tell that the channel planes do not overlap).
template <typename G>
__device__ void accumulate(const uint8_t* __restrict__ bins,
                           const G* __restrict__ gh,
                           const long long* __restrict__ order, long long p0,
                           long long p1, int F, int f0, int ft, int num_bin,
                           typename Gh<G>::Acc* hist) {
  using Acc = typename Gh<G>::Acc;
  const int lane = threadIdx.x;
  const bool active = lane < ft;
  const uint8_t* col = bins + f0 + lane;
  Acc* h0 = hist + lane;
  const int cstride = num_bin * kLanes;
  Acc c0, c1, c2;
  int cb[kBatch];
  fetch<G>(col, gh, row_at(order, p0 + lane, p1), F, active, num_bin, c0,
           c1, c2, cb);
  long long next_row = row_at(order, p0 + kBatch + lane, p1);
  for (long long base = p0; base < p1; base += kBatch) {
    Acc n0, n1, n2;
    int nb[kBatch];
    fetch<G>(col, gh, next_row, F, active, num_bin, n0, n1, n2, nb);
    next_row = row_at(order, base + 2 * kBatch + lane, p1);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const Acc g0 = __shfl_sync(kFull, c0, j);
      const Acc g1 = __shfl_sync(kFull, c1, j);
      const Acc g2 = __shfl_sync(kFull, c2, j);
      if (cb[j] < num_bin) {
        Acc* h = h0 + cb[j] * kLanes;
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
    for (int j = 0; j < kBatch; ++j) cb[j] = nb[j];
  }
  __syncwarp();
}

// The block's histogram straight into out[f0 .. f0 + ft) of an
// [F, num_bin, 3] output: lane l writes feature f0 + l.
template <typename Acc>
__device__ void write_out(const Acc* hist, Acc* out, int f0, int ft,
                          int num_bin) {
  const int lane = threadIdx.x;
  if (lane >= ft) return;
  Acc* o = out + static_cast<long long>(f0 + lane) * num_bin * kChannels;
  const int cstride = num_bin * kLanes;
  for (int b = 0; b < num_bin; ++b) {
    const Acc* h = hist + b * kLanes + lane;
    o[b * kChannels + 0] = h[0];
    o[b * kChannels + 1] = h[cstride];
    o[b * kChannels + 2] = h[2 * cstride];
  }
}

// The block's histogram, verbatim, into its slice of the partials buffer.
template <typename Acc>
__device__ void write_partial(const Acc* hist, Acc* part, int num_bin) {
  const int n = tile_slots(num_bin);
  for (int i = threadIdx.x; i < n; i += kLanes) part[i] = hist[i];
}

// out[node] = sum of its blocks' partials, in block order. The partials
// of global block g, feature tile t, live at
// partials[(g * n_ftiles + t) * tile_slots]. Node v owns blocks
// [first[v], first[v + 1]) (with first == nullptr: one node owning
// blocks [0, n_parts)). A node with one block was written directly by
// that block and is skipped; a node with none gets zeros.
// grid: (ceil(tile_slots / blockDim.x), n_ftiles, n_nodes)
template <typename Acc>
__global__ void reduce_partials(const Acc* __restrict__ partials,
                                Acc* __restrict__ out,
                                const long long* __restrict__ first,
                                long long n_parts, int F, int ft,
                                int n_ftiles, int num_bin) {
  const int v = blockIdx.z;
  const long long g0 = first != nullptr ? first[v] : 0;
  const long long g1 = first != nullptr ? first[v + 1] : n_parts;
  if (g1 - g0 == 1) return;
  const int slots = tile_slots(num_bin);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= slots) return;
  const int fl = p % kLanes;
  const int k = p / kLanes;            // c * num_bin + b
  const int c = k / num_bin;
  const int b = k - c * num_bin;
  const int t = blockIdx.y;
  const int f = t * ft + fl;
  if (fl >= ft || f >= F) return;
  Acc s = Acc(0);
  for (long long g = g0; g < g1; ++g) {
    s += partials[(g * n_ftiles + t) * slots + p];
  }
  out[((static_cast<long long>(v) * F + f) * num_bin + b) * kChannels + c] =
      s;
}

// Feature tiling: as few tiles of at most 32 features as cover F, of
// equal width.
inline void feature_tiles(int F, int* ft, int* n_ftiles) {
  *n_ftiles = (F + kLanes - 1) / kLanes;
  *ft = (F + *n_ftiles - 1) / *n_ftiles;
}

// Dynamic shared memory of a block: its [3][num_bin][32] accumulators
// (f32 and int32 alike are 4 bytes).
inline int shared_bytes(int num_bin) { return tile_slots(num_bin) * 4; }

constexpr int kMaxDevices = 64;

// Lets `kernel` use the shared memory of num_bin = 256 on the current
// device; done once per device and kernel (flags: one per kernel
// instantiation, indexed by device).
template <typename K>
inline cudaError_t allow_shared(K kernel, bool* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             shared_bytes(256));
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    done[device] = true;
  }
  return err;
}

// Blocks of `kernel` resident on the whole current device at once, with
// the shared memory of num_bin bins.
template <typename K>
inline cudaError_t resident_blocks(K kernel, bool* done, int num_bin,
                                   long long* out) {
  cudaError_t err = allow_shared(kernel, done);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, kLanes, shared_bytes(num_bin));
  if (err != cudaSuccess) return err;
  *out = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

}  // namespace lgbm
