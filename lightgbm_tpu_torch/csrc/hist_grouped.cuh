// Block body of the port's histogram kernels K1 (hist_rowmajor.cu), K2
// (hist_level.cu) and B2 (hist_featmajor.cu) for Hopper (sm_90a): rows
// added a group at a time into a private shared-memory histogram.
//
// A block is one warp. Lane l owns feature f0 + l of a feature tile (at
// most 32 features) and keeps its slots in a private [win][32][3]
// histogram in dynamic shared memory: a slot's three accumulators
// (grad, hess, count) adjacent, one address for all three, and lane l's
// slots in banks 3l + c mod 32, distinct across a warp. Each slot has one
// owner (its lane), so no atomics are needed and a block's sums never
// depend on scheduling.
//
// Rows are staged: a batch of 32 rows' bytes is copied into a
// shared-memory ring with cp.async, 16 bytes a lane, kStages batches
// ahead of the one being added, so many loads are in flight per warp.
// A lane then takes the batch's rows in groups of kGroup: it loads the
// slots of all the group's rows at once, adds each row's values to the
// latest sum of its slot, forwarding the sum of an earlier row of the
// group that hit the same slot, and stores the rows' sums in row order,
// so the last store of a slot holds every add. Each slot's sum is formed
// exactly as a one-row-at-a-time loop forms it, in row order, and the
// shared-memory latency is paid once per group instead of once per row.
// (Groups of 8 rows cost more in the forwarding's compares than they
// hid; a block of several warps sharing one histogram by bin did not
// help, since a warp's lanes are features and every warp still issued
// every row's loads.)
//
// Bins are uint8, or uint16 when a feature has more than 256 bins. At
// 384 bytes a bin, a block's histogram of 256 bins takes 98,304 bytes
// (two blocks per SM); 1,023 bins do not fit the 227 KB a block can opt
// in to. So a launch's histogram columns are (feature tile, bin window)
// pairs: each block adds only the bins of its window [b0, b0 + win), at
// slot b - b0, and the rows are read once per window. All num_bin bins
// form one window wherever they fit beside the block's other shared
// memory and the caller's cap (plan_window); u8 bins always do.
//
// Blocks that share an output write their histograms to a partials
// buffer in the shared-memory layout (16 bytes a lane) and a reduction
// (reduce_flagged, reduce_nodes) sums them in a fixed block order. A
// block that is the only one of its output writes it directly. Two
// launches on the same input give the same bits.
//
// gh types: f32; bf16 (raw bits, widened on load: the bf16 value is exact
// in f32); int8 (summed exactly in int32).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kLanes = 32;      // threads per block = features per tile
constexpr int kChannels = 3;    // grad, hess, count
constexpr int kBatch = 32;      // rows staged per step
constexpr int kGroup = 4;       // rows whose slots a lane loads at once
constexpr int kStages = 4;      // batches staged ahead in shared memory
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

// gh of a staged row from shared memory, widened as Gh<G>::load does.
template <typename G> struct GhShared;
template <> struct GhShared<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
};
template <> struct GhShared<uint16_t> {
  static __device__ __forceinline__ float load(const uint16_t* p) {
    return __uint_as_float(static_cast<unsigned>(*p) << 16);
  }
};
template <> struct GhShared<int8_t> {
  static __device__ __forceinline__ int load(const int8_t* p) {
    return static_cast<int>(*reinterpret_cast<const signed char*>(p));
  }
};

// Accumulators of one block's histogram of `win` bins: [win][32][3].
__host__ __device__ inline int tile_slots(int win) {
  return kChannels * win * kLanes;
}

// Bytes of that histogram (4-byte accumulators; a multiple of 16), where
// a kernel's other shared memory starts.
__host__ __device__ inline int hist_bytes(int win) {
  return tile_slots(win) * 4;
}

// The slot of bin b (window-local) of lane `lane`.
__device__ __forceinline__ int slot_at(int b, int lane) {
  return (b * kLanes + lane) * kChannels;
}

// The histogram columns of a launch: F features in n_ftiles tiles of ft
// (at most 32), each tile's num_bin bins in n_win windows of win. Column
// t is tile t / n_win, window t % n_win.
struct Cols {
  int F, ft, n_ftiles, num_bin, win, n_win;
  __host__ __device__ int count() const { return n_ftiles * n_win; }
  __host__ __device__ int f0(int t) const { return (t / n_win) * ft; }
  __host__ __device__ int b0(int t) const { return (t % n_win) * win; }
  // features of column t's tile, and bins of its window
  __host__ __device__ int width(int t) const {
    const int f = f0(t);
    return ft < F - f ? ft : F - f;
  }
  __host__ __device__ int bins(int t) const {
    const int b = b0(t);
    return win < num_bin - b ? win : num_bin - b;
  }
};

// Feature tiles: as few tiles of at most 32 features as cover F, of equal
// width; bin windows of `win` bins.
inline Cols make_cols(int F, int num_bin, int win) {
  Cols c;
  c.F = F;
  c.n_ftiles = (F + kLanes - 1) / kLanes;
  c.ft = (F + c.n_ftiles - 1) / c.n_ftiles;
  c.num_bin = num_bin;
  c.win = win;
  c.n_win = (num_bin + win - 1) / win;
  return c;
}

// Whether window-local bin b (a bin value less the window's first bin)
// is one of the `lim` bins of the window (lim = 0: an inactive lane): a
// value below the window is negative, and fails the unsigned compare as
// one past it does. (Mapping the values outside to one sentinel with a
// select made K1's dense pass about 1.7 times slower on the H100.)
__device__ __forceinline__ bool in_window(int b, int lim) {
  return static_cast<unsigned>(b) < static_cast<unsigned>(lim);
}

// Zero the block's (one warp's) histogram, 16 bytes a lane at a time.
__device__ __forceinline__ void zero_hist_vec(void* hist, int win) {
  uint4* h = static_cast<uint4*>(hist);
  const int n = hist_bytes(win) / 16;
  for (int i = threadIdx.x; i < n; i += kLanes) h[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();
}

// Zero n 4-byte words at p (16-byte aligned, n a multiple of 4) with the
// whole block, 16 bytes a thread at a time.
__device__ __forceinline__ void zero_hist_block(void* p, int n) {
  uint4* h = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) {
    h[i] = make_uint4(0, 0, 0, 0);
  }
}

// The block's (one warp's) histogram, verbatim, into its slice of a
// partials buffer (16-byte aligned: every slice is 384 * win bytes), 16
// bytes a lane.
__device__ __forceinline__ void write_partial_vec(const void* hist,
                                                  void* part, int win) {
  const uint4* h = static_cast<const uint4*>(hist);
  uint4* o = static_cast<uint4*>(part);
  const int n = hist_bytes(win) / 16;
  for (int i = threadIdx.x; i < n; i += kLanes) o[i] = h[i];
}

// Add rows j0 .. j0 + kGroup - 1 of a batch to lane `lane`'s slots: bin(j)
// is the lane's window-local bin of row j (outside [0, lim): nothing to
// add) and gh(j, c) channel c of row j's (grad, hess, count).
template <typename Acc, typename BinOf, typename GhOf>
__device__ __forceinline__ void add_group(Acc* hist, int lane, int lim,
                                          int j0, BinOf bin, GhOf gh) {
  int b[kGroup];
  Acc x0[kGroup], x1[kGroup], x2[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    b[k] = bin(j0 + k);
    x0[k] = x1[k] = x2[k] = Acc(0);
    if (in_window(b[k], lim)) {
      const Acc* h = hist + slot_at(b[k], lane);
      x0[k] = h[0];
      x1[k] = h[1];
      x2[k] = h[2];
    }
  }
  Acc y0[kGroup], y1[kGroup], y2[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    Acc a0 = x0[k], a1 = x1[k], a2 = x2[k];
#pragma unroll
    for (int i = 0; i < k; ++i) {      // the latest earlier row of the slot
      if (b[i] == b[k]) {
        a0 = y0[i];
        a1 = y1[i];
        a2 = y2[i];
      }
    }
    y0[k] = a0 + gh(j0 + k, 0);
    y1[k] = a1 + gh(j0 + k, 1);
    y2[k] = a2 + gh(j0 + k, 2);
  }
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    if (in_window(b[k], lim)) {
      Acc* h = hist + slot_at(b[k], lane);
      h[0] = y0[k];
      h[1] = y1[k];
      h[2] = y2[k];
    }
  }
}

// Where accumulator p of column t's histogram goes in an [F, num_bin, 3]
// output (-1: an unused lane's, or a bin past num_bin).
__device__ __forceinline__ long long out_index(int p, const Cols& cols,
                                               int t) {
  const int b = p / (kLanes * kChannels);
  const int rem = p - b * (kLanes * kChannels);
  const int fl = rem / kChannels;
  const int c = rem - fl * kChannels;
  const int f = cols.f0(t) + fl;
  if (fl >= cols.ft || f >= cols.F || b >= cols.bins(t)) return -1;
  return (static_cast<long long>(f) * cols.num_bin + cols.b0(t) + b) *
             kChannels + c;
}

// Column t's histogram straight into an [F, num_bin, 3] output: lane l
// writes feature f0 + l's bins of the window.
template <typename Acc>
__device__ void write_out_slots(const Acc* hist, Acc* out, const Cols& cols,
                                int t) {
  const int lane = threadIdx.x;
  if (lane >= cols.width(t)) return;
  Acc* o = out + (static_cast<long long>(cols.f0(t) + lane) * cols.num_bin +
                  cols.b0(t)) * kChannels;
  const int nb = cols.bins(t);
  for (int b = 0; b < nb; ++b) {
    const Acc* h = hist + slot_at(b, lane);
    o[b * kChannels + 0] = h[0];
    o[b * kChannels + 1] = h[1];
    o[b * kChannels + 2] = h[2];
  }
}

// Asynchronous copies into shared memory (sm_80+): a lane's 16 bytes, in
// groups the lane commits and waits for.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows in a row-major [*, F] layout (K1's leaf block, K2's rows gathered
// into node order): a batch of 32 rows is 32 * F contiguous bins, and its
// staging slot holds them and their gh, each widened to whole 16-byte
// chunks at either end.
template <typename BinT>
__host__ __device__ inline int rm_bins_slot_bytes(int F) {
  return (kBatch * F * static_cast<int>(sizeof(BinT)) + 32 + 15) / 16 * 16;
}
template <typename G>
__host__ __device__ inline int rm_gh_slot_bytes() {
  return (kBatch * kChannels * static_cast<int>(sizeof(G)) + 32 + 15) / 16 *
         16;
}
template <typename G, typename BinT>
__host__ __device__ inline int rm_ring_bytes(int F) {
  return kStages * (rm_bins_slot_bytes<BinT>(F) + rm_gh_slot_bytes<G>());
}

// Add rows p0 .. p1 - 1 of row-major bins [*, F] and gh [*, 3] to column
// t's histogram `hist`, staged through `ring` (rm_ring_bytes of shared
// memory). Both buffers must be 16-byte aligned and readable up to the
// next multiple of 16 bytes past their last row (every allocation of
// torch's caching allocator is). Lane l reads feature f0 + l of each
// staged row, every lane the row's gh.
template <typename G, typename BinT>
__device__ void add_rows_rowmajor(typename Gh<G>::Acc* hist,
                                  unsigned char* ring,
                                  const BinT* __restrict__ bins,
                                  const G* __restrict__ gh, long long p0,
                                  long long p1, const Cols& cols, int t) {
  const int lane = threadIdx.x;
  const int F = cols.F;
  const int f0 = cols.f0(t), b0 = cols.b0(t);
  const bool active = lane < cols.width(t);
  // inactive lanes read feature f0's bins and add nothing
  const int lim = active ? cols.bins(t) : 0;
  const int lf = active ? lane : 0;
  const int skip = cols.win;
  const int bslot = rm_bins_slot_bytes<BinT>(F);
  const int slot = bslot + rm_gh_slot_bytes<G>();
  const long long row_b = F * static_cast<long long>(sizeof(BinT));
  const long long gh_row = kChannels * static_cast<long long>(sizeof(G));
  const unsigned char* bin_bytes =
      reinterpret_cast<const unsigned char*>(bins);
  const unsigned char* gh_bytes = reinterpret_cast<const unsigned char*>(gh);
  const long long n_batches = (p1 - p0 + kBatch - 1) / kBatch;

  // copy batch i's whole 16-byte chunks of bins and gh into its slot
  auto stage = [&](long long i) {
    unsigned char* sl = ring + (i % kStages) * slot;
    const long long base = p0 + i * kBatch;
    const long long end = min(base + kBatch, p1);
    const long long c0 = base * row_b / 16, c1 = (end * row_b + 15) / 16;
    for (long long c = c0 + lane; c < c1; c += kLanes) {
      cp_async16(sl + (c - c0) * 16, bin_bytes + c * 16);
    }
    const long long g0 = base * gh_row / 16;
    const long long g1 = (end * gh_row + 15) / 16;
    for (long long c = g0 + lane; c < g1; c += kLanes) {
      cp_async16(sl + bslot + (c - g0) * 16, gh_bytes + c * 16);
    }
  };
  for (int i = 0; i + 1 < kStages; ++i) {
    if (i < n_batches) stage(i);
    cp_async_commit();
  }
  for (long long i = 0; i < n_batches; ++i) {
    if (i + kStages - 1 < n_batches) stage(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const unsigned char* sl = ring + (i % kStages) * slot;
    const long long base = p0 + i * kBatch;
    const int rows = static_cast<int>(min(static_cast<long long>(kBatch),
                                          p1 - base));
    // row j's bin of feature f0 + lane, and its gh
    const BinT* sb = reinterpret_cast<const BinT*>(
                         sl + (base * row_b - base * row_b / 16 * 16)) +
                     f0 + lf;
    const G* sg = reinterpret_cast<const G*>(
        sl + bslot + (base * gh_row - base * gh_row / 16 * 16));
#pragma unroll
    for (int j0 = 0; j0 < kBatch; j0 += kGroup) {
      add_group(hist, lane, lim, j0,
                [&](int j) {
                  return j < rows ? static_cast<int>(sb[j * F]) - b0 : skip;
                },
                [&](int j, int c) {
                  return GhShared<G>::load(sg + j * kChannels + c);
                });
    }
    __syncwarp();
  }
}

// Programmatic dependent launch (sm_90): a kernel launched by
// launch_after may start while the kernel before it on the stream is
// still finishing, and waits here, before it reads what that kernel
// wrote, until it has completed and its writes are visible (at once when
// it was launched the ordinary way). It hides the gap between dependent
// launches, which at a few microseconds is the size of a small leaf's
// whole histogram.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// kernel<<<grid, block, smem, stream>>>(args...), allowed to start before
// the stream's previous kernel ends (see wait_for_prior_grid, which the
// kernel must call first); returns the launch's error.
template <typename... Params, typename... Args>
inline cudaError_t launch_after(void (*kernel)(Params...), dim3 grid,
                                dim3 block, size_t smem, cudaStream_t stream,
                                Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Makes `device` current for the caller's launches, and the device that
// was current before current again when it goes out of scope (so that the
// caller need not switch devices around every call).
struct OnDevice {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit OnDevice(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~OnDevice() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// Lets `kernel` use `bytes` of dynamic shared memory on the current
// device (raised when a launch needs more than before; `set` holds the
// largest size set so far, per device).
template <typename K>
inline cudaError_t allow_bytes(K kernel, int* set, int bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 0 && device < kMaxDevices && set[device] >= bytes) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    set[device] = bytes;
  }
  return err;
}

// Blocks of `kernel` (one warp, `bytes` of dynamic shared memory)
// resident on the whole current device at once.
template <typename K>
inline cudaError_t resident_with(K kernel, int* set, int bytes,
                                 long long* out) {
  cudaError_t err = allow_bytes(kernel, set, bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLanes,
                                                      bytes);
  if (err != cudaSuccess) return err;
  *out = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// A kernel's gh mode, bin width (1 or 2 bytes) and bin count are ones it
// serves: at most 256 bins in u8, 65,536 in u16.
inline bool valid_args(int num_bin, int mode, int bin_bytes) {
  return (bin_bytes == 1 || bin_bytes == 2) && num_bin >= 1 &&
         num_bin <= (bin_bytes == 1 ? 256 : 65536) && mode >= kF32 &&
         mode <= kInt8;
}

// fn<G, BinT>(args...) for gh mode `mode` (f32, bf16 or int8) and bins of
// `bin_bytes` bytes.
#define LGBM_DISPATCH3(fn, mode, bin_bytes, ...)                           \
  ((bin_bytes) == 1                                                        \
       ? ((mode) == kF32    ? fn<float, uint8_t>(__VA_ARGS__)              \
          : (mode) == kBF16 ? fn<uint16_t, uint8_t>(__VA_ARGS__)           \
                            : fn<int8_t, uint8_t>(__VA_ARGS__))            \
       : ((mode) == kF32    ? fn<float, uint16_t>(__VA_ARGS__)             \
          : (mode) == kBF16 ? fn<uint16_t, uint16_t>(__VA_ARGS__)          \
                            : fn<int8_t, uint16_t>(__VA_ARGS__)))

// The dynamic shared memory a block of the current device can opt in to
// (232,448 bytes on the H100).
inline cudaError_t shared_optin(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
}

// The bin window of a launch (written to *win): all num_bin bins when
// their histogram fits a block's shared memory beside `fixed` other
// bytes and num_bin <= max_win; else the fewest equal windows of at most
// max_win bins that fit.
inline cudaError_t plan_window(int num_bin, int max_win, int fixed,
                               int* win) {
  int optin = 0;
  const cudaError_t err = shared_optin(&optin);
  if (err != cudaSuccess) return err;
  const int fit = (optin - fixed) / hist_bytes(1);
  const int cap = max_win < fit ? max_win : fit;
  if (cap < 1 || num_bin < 1) return cudaErrorInvalidValue;
  const int n_win = (num_bin + cap - 1) / cap;
  *win = (num_bin + n_win - 1) / n_win;
  return cudaSuccess;
}

// out[node] = the sum, in block order, of its blocks' partials, for the
// nodes with more than one block (a node with one block was written by
// it, a node with none gets zeros). Node v owns blocks [first[v],
// first[v + 1]); the partials of block g, column t, are at
// partials[(g * n_cols + t) * tile_slots(win)]. grid: (ceil(tile_slots /
// blockDim.x), n_cols, any z); block z takes nodes z, z + gridDim.z, ...
template <typename Acc>
__global__ void reduce_nodes(const Acc* __restrict__ partials,
                             Acc* __restrict__ out,
                             const long long* __restrict__ first,
                             int n_nodes, Cols cols) {
  const int slots = tile_slots(cols.win);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= slots) return;
  const int t = blockIdx.y;
  const long long o = out_index(p, cols, t);
  if (o < 0) return;
  const long long n_cols = cols.count();
  const long long node_out =
      static_cast<long long>(cols.F) * cols.num_bin * kChannels;
  for (int v = blockIdx.z; v < n_nodes; v += gridDim.z) {
    const long long g0 = first[v], g1 = first[v + 1];
    if (g1 - g0 == 1) continue;
    Acc s = Acc(0);
    for (long long g = g0; g < g1; ++g) {
      s += partials[(g * n_cols + t) * slots + p];
    }
    out[v * node_out + o] = s;
  }
}

// out = the sum of the partials of the blocks that wrote one (flags[g *
// n_cols + t] != 0, or every block when flags is null; zeros where none
// did), in a fixed order: the n_parts (<= kMaxParts) blocks are cut into
// kSegs runs of consecutive blocks, each run summed in block order by its
// own thread, and the runs' sums added in run order. One output. A thread
// takes 4 adjacent accumulators (16 bytes), a block kReduceSlots such
// groups of every run. grid: (ceil(tile_slots / (4 * kReduceSlots)),
// n_cols), kSegs * kReduceSlots threads; each block reads the flags once
// into shared memory.
constexpr int kMaxParts = 4096;
constexpr int kSegs = 16;
constexpr int kReduceSlots = 32;

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int> { using T = int4; };

template <typename Acc>
__global__ void __launch_bounds__(kSegs * kReduceSlots)
reduce_flagged(const Acc* __restrict__ partials, const int* __restrict__ flags,
               Acc* __restrict__ out, int n_parts, Cols cols) {
  using V = typename Vec4<Acc>::T;
  constexpr int kUnroll = 8;
  __shared__ unsigned char wrote[kMaxParts];
  __shared__ V run_sum[kSegs][kReduceSlots];
  const int t = blockIdx.y;
  const long long n_cols = cols.count();
  wait_for_prior_grid();
  for (int g = threadIdx.x; g < n_parts; g += blockDim.x) {
    wrote[g] = flags == nullptr || __ldg(flags + g * n_cols + t) != 0;
  }
  __syncthreads();
  const int slots = tile_slots(cols.win);       // a multiple of 4
  const int sl = threadIdx.x % kReduceSlots;
  const int q = threadIdx.x / kReduceSlots;
  const int p = (blockIdx.x * kReduceSlots + sl) * 4;
  const int per_run = (n_parts + kSegs - 1) / kSegs;
  V s;
  s.x = s.y = s.z = s.w = Acc(0);
  if (p < slots) {
    // kUnroll partials' loads in flight at once, added in block order
    const int g1 = min(n_parts, (q + 1) * per_run);
    for (int g = q * per_run; g < g1; g += kUnroll) {
      V a[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (g + k < g1 && wrote[g + k]) {
          a[k] = *reinterpret_cast<const V*>(
              partials + (static_cast<long long>(g + k) * n_cols + t) *
                             slots + p);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        if (g + k < g1 && wrote[g + k]) {
          s.x += a[k].x;
          s.y += a[k].y;
          s.z += a[k].z;
          s.w += a[k].w;
        }
      }
    }
  }
  run_sum[q][sl] = s;
  __syncthreads();
  if (q != 0 || p >= slots) return;
  V total = run_sum[0][sl];
#pragma unroll
  for (int r = 1; r < kSegs; ++r) {
    const V a = run_sum[r][sl];
    total.x += a.x;
    total.y += a.y;
    total.z += a.z;
    total.w += a.w;
  }
  const Acc v[4] = {total.x, total.y, total.z, total.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long o = out_index(p + e, cols, t);
    if (o >= 0) out[o] = v[e];
  }
}

}  // namespace lgbm
