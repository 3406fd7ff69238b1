// Block body of the redesigned K2 (hist_level.cu) and B2
// (hist_featmajor.cu) for Hopper (sm_90a): rows added a group at a time.
//
// K1's body (hist_common.cuh, unchanged) gives a block one warp, lane l
// owning feature f0 + l of a private [3][num_bin][32] shared histogram
// (98,304 B at num_bin = 256: two blocks, two warps, per SM), and adds a
// lane's rows one after another: load the row's three slots, add, store,
// then the next row. Each row waits for the one before it (shared-memory
// latency plus the add), and with two warps per SM nothing else hides
// that wait. (Giving a block more warps, each owning a share of the bins,
// does not help: a warp's lanes are features, so every warp still issues
// every row's loads and stores, with fewer lanes active.)
//
// The rows themselves are staged: a batch's bytes are copied into shared
// memory with cp.async, 16 bytes a lane, kStages batches ahead of the one
// being added, so many loads are in flight per warp; K1's body loads one
// batch ahead, a byte per lane and row, and that latency bounds it as
// much as the adds do.
//
// Here a lane takes its rows in groups of kGroup: it loads the slots of
// all the group's rows at once, then adds each row's values to the
// latest sum of its slot, forwarding the sum of an earlier row of the
// group that hit the same slot, and stores the rows' sums in row order,
// so the last store of a slot holds every add. Each slot's sum is formed
// exactly as the one-row-at-a-time loop forms it, in row order, so the
// results are the same bits, and the wait is paid once per group instead
// of once per row. The histogram is [num_bin][32][3] (a slot's three
// accumulators adjacent, one address for all three; lane l's slots fall
// in bank 3l + c mod 32, distinct across a warp). The single owner of
// every slot (its lane) and the fixed order of the partials' reduction
// are K1's: two launches give the same bits. (Groups of 8 rows were
// tried first: the forwarding network's compares and selects, which grow
// with the square of the group, cost more than the waits they hid.)
#pragma once

#include "hist_common.cuh"

namespace lgbm {

constexpr int kGroup = 4;   // rows whose slots a lane loads at once

// Bytes of the block's [num_bin][32][3] histogram (4-byte accumulators),
// where the staging ring starts in shared memory.
__host__ __device__ inline int hist_bytes(int num_bin) {
  return tile_slots(num_bin) * 4;
}

// Zero the block's histogram, 16 bytes a lane at a time.
__device__ __forceinline__ void zero_hist_vec(void* hist, int num_bin) {
  uint4* h = static_cast<uint4*>(hist);
  const int n = hist_bytes(num_bin) / 16;
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

// The block's histogram, verbatim, into its slice of a partials buffer
// (16-byte aligned: every slice is 384 * num_bin bytes), 16 bytes a lane
// at a time.
__device__ __forceinline__ void write_partial_vec(const void* hist,
                                                  void* part, int num_bin) {
  const uint4* h = static_cast<const uint4*>(hist);
  uint4* o = static_cast<uint4*>(part);
  const int n = hist_bytes(num_bin) / 16;
  for (int i = threadIdx.x; i < n; i += kLanes) o[i] = h[i];
}

// The histogram's layout: [bin][lane][channel], so that a slot's three
// accumulators are adjacent (one address for all three) and lane l of a
// warp still meets a bank of its own (3l mod 32 differs for every l).
__device__ __forceinline__ int slot_at(int b, int lane) {
  return (b * kLanes + lane) * kChannels;
}

// Add rows j0 .. j0 + kGroup - 1 of a batch to lane `lane`'s slots: bin(j)
// is the lane's bin of row j (num_bin or more: nothing to add) and gh(j,
// c) channel c of row j's (grad, hess, count).
template <typename Acc, typename BinOf, typename GhOf>
__device__ __forceinline__ void add_group(Acc* hist, int lane, int num_bin,
                                          int j0, BinOf bin, GhOf gh) {
  int b[kGroup];
  Acc x0[kGroup], x1[kGroup], x2[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    b[k] = bin(j0 + k);
    x0[k] = x1[k] = x2[k] = Acc(0);
    if (b[k] < num_bin) {
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
    if (b[k] < num_bin) {
      Acc* h = hist + slot_at(b[k], lane);
      h[0] = y0[k];
      h[1] = y1[k];
      h[2] = y2[k];
    }
  }
}

// The block's histogram straight into out[f0 .. f0 + ft) of an
// [F, num_bin, 3] output: lane l writes feature f0 + l.
template <typename Acc>
__device__ void write_out_slots(const Acc* hist, Acc* out, int f0, int ft,
                                int num_bin) {
  const int lane = threadIdx.x;
  if (lane >= ft) return;
  Acc* o = out + static_cast<long long>(f0 + lane) * num_bin * kChannels;
  for (int b = 0; b < num_bin; ++b) {
    const Acc* h = hist + slot_at(b, lane);
    o[b * kChannels + 0] = h[0];
    o[b * kChannels + 1] = h[1];
    o[b * kChannels + 2] = h[2];
  }
}

// Where accumulator p of a block's histogram goes in an [F, num_bin, 3]
// output (-1: an unused lane's), for a feature tile of width ft at f0.
__device__ __forceinline__ long long out_index(int p, int f0, int ft, int F,
                                               int num_bin) {
  const int b = p / (kLanes * kChannels);
  const int rem = p - b * (kLanes * kChannels);
  const int fl = rem / kChannels;
  const int c = rem - fl * kChannels;
  const int f = f0 + fl;
  if (fl >= ft || f >= F) return -1;
  return (static_cast<long long>(f) * num_bin + b) * kChannels + c;
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

constexpr int kStages = 4;   // batches staged ahead in shared memory

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

// out[node] = the sum, in block order, of its blocks' partials, for the
// nodes with more than one block (a node with one block was written by
// it, a node with none gets zeros). Node v owns blocks [first[v],
// first[v + 1]); the partials of block g, feature tile t, are at
// partials[(g * n_ftiles + t) * tile_slots]. grid: (ceil(tile_slots /
// blockDim.x), n_ftiles, any z); block z takes nodes z, z + gridDim.z, ...
template <typename Acc>
__global__ void reduce_nodes(const Acc* __restrict__ partials,
                             Acc* __restrict__ out,
                             const long long* __restrict__ first,
                             int n_nodes, int F, int ft, int n_ftiles,
                             int num_bin) {
  const int slots = tile_slots(num_bin);
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= slots) return;
  const int t = blockIdx.y;
  const long long o = out_index(p, t * ft, ft, F, num_bin);
  if (o < 0) return;
  for (int v = blockIdx.z; v < n_nodes; v += gridDim.z) {
    const long long g0 = first[v], g1 = first[v + 1];
    if (g1 - g0 == 1) continue;
    Acc s = Acc(0);
    for (long long g = g0; g < g1; ++g) {
      s += partials[(g * n_ftiles + t) * slots + p];
    }
    out[static_cast<long long>(v) * F * num_bin * kChannels + o] = s;
  }
}

// out = the sum of the partials of the blocks that wrote one (flags[g *
// n_ftiles + t] != 0; zeros where none did), in a fixed order: the
// n_parts (<= kMaxParts) blocks are cut into kSegs runs of consecutive
// blocks, each run summed in block order by its own thread, and the
// runs' sums added in run order. One output. A thread takes 4 adjacent
// accumulators (16 bytes), a block kReduceSlots such groups of every run.
// grid: (ceil(tile_slots / (4 * kReduceSlots)), n_ftiles), kSegs *
// kReduceSlots threads; each block reads the flags once into shared
// memory.
constexpr int kMaxParts = 4096;
constexpr int kSegs = 16;
constexpr int kReduceSlots = 32;

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int> { using T = int4; };

template <typename Acc>
__global__ void __launch_bounds__(kSegs * kReduceSlots)
reduce_flagged(const Acc* __restrict__ partials, const int* __restrict__ flags,
               Acc* __restrict__ out, int n_parts, int F, int ft,
               int n_ftiles, int num_bin) {
  using V = typename Vec4<Acc>::T;
  constexpr int kUnroll = 8;
  __shared__ unsigned char wrote[kMaxParts];
  __shared__ V run_sum[kSegs][kReduceSlots];
  const int t = blockIdx.y;
  wait_for_prior_grid();
  for (int g = threadIdx.x; g < n_parts; g += blockDim.x) {
    wrote[g] = __ldg(flags + g * n_ftiles + t) != 0;
  }
  __syncthreads();
  const int slots = tile_slots(num_bin);       // a multiple of 4
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
              partials + (static_cast<long long>(g + k) * n_ftiles + t) *
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
    const long long o = out_index(p + e, t * ft, ft, F, num_bin);
    if (o >= 0) out[o] = v[e];
  }
}

}  // namespace lgbm
