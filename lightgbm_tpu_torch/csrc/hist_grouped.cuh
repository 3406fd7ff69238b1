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
// Bins are uint8 here: at 384 bytes a bin, a block's histogram of 256
// bins takes 98,304 bytes (two blocks per SM), and 1,023 bins would not
// fit the 227 KB a block can opt in to. A launch's histogram columns are
// feature tiles (Cols keeps a bin window [b0, b0 + win) per column, and
// every u8 launch makes it all num_bin bins). K1, K2 and B2 take this
// body for u8 bins only.
//
// Blocks that share an output write their histograms to a partials
// buffer in the shared-memory layout (16 bytes a lane) and a reduction
// (reduce_flagged, reduce_nodes) sums them in a fixed block order. A
// block that is the only one of its output writes it directly. Two
// launches on the same input give the same bits.
//
// gh types: f32; bf16 (raw bits, widened on load: the bf16 value is exact
// in f32); int8 (summed exactly in int32).
//
// Skewed bins (most of a block's rows in a few bins of a feature) make a
// slot's chain of f32 adds as long as the block's rows; the block then
// sums those bins' rows in f64 registers (LaneHot, below), and the
// reductions sum the blocks' partials in f64.
//
// u16 bins take a second body, the wide body (below; K1's and K2's
// add_rows_wide, B2's feature-major stages in hist_featmajor.cu): a warp
// per feature and a lane per row, so that a block's histogram takes 12
// bytes a bin and feature instead of 384 bytes a bin.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---- Hot bins of the grouped body ------------------------------------------
//
// Where most of a block's rows share a few bins of a feature (a feature of
// three values, or one value in four rows of five), a slot's chain of f32
// adds grows as long as the block's rows, and where the sum nearly
// cancels its rounding error passes the plain version's tolerance (a
// partial sum of a million values of magnitude ~1 is ~1,000, where one
// f32 ulp is 6e-5). So a block first tests its first batch as soon as
// it lands, before its loop (K1's and K2's first kSkewScan rows): a lane
// whose feature puts a quarter of them (and at least kSkewRows) in the
// bin of one of its first three rows is skewed. With no skewed lane the
// block adds its rows in the usual loop, unchanged. Otherwise each lane
// counts its bins of that batch (Misra-Gries counters, kLaneHot of them:
// every bin holding more than a quarter of the rows is among them, and a
// feature of at most kLaneHot values keeps all of them), makes hot those
// counted in at least a quarter of the rows, and the block adds its rows
// with each lane's hot bins' rows summed in f64 registers, in row order
// (each batch's gh widened to f64 once, a row a lane, into shared
// memory), the other rows into its f32 slots as before; at the end each
// hot sum is added to its slot, rounded once. int8 gh sum exactly in
// int32 and take none of this.
constexpr int kLaneHot = 3;
constexpr int kSkewScan = 16;          // K1's and K2's rows tested
constexpr int kSkewRows = 5;
constexpr int kNoBin = -0x7fffffff;     // equals no bin, in or out of window
constexpr int kHotGhStride = 4;         // doubles a row of widened gh takes
// shared bytes of a batch's gh widened to f64
constexpr int kHotBytes = kBatch * kHotGhStride * 8;

// whether gh of type G take hot sums (not int8: its int32 sums are exact)
template <typename G>
constexpr bool kHotSums = !std::is_same<typename Gh<G>::Acc, int>::value;

// How a step of a block's batch loop adds its batch: as usual, with the
// hot bins' rows in f64, or (a skewed block's first batch) after picking
// the hot bins from it, in either way.
enum AddMode { kAddPlain, kAddHot, kAddPick };
template <int M> using AddAs = std::integral_constant<int, M>;

// Whether the lane's feature is skewed in the first N rows of a batch:
// bin(j) is row j's window-local bin (outside [0, lim): not the lane's,
// or not a row), `rows` of them are rows of the block, and c0..c2 (the
// bins of the first three such rows) are the candidates. Every bin is
// read before any is compared, so that the reads are in flight together.
template <int N, typename BinOf>
__device__ __forceinline__ bool skewed_batch(BinOf bin, int lim, int rows,
                                             int c0, int c1, int c2) {
  int v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = bin(j);
  c0 = in_window(c0, lim) ? c0 : kNoBin;
  c1 = in_window(c1, lim) ? c1 : kNoBin;
  c2 = in_window(c2, lim) ? c2 : kNoBin;
  int n0 = 0, n1 = 0, n2 = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    n0 += v[j] == c0 ? 1 : 0;
    n1 += v[j] == c1 ? 1 : 0;
    n2 += v[j] == c2 ? 1 : 0;
  }
  const int n = max(n0, max(n1, n2));
  return n >= kSkewRows && 4 * n >= rows;
}

// s += g where b == key, for each of three sums: predicated adds, so that
// lanes whose rows fall in different bins do not diverge
__device__ __forceinline__ void add_where(double& s0, double& s1, double& s2,
                                          int b, int key, double g0,
                                          double g1, double g2) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.s32 p, %3, %4;\n\t"
      "@p add.f64 %0, %0, %5;\n\t"
      "@p add.f64 %1, %1, %6;\n\t"
      "@p add.f64 %2, %2, %7;\n\t}"
      : "+d"(s0), "+d"(s1), "+d"(s2)
      : "r"(b), "r"(key), "d"(g0), "d"(g1), "d"(g2));
}

struct LaneHot {
  int key[kLaneHot];                 // window-local bins, kNoBin: none
  int cnt[kLaneHot];                 // Misra-Gries counters while counting
  double sum[kLaneHot][kChannels];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int k = 0; k < kLaneHot; ++k) {
      key[k] = kNoBin;
      cnt[k] = 0;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) sum[k][c] = 0.0;
    }
  }

  // Counts the lane's bins of a batch (bin and lim as in skewed_batch),
  // every bin read first and the counters updated without branches.
  template <typename BinOf>
  __device__ __forceinline__ void count(BinOf bin, int lim) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v[j] = bin(j);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int b = v[j];
      bool left = in_window(b, lim);   // not yet placed
#pragma unroll
      for (int k = 0; k < kLaneHot; ++k) {
        const bool hit = left && cnt[k] > 0 && key[k] == b;
        cnt[k] += hit ? 1 : 0;
        left &= !hit;
      }
#pragma unroll
      for (int k = 0; k < kLaneHot; ++k) {
        const bool take = left && cnt[k] == 0;
        key[k] = take ? b : key[k];
        cnt[k] += take ? 1 : 0;
        left &= !take;
      }
#pragma unroll
      for (int k = 0; k < kLaneHot; ++k) cnt[k] -= left ? 1 : 0;
    }
  }

  // Keeps the bins counted in at least a quarter of the batch's `seen`
  // rows; returns whether the lane has one.
  __device__ __forceinline__ bool choose(int seen) {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kLaneHot; ++k) {
      if (cnt[k] <= 0 || 4 * cnt[k] < seen) key[k] = kNoBin;
      any |= key[k] != kNoBin;
    }
    return any;
  }

  __device__ __forceinline__ bool is_hot(int b) const {
    bool hot = false;
#pragma unroll
    for (int k = 0; k < kLaneHot; ++k) hot |= b == key[k];
    return hot;
  }

  // a row of bin b, g its widened gh: added to b's sums if b is hot
  __device__ __forceinline__ void add(int b, const double* g) {
    const double2 g01 = *reinterpret_cast<const double2*>(g);
    const double g2 = g[2];
#pragma unroll
    for (int k = 0; k < kLaneHot; ++k) {
      add_where(sum[k][0], sum[k][1], sum[k][2], b, key[k], g01.x, g01.y,
                g2);
    }
  }

  // each hot sum added to its slot of lane `lane`, rounded once
  template <typename Acc>
  __device__ __forceinline__ void finish(Acc* hist, int lane) const {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kLaneHot; ++k) {
      if (key[k] == kNoBin) continue;
      Acc* h = hist + slot_at(key[k], lane);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        h[c] = Acc(static_cast<double>(h[c]) + sum[k][c]);
      }
    }
    __syncwarp();
  }
};

// Row `lane` of a batch (gh(j, c)) widened into gd[lane * kHotGhStride
// + c]; the caller syncs the warp after it. (A row that is not the
// block's, or not the leaf's, has no bin, so it is never hot and its
// widened gh, whatever the staged bytes hold, is never added.)
template <typename GhOf>
__device__ __forceinline__ void widen_gh(double* gd, int lane, GhOf gh) {
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    gd[lane * kHotGhStride + c] = static_cast<double>(gh(lane, c));
  }
}

// add_group with the lane's hot bins' rows taken into hot's f64 sums
// (gd: the batch's gh widened) and the other rows into its slots.
template <typename Acc, typename BinOf, typename GhOf>
__device__ __forceinline__ void add_group_hot(Acc* hist, LaneHot& hot,
                                              const double* gd, int lane,
                                              int lim, int j0, BinOf bin,
                                              GhOf gh) {
  int b[kGroup];
#pragma unroll
  for (int k = 0; k < kGroup; ++k) b[k] = bin(j0 + k);
  add_group(hist, lane, lim, j0,
            [&](int j) {
              const int v = b[j - j0];
              return hot.is_hot(v) ? -1 : v;
            },
            gh);
#pragma unroll
  for (int k = 0; k < kGroup; ++k) {
    hot.add(b[k], gd + (j0 + k) * kHotGhStride);
  }
}

// A batch's groups added in mode M (AddMode), `seen` of its rows the
// block's; gd (kHotBytes of shared memory) takes the batch's gh widened
// for the hot sums. `live(j0)`: whether group j0 has a row. Returns
// whether the hot sums are in use.
template <int M, typename Acc, typename BinOf, typename GhOf, typename Live>
__device__ __forceinline__ bool add_batch(Acc* hist, LaneHot& hot,
                                          double* gd, int lane, int lim,
                                          int seen, BinOf bin, GhOf gh,
                                          Live live) {
  bool hot_sums = M == kAddHot;
  if constexpr (M == kAddPick) {
    hot.count(bin, lim);
    hot_sums = __any_sync(kFull, hot.choose(seen));
  }
  if (M != kAddPlain && hot_sums) {
    widen_gh(gd, lane, gh);
    __syncwarp();
#pragma unroll
    for (int j0 = 0; j0 < kBatch; j0 += kGroup) {
      if (live(j0)) add_group_hot(hist, hot, gd, lane, lim, j0, bin, gh);
    }
  } else {
#pragma unroll
    for (int j0 = 0; j0 < kBatch; j0 += kGroup) {
      if (live(j0)) add_group(hist, lane, lim, j0, bin, gh);
    }
  }
  return hot_sums;
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
// The same for N (4 or 8) bytes, both addresses N-aligned.
template <int N>
__device__ __forceinline__ void cp_async_small(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(N)
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
template <typename G>                    // the gh of `rows` rows
__host__ __device__ inline int gh_slot_bytes(int rows) {
  return (rows * kChannels * static_cast<int>(sizeof(G)) + 32 + 15) / 16 *
         16;
}
template <typename BinT>
__host__ __device__ inline int rm_bins_slot_bytes(int F) {
  return (kBatch * F * static_cast<int>(sizeof(BinT)) + 32 + 15) / 16 * 16;
}
template <typename G>
__host__ __device__ inline int rm_gh_slot_bytes() {
  return gh_slot_bytes<G>(kBatch);
}
template <typename G, typename BinT>
__host__ __device__ inline int rm_ring_bytes(int F) {
  return kStages * (rm_bins_slot_bytes<BinT>(F) + rm_gh_slot_bytes<G>());
}
// The ring and the widened gh of the hot sums, after a block's histogram.
template <typename G, typename BinT>
__host__ __device__ inline int rm_fixed_bytes(int F) {
  return rm_ring_bytes<G, BinT>(F) + kHotBytes;
}

// Add rows p0 .. p1 - 1 of row-major bins [*, F] and gh [*, 3] to column
// t's histogram `hist`, staged through `ring` (rm_ring_bytes of shared
// memory, then kHotBytes for the hot sums). Both buffers must be
// 16-byte aligned and readable up to the next multiple of 16 bytes past
// their last row (every allocation of torch's caching allocator is).
// Lane l reads feature f0 + l of each staged row, every lane the row's
// gh.
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
  double* gd = reinterpret_cast<double*>(ring + kStages * slot);
  LaneHot hot;

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
  // whether a lane finds the block's first batch skewed (its first
  // kSkewScan rows, read from the ring as soon as they land)
  bool skewed = false;
  if constexpr (kHotSums<G>) {
    if (n_batches > 0) {
      cp_async_wait<kStages - 2>();
      __syncwarp();
      const int r0 = static_cast<int>(min(
          static_cast<long long>(kSkewScan), p1 - p0));
      const BinT* sb0 = reinterpret_cast<const BinT*>(
                            ring + (p0 * row_b - p0 * row_b / 16 * 16)) +
                        f0 + lf;
      auto first = [&](int j) {
        return j < r0 ? static_cast<int>(sb0[j * F]) - b0 : skip;
      };
      skewed = __any_sync(kFull, skewed_batch<kSkewScan>(
                                     first, lim, r0, first(0), first(1),
                                     first(2)));
    }
  }
  // batch i added in mode M; returns whether the hot sums are in use
  auto step = [&](long long i, auto mode) {
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
    const bool hot_sums = add_batch<decltype(mode)::value>(
        hist, hot, gd, lane, lim, rows,
        [&](int j) {
          return j < rows ? static_cast<int>(sb[j * F]) - b0 : skip;
        },
        [&](int j, int c) {
          return GhShared<G>::load(sg + j * kChannels + c);
        },
        [](int) { return true; });
    __syncwarp();
    return hot_sums;
  };
  long long i = 0;
  if constexpr (kHotSums<G>) {
    if (skewed) {
      hot.clear();
      if (step(i++, AddAs<kAddPick>())) {
        while (i < n_batches) step(i++, AddAs<kAddHot>());
        hot.finish(hist, lane);
      }
    }
  }
  while (i < n_batches) step(i++, AddAs<kAddPlain>());
}

// ---- The wide body: u16 bins ---------------------------------------------
//
// At 384 bytes a bin, the body above holds at most about 512 bins a block:
// wider histograms are cut into windows that each re-read every row, and
// a 512-bin window leaves one one-warp block per SM to issue the adds. The
// wide body turns the block around: lanes are rows, and a warp owns one
// feature's bins, or a run of them. A block is ft features times wpf
// warps a feature (at most kWideMaxWarps warps); warp (f, s) owns bins
// [s * sub, (s + 1) * sub) of the window of feature f0 + f, sub = win /
// wpf, in a private [sub][3] histogram: 12 bytes a bin and feature (and a
// byte of tag), so a feature's 1,023 bins take 13 KB and its 4,095 bins
// 52 KB. Windows are needed only where one feature's bins do not fit
// beside the staging ring (past about 17,000 bins).
//
// The block stages stage_rows rows at a time, the next stage's copies in
// flight while the warps add this one (add_stages_wide: kWideStages slots,
// cp.async, one __syncthreads a stage: fewer, larger stages measured
// faster, since each barrier waits for the slowest warp). How a stage is
// staged is the kernel's: K1 and K2 (add_rows_wide) copy of each
// row-major row only the tile's bins, in 16-, 8- or 4-byte copies where
// the row and the tile allow (tile_unit; else the 16-byte chunks that hold
// them), so that a tile of four u16 features of 28 moves 8 bytes a row and
// not 56, and the rows' gh, contiguous; B2 copies each feature's run of
// feature-major bins and lists the stage's rows of its leaf
// (hist_featmajor.cu). Each warp then adds the staged rows 32 at a time,
// lane j taking row j, and adds row j only if its bin of the warp's
// feature is one of the warp's:
// - a row of a hot bin (below) goes to the lane's registers;
// - the other rows find the rows of the 32 that share their bin: each
//   writes its lane number into its bin's byte tag and reads it back, and
//   a lane that reads another's shares its bin. (__match_any_sync finds
//   the same groups; on the H100 it cost about half of the body's time,
//   and a ballot a bit of the bin a third.) With no such lane, most
//   batches of uniform bins, every lane adds its row to its slot;
// - else the shared bins are peeled off one at a time: a ballot finds the
//   lanes of a bin; a group of at most kLeaderMax rows is summed by its
//   lowest lane, in row order, into the slot (the leader loop);
// - a larger group (skewed bins: most rows of a feature in one bin, or a
//   feature of three values), taken in the order of its lowest lane,
//   makes its bin one of the warp's kHot hot bins while one is free: from
//   then on each lane adds its own rows of that bin into registers, in
//   row order and in f64 (int32 for int8 gh), and after the block's last
//   row the warp sums the lanes' sums by a butterfly (five shuffle steps,
//   the same bits in every lane) into the slot once. With no hot bin
//   free, a large group is summed by that butterfly at once, the other
//   lanes' values masked to zero.
// Which lane wins a tag does not matter: the groups, the order of their
// sums and the hot bins do not depend on it. Each slot has one owner (its
// warp), and within the warp one lane adds to it at a time, batch after
// batch: no atomics, and the sums do not depend on scheduling. Rows are
// read once per feature tile, not once per window of bins. The f64 hot
// sums keep a bin of a million rows within the plain version's tolerance,
// where a chain of f32 adds that long drifts past it.
// stages of rows in shared memory (ops/hist_cuda.WIDE_STAGES plans with
// the same count)
constexpr int kWideStages = 2;
constexpr int kWideMaxWarps = 16;   // warps a block at most
constexpr int kLeaderMax = 4;       // the largest group the leader loop adds
constexpr int kHot = 4;             // bins a warp sums in registers

// The histogram columns of a wide launch: F features in n_ftiles tiles of
// ft, each tile's num_bin bins in n_win windows of win (a multiple of 4 *
// wpf), each feature's window split between wpf warps, stage_rows rows
// staged at a time (a multiple of 32). Column t is tile t / n_win, window
// t % n_win.
struct WideCols {
  int F, ft, n_ftiles, num_bin, win, n_win, wpf, stage_rows;
  __host__ __device__ int count() const { return n_ftiles * n_win; }
  __host__ __device__ int f0(int t) const { return (t / n_win) * ft; }
  __host__ __device__ int b0(int t) const { return (t % n_win) * win; }
  __host__ __device__ int width(int t) const {
    const int f = f0(t);
    return ft < F - f ? ft : F - f;
  }
  __host__ __device__ int bins(int t) const {
    const int b = b0(t);
    return win < num_bin - b ? win : num_bin - b;
  }
  __host__ __device__ int sub() const { return win / wpf; }
  __host__ __device__ int warps() const { return ft * wpf; }
};

// Tiles of ft features, windows of win bins and wpf warps a feature over
// F features and num_bin bins.
inline WideCols make_wide_cols(int F, int num_bin, int ft, int win, int wpf,
                               int stage_rows) {
  WideCols c;
  c.F = F;
  c.ft = ft;
  c.n_ftiles = (F + ft - 1) / ft;
  c.num_bin = num_bin;
  c.win = win;
  c.n_win = (num_bin + win - 1) / win;
  c.wpf = wpf;
  c.stage_rows = stage_rows;
  return c;
}

// Whether a wide geometry is one the kernels take.
inline bool valid_wide(int F, int num_bin, int ft, int win, int wpf,
                       int stage_rows) {
  return F >= 1 && ft >= 1 && wpf >= 1 && ft * wpf <= kWideMaxWarps &&
         win >= 4 && win % (4 * wpf) == 0 && num_bin >= 1 &&
         stage_rows >= kLanes && stage_rows <= 1024 &&
         stage_rows % kLanes == 0;
}

// Accumulators of a block's histograms: ft features x [win][3].
__host__ __device__ inline int col_slots(const Cols& c) {
  return tile_slots(c.win);
}
__host__ __device__ inline int col_slots(const WideCols& c) {
  return kChannels * c.ft * c.win;
}

// How a row's tile of ft bins (of F) is staged: in copies of g bytes (16,
// 8 or 4: the largest that divides both the row's and the tile's bytes,
// so every tile of every row starts g-aligned), or, where no such g
// exists (0), as the 16-byte chunks that hold it, up to tile_row_chunks
// of them. (A tile of four u16 bins of 28 moves 8 bytes a row, not the
// 32 of its chunks or the 56 of the row.)
template <typename BinT>
__host__ __device__ inline int tile_unit(int F, int ft) {
  const int rb = F * static_cast<int>(sizeof(BinT));
  const int tb = ft * static_cast<int>(sizeof(BinT));
  for (int g = 16; g >= 4; g /= 2) {
    if (rb % g == 0 && tb % g == 0) return g;
  }
  return 0;
}
template <typename BinT>
__host__ __device__ inline int tile_row_chunks(int ft) {
  return (ft * static_cast<int>(sizeof(BinT)) + 30) / 16;
}
// Bytes a staged row takes in the ring.
template <typename BinT>
__host__ __device__ inline int tile_row_bytes(int F, int ft) {
  const int g = tile_unit<BinT>(F, ft);
  return g > 0 ? ft * static_cast<int>(sizeof(BinT))
               : tile_row_chunks<BinT>(ft) * 16;
}

// The shared memory of a wide block: its histograms, its bin tags, then
// the ring of kWideStages stages, each stage_rows rows' tiles (16-byte
// aligned in all) and their gh.
template <typename G, typename BinT>
__host__ __device__ inline int wide_stage_bytes(const WideCols& c) {
  return (c.stage_rows * tile_row_bytes<BinT>(c.F, c.ft) + 15) / 16 * 16 +
         gh_slot_bytes<G>(c.stage_rows);
}
// Bytes of a wide block's bin tags (a byte a bin and feature), a multiple
// of 16.
__host__ __device__ inline int wide_tag_bytes(const WideCols& c) {
  return (c.ft * c.win + 15) / 16 * 16;
}
template <typename G, typename BinT>
__host__ __device__ inline int wide_shared_bytes(const WideCols& c) {
  return col_slots(c) * 4 + wide_tag_bytes(c) +
         kWideStages * wide_stage_bytes<G, BinT>(c);
}

// Where accumulator p of column t's wide histograms goes in an [F,
// num_bin, 3] output (-1: an unused feature's, or a bin past num_bin).
__device__ __forceinline__ long long out_index(int p, const WideCols& cols,
                                               int t) {
  const int per = cols.win * kChannels;
  const int fl = p / per;
  const int rem = p - fl * per;
  const int b = rem / kChannels;
  const int c = rem - b * kChannels;
  const int f = cols.f0(t) + fl;
  if (fl >= cols.width(t) || b >= cols.bins(t)) return -1;
  return (static_cast<long long>(f) * cols.num_bin + cols.b0(t) + b) *
             kChannels + c;
}

// Column t's histograms straight into an [F, num_bin, 3] output: warp
// (f, s) writes its run of feature f0 + f's bins, contiguous in both.
template <typename Acc>
__device__ void write_out_wide(const Acc* hist, Acc* out,
                               const WideCols& cols, int t) {
  const int warp = threadIdx.x / kLanes;
  const int fl = warp / cols.wpf;
  const int s0 = (warp - fl * cols.wpf) * cols.sub();
  if (fl >= cols.width(t) || s0 >= cols.bins(t)) return;
  const Acc* h = hist + (fl * cols.win + s0) * kChannels;
  Acc* o = out + (static_cast<long long>(cols.f0(t) + fl) * cols.num_bin +
                  cols.b0(t) + s0) * kChannels;
  const int n = min(cols.sub(), cols.bins(t) - s0) * kChannels;
  for (int p = threadIdx.x % kLanes; p < n; p += kLanes) o[p] = h[p];
}

// n 4-byte words (a multiple of 4) from shared memory into a partials
// slice (16-byte aligned) with the whole block, 16 bytes a thread.
__device__ __forceinline__ void write_partial_block(const void* hist,
                                                    void* part, int n) {
  const uint4* h = static_cast<const uint4*>(hist);
  uint4* o = static_cast<uint4*>(part);
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x) o[i] = h[i];
}

// The sum over the warp's lanes of v, the same bits in every lane: a
// butterfly, five shuffle steps in a fixed order.
template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
#pragma unroll
  for (int m = kLanes / 2; m >= 1; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// What a lane sums a hot bin's rows in: f64 for f32 sums (a hot bin
// takes hundreds of thousands of rows, and a chain of f32 adds that long
// drifts past the plain version's tolerance), int32 for int8 gh (exact).
template <typename Acc> struct HotSum { using T = double; };
template <> struct HotSum<int> { using T = int; };

// A warp's hot bins: kHot bins (window-local; -1: free, the same in every
// lane) whose rows each lane sums into registers.
template <typename Acc>
struct HotBins {
  using T = typename HotSum<Acc>::T;
  int key[kHot];
  T sum[kHot][kChannels];
  __device__ void clear() {
#pragma unroll
    for (int k = 0; k < kHot; ++k) {
      key[k] = -1;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) sum[k][c] = T(0);
    }
  }
  // lane's row of bin b (x0, x1, x2), if b is hot: added to its sums
  // (hot bins fill in order, so the first free one ends the search)
  __device__ __forceinline__ bool add(int b, Acc x0, Acc x1, Acc x2) {
    bool hit = false;
#pragma unroll
    for (int k = 0; k < kHot; ++k) {
      if (key[k] < 0) break;
      if (b == key[k]) {
        sum[k][0] += T(x0);
        sum[k][1] += T(x1);
        sum[k][2] += T(x2);
        hit = true;
      }
    }
    return hit;
  }
  // the lanes' sums of each hot bin added to its slot of h, by lane 0
  __device__ void flush(Acc* h) {
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kHot; ++k) {
      if (key[k] < 0) continue;
      const T s0 = warp_sum(sum[k][0]), s1 = warp_sum(sum[k][1]),
              s2 = warp_sum(sum[k][2]);
      if (threadIdx.x % kLanes == 0) {
        Acc* s = h + key[k] * kChannels;
        s[0] += Acc(s0);
        s[1] += Acc(s1);
        s[2] += Acc(s2);
      }
    }
    __syncwarp();
  }
};

// Add rows j0 .. j0 + 31 of a stage (`rows` of them to add) to one warp's
// run of bins, h its [sub][3] histogram, tag its [sub] byte tags and hot
// its hot bins: lane l's row is row j0 + l, its bin (less b0, the run's
// first bin) bin(j0 + l), its three gh in shared memory at gh_at(j0 + l);
// bins outside [0, lim) are not the warp's.
template <typename G, typename BinOf, typename GhAt>
__device__ __forceinline__ void add_batch_wide(
    typename Gh<G>::Acc* h, unsigned char* tag,
    HotBins<typename Gh<G>::Acc>& hot, BinOf bin, GhAt gh_at, int b0,
    int lim, int j0, int rows) {
  using Acc = typename Gh<G>::Acc;
  const int lane = threadIdx.x % kLanes;
  const int j = j0 + lane;
  const int b = j < rows ? bin(j) - b0 : -1;
  const bool adds = in_window(b, lim);
  Acc x0 = Acc(0), x1 = Acc(0), x2 = Acc(0);
  if (adds) {
    const G* g = gh_at(j);
    x0 = GhShared<G>::load(g);
    x1 = GhShared<G>::load(g + 1);
    x2 = GhShared<G>::load(g + 2);
  }
  // not yet added
  bool rest = adds && !hot.add(b, x0, x1, x2);
  if (rest) tag[b] = static_cast<unsigned char>(lane);
  __syncwarp();
  // the bins of this batch that more than one row shares: small groups
  // summed by their lowest lane at once, large ones (bigs) after
  unsigned bigs = 0u;
  for (unsigned clash = __ballot_sync(kFull, rest && tag[b] != lane);
       clash != 0u;) {
    const int key = __shfl_sync(kFull, b, __ffs(clash) - 1);
    const unsigned group = __ballot_sync(kFull, rest && b == key);
    if (__popc(group) > kLeaderMax) {
      bigs |= group;
    } else if (lane == __ffs(group) - 1) {
      for (unsigned m = group & (group - 1u); m != 0u; m &= m - 1u) {
        const G* g = gh_at(j0 + __ffs(m) - 1);
        x0 += GhShared<G>::load(g);
        x1 += GhShared<G>::load(g + 1);
        x2 += GhShared<G>::load(g + 2);
      }
      Acc* s = h + b * kChannels;
      s[0] += x0;
      s[1] += x1;
      s[2] += x2;
    }
    if ((group >> lane) & 1u) rest = false;
    clash &= ~group;
  }
  // large groups in the order of their lowest lane: a free hot bin, else
  // a butterfly into the slot
  while (bigs != 0u) {
    const int src = __ffs(bigs) - 1;
    const int key = __shfl_sync(kFull, b, src);
    const bool in = (bigs >> lane) & 1u && b == key;
    const unsigned group = __ballot_sync(kFull, in);
    int k = 0;
    while (k < kHot && hot.key[k] >= 0) ++k;
    if (k < kHot) {
#pragma unroll
      for (int q = 0; q < kHot; ++q) {
        if (q == k) hot.key[q] = key;
      }
      if (in) hot.add(b, x0, x1, x2);
    } else {
      const Acc v0 = warp_sum(in ? x0 : Acc(0)),
                v1 = warp_sum(in ? x1 : Acc(0)),
                v2 = warp_sum(in ? x2 : Acc(0));
      if (lane == src) {
        Acc* s = h + b * kChannels;
        s[0] += v0;
        s[1] += v1;
        s[2] += v2;
      }
    }
    bigs &= ~group;
  }
  if (rest) {
    Acc* s = h + b * kChannels;
    s[0] += x0;
    s[1] += x1;
    s[2] += x2;
  }
  // (the next batch's first __syncwarp orders these adds before its
  // loads of the same slots; its tag writes come after every lane's
  // ballot of this batch's tags)
}

// The stage loop of the wide body, shared by every wide kernel: stages 0
// .. n_stages - 1 of rows are copied into a ring of kWideStages slots of
// slot_bytes, the next stage's copies in flight while the warps add this
// one, and added to column t's histograms `hist` (zeroed by the block
// before the call) with the block's bin tags `tags`; every thread of the
// block (32 * cols.warps()) calls it. What differs between kernels is how
// a stage is staged and read:
// - stage(i, slot): every thread's share of stage i's copies into `slot`
//   (cp.async; committed here; plain shared stores are visible too, from
//   the barrier before the stage is added);
// - add_stage(i, slot, fl, add), for each warp that owns bins: calls
//   add(rows, bin, gh_at) once or more with the stage's rows to add, bin(j)
//   row j's bin of the tile's feature fl and gh_at(j) its gh in `slot`.
template <typename G, typename Stage, typename AddStage>
__device__ void add_stages_wide(typename Gh<G>::Acc* hist,
                                unsigned char* tags, unsigned char* ring,
                                int slot_bytes, const WideCols& cols, int t,
                                long long n_stages, Stage stage,
                                AddStage add_stage) {
  using Acc = typename Gh<G>::Acc;
  const int warp = threadIdx.x / kLanes;
  const int fl = warp / cols.wpf;
  const int s0 = (warp - fl * cols.wpf) * cols.sub();
  const bool active = fl < cols.width(t) && s0 < cols.bins(t);
  const int lim = min(cols.sub(), cols.bins(t) - s0);
  const int b0 = cols.b0(t) + s0;
  Acc* h = hist + (fl * cols.win + s0) * kChannels;
  unsigned char* tag = tags + fl * cols.win + s0;
  HotBins<Acc> hot;
  hot.clear();
  auto add = [&](int rows, auto bin, auto gh_at) {
    for (int j0 = 0; j0 < rows; j0 += kLanes) {
      add_batch_wide<G>(h, tag, hot, bin, gh_at, b0, lim, j0, rows);
    }
  };
  for (int i = 0; i + 1 < kWideStages; ++i) {
    if (i < n_stages) stage(i, ring + (i % kWideStages) * slot_bytes);
    cp_async_commit();
  }
  for (long long i = 0; i < n_stages; ++i) {
    // stage i has landed for every thread, and every warp is done with
    // stage i - 1, whose slot the next copy fills
    cp_async_wait<kWideStages - 2>();
    __syncthreads();
    const long long next = i + kWideStages - 1;
    if (next < n_stages) stage(next, ring + (next % kWideStages) * slot_bytes);
    cp_async_commit();
    if (!active) continue;
    add_stage(i, ring + (i % kWideStages) * slot_bytes, fl, add);
  }
  if (active) hot.flush(h);
}

// Add rows p0 .. p1 - 1 of row-major bins [*, F] and gh [*, 3] to column
// t's histograms `hist` (zeroed by the block before the call), with the
// block's bin tags `tags` and staged through `ring` (add_stages_wide);
// every thread of the block calls it. The buffers' alignment and padding
// are add_rows_rowmajor's.
template <typename G, typename BinT>
__device__ void add_rows_wide(typename Gh<G>::Acc* hist, unsigned char* tags,
                              unsigned char* ring,
                              const BinT* __restrict__ bins,
                              const G* __restrict__ gh, long long p0,
                              long long p1, const WideCols& cols, int t) {
  const int R = cols.stage_rows;
  const int g = tile_unit<BinT>(cols.F, cols.ft);
  const int stride = tile_row_bytes<BinT>(cols.F, cols.ft);  // ring row
  const int bpart = (R * stride + 15) / 16 * 16;
  const long long row_b = cols.F * static_cast<long long>(sizeof(BinT));
  const long long tile_b = cols.f0(t) * static_cast<long long>(sizeof(BinT));
  const int tile_w = cols.width(t) * static_cast<int>(sizeof(BinT));
  const int units = g > 0 ? (tile_w + g - 1) / g : 0;   // copies a row
  const long long gh_row = kChannels * static_cast<long long>(sizeof(G));
  const int row16 = static_cast<int>(row_b & 15);
  const int tile16 = static_cast<int>(tile_b & 15);
  const unsigned char* bin_bytes =
      reinterpret_cast<const unsigned char*>(bins);
  const unsigned char* gh_bytes = reinterpret_cast<const unsigned char*>(gh);
  const long long n_stages = p1 > p0 ? (p1 - p0 + R - 1) / R : 0;

  // copy stage i into slot sl: row r's tile at r * stride (in g-byte
  // copies, or the 16-byte chunks holding it), then the stage's gh, whole
  // 16-byte chunks
  auto stage = [&](long long i, unsigned char* sl) {
    const long long base = p0 + i * R;
    const int n = static_cast<int>(min(base + R, p1) - base);
    if (g > 0) {
      const unsigned char* src = bin_bytes + base * row_b + tile_b;
      for (int q = threadIdx.x; q < n * units; q += blockDim.x) {
        const int r = q / units;
        const int o = (q - r * units) * g;
        unsigned char* d = sl + r * stride + o;
        const unsigned char* a = src + r * row_b + o;
        if (g == 16) {
          cp_async16(d, a);
        } else if (g == 8) {
          cp_async_small<8>(d, a);
        } else {
          cp_async_small<4>(d, a);
        }
      }
    } else {
      for (int r = threadIdx.x; r < n; r += blockDim.x) {
        const long long a = (base + r) * row_b + tile_b;
        const long long c0 = a >> 4;
        const int last = static_cast<int>(((a + tile_w - 1) >> 4) - c0);
        for (int k = 0; k <= last; ++k) {
          cp_async16(sl + r * stride + k * 16, bin_bytes + (c0 + k) * 16);
        }
      }
    }
    const long long g0 = base * gh_row >> 4;
    const long long g1 = ((base + n) * gh_row + 15) >> 4;
    for (long long c = g0 + threadIdx.x; c < g1; c += blockDim.x) {
      cp_async16(sl + bpart + (c - g0) * 16, gh_bytes + c * 16);
    }
  };
  auto add_stage = [&](long long i, const unsigned char* sl, int fl,
                       auto add) {
    const long long base = p0 + i * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R),
                                          p1 - base));
    const G* sg = reinterpret_cast<const G*>(
        sl + bpart + (base * gh_row - base * gh_row / 16 * 16));
    // row j's bin of the warp's feature: at the start of its ring row, or
    // where the row's tile starts in its chunks, byte (base + j) * row_b +
    // tile_b mod 16
    const int base16 = static_cast<int>(base & 15);
    const int skew = g > 0 ? 0 : 15;
    add(rows,
        [&](int j) {
          const int o = ((base16 + j) * row16 + tile16) & skew;
          return static_cast<int>(*reinterpret_cast<const BinT*>(
              sl + j * stride + o + fl * static_cast<int>(sizeof(BinT))));
        },
        [&](int j) { return sg + j * kChannels; });
  };
  add_stages_wide<G>(hist, tags, ring, wide_stage_bytes<G, BinT>(cols), cols,
                     t, n_stages, stage, add_stage);
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

// Blocks of `kernel` (`threads` a block, `bytes` of dynamic shared
// memory) resident on the whole current device at once.
template <typename K>
inline cudaError_t resident_threads(K kernel, int* set, int threads,
                                    int bytes, long long* out) {
  cudaError_t err = allow_bytes(kernel, set, bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, bytes);
  if (err != cudaSuccess) return err;
  *out = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return cudaSuccess;
}

// The same for a one-warp block.
template <typename K>
inline cudaError_t resident_with(K kernel, int* set, int bytes,
                                 long long* out) {
  return resident_threads(kernel, set, kLanes, bytes, out);
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

// fn<G>(args...) for gh mode `mode` (f32, bf16 or int8), for kernels
// built for one bin width.
#define LGBM_DISPATCH_MODE(fn, mode, ...)                                  \
  ((mode) == kF32    ? fn<float>(__VA_ARGS__)                              \
   : (mode) == kBF16 ? fn<uint16_t>(__VA_ARGS__)                           \
                     : fn<int8_t>(__VA_ARGS__))

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

// The opt-in shared bytes of a block on the current device (*optin) and,
// for ft > 0, the blocks of `kernel` (ft * wpf warps, the wide geometry's
// shared memory at F features) resident on the device at once
// (*blocks); `set` as for allow_bytes.
template <typename G, typename BinT, typename K>
inline cudaError_t wide_plan(K kernel, int* set, int F, int ft, int win,
                             int wpf, int stage_rows, int* optin,
                             long long* blocks) {
  cudaError_t err = shared_optin(optin);
  if (err != cudaSuccess || ft <= 0) return err;
  const WideCols c = make_wide_cols(F, win, ft, win, wpf, stage_rows);
  return resident_threads(kernel, set, c.warps() * kLanes,
                          wide_shared_bytes<G, BinT>(c), blocks);
}

// What the reductions sum partials in: f64 for f32 histograms (rounded
// once into the output; an f32 sum of hundreds of partials of ~50 each
// rounds at ~1e-5 an add), int32 for int8 gh (exact).
template <typename Acc> struct RedSum { using T = double; };
template <> struct RedSum<int> { using T = int; };

// out[node] = the sum, in block order, of its blocks' partials, for the
// nodes with more than one block (a node with one block was written by
// it, a node with none gets zeros). Node v owns blocks [first[v],
// first[v + 1]); the partials of block g, column t, are at
// partials[(g * n_cols + t) * col_slots(cols)]. grid: (ceil(col_slots /
// blockDim.x), n_cols, any z); block z takes nodes z, z + gridDim.z, ...
// C is Cols (the grouped body's layout) or WideCols (the wide body's).
template <typename Acc, typename C = Cols>
__global__ void reduce_nodes(const Acc* __restrict__ partials,
                             Acc* __restrict__ out,
                             const long long* __restrict__ first,
                             int n_nodes, C cols) {
  const int slots = col_slots(cols);
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
    // four sums in turn, so that four adds are in flight
    typename RedSum<Acc>::T s[4] = {0, 0, 0, 0};
    long long g = g0;
    for (; g + 4 <= g1; g += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s[k] += partials[((g + k) * n_cols + t) * slots + p];
      }
    }
    for (; g < g1; ++g) s[0] += partials[(g * n_cols + t) * slots + p];
    out[v * node_out + o] = Acc((s[0] + s[1]) + (s[2] + s[3]));
  }
}

// out = the sum of the partials of the blocks that wrote one (flags[g *
// n_cols + t] != 0, or every block when flags is null; zeros where none
// did), in a fixed order: the n_parts (<= kMaxParts) blocks are cut into
// kSegs runs of consecutive blocks, each run summed in block order by its
// own thread, and the runs' sums added in run order, in RedSum's type.
// One output. A thread
// takes 4 adjacent accumulators (16 bytes), a block kReduceSlots such
// groups of every run. grid: (ceil(col_slots / (4 * kReduceSlots)),
// n_cols), kSegs * kReduceSlots threads; each block reads the flags once
// into shared memory. C is Cols or WideCols, as for reduce_nodes.
constexpr int kMaxParts = 4096;
constexpr int kSegs = 16;
constexpr int kReduceSlots = 32;

template <typename Acc> struct Vec4;
template <> struct Vec4<float> { using T = float4; };
template <> struct Vec4<int> { using T = int4; };
// four sums of RedSum's type
template <typename T> struct Sum4 { T x, y, z, w; };

template <typename Acc, typename C = Cols>
__global__ void __launch_bounds__(kSegs * kReduceSlots)
reduce_flagged(const Acc* __restrict__ partials, const int* __restrict__ flags,
               Acc* __restrict__ out, int n_parts, C cols) {
  using V = typename Vec4<Acc>::T;
  using S = Sum4<typename RedSum<Acc>::T>;
  constexpr int kUnroll = 8;
  __shared__ unsigned char wrote[kMaxParts];
  __shared__ S run_sum[kSegs][kReduceSlots];
  const int t = blockIdx.y;
  const long long n_cols = cols.count();
  wait_for_prior_grid();
  for (int g = threadIdx.x; g < n_parts; g += blockDim.x) {
    wrote[g] = flags == nullptr || __ldg(flags + g * n_cols + t) != 0;
  }
  __syncthreads();
  const int slots = col_slots(cols);            // a multiple of 4
  const int sl = threadIdx.x % kReduceSlots;
  const int q = threadIdx.x / kReduceSlots;
  const int p = (blockIdx.x * kReduceSlots + sl) * 4;
  const int per_run = (n_parts + kSegs - 1) / kSegs;
  S s = {0, 0, 0, 0};
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
  S total = run_sum[0][sl];
#pragma unroll
  for (int r = 1; r < kSegs; ++r) {
    const S a = run_sum[r][sl];
    total.x += a.x;
    total.y += a.y;
    total.z += a.z;
    total.w += a.w;
  }
  const Acc v[4] = {Acc(total.x), Acc(total.y), Acc(total.z),
                    Acc(total.w)};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long o = out_index(p + e, cols, t);
    if (o >= 0) out[o] = v[e];
  }
}

}  // namespace lgbm
