// Kernel B2 for Hopper (sm_90a): histogram of (grad, hess, count) over
// the rows of one leaf, given FEATURE-major [F, R] uint8 or uint16 bins
// and each row's leaf id, in two modes.
//
// Replaces: lightgbm_tpu/ops/hist_pallas.py::hist_pallas (the Pallas
// kernel _hist_kernel over feature-major bins), which the full/leaf row
// scheduler calls through make_hist_fn("pallas") for the root and for
// the smaller child of every split (core/grower.py leaf_hist) with gh
// masked to the leaf, in one full pass. Its f32 mode, and its int8 ->
// int32 mode (quantized gradients). The full path never builds bf16
// histograms (GrowerConfig.hist_dtype is read only on the compact path),
// so neither does this kernel. The TPU kernel's transpose of gh, its
// channel padding to 16/32, its (8, 128) tiles and its bf16 hi/mid/lo
// split of f32 gh serve the matrix unit; none of that carries over.
//
//   out[f, b, c] = sum over rows r with leaf_id[r] == leaf (every row
//                  when leaf_id is null) of gh[r, c] * [bins[f * ld + r] == b]
//   bins:    uint8 or uint16, row f of the [F, R] matrix at bins + f * ld
//            (ld >= R, in elements); values >= num_bin are skipped
//   gh:      [R, 3] contiguous, f32 / int8 (not masked)
//   leaf_id: int64 [R] or null
//   out:     [F, num_bin, 3], f32 (int32 for int8 gh); every slot written
//
// The mask is fused: the caller no longer writes gh * (leaf_id == leaf)
// (two 1M-row torch ops a split) before a full pass. Skipping a row
// outside the leaf changes no bit: its masked gh would add +-0.0, and a
// slot that starts at +0.0 never sums to -0.0.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes it must move are 8*R (leaf
// ids) + S*(F*w + 3*sizeof(gh)) (the leaf's S rows, bins of w bytes) +
// 12*F*num_bin (out).
// At R = 1M, F = 28, num_bin = 255: about 2.4 us for a 1-row leaf and 14
// us for a 1M-row f32 leaf (u16 at 4,095 bins: about 23 us). Its 3*S*F
// adds are far below the card's rate, so memory bounds it.
//
// Two paths, picked by the bin width: u8 bins take the grouped path
// (hist_featmajor_kernel, below), u16 bins the wide path
// (hist_featmajor_wide, whose note is further down). Both share the mask
// pass, the listing of small leaves' rows, the reduction and the order of
// the four kernels.
//
// Design of the grouped path. A first kernel, batch_masks, reads every
// row's leaf id once (a warp per four 32-row batches, many warps per SM,
// coalesced) and writes one 32-bit mask per batch: bit j set when row j
// is in the leaf. Each block of the histogram kernel owns a slice of rows,
// a whole number of batches, and reads its batches' masks 32 at a time
// (one load a lane, the next 32 loading while the current ones are
// added). A batch with no row of the leaf issues no bin or gh load and no
// add. The others are copied into a shared-memory ring with cp.async,
// kRing batches ahead of the one being added: in the feature-major layout
// lane l's 32 bins of a batch are contiguous, two 16-byte copies (bins +
// f*ld + base 16-byte aligned: the pointer is, ld is a multiple of 16
// elements from feature_major_bins in ops/hist_cuda.py, and base % 32 ==
// 0; element by element at a ragged edge or an unaligned stride), and the
// batch's gh is contiguous too. The block body is hist_grouped.cuh: one
// warp, lane = feature, a private [num_bin][32][3] shared histogram, the
// leaf's rows of a batch added four at a time (a group with none is
// skipped), their slots loaded together and sums of the same slot
// forwarded in row order; no float atomics, so two launches give the same
// bits. Skewed bins take the body's f64 hot sums (LaneHot), and
// reduce_flagged sums in f64. A block that met no row of the leaf writes
// no partial (its flag says so), and reduce_flagged sums the partials of
// the others in a fixed order (runs of consecutive blocks in parallel,
// then the runs in order).
//
// Small leaves. A block first counts its rows of the leaf from the
// masks. One with at most kSparseRows of them builds no histogram: it
// writes their row numbers to its list and stops, since zeroing and
// writing a 98 KB partial (and the reduction reading it back) would cost
// far more than its few rows. After the reduction has summed the other
// blocks' partials into out, hist_sparse_kernel adds the listed rows to
// it: kSplit blocks per feature, each adding a share of the rows, the
// last to finish adding the shares to out in order. At a 4,097-row
// leaf of 1M rows every block lists, and no partial is written. Sizing
// the main grid by the leaf's row count was tried and dropped: fewer
// blocks leave each more sparse batches to wait for, and a 4,097-row leaf
// ran slower at 64 blocks than at 264. Sparse passes that gave each run
// of 8 blocks a partial of its own were tried too (a warp per run, lane =
// feature; a thread per bin; a warp per feature): with those partials to
// write and reduce, none was faster than the blocks' own partials.
//
// Scratch of the grouped path, in 4-byte words from one caller buffer
// (16-byte aligned), with n_cols feature tiles: partials [blocks * n_cols
// * tile_slots(num_bin)], flags [blocks * n_cols], and when leaf_id is
// given counts [blocks * n_cols], lists [blocks * n_cols * kSparseRows],
// masks [ceil(R / 32)], the sparse pass's shares [F * kSplit * num_bin *
// 3] and its arrival counters [F].
#include "hist_grouped.cuh"

namespace {

using namespace lgbm;

constexpr int kAhead = kLanes;       // batches whose masks load at once
constexpr int kRing = 2 * kStages;   // batches staged ahead: sparse leaves
                                     // leave few batches to overlap
constexpr int kSparseRows = 64;      // rows a block hands on, at most
constexpr int kHeld = 4;             // chunks of masks a block keeps

// Bytes of a batch's staging slot: every lane's 32 bins, then the rows' gh.
constexpr int kFmBinsSlot = kLanes * kBatch;
template <typename G>
__host__ __device__ constexpr int fm_slot_bytes() {
  return kFmBinsSlot +
         (kBatch * kChannels * static_cast<int>(sizeof(G)) + 15) / 16 * 16;
}
// Shared memory beside the histogram: the ring, the masks and the
// widened gh of the hot sums.
template <typename G>
inline int fm_fixed_bytes() {
  return kRing * fm_slot_bytes<G>() + (kRing + kAhead) * 4 + kHotBytes;
}

// Where lane l keeps 16-byte chunk c of its 32 bins in a slot: the
// chunks of neighbouring lanes swapped so that a quarter warp's 16-byte
// reads touch all 32 banks once.
__device__ __forceinline__ int bins_at(int lane, int c) {
  return lane * 32 + 16 * (c ^ ((lane >> 2) & 1));
}

// masks[b] = the rows of batch b (rows 32b .. 32b + 31 below R) whose leaf
// id is `leaf`, as bits. A warp takes kMaskBatches consecutive batches at
// a time (their loads in flight together), grid-stride. Block 0 also
// zeroes the sparse pass's arrival counters.
constexpr int kMaskBatches = 4;
__global__ void batch_masks(const long long* __restrict__ leaf_id,
                            long long leaf, long long R,
                            unsigned* __restrict__ masks,
                            int* __restrict__ arrived, int n_arrived) {
  if (blockIdx.x == 0) {
    for (int f = threadIdx.x; f < n_arrived; f += blockDim.x) arrived[f] = 0;
  }
  const long long n_batches = (R + kBatch - 1) / kBatch;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x /
                          kLanes;
  const int lane = threadIdx.x % kLanes;
  for (long long b0 = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) / kLanes * kMaskBatches;
       b0 < n_batches; b0 += warps * kMaskBatches) {
    bool in[kMaskBatches];
#pragma unroll
    for (int k = 0; k < kMaskBatches; ++k) {
      const long long r = (b0 + k) * kBatch + lane;
      in[k] = r < R && __ldg(leaf_id + r) == leaf;
    }
#pragma unroll
    for (int k = 0; k < kMaskBatches; ++k) {
      const unsigned m = __ballot_sync(kFull, in[k]);
      if (lane == 0 && b0 + k < n_batches) masks[b0 + k] = m;
    }
  }
}

template <typename G>
__global__ void __launch_bounds__(kLanes)
hist_featmajor_kernel(const uint8_t* __restrict__ bins,
                      const G* __restrict__ gh,
                      const unsigned* __restrict__ masks,
                      typename Gh<G>::Acc* __restrict__ out,
                      typename Gh<G>::Acc* __restrict__ partials,
                      int* __restrict__ flags, int* __restrict__ counts,
                      int* __restrict__ lists, long long R, long long ld,
                      Cols cols, long long rows_per_block, bool vec) {
  using Acc = typename Gh<G>::Acc;
  using BinT = uint8_t;
  constexpr int kPer = 4;        // bins a word
  constexpr int kChunks = 2;     // 16-byte chunks of a lane's 32 bins
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  unsigned char* ring = smem_raw + hist_bytes(cols.win);
  constexpr int slot = fm_slot_bytes<G>();
  unsigned* s_mask = reinterpret_cast<unsigned*>(ring + kRing * slot);
  unsigned* s_chunk = s_mask + kRing;        // the masks of a chunk
  double* gd = reinterpret_cast<double*>(s_chunk + kAhead);   // kHotBytes
  LaneHot hot;
  const int lane = threadIdx.x;
  const int t = blockIdx.y;
  const int f0 = cols.f0(t), b0 = cols.b0(t);
  const bool active = lane < cols.width(t);
  const int lim = active ? cols.bins(t) : 0;   // inactive lanes add nothing
  const int skip = cols.win;
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(R, p0 + rows_per_block);
  const long long part =
      static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y;
  wait_for_prior_grid();
  // inactive lanes read feature f0's row and add nothing
  const BinT* col = bins + static_cast<long long>(f0 + (active ? lane : 0))
                               * ld;
  const long long gh_row = kChannels * static_cast<long long>(sizeof(G));
  const unsigned char* gh_bytes = reinterpret_cast<const unsigned char*>(gh);

  // the batches with a row of the leaf, in order: the next one's base and
  // mask, kAhead batches' masks at a time (lane u holds batch u's), the
  // next chunk's loading while the current chunk's batches are added
  // (every row below p1 when masks is null)
  auto load_mask = [&](long long chunk_base) -> unsigned {
    const long long base = chunk_base + lane * kBatch;
    if (base >= p1) return 0u;
    if (masks != nullptr) return __ldg(masks + base / kBatch);
    const long long rows = p1 - base;
    return rows >= kBatch ? kFull : (1u << rows) - 1u;
  };
  if (counts != nullptr && gridDim.x > 1) {
    // a block with few rows of the leaf lists them for the sparse pass;
    // the masks of its first kHeld chunks load together and are kept
    constexpr long long kChunk = kAhead * kBatch;
    unsigned held[kHeld];
    int n = 0;
#pragma unroll
    for (int c = 0; c < kHeld; ++c) held[c] = load_mask(p0 + c * kChunk);
#pragma unroll
    for (int c = 0; c < kHeld; ++c) n += __popc(held[c]);
    for (long long cb = p0 + kHeld * kChunk; cb < p1; cb += kChunk) {
      n += __popc(load_mask(cb));
    }
#pragma unroll
    for (int d = kLanes / 2; d > 0; d /= 2) n += __shfl_xor_sync(kFull, n, d);
    if (n <= kSparseRows) {
      int* list = lists + part * kSparseRows;
      int at = 0;                              // rows listed so far
      auto list_chunk = [&](long long cb, unsigned m) {
        const int mine = __popc(m);
        int before = mine;                     // inclusive scan over lanes
#pragma unroll
        for (int d = 1; d < kLanes; d *= 2) {
          const int v = __shfl_up_sync(kFull, before, d);
          if (lane >= d) before += v;
        }
        int k = at + before - mine;
        for (; m != 0u; m &= m - 1u) {
          list[k++] = static_cast<int>(cb + lane * kBatch + __ffs(m) - 1);
        }
        at += __shfl_sync(kFull, before, kLanes - 1);
      };
#pragma unroll
      for (int c = 0; c < kHeld; ++c) list_chunk(p0 + c * kChunk, held[c]);
      for (long long cb = p0 + kHeld * kChunk; cb < p1 && at < n;
           cb += kChunk) {
        list_chunk(cb, load_mask(cb));
      }
      if (lane == 0) {
        flags[part] = 0;
        counts[part] = n;
      }
      return;
    }
    if (lane == 0) counts[part] = 0;
  }
  zero_hist_vec(hist, cols.win);
  long long next_chunk = p0, chunk = p0;
  unsigned nonempty = 0;                       // bit u: batch u of chunk
  unsigned next_mask = load_mask(next_chunk);  // this lane's, next chunk
  auto next_batch = [&](long long& base, unsigned& mask) -> bool {
    while (nonempty == 0u) {
      if (next_chunk >= p1) return false;
      const unsigned m = next_mask;
      chunk = next_chunk;
      next_chunk += kAhead * kBatch;
      next_mask = load_mask(next_chunk);
      __syncwarp();
      s_chunk[lane] = m;
      nonempty = __ballot_sync(kFull, m != 0u);
      __syncwarp();
    }
    const int u = __ffs(nonempty) - 1;
    nonempty &= nonempty - 1u;
    base = chunk + u * kBatch;
    mask = s_chunk[u];
    return true;
  };
  // copy a batch's bins and gh into slot k (element by element where
  // 16-byte copies cannot be made)
  auto stage = [&](int k, long long base, unsigned mask) {
    unsigned char* sl = ring + k * slot;
    const bool whole = base + kBatch <= p1;
    if (vec && whole) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        cp_async16(sl + bins_at(lane, c),
                   reinterpret_cast<const unsigned char*>(col + base) +
                       16 * c);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kBatch; ++j) {
        sl[bins_at(lane, j >> 4) + (j & 15)] =
            base + j < p1 ? __ldg(col + base + j) : BinT(0);
      }
    }
    unsigned char* sg = sl + kFmBinsSlot;
    if (whole) {
      for (int c = lane; c * 16 < kBatch * gh_row; c += kLanes) {
        cp_async16(sg + c * 16, gh_bytes + base * gh_row + c * 16);
      }
    } else if ((mask >> lane) & 1u) {
      G* to = reinterpret_cast<G*>(sg) + lane * kChannels;
      const G* from = gh + (base + lane) * kChannels;
      to[0] = from[0];
      to[1] = from[1];
      to[2] = from[2];
    }
    if (lane == 0) s_mask[k] = mask;
  };

  unsigned any = 0;
  int staged = 0;
  for (int i = 0; i + 1 < kRing; ++i) {
    long long base;
    unsigned mask;
    if (next_batch(base, mask)) stage(staged++ % kRing, base, mask);
    cp_async_commit();
  }
  // whether a lane finds the block's first batch with a row of the leaf
  // skewed (its rows of the leaf, read from the ring as soon as they
  // land)
  bool skewed = false;
  if constexpr (kHotSums<G>) {
    if (staged > 0) {
      cp_async_wait<kRing - 2>();
      __syncwarp();
      const unsigned m = s_mask[0];
      auto bin = [&](int j) {
        const int v = static_cast<int>(
            ring[bins_at(lane, j >> 4) + (j & 15)]);
        return (m >> j) & 1u ? v - b0 : skip;
      };
      // the candidates: the bins of the batch's first three leaf rows
      const unsigned m1 = m & (m - 1u), m2 = m1 & (m1 - 1u);
      auto nth = [&](unsigned bits) {
        return bits != 0u ? bin(__ffs(bits) - 1) : skip;
      };
      skewed = __any_sync(kFull, skewed_batch<kBatch>(bin, lim, __popc(m),
                                                      nth(m), nth(m1),
                                                      nth(m2)));
    }
  }
  // batch i added in mode M; returns whether the hot sums are in use
  auto step = [&](int i, auto mode) {
    long long base;
    unsigned mask;
    if (next_batch(base, mask)) stage(staged++ % kRing, base, mask);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    __syncwarp();
    const unsigned char* sl = ring + (i % kRing) * slot;
    const unsigned cur = s_mask[i % kRing];
    uint32_t w[8];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(sl + bins_at(lane, c));
      w[4 * c] = a.x;
      w[4 * c + 1] = a.y;
      w[4 * c + 2] = a.z;
      w[4 * c + 3] = a.w;
    }
    const G* sg = reinterpret_cast<const G*>(sl + kFmBinsSlot);
    any |= cur;
    auto bin = [&](int j) {
      const int v = static_cast<int>((w[j / kPer] >> (8 * (j % kPer))) &
                                     0xffu);
      return ((cur >> j) & 1u) ? v - b0 : skip;
    };
    const bool hot_sums = add_batch<decltype(mode)::value>(
        hist, hot, gd, lane, lim, __popc(cur), bin,
        [&](int j, int c) {
          return GhShared<G>::load(sg + j * kChannels + c);
        },
        [&](int j0) {            // warp-uniform: a row of the leaf
          return ((cur >> j0) & ((1u << kGroup) - 1u)) != 0u;
        });
    __syncwarp();
    return hot_sums;
  };
  int i = 0;
  if constexpr (kHotSums<G>) {
    if (skewed) {
      hot.clear();
      if (step(i++, AddAs<kAddPick>())) {
        while (i < staged) step(i++, AddAs<kAddHot>());
        hot.finish(hist, lane);
      }
    }
  }
  while (i < staged) step(i++, AddAs<kAddPlain>());
  if (gridDim.x == 1) {
    write_out_slots(hist, out, cols, t);
    return;
  }
  if (lane == 0) flags[part] = any != 0u ? 1 : 0;
  if (any != 0u) {
    write_partial_vec(hist, partials + part * tile_slots(cols.win),
                      cols.win);
  }
}

constexpr int kSparseWarps = 16;     // the sparse pass's warps a block
constexpr int kChunkRows = 4096;     // listed rows it stages at a time
constexpr int kRowsPerThread = kChunkRows / (kSparseWarps * kLanes);
constexpr int kSplit = 8;            // blocks sharing a feature's rows

// Bytes of the sparse pass's shared memory at a window of win bins and
// `blocks` listing blocks: a [win][3] histogram per warp, a chunk's rows'
// gh (widened) and bins, and the blocks' row offsets.
inline int sparse_shared_bytes(int win, long long blocks) {
  return kSparseWarps * win * kChannels * 4 +
         kChunkRows * (kChannels * 4 + 1) + static_cast<int>(blocks + 1) * 4;
}

// out[f] += the histogram of the rows that blocks listed (counts[g *
// n_cols + t] of them at lists + (g * n_cols + t) * kSparseRows, t = the
// column of f's tile and the block's window), for feature f and window w
// of blockIdx.x = f * n_win + w, after reduce_flagged wrote the other
// blocks' sum to out. The listed rows, in block order and row order, are
// cut into kSplit equal shares, one per block (s = blockIdx.y), so that
// many SMs gather them. A block gathers its share's bins of f and gh into
// shared memory, a chunk at a time, and warp w adds its part of the
// chunk, 32 rows at a time, to its own histogram: the rows of a batch
// that share a bin (__match_any_sync) are summed in row order by the
// first of them, which alone adds the sum to the bin. The block sums its
// warps' histograms in warp order into its share; the last of the (f, w)
// blocks to arrive adds the shares to out in share order. A fixed order
// of adds throughout, so two launches give the same bits; a bin no listed
// row reached adds +0.0, which changes no bit.
template <typename G>
__global__ void __launch_bounds__(kSparseWarps * kLanes)
hist_sparse_kernel(const uint8_t* __restrict__ bins,
                   const G* __restrict__ gh, const int* __restrict__ counts,
                   const int* __restrict__ lists,
                   typename Gh<G>::Acc* __restrict__ share_h,
                   int* __restrict__ arrived,
                   typename Gh<G>::Acc* __restrict__ out, long long ld,
                   Cols cols, int blocks) {
  using Acc = typename Gh<G>::Acc;
  using BinT = uint8_t;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int win = cols.win;
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);
  Acc* s_gh = s_hist + kSparseWarps * win * kChannels;
  int* s_off = reinterpret_cast<int*>(s_gh + kChunkRows * kChannels);
  BinT* s_bin = reinterpret_cast<BinT*>(s_off + blocks + 1);
  __shared__ bool s_last;
  const int fw = blockIdx.x;                 // f * n_win + w
  const int f = fw / cols.n_win, wi = fw - f * cols.n_win;
  const int t = (f / cols.ft) * cols.n_win + wi;   // f's column
  const int b0 = wi * win, nb = cols.bins(t);
  const int share = blockIdx.y;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int nh = win * kChannels;
  const long long n_cols = cols.count();
  wait_for_prior_grid();
  for (int g = threadIdx.x; g < blocks; g += blockDim.x) {
    s_off[g + 1] = __ldg(counts + g * n_cols + t);
  }
  zero_hist_block(s_hist, kSparseWarps * nh);
  __syncthreads();
  if (warp == 0) {
    // s_off[g] = the rows listed by blocks before g
    int run = 0;
    for (int g0 = 0; g0 < blocks; g0 += kLanes) {
      int x = g0 + lane < blocks ? s_off[g0 + lane + 1] : 0;
#pragma unroll
      for (int d = 1; d < kLanes; d *= 2) {
        const int v = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += v;
      }
      if (g0 + lane < blocks) s_off[g0 + lane + 1] = run + x;
      run += __shfl_sync(kFull, x, kLanes - 1);
    }
    if (lane == 0) s_off[0] = 0;
  }
  __syncthreads();
  const int total = s_off[blocks];
  if (total == 0) return;
  const int per_share = (total + kSplit - 1) / kSplit;
  const int r0 = min(total, share * per_share);
  const int r1 = min(total, r0 + per_share);
  const BinT* col = bins + static_cast<long long>(f) * ld;
  Acc* h = s_hist + warp * nh;
  for (int c0 = r0; c0 < r1; c0 += kChunkRows) {
    const int rows = min(kChunkRows, r1 - c0);
    // a thread's rows of the chunk: every list load in flight at once,
    // then every bin and gh load
    int row[kRowsPerThread];
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < rows) {
        int lo = 0, hi = blocks;      // the block that listed row c0 + i
        while (hi - lo > 1) {
          const int mid = (lo + hi) / 2;
          if (s_off[mid] <= c0 + i) lo = mid; else hi = mid;
        }
        row[k] = __ldg(lists + (static_cast<long long>(lo) * n_cols + t) *
                                   kSparseRows + c0 + i - s_off[lo]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < rows) {
        s_bin[i] = __ldg(col + row[k]);
#pragma unroll
        for (int c = 0; c < kChannels; ++c) {
          s_gh[i * kChannels + c] = Gh<G>::load(
              gh + static_cast<long long>(row[k]) * kChannels + c);
        }
      }
    }
    __syncthreads();
    const int per = (rows + kSparseWarps - 1) / kSparseWarps;
    const int i1 = min(rows, (warp + 1) * per);
    for (int k0 = warp * per; k0 < i1; k0 += kLanes) {
      const int i = k0 + lane;
      const int b = i < i1 ? static_cast<int>(s_bin[i]) - b0 : -1;
      const bool adds = in_window(b, nb);
      // rows that add nothing each get a key of their own
      const unsigned peers = __match_any_sync(kFull, adds ? b : -1 - lane);
      if (adds && (peers & ((1u << lane) - 1u)) == 0u) {
        Acc x0 = s_gh[i * kChannels], x1 = s_gh[i * kChannels + 1],
            x2 = s_gh[i * kChannels + 2];
        for (unsigned m = peers & (peers - 1u); m != 0u; m &= m - 1u) {
          const int j = k0 + __ffs(m) - 1;
          x0 += s_gh[j * kChannels];
          x1 += s_gh[j * kChannels + 1];
          x2 += s_gh[j * kChannels + 2];
        }
        h[b * kChannels] += x0;
        h[b * kChannels + 1] += x1;
        h[b * kChannels + 2] += x2;
      }
      __syncwarp();
    }
    __syncthreads();
  }
  Acc* mine = share_h + (static_cast<long long>(fw) * kSplit + share) * nh;
  for (int q = threadIdx.x; q < nb * kChannels; q += blockDim.x) {
    Acc sum = s_hist[q];
    for (int w = 1; w < kSparseWarps; ++w) sum += s_hist[w * nh + q];
    mine[q] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrived + fw, 1) == kSplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const Acc* shares = share_h + static_cast<long long>(fw) * kSplit * nh;
  Acc* o = out + (static_cast<long long>(f) * cols.num_bin + b0) * kChannels;
  for (int q = threadIdx.x; q < nb * kChannels; q += blockDim.x) {
    Acc sum = __ldcg(shares + q);
#pragma unroll
    for (int k = 1; k < kSplit; ++k) sum += __ldcg(shares + k * nh + q);
    o[q] = o[q] + sum;
  }
}

// ---- The wide path: u16 bins ---------------------------------------------
//
// B2 over u16 bins runs the wide body of hist_grouped.cuh (add_stages_wide:
// a warp per feature of a tile, or per run of its bins, lane = row, a
// private [sub][3] histogram of 12 bytes a bin and its byte tags, skewed
// bins summed in f64 registers), with its own stages: feature-major rows
// and the leaf's mask.
//
// Prologue (fused form): the block reads its batches' masks, blockDim
// batches at a time, and writes the batches with a row of the leaf, in
// order, to its range of `blist` (a scratch array beside the masks; every
// column's block of the same rows writes the same values), and counts the
// leaf's rows. A block with at most kSparseRows of them lists them for the
// sparse pass and stops, as the grouped kernel does (column 0's block
// writes the list). A batch with no row of the leaf is never staged.
//
// A stage is the block's next stage_rows / 32 listed batches. Its ring
// slot holds, for each feature of the tile, one run of its bins (64 bytes
// a batch: four 16-byte cp.async copies at bins + f * ld + 32 * batch,
// element by element only at a ragged edge or an unaligned stride), the
// batches' gh (contiguous rows, whole 16-byte copies), and the list of the
// stage's leaf rows, written while the copies fly: lane k of each warp
// takes batch k's mask, a popcount prefix over the lanes gives each batch
// its place, and each warp lists its batches' leaf rows in row order. So
// every lane of an add takes a row of the leaf (a stage whose rows are all
// the leaf's skips the list), and a row outside the leaf adds nothing.
// (Adding every staged row instead, rows outside the leaf given no bin,
// was 2 to 3 times slower at leaves of 65,536 rows of a million.)
//
// Reduction: partials of 12 bytes a bin and feature, summed by
// reduce_flagged over WideCols in f64; a block that met no row of the leaf
// writes none.
//
// Sparse pass (hist_sparse_wide): the rows the blocks listed, cut into as
// many shares as they need (one for a few hundred rows); a block takes one
// feature and one share, its warps (lane = listed row) adding parts of it
// into their own [win][3] histograms (all of a feature's bins up to about
// 15,000 bins, else the fewest windows), so a listed row is read once per
// feature. One share is added straight into out; several are summed in
// share order by the last block of the feature to finish. Its cost grows
// with the listed rows and the bins they reach, not with num_bin times the
// shares.
constexpr int kSparseChunk = 1024;     // listed rows gathered at a time
constexpr int kSparseMaxWarps = 4;     // warps of a sparse block
constexpr int kSparseWarpRows = 128;   // rows a warp adds before a share more
constexpr int kSparseMaxSplit = 8;     // shares of the listed rows, at most

// A stage of the wide path in its ring slot: [ft][stage_rows] u16 bins,
// [stage_rows][3] gh, [stage_rows] u16 positions of the leaf's rows, then
// a header of kFmHeader bytes: the leaf's rows in the stage, and whether
// they are all its rows.
constexpr int kFmHeader = 16;
template <typename G>
__host__ __device__ inline int fm_stage_bytes(const WideCols& c) {
  return c.stage_rows * (2 * c.ft + kChannels * static_cast<int>(sizeof(G)) +
                         2) +
         kFmHeader;
}
// A wide block's shared memory: histograms, bin tags, the ring.
template <typename G>
__host__ __device__ inline int fm_wide_shared_bytes(const WideCols& c) {
  return col_slots(c) * 4 + wide_tag_bytes(c) +
         kWideStages * fm_stage_bytes<G>(c);
}

template <typename G>
__global__ void __launch_bounds__(kWideMaxWarps * kLanes)
hist_featmajor_wide(const uint16_t* __restrict__ bins,
                    const G* __restrict__ gh,
                    const unsigned* __restrict__ masks,
                    typename Gh<G>::Acc* __restrict__ out,
                    typename Gh<G>::Acc* __restrict__ partials,
                    int* __restrict__ flags, int* __restrict__ counts,
                    int* __restrict__ lists, int* blist, long long R,
                    long long ld, WideCols cols, long long rows_per_block,
                    bool vec) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  const int slots = col_slots(cols);
  unsigned char* tags = smem_raw + slots * 4;
  unsigned char* ring = tags + wide_tag_bytes(cols);
  const int t = blockIdx.y;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int n_warps = blockDim.x / kLanes;
  const unsigned below = (1u << lane) - 1u;    // the lanes before this one
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(R, p0 + rows_per_block);
  const long long part =
      static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y;
  const long long q0 = p0 / kBatch;             // the block's batches
  const long long q1 = (p1 + kBatch - 1) / kBatch;
  zero_hist_block(hist, slots);
  wait_for_prior_grid();
  long long n_ne = q1 - q0;        // batches with a row of the leaf
  if (masks != nullptr) {
    int* s_cnt = reinterpret_cast<int*>(ring);  // [warps], before any stage
    long long ne = 0;
    int n = 0;
    for (long long c = q0; c < q1; c += blockDim.x) {
      const long long q = c + threadIdx.x;
      const unsigned m = q < q1 ? __ldg(masks + q) : 0u;
      n += __popc(m);
      const unsigned in = __ballot_sync(kFull, m != 0u);
      if (lane == 0) s_cnt[warp] = __popc(in);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < n_warps; ++w) {
        const int v = s_cnt[w];
        before += w < warp ? v : 0;
        total += v;
      }
      if (m != 0u) {
        blist[q0 + ne + before + __popc(in & below)] = static_cast<int>(q);
      }
      ne += total;
      __syncthreads();
    }
#pragma unroll
    for (int d = kLanes / 2; d > 0; d /= 2) n += __shfl_xor_sync(kFull, n, d);
    if (lane == 0) s_cnt[warp] = n;
    __syncthreads();
    n = 0;
    for (int w = 0; w < n_warps; ++w) n += s_cnt[w];
    __syncthreads();               // s_cnt is read before the ring fills
    n_ne = ne;
    if (gridDim.x > 1 && n <= kSparseRows) {
      // ne <= n <= kSparseRows batches, listed 32 at a time
      if (t == 0 && warp == 0) {
        int* list = lists + static_cast<long long>(blockIdx.x) * kSparseRows;
        int at = 0;
        for (long long k0 = 0; k0 < ne; k0 += kLanes) {
          const long long k = k0 + lane;
          const int q = k < ne ? blist[q0 + k] : 0;
          unsigned m = k < ne ? __ldg(masks + q) : 0u;
          const int mine = __popc(m);
          int incl = mine;
#pragma unroll
          for (int d = 1; d < kLanes; d *= 2) {
            const int v = __shfl_up_sync(kFull, incl, d);
            if (lane >= d) incl += v;
          }
          int o = at + incl - mine;
          for (; m != 0u; m &= m - 1u) list[o++] = q * kBatch + __ffs(m) - 1;
          at += __shfl_sync(kFull, incl, kLanes - 1);
        }
        if (lane == 0) counts[blockIdx.x] = n;
      }
      if (threadIdx.x == 0) flags[part] = 0;
      return;
    }
    if (t == 0 && threadIdx.x == 0) counts[blockIdx.x] = 0;
  }

  const int SR = cols.stage_rows;
  const int K = SR / kBatch;                    // batches a stage
  const int wt = cols.width(t);
  const int f0 = cols.f0(t);
  constexpr int kGhBatch = kBatch * kChannels * static_cast<int>(sizeof(G));
  const int gh_off = cols.ft * SR * 2;
  const int list_off = gh_off + K * kGhBatch;
  const int head_off = list_off + SR * 2;
  const long long n_stages = (n_ne + K - 1) / K;
  // the block's k-th batch with a row of the leaf, and a batch's mask
  auto batch_at = [&](long long k) -> long long {
    return masks != nullptr ? blist[q0 + k] : q0 + k;
  };
  auto mask_at = [&](long long q) -> unsigned {
    if (masks != nullptr) return __ldg(masks + q);
    const long long rows = R - q * kBatch;
    return rows >= kBatch ? kFull : (1u << rows) - 1u;
  };
  auto stage = [&](long long i, unsigned char* sl) {
    const long long k0 = i * K;
    const int nb = static_cast<int>(min(static_cast<long long>(K),
                                        n_ne - k0));
    // bins: feature f's 32 bins of batch k at (f * SR + 32 k) * 2, four
    // 16-byte copies
    for (int u = threadIdx.x; u < nb * wt * 4; u += blockDim.x) {
      const int k = u / (wt * 4);
      const int rem = u - k * wt * 4;
      const int f = rem >> 2, c = rem & 3;
      const long long base = batch_at(k0 + k) * kBatch + c * 8;
      const uint16_t* src = bins + (f0 + f) * ld + base;
      uint16_t* dst = reinterpret_cast<uint16_t*>(sl) + f * SR + k * kBatch +
                      c * 8;
      if (vec && base - c * 8 + kBatch <= R) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dst[e] = base + e < R ? __ldg(src + e) : uint16_t(0);
        }
      }
    }
    // gh: each batch's rows, contiguous, in whole 16-byte copies (byte by
    // byte at the ragged edge)
    for (int u = threadIdx.x; u < nb * (kGhBatch / 16); u += blockDim.x) {
      const int k = u / (kGhBatch / 16);
      const int c = u - k * (kGhBatch / 16);
      const long long base = batch_at(k0 + k) * kBatch;
      unsigned char* dst = sl + gh_off + k * kGhBatch + c * 16;
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(gh + base * kChannels) +
          c * 16;
      if (base + kBatch <= R) {
        cp_async16(dst, src);
      } else {
        const long long valid =
            (R - base) * kChannels * static_cast<long long>(sizeof(G));
        for (int e = 0; e < 16; ++e) dst[e] = c * 16 + e < valid ? src[e] : 0;
      }
    }
    // the stage's leaf rows: lane k of each warp takes batch k's mask
    // (nb <= 32), a prefix over the lanes places each batch's rows, and
    // warp w lists batches w, w + warps, ... in row order
    const unsigned m = lane < nb ? mask_at(batch_at(k0 + lane)) : 0u;
    const int mine = __popc(m);
    int incl = mine;
#pragma unroll
    for (int d = 1; d < kLanes; d *= 2) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, kLanes - 1);
    uint16_t* list = reinterpret_cast<uint16_t*>(sl + list_off);
    const int excl = incl - mine;
    for (int k = warp; k < nb; k += n_warps) {
      const unsigned mk = __shfl_sync(kFull, m, k);
      const int at = __shfl_sync(kFull, excl, k);
      if ((mk >> lane) & 1u) {
        list[at + __popc(mk & below)] =
            static_cast<uint16_t>(k * kBatch + lane);
      }
    }
    if (threadIdx.x == 0) {
      int* head = reinterpret_cast<int*>(sl + head_off);
      head[0] = total;
      head[1] = total == nb * kBatch;
    }
  };
  auto add_stage = [&](long long, const unsigned char* sl, int fl,
                       auto add) {
    const uint16_t* run = reinterpret_cast<const uint16_t*>(sl) + fl * SR;
    const G* sg = reinterpret_cast<const G*>(sl + gh_off);
    const int* head = reinterpret_cast<const int*>(sl + head_off);
    const uint16_t* list = reinterpret_cast<const uint16_t*>(sl + list_off);
    if (head[1] != 0) {            // every staged row is the leaf's
      add(head[0], [&](int j) { return static_cast<int>(run[j]); },
          [&](int j) { return sg + j * kChannels; });
    } else {
      add(head[0], [&](int j) { return static_cast<int>(run[list[j]]); },
          [&](int j) { return sg + list[j] * kChannels; });
    }
  };
  add_stages_wide<G>(hist, tags, ring, fm_stage_bytes<G>(cols), cols, t,
                     n_stages, stage, add_stage);
  __syncthreads();
  if (gridDim.x == 1) {
    write_out_wide(hist, out, cols, t);
    return;
  }
  if (threadIdx.x == 0) flags[part] = n_ne > 0 ? 1 : 0;
  if (n_ne > 0) write_partial_block(hist, partials + part * slots, slots);
}

// The wide sparse pass's geometry: windows of win bins (n_win of them)
// and nw warps a block.
struct SparseWide {
  int win, n_win, nw;
};
// Its shared memory beside the warps' histograms: a chunk's rows' bins and
// gh, the blocks' row offsets, the last-block flag.
template <typename G>
__host__ __device__ inline int sparse_wide_fixed() {
  return kSparseChunk * 2 +
         (kSparseChunk * kChannels * static_cast<int>(sizeof(G)) + 15) / 16 *
             16 +
         (kMaxParts + 1 + 3) / 4 * 16 + 16;
}
// A warp's: its [win][3] histogram and its tags.
__host__ __device__ inline int sparse_wide_per_warp(int win) {
  return 12 * win + (win + 15) / 16 * 16;
}
template <typename G>
inline SparseWide sparse_wide_geometry(int num_bin, int optin) {
  SparseWide s;
  const int room = optin - sparse_wide_fixed<G>();
  const int most = (room - 15) / 13 / 4 * 4;     // one warp's window
  s.n_win = (num_bin + most - 1) / most;
  s.win = ((num_bin + s.n_win - 1) / s.n_win + 3) / 4 * 4;
  s.nw = min(kSparseMaxWarps, room / sparse_wide_per_warp(s.win));
  return s;
}
template <typename G>
inline int sparse_wide_bytes(const SparseWide& s) {
  return s.nw * sparse_wide_per_warp(s.win) + sparse_wide_fixed<G>();
}

// out[f] += the histogram of the rows that blocks listed (counts[g] of
// them at lists + g * kSparseRows), for feature f and window w of
// blockIdx.x = f * n_win + w, after reduce_flagged wrote the other blocks'
// sum to out. The listed rows, in block order and row order, are cut into
// `split` equal shares (one for every kSparseWarpRows * nw rows, at most
// kSparseMaxSplit; the same count in every block), one per block (s =
// blockIdx.y; the blocks past split stop at once). A block gathers its
// share's bins of f and gh into shared memory, a chunk at a time, and each
// warp adds its part of the chunk, lane = row, into its own histogram
// (add_batch_wide: rows sharing a bin summed in row order, large groups in
// f64 registers). The block sums its warps' histograms in warp order: with
// one share straight into out, else into its share, and the last of the
// (f, w) blocks to arrive adds the shares to out in share order. A bin that
// no listed row reached is left alone (it would add +0.0, and out holds no
// -0.0). A fixed order of adds throughout, so two launches give the same
// bits.
template <typename G>
__global__ void __launch_bounds__(kSparseMaxWarps * kLanes)
hist_sparse_wide(const uint16_t* __restrict__ bins,
                 const G* __restrict__ gh, const int* __restrict__ counts,
                 const int* __restrict__ lists,
                 typename Gh<G>::Acc* __restrict__ share_h,
                 int* __restrict__ arrived,
                 typename Gh<G>::Acc* __restrict__ out, long long ld,
                 int num_bin, SparseWide sp, int blocks) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int win = sp.win, nw = sp.nw;
  const int tag_w = (win + 15) / 16 * 16;
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);          // [nw][win][3]
  unsigned char* s_tags = smem_raw + nw * win * 12;        // [nw][tag_w]
  uint16_t* s_bin = reinterpret_cast<uint16_t*>(s_tags + nw * tag_w);
  G* s_gh = reinterpret_cast<G*>(s_bin + kSparseChunk);    // [chunk][3]
  int* s_off = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(s_gh) +
      (kSparseChunk * kChannels * static_cast<int>(sizeof(G)) + 15) / 16 *
          16);                                              // [blocks + 1]
  int* s_last = s_off + (kMaxParts + 1 + 3) / 4 * 4;
  const int warp = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int fw = blockIdx.x;                 // f * n_win + w
  const int f = fw / sp.n_win, wi = fw - f * sp.n_win;
  const int b0 = wi * win, nb = min(win, num_bin - b0);
  const int nh = win * kChannels;
  wait_for_prior_grid();
  for (int g = threadIdx.x; g < blocks; g += blockDim.x) {
    s_off[g + 1] = __ldg(counts + g);
  }
  __syncthreads();
  if (warp == 0) {
    // s_off[g] = the rows listed by blocks before g
    int run = 0;
    for (int g0 = 0; g0 < blocks; g0 += kLanes) {
      int x = g0 + lane < blocks ? s_off[g0 + lane + 1] : 0;
#pragma unroll
      for (int d = 1; d < kLanes; d *= 2) {
        const int v = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += v;
      }
      if (g0 + lane < blocks) s_off[g0 + lane + 1] = run + x;
      run += __shfl_sync(kFull, x, kLanes - 1);
    }
    if (lane == 0) s_off[0] = 0;
  }
  __syncthreads();
  const int total = s_off[blocks];
  const int split = min(kSparseMaxSplit,
                        max(1, (total + nw * kSparseWarpRows - 1) /
                                   (nw * kSparseWarpRows)));
  const int share = blockIdx.y;
  if (total == 0 || share >= split) return;
  zero_hist_block(s_hist, nw * nh);
  const int per_share = (total + split - 1) / split;
  const int r0 = min(total, share * per_share);
  const int r1 = min(total, r0 + per_share);
  Acc* h = s_hist + warp * nh;
  unsigned char* tag = s_tags + warp * tag_w;
  const uint16_t* col = bins + static_cast<long long>(f) * ld;
  HotBins<Acc> hot;
  hot.clear();
  for (int c0 = r0; c0 < r1; c0 += kSparseChunk) {
    const int rows = min(kSparseChunk, r1 - c0);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
      int lo = 0, hi = blocks;          // the block that listed row c0 + i
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (s_off[mid] <= c0 + i) lo = mid; else hi = mid;
      }
      const long long r = __ldg(lists + static_cast<long long>(lo) *
                                            kSparseRows + c0 + i - s_off[lo]);
      s_bin[i] = __ldg(col + r);
#pragma unroll
      for (int c = 0; c < kChannels; ++c) {
        s_gh[i * kChannels + c] = gh[r * kChannels + c];
      }
    }
    __syncthreads();
    // warp k adds rows [k * per, (k + 1) * per) of the chunk
    const int per = (rows + nw - 1) / nw;
    const int i1 = min(rows, (warp + 1) * per);
    for (int j0 = warp * per; j0 < i1; j0 += kLanes) {
      add_batch_wide<G>(h, tag, hot,
                        [&](int j) { return static_cast<int>(s_bin[j]); },
                        [&](int j) { return s_gh + j * kChannels; }, b0, nb,
                        j0, i1);
    }
    __syncthreads();
  }
  hot.flush(h);
  __syncthreads();
  // the block's sum of its warps, in warp order
  auto block_sum = [&](int q) {
    Acc v = s_hist[q];
    for (int k = 1; k < nw; ++k) v += s_hist[k * nh + q];
    return v;
  };
  Acc* o = out + (static_cast<long long>(f) * num_bin + b0) * kChannels;
  if (split == 1) {
    for (int q = threadIdx.x; q < nb * kChannels; q += blockDim.x) {
      const Acc v = block_sum(q);
      if (v != Acc(0)) o[q] = o[q] + v;
    }
    return;
  }
  Acc* shares = share_h + static_cast<long long>(fw) * kSparseMaxSplit * nh;
  for (int q = threadIdx.x; q < nb * kChannels; q += blockDim.x) {
    shares[share * nh + q] = block_sum(q);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(arrived + fw, 1) == split - 1;
  __syncthreads();
  if (*s_last == 0) return;
  __threadfence();
  // the shares in share order, four adjacent accumulators a thread (16-byte
  // loads), every load of a round issued before its stores
  using V = typename Vec4<Acc>::T;
  const int n4 = (nb * kChannels + 3) / 4;
  constexpr int kAt = 4;
  for (int x0 = threadIdx.x; x0 < n4; x0 += kAt * blockDim.x) {
    V sum[kAt];
#pragma unroll
    for (int u = 0; u < kAt; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x >= n4) continue;
      const V* sh = reinterpret_cast<const V*>(shares) + x;
      sum[u] = __ldcg(sh);
      for (int k = 1; k < split; ++k) {
        const V a = __ldcg(sh + k * nh / 4);
        sum[u].x += a.x;
        sum[u].y += a.y;
        sum[u].z += a.z;
        sum[u].w += a.w;
      }
    }
#pragma unroll
    for (int u = 0; u < kAt; ++u) {
      const int x = x0 + u * blockDim.x;
      if (x >= n4) continue;
      const Acc e[4] = {sum[u].x, sum[u].y, sum[u].z, sum[u].w};
      for (int c = 0; c < 4 && 4 * x + c < nb * kChannels; ++c) {
        if (e[c] != Acc(0)) o[4 * x + c] = o[4 * x + c] + e[c];
      }
    }
  }
}

// ---- Host side -------------------------------------------------------------

// batch_masks over R rows (8 warps a block, at most 8,192 blocks), zeroing
// n_arrived arrival counters; returns the launch's error.
cudaError_t launch_masks(const void* leaf_id, long long leaf, long long R,
                         unsigned* masks, int* arrived, long long n_arrived,
                         cudaStream_t stream) {
  const long long n_batches = (R + kBatch - 1) / kBatch;
  const long long per_block = 8 * kMaskBatches;
  const int grid = static_cast<int>(
      min((n_batches + per_block - 1) / per_block, 8192LL));
  batch_masks<<<grid, 8 * kLanes, 0, stream>>>(
      static_cast<const long long*>(leaf_id), leaf, R, masks, arrived,
      static_cast<int>(n_arrived));
  return cudaGetLastError();
}

int g_shared_set[3][kMaxDevices];   // per mode, device
int g_sparse_set[3][kMaxDevices];
int g_wide_set[3][kMaxDevices];
int g_sparse_wide_set[3][kMaxDevices];

// The scratch of the grouped path (u8), in 4-byte words: the layout of
// the note at the top of this file, with one window of num_bin bins.
long long scratch_words(long long R, int F, int num_bin, long long blocks,
                        bool fused) {
  const Cols cols = make_cols(F, num_bin, num_bin);
  const long long n_parts = blocks * cols.count();
  long long words = n_parts * tile_slots(num_bin) + n_parts;
  if (fused) {
    words += n_parts * (1 + kSparseRows) + (R + kBatch - 1) / kBatch +
             static_cast<long long>(F) * (kSplit * num_bin * kChannels + 1);
  }
  return words;
}

template <typename G>
int plan(int num_bin, int mode, long long* blocks) {
  return static_cast<int>(resident_with(
      hist_featmajor_kernel<G>, g_shared_set[mode],
      hist_bytes(num_bin) + fm_fixed_bytes<G>(), blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, const void* leaf_id,
           long long leaf, int* scratch, void* out, long long R, long long ld,
           int F, int num_bin, int mode, long long blocks,
           long long rows_per_block, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  const int win = num_bin;
  const Cols cols = make_cols(F, num_bin, win);
  const bool fused = leaf_id != nullptr;
  const long long n_parts = blocks * cols.count();
  // the scratch layout of the note at the top of this file
  Acc* partials = reinterpret_cast<Acc*>(scratch);
  int* flags = scratch + n_parts * tile_slots(win);
  int* counts = flags + n_parts;
  int* lists = counts + (fused ? n_parts : 0);
  unsigned* masks = reinterpret_cast<unsigned*>(
      lists + (fused ? n_parts * kSparseRows : 0));
  Acc* share_h = reinterpret_cast<Acc*>(masks + (fused ? (R + kBatch - 1) /
                                                             kBatch : 0));
  const long long n_fw = static_cast<long long>(F) * cols.n_win;
  int* arrived = reinterpret_cast<int*>(
      share_h + (fused ? n_fw * kSplit * win * kChannels : 0));
  const int smem = hist_bytes(win) + fm_fixed_bytes<G>();
  cudaError_t err = allow_bytes(hist_featmajor_kernel<G>, g_shared_set[mode],
                                smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(bins) % 16 == 0) &&
                   (ld % 16 == 0);
  if (fused) {
    err = launch_masks(leaf_id, leaf, R, masks, arrived, n_fw, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(blocks),
            static_cast<unsigned>(cols.count()));
  err = launch_after(hist_featmajor_kernel<G>, grid, dim3(kLanes), smem,
                     stream, static_cast<const uint8_t*>(bins),
                     static_cast<const G*>(gh),
                     static_cast<const unsigned*>(fused ? masks : nullptr),
                     static_cast<Acc*>(out), partials, flags,
                     fused ? counts : static_cast<int*>(nullptr), lists, R,
                     ld, cols, rows_per_block, vec);
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  constexpr int kPerBlock = 4 * kReduceSlots;   // accumulators a block sums
  dim3 rgrid((tile_slots(win) + kPerBlock - 1) / kPerBlock,
             static_cast<unsigned>(cols.count()), 1);
  err = launch_after(reduce_flagged<Acc>, rgrid, dim3(kSegs * kReduceSlots),
                     0, stream, static_cast<const Acc*>(partials),
                     static_cast<const int*>(flags), static_cast<Acc*>(out),
                     static_cast<int>(blocks), cols);
  if (err != cudaSuccess || !fused) return static_cast<int>(err);
  const int sm = sparse_shared_bytes(win, blocks);
  err = allow_bytes(hist_sparse_kernel<G>, g_sparse_set[mode], sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(hist_sparse_kernel<G>,
                     dim3(static_cast<unsigned>(n_fw), kSplit),
                     dim3(kSparseWarps * kLanes), sm, stream,
                     static_cast<const uint8_t*>(bins),
                     static_cast<const G*>(gh),
                     static_cast<const int*>(counts),
                     static_cast<const int*>(lists), share_h, arrived,
                     static_cast<Acc*>(out), ld, cols,
                     static_cast<int>(blocks));
  return static_cast<int>(err);
}

// The wide path's scratch, in 4-byte words from the start of one buffer:
// partials [blocks * n_cols * col_slots] (blocks > 1), flags [blocks *
// n_cols], and when fused counts [blocks], lists [blocks * kSparseRows],
// the masks and the blocks' batch lists [ceil(R / 32)] each, the sparse
// pass's shares [F * n_win * kSparseMaxSplit * win * 3] and its arrival
// counters [F * n_win].
struct WideScratch {
  long long flags, counts, lists, masks, blist, shares, arrived, words;
};
inline WideScratch wide_scratch(long long R, const WideCols& c,
                                long long blocks, bool fused,
                                const SparseWide& sp) {
  WideScratch w;
  const long long n_parts = blocks * c.count();
  w.flags = blocks > 1 ? n_parts * col_slots(c) : 0;
  w.counts = w.flags + n_parts;
  const long long n_batches = (R + kBatch - 1) / kBatch;
  w.lists = w.counts + (fused ? blocks : 0);
  w.masks = w.lists + (fused ? blocks * kSparseRows : 0);
  w.blist = w.masks + (fused ? n_batches : 0);
  w.shares = (w.blist + (fused ? n_batches : 0) + 3) / 4 * 4;  // 16 B
  const long long n_fw = static_cast<long long>(c.F) * sp.n_win;
  w.arrived = w.shares +
              (fused ? n_fw * kSparseMaxSplit * sp.win * kChannels : 0);
  w.words = w.arrived + (fused ? n_fw : 0);
  return w;
}

template <typename G>
int plan_wide(int F, int mode, int ft, int win, int wpf, int stage_rows,
              int* optin, long long* blocks) {
  cudaError_t err = shared_optin(optin);
  if (err != cudaSuccess || ft <= 0) return static_cast<int>(err);
  const WideCols c = make_wide_cols(F, win, ft, win, wpf, stage_rows);
  return static_cast<int>(resident_threads(
      hist_featmajor_wide<G>, g_wide_set[mode], c.warps() * kLanes,
      fm_wide_shared_bytes<G>(c), blocks));
}

template <typename G>
long long wide_words(long long R, int F, int num_bin, int ft, int win,
                     int wpf, int stage_rows, long long blocks, bool fused,
                     int optin) {
  const WideCols c = make_wide_cols(F, num_bin, ft, win, wpf, stage_rows);
  return wide_scratch(R, c, blocks, fused,
                      sparse_wide_geometry<G>(num_bin, optin)).words;
}

template <typename G>
int launch_wide(const void* bins, const void* gh, const void* leaf_id,
                long long leaf, int* scratch, void* out, long long R,
                long long ld, int F, int num_bin, int mode, int ft, int win,
                int wpf, int stage_rows, long long blocks,
                long long rows_per_block, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  const WideCols cols = make_wide_cols(F, num_bin, ft, win, wpf, stage_rows);
  const bool fused = leaf_id != nullptr;
  int optin = 0;
  cudaError_t err = shared_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const SparseWide sp = sparse_wide_geometry<G>(num_bin, optin);
  const WideScratch w = wide_scratch(R, cols, blocks, fused, sp);
  Acc* partials = reinterpret_cast<Acc*>(scratch);
  int* flags = scratch + w.flags;
  int* counts = scratch + w.counts;
  int* lists = scratch + w.lists;
  unsigned* masks = reinterpret_cast<unsigned*>(scratch + w.masks);
  int* blist = scratch + w.blist;
  Acc* share_h = reinterpret_cast<Acc*>(scratch + w.shares);
  int* arrived = scratch + w.arrived;
  const int n_fw = F * sp.n_win;
  const int smem = fm_wide_shared_bytes<G>(cols);
  err = allow_bytes(hist_featmajor_wide<G>, g_wide_set[mode], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(bins) % 16 == 0) &&
                   (ld % 8 == 0);
  if (fused) {
    err = launch_masks(leaf_id, leaf, R, masks, arrived, n_fw, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(blocks),
            static_cast<unsigned>(cols.count()));
  err = launch_after(hist_featmajor_wide<G>, grid,
                     dim3(cols.warps() * kLanes), smem, stream,
                     static_cast<const uint16_t*>(bins),
                     static_cast<const G*>(gh),
                     static_cast<const unsigned*>(fused ? masks : nullptr),
                     static_cast<Acc*>(out), partials, flags, counts, lists,
                     blist, R, ld, cols, rows_per_block, vec);
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  constexpr int kPerBlock = 4 * kReduceSlots;   // accumulators a block sums
  dim3 rgrid((col_slots(cols) + kPerBlock - 1) / kPerBlock,
             static_cast<unsigned>(cols.count()), 1);
  err = launch_after(reduce_flagged<Acc, WideCols>, rgrid,
                     dim3(kSegs * kReduceSlots), 0, stream,
                     static_cast<const Acc*>(partials),
                     static_cast<const int*>(flags), static_cast<Acc*>(out),
                     static_cast<int>(blocks), cols);
  if (err != cudaSuccess || !fused) return static_cast<int>(err);
  const int sm = sparse_wide_bytes<G>(sp);
  err = allow_bytes(hist_sparse_wide<G>, g_sparse_wide_set[mode], sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(hist_sparse_wide<G>,
                     dim3(static_cast<unsigned>(n_fw), kSparseMaxSplit),
                     dim3(sp.nw * kLanes), sm, stream,
                     static_cast<const uint16_t*>(bins),
                     static_cast<const G*>(gh),
                     static_cast<const int*>(counts),
                     static_cast<const int*>(lists), share_h, arrived,
                     static_cast<Acc*>(out), ld, num_bin, sp,
                     static_cast<int>(blocks));
  return static_cast<int>(err);
}

// f32 and int8 gh only: the full path never builds bf16 histograms.
bool valid(int num_bin, int mode, int bin_bytes) {
  return valid_args(num_bin, mode, bin_bytes) && mode != kBF16;
}

// fn<G>(args...) for the gh mode (f32 or int8)
#define LGBM_DISPATCH_FM(fn, mode, ...)                                    \
  ((mode) == kF32 ? fn<float>(__VA_ARGS__) : fn<int8_t>(__VA_ARGS__))

// The arguments every launch checks: rows, stride, grid, leaf, alignment.
bool valid_launch(const void* gh, const void* leaf_id, long long leaf,
                  const void* scratch, long long R, long long ld, int F,
                  long long blocks, long long rows_per_block) {
  return R > 0 && ld >= R && F > 0 && blocks >= 1 && blocks <= kMaxParts &&
         rows_per_block >= kBatch && rows_per_block % kBatch == 0 &&
         blocks * rows_per_block >= R && leaf >= 0 &&
         (leaf_id == nullptr || R <= 0x7fffffffLL) &&
         reinterpret_cast<uintptr_t>(gh) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
}

}  // namespace

extern "C" {

// The grouped path's plan (u8 bins) in `mode` on `device` at num_bin
// bins (F features; its shared memory does not depend on F): the blocks
// resident on the device at once (*blocks), with which the caller sizes
// its grid. Returns a cudaError_t.
int lgbm_hist_featmajor_plan(int num_bin, int F, int mode, int device,
                             long long* blocks) {
  if (!valid(num_bin, mode, 1) || F <= 0) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_FM(plan, mode, num_bin, mode, blocks);
}

// 4-byte words of scratch that lgbm_hist_featmajor needs (the layout of
// the note at the top of this file), for `fused` != 0 when leaf_id is
// given.
long long lgbm_hist_featmajor_scratch_words(long long R, int F, int num_bin,
                                            long long blocks, int fused) {
  return scratch_words(R, F, num_bin, blocks, fused != 0);
}

// The grouped path (u8 bins): the histogram over `blocks` row slices of
// rows_per_block rows (a multiple of 32; blocks * rows_per_block >= R) per
// feature tile and, for blocks > 1, the reduction of their partials, on
// `stream`; returns cudaGetLastError() (0 = ok). leaf_id may be null
// (every row is added); otherwise only rows with leaf_id == leaf >= 0 (R
// < 2^31): batch_masks writes the rows' masks first, and for blocks > 1
// the sparse pass adds the rows of the blocks that listed them last.
// `scratch` (16-byte aligned) holds lgbm_hist_featmajor_scratch_words
// words. gh must be 16-byte aligned. Launches on `device`; the device
// current before the call is current again after it.
int lgbm_hist_featmajor(const void* bins, const void* gh, const void* leaf_id,
                        long long leaf, void* scratch, void* out, long long R,
                        long long ld, int F, int num_bin, int mode,
                        long long blocks, long long rows_per_block,
                        int device, void* stream) {
  if (!valid(num_bin, mode, 1) ||
      !valid_launch(gh, leaf_id, leaf, scratch, R, ld, F, blocks,
                    rows_per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_FM(launch, mode, bins, gh, leaf_id, leaf,
                          static_cast<int*>(scratch), out, R, ld, F, num_bin,
                          mode, blocks, rows_per_block,
                          static_cast<cudaStream_t>(stream));
}

// The wide path's plan (u16 bins) on `device`: the opt-in shared bytes of
// a block (*optin) and, for ft > 0, the blocks of the geometry (ft
// features a tile, windows of win bins, wpf warps a feature, stage_rows
// rows a stage) resident on the device at once (*blocks). Returns a
// cudaError_t.
int lgbm_hist_featmajor_wide_plan(int F, int mode, int ft, int win, int wpf,
                                  int stage_rows, int device, int* optin,
                                  long long* blocks) {
  if (!valid(1, mode, 2) ||
      (ft > 0 && !valid_wide(F, 1, ft, win, wpf, stage_rows))) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_FM(plan_wide, mode, F, mode, ft, win, wpf, stage_rows,
                          optin, blocks);
}

// 4-byte words of scratch that lgbm_hist_featmajor_wide needs on `device`
// (wide_scratch's layout); -1 if the device cannot be asked.
long long lgbm_hist_featmajor_wide_scratch_words(long long R, int F,
                                                 int num_bin, int mode,
                                                 int ft, int win, int wpf,
                                                 int stage_rows,
                                                 long long blocks, int fused,
                                                 int device) {
  const OnDevice on(device);
  int optin = 0;
  if (on.err != cudaSuccess || shared_optin(&optin) != cudaSuccess ||
      !valid(num_bin, mode, 2)) {
    return -1;
  }
  return LGBM_DISPATCH_FM(wide_words, mode, R, F, num_bin, ft, win, wpf,
                          stage_rows, blocks, fused != 0, optin);
}

// The wide path (u16 bins): as lgbm_hist_featmajor, over columns of ft
// features a tile and windows of win bins (wpf warps a feature, stage_rows
// rows a stage, from the plan); `scratch` holds
// lgbm_hist_featmajor_wide_scratch_words words.
int lgbm_hist_featmajor_wide(const void* bins, const void* gh,
                             const void* leaf_id, long long leaf,
                             void* scratch, void* out, long long R,
                             long long ld, int F, int num_bin, int mode,
                             int ft, int win, int wpf, int stage_rows,
                             long long blocks, long long rows_per_block,
                             int device, void* stream) {
  if (!valid(num_bin, mode, 2) ||
      !valid_wide(F, num_bin, ft, win, wpf, stage_rows) ||
      !valid_launch(gh, leaf_id, leaf, scratch, R, ld, F, blocks,
                    rows_per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH_FM(launch_wide, mode, bins, gh, leaf_id, leaf,
                          static_cast<int*>(scratch), out, R, ld, F, num_bin,
                          mode, ft, win, wpf, stage_rows, blocks,
                          rows_per_block, static_cast<cudaStream_t>(stream));
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
