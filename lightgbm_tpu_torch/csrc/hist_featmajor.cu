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
// us for a 1M-row f32 leaf. Its 3*S*F adds are far below the card's
// rate, so memory bounds it.
//
// Design. A first kernel, batch_masks, reads every row's leaf id once (a
// warp per four 32-row batches, many warps per SM, coalesced) and writes one
// 32-bit mask per batch: bit j set when row j is in the leaf. Each block
// of the histogram kernel owns a slice of rows, a whole number of
// batches, and reads its batches' masks 32 at a time (one load a lane,
// the next 32 loading while the current ones are added). A batch with
// no row of the leaf issues no bin or gh load and no add. The
// others are copied into a shared-memory ring with cp.async, kRing
// batches ahead of the one being added: in the feature-major layout lane
// l's 32 bins of a batch are contiguous, two 16-byte copies in u8 and
// four in u16 (bins + f*ld + base 16-byte aligned: the pointer is, ld is
// a multiple of 16 elements from feature_major_bins in ops/hist_cuda.py,
// and base % 32 == 0; element by element at a ragged edge or an
// unaligned stride), and the batch's gh is contiguous too. The block
// body is hist_grouped.cuh: one warp, lane = feature, a private
// [win][32][3] shared histogram over its column's bin window (all the
// bins in one window wherever they fit), the leaf's rows
// of a batch added four at a time (a group with none is skipped), their
// slots loaded together and sums of the same slot forwarded in row
// order; no float atomics, so two launches give the same bits.
// A block that met no row of the leaf writes no partial (its flag says
// so), and reduce_flagged sums the partials of the others in a fixed
// order (runs of consecutive blocks in parallel, then the runs in order).
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
// Scratch, in 4-byte words from one caller buffer (16-byte aligned), with
// n_cols = n_ftiles * n_win histogram columns (feature tile x bin
// window): partials [blocks * n_cols * tile_slots(win)], flags [blocks *
// n_cols], and when leaf_id is given counts [blocks * n_cols], lists
// [blocks * n_cols * kSparseRows], masks [ceil(R / 32)], the sparse
// pass's shares [F * n_win * kSplit * win * 3] and its arrival counters
// [F * n_win].
#include "hist_grouped.cuh"

namespace {

using namespace lgbm;

constexpr int kAhead = kLanes;       // batches whose masks load at once
constexpr int kRing = 2 * kStages;   // batches staged ahead: sparse leaves
                                     // leave few batches to overlap
constexpr int kSparseRows = 64;      // rows a block hands on, at most
constexpr int kHeld = 4;             // chunks of masks a block keeps

// Bytes of a batch's staging slot: every lane's 32 bins, then the rows' gh.
template <typename BinT>
__host__ __device__ constexpr int fm_bins_slot() {
  return kLanes * kBatch * static_cast<int>(sizeof(BinT));
}
template <typename G, typename BinT>
__host__ __device__ constexpr int fm_slot_bytes() {
  return fm_bins_slot<BinT>() +
         (kBatch * kChannels * static_cast<int>(sizeof(G)) + 15) / 16 * 16;
}
// Shared memory beside the histogram: the ring and the masks.
template <typename G, typename BinT>
inline int fm_fixed_bytes() {
  return kRing * fm_slot_bytes<G, BinT>() + (kRing + kAhead) * 4;
}

// Where lane l keeps 16-byte chunk c of its 32 bins (32 * sizeof(BinT)
// bytes) in a slot: the chunks of neighbouring lanes swapped so that a
// quarter warp's 16-byte reads touch all 32 banks once.
template <typename BinT>
__device__ __forceinline__ int bins_at(int lane, int c) {
  return sizeof(BinT) == 1 ? lane * 32 + 16 * (c ^ ((lane >> 2) & 1))
                           : lane * 64 + 16 * (c ^ ((lane >> 1) & 3));
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

template <typename G, typename BinT>
__global__ void __launch_bounds__(kLanes)
hist_featmajor_kernel(const BinT* __restrict__ bins,
                      const G* __restrict__ gh,
                      const unsigned* __restrict__ masks,
                      typename Gh<G>::Acc* __restrict__ out,
                      typename Gh<G>::Acc* __restrict__ partials,
                      int* __restrict__ flags, int* __restrict__ counts,
                      int* __restrict__ lists, long long R, long long ld,
                      Cols cols, long long rows_per_block, bool vec) {
  using Acc = typename Gh<G>::Acc;
  constexpr int kPer = 4 / static_cast<int>(sizeof(BinT));  // bins a word
  constexpr int kChunks = 2 * static_cast<int>(sizeof(BinT));  // 16 B each
  constexpr unsigned kBinMask = sizeof(BinT) == 1 ? 0xffu : 0xffffu;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  unsigned char* ring = smem_raw + hist_bytes(cols.win);
  constexpr int slot = fm_slot_bytes<G, BinT>();
  unsigned* s_mask = reinterpret_cast<unsigned*>(ring + kRing * slot);
  unsigned* s_chunk = s_mask + kRing;        // the masks of a chunk
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
        cp_async16(sl + bins_at<BinT>(lane, c),
                   reinterpret_cast<const unsigned char*>(col + base) +
                       16 * c);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kBatch; ++j) {
        const int byte = j * static_cast<int>(sizeof(BinT));
        *reinterpret_cast<BinT*>(sl + bins_at<BinT>(lane, byte >> 4) +
                                 (byte & 15)) =
            base + j < p1 ? __ldg(col + base + j) : BinT(0);
      }
    }
    unsigned char* sg = sl + fm_bins_slot<BinT>();
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
  for (int i = 0; i < staged; ++i) {
    long long base;
    unsigned mask;
    if (next_batch(base, mask)) stage(staged++ % kRing, base, mask);
    cp_async_commit();
    cp_async_wait<kRing - 1>();
    __syncwarp();
    const unsigned char* sl = ring + (i % kRing) * slot;
    const unsigned cur = s_mask[i % kRing];
    uint32_t w[8 * sizeof(BinT)];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 a =
          *reinterpret_cast<const uint4*>(sl + bins_at<BinT>(lane, c));
      w[4 * c] = a.x;
      w[4 * c + 1] = a.y;
      w[4 * c + 2] = a.z;
      w[4 * c + 3] = a.w;
    }
    const G* sg = reinterpret_cast<const G*>(sl + fm_bins_slot<BinT>());
    any |= cur;
#pragma unroll
    for (int j0 = 0; j0 < kBatch; j0 += kGroup) {
      if ((cur >> j0) & ((1u << kGroup) - 1u)) {   // warp-uniform
        add_group(hist, lane, lim, j0,
                  [&](int j) {
                    const int v = static_cast<int>(
                        (w[j / kPer] >> (8 * sizeof(BinT) * (j % kPer))) &
                        kBinMask);
                    return ((cur >> j) & 1u) ? v - b0 : skip;
                  },
                  [&](int j, int c) {
                    return GhShared<G>::load(sg + j * kChannels + c);
                  });
      }
    }
    __syncwarp();
  }
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
template <typename BinT>
inline int sparse_shared_bytes(int win, long long blocks) {
  return kSparseWarps * win * kChannels * 4 +
         kChunkRows * (kChannels * 4 + static_cast<int>(sizeof(BinT))) +
         static_cast<int>(blocks + 1) * 4;
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
template <typename G, typename BinT>
__global__ void __launch_bounds__(kSparseWarps * kLanes)
hist_sparse_kernel(const BinT* __restrict__ bins,
                   const G* __restrict__ gh, const int* __restrict__ counts,
                   const int* __restrict__ lists,
                   typename Gh<G>::Acc* __restrict__ share_h,
                   int* __restrict__ arrived,
                   typename Gh<G>::Acc* __restrict__ out, long long ld,
                   Cols cols, int blocks) {
  using Acc = typename Gh<G>::Acc;
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

int g_shared_set[3][2][kMaxDevices];   // per mode, bin width, device
int g_sparse_set[3][2][kMaxDevices];

template <typename G, typename BinT>
int plan(int num_bin, int mode, int max_win, int* win, long long* blocks) {
  // the sparse pass's per-warp histograms share the window
  int optin = 0;
  cudaError_t err = shared_optin(&optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int by_sparse = (optin - sparse_shared_bytes<BinT>(0, kMaxParts)) /
                        (kSparseWarps * kChannels * 4);
  err = plan_window(num_bin, max_win < by_sparse ? max_win
                                                             : by_sparse,
                                fm_fixed_bytes<G, BinT>(), win);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(resident_with(
      hist_featmajor_kernel<G, BinT>, g_shared_set[mode][sizeof(BinT) - 1],
      hist_bytes(*win) + fm_fixed_bytes<G, BinT>(), blocks));
}

template <typename G, typename BinT>
int launch(const void* bins, const void* gh, const void* leaf_id,
           long long leaf, int* scratch, void* out, long long R, long long ld,
           int F, int num_bin, int mode, int win, long long blocks,
           long long rows_per_block, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
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
  const int smem = hist_bytes(win) + fm_fixed_bytes<G, BinT>();
  cudaError_t err = allow_bytes(hist_featmajor_kernel<G, BinT>,
                                g_shared_set[mode][sizeof(BinT) - 1], smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(bins) % 16 == 0) &&
                   ((ld * static_cast<long long>(sizeof(BinT))) % 16 == 0);
  if (fused) {
    const long long n_batches = (R + kBatch - 1) / kBatch;
    const long long per_block = 8 * kMaskBatches;   // 8 warps a block
    const int mgrid = static_cast<int>(
        min((n_batches + per_block - 1) / per_block, 8192LL));
    batch_masks<<<mgrid, 8 * kLanes, 0, stream>>>(
        static_cast<const long long*>(leaf_id), leaf, R, masks, arrived,
        static_cast<int>(n_fw));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(blocks),
            static_cast<unsigned>(cols.count()));
  err = launch_after(hist_featmajor_kernel<G, BinT>, grid, dim3(kLanes), smem,
                     stream, static_cast<const BinT*>(bins),
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
  const int sm = sparse_shared_bytes<BinT>(win, blocks);
  err = allow_bytes(hist_sparse_kernel<G, BinT>,
                    g_sparse_set[mode][sizeof(BinT) - 1], sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(hist_sparse_kernel<G, BinT>,
                     dim3(static_cast<unsigned>(n_fw), kSplit),
                     dim3(kSparseWarps * kLanes), sm, stream,
                     static_cast<const BinT*>(bins),
                     static_cast<const G*>(gh),
                     static_cast<const int*>(counts),
                     static_cast<const int*>(lists), share_h, arrived,
                     static_cast<Acc*>(out), ld, cols,
                     static_cast<int>(blocks));
  return static_cast<int>(err);
}

// f32 and int8 gh only: the full path never builds bf16 histograms.
bool valid(int num_bin, int mode, int bin_bytes) {
  return valid_args(num_bin, mode, bin_bytes) && mode != kBF16;
}

// fn<G, BinT>(args...) for the gh mode and the bin width
#define LGBM_DISPATCH2(fn, mode, bin_bytes, ...)                            \
  ((bin_bytes) == 1                                                        \
       ? ((mode) == kF32 ? fn<float, uint8_t>(__VA_ARGS__)                 \
                         : fn<int8_t, uint8_t>(__VA_ARGS__))               \
       : ((mode) == kF32 ? fn<float, uint16_t>(__VA_ARGS__)                \
                         : fn<int8_t, uint16_t>(__VA_ARGS__)))

}  // namespace

extern "C" {

// The plan of the kernel in `mode` on `device` at num_bin bins of
// bin_bytes (1 or 2): its bin window (at most max_win bins; *win) and the
// blocks resident on the device at once (*blocks), with which the caller
// sizes its grid. Returns a cudaError_t.
int lgbm_hist_featmajor_plan(int num_bin, int mode, int bin_bytes,
                             int max_win, int device, int* win,
                             long long* blocks) {
  if (!valid(num_bin, mode, bin_bytes) || max_win < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH2(plan, mode, bin_bytes, num_bin, mode, max_win, win,
                       blocks);
}

// 4-byte words of scratch that lgbm_hist_featmajor needs (the layout of
// the note at the top of this file), for `fused` != 0 when leaf_id is
// given.
long long lgbm_hist_featmajor_scratch_words(long long R, int F, int num_bin,
                                            int win, long long blocks,
                                            int fused) {
  const Cols cols = make_cols(F, num_bin, win);
  const long long n_parts = blocks * cols.count();
  long long words = n_parts * tile_slots(win) + n_parts;
  if (fused) {
    const long long n_fw = static_cast<long long>(F) * cols.n_win;
    words += n_parts * (1 + kSparseRows) + (R + kBatch - 1) / kBatch +
             n_fw * (kSplit * win * kChannels + 1);
  }
  return words;
}

// Launches the histogram over `blocks` row slices of rows_per_block rows
// (a multiple of 32; blocks * rows_per_block >= R) per column (feature
// tile x window of `win` bins, from the plan) and, for blocks > 1, the
// reduction of their partials, on `stream`; returns cudaGetLastError()
// (0 = ok). leaf_id may be null (every row is added); otherwise only
// rows with leaf_id == leaf >= 0 (R < 2^31): batch_masks writes the
// rows' masks first, and for blocks > 1 the sparse pass adds the rows of
// the blocks that listed them last. `scratch` (16-byte aligned) holds
// lgbm_hist_featmajor_scratch_words words. gh must be 16-byte aligned.
// Launches on `device`; the device current before the call is current
// again after it.
int lgbm_hist_featmajor(const void* bins, const void* gh, const void* leaf_id,
                        long long leaf, void* scratch, void* out, long long R,
                        long long ld, int F, int num_bin, int mode,
                        int bin_bytes, int win, long long blocks,
                        long long rows_per_block, int device, void* stream) {
  if (!valid(num_bin, mode, bin_bytes) || R <= 0 || ld < R || F <= 0 ||
      win < 1 || blocks < 1 || blocks > kMaxParts ||
      rows_per_block < kBatch || rows_per_block % kBatch != 0 ||
      blocks * rows_per_block < R || leaf < 0 ||
      (leaf_id != nullptr && R > 0x7fffffffLL) ||
      reinterpret_cast<uintptr_t>(gh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  return LGBM_DISPATCH2(launch, mode, bin_bytes, bins, gh, leaf_id, leaf,
                       static_cast<int*>(scratch), out, R, ld, F, num_bin,
                       mode, win, blocks, rows_per_block,
                       static_cast<cudaStream_t>(stream));
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
