// Kernel B2 for Hopper (sm_90a): histogram of (grad, hess, count) over
// the rows of one leaf, given FEATURE-major [F, R] uint8 bins and each
// row's leaf id, in two modes.
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
//   bins:    uint8, row f of the [F, R] matrix at bins + f * ld (ld >= R);
//            values >= num_bin are skipped
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
// ids) + S*(F + 3*sizeof(gh)) (the leaf's S rows) + 12*F*num_bin (out).
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
// l's 32 bytes of a batch are contiguous, two 16-byte copies (bins +
// f*ld + base 16-byte aligned: the pointer is, ld % 16 == 0 from
// feature_major_bins in ops/hist_cuda.py, and base % 32 == 0; byte by
// byte at a ragged edge or an unaligned stride), and the batch's gh is
// contiguous too. The block body is hist_grouped.cuh: one warp, lane =
// feature, a private [num_bin][32][3] shared histogram, the leaf's rows
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
// Scratch, in 4-byte words from one caller buffer (16-byte aligned):
// partials [blocks * n_ftiles * tile_slots], flags [blocks * n_ftiles],
// and when leaf_id is given counts [blocks * n_ftiles], lists [blocks *
// n_ftiles * kSparseRows], masks [ceil(R / 32)], the sparse pass's shares
// [F * kSplit * num_bin * 3] and its arrival counters [F].
#include "hist_grouped.cuh"

namespace {

using namespace lgbm;

constexpr int kAhead = kLanes;       // batches whose masks load at once
constexpr int kRing = 2 * kStages;   // batches staged ahead: sparse leaves
                                     // leave few batches to overlap
constexpr int kBinsSlot = kLanes * kBatch;   // a lane's 32 bins, per lane
constexpr int kSparseRows = 64;      // rows a block hands on, at most
constexpr int kHeld = 4;             // chunks of masks a block keeps

// Bytes of a batch's staging slot: every lane's 32 bins, then the rows' gh.
template <typename G>
__host__ __device__ constexpr int fm_slot_bytes() {
  return kBinsSlot + (kBatch * kChannels * static_cast<int>(sizeof(G)) + 15) /
                         16 * 16;
}
template <typename G>
inline int fm_shared_bytes(int num_bin) {
  return hist_bytes(num_bin) + kRing * fm_slot_bytes<G>() +
         (kRing + kAhead) * 4;
}

// Where lane l keeps 16-byte half c of its 32 bins in a slot: the halves
// of lanes 4..7 of every 8 swapped, so that a quarter warp's 16-byte reads
// touch all 32 banks once.
__device__ __forceinline__ int bins_at(int lane, int c) {
  return lane * kBatch + 16 * (c ^ ((lane >> 2) & 1));
}

// masks[b] = the rows of batch b (rows 32b .. 32b + 31 below R) whose leaf
// id is `leaf`, as bits. A warp takes kMaskBatches consecutive batches at
// a time (their loads in flight together), grid-stride. Block 0 also
// zeroes the sparse pass's F arrival counters.
constexpr int kMaskBatches = 4;
__global__ void batch_masks(const long long* __restrict__ leaf_id,
                            long long leaf, long long R,
                            unsigned* __restrict__ masks,
                            int* __restrict__ arrived, int F) {
  if (blockIdx.x == 0) {
    for (int f = threadIdx.x; f < F; f += blockDim.x) arrived[f] = 0;
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
                      int F, int ft, int num_bin, long long rows_per_block,
                      bool vec) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = reinterpret_cast<Acc*>(smem_raw);
  unsigned char* ring = smem_raw + hist_bytes(num_bin);
  constexpr int slot = fm_slot_bytes<G>();
  unsigned* s_mask = reinterpret_cast<unsigned*>(ring + kRing * slot);
  unsigned* s_chunk = s_mask + kRing;        // the masks of a chunk
  const int lane = threadIdx.x;
  const int f0 = blockIdx.y * ft;
  const int ftl = min(ft, F - f0);
  const bool active = lane < ftl;
  const int lane_bins = active ? num_bin : 0;   // inactive lanes add nothing
  const long long p0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long p1 = min(R, p0 + rows_per_block);
  const long long part =
      static_cast<long long>(blockIdx.x) * gridDim.y + blockIdx.y;
  wait_for_prior_grid();
  // inactive lanes read feature f0's row and add nothing
  const uint8_t* col = bins + static_cast<long long>(f0 + (active ? lane : 0))
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
  zero_hist_vec(hist, num_bin);
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
  // copy a batch's bins and gh into slot k (byte by byte where 16-byte
  // copies cannot be made)
  auto stage = [&](int k, long long base, unsigned mask) {
    unsigned char* sl = ring + k * slot;
    const bool whole = base + kBatch <= p1;
    if (vec && whole) {
      cp_async16(sl + bins_at(lane, 0), col + base);
      cp_async16(sl + bins_at(lane, 1), col + base + 16);
    } else {
#pragma unroll 4
      for (int j = 0; j < kBatch; ++j) {
        sl[bins_at(lane, j >> 4) + (j & 15)] =
            base + j < p1 ? __ldg(col + base + j) : 0;
      }
    }
    unsigned char* sg = sl + kBinsSlot;
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
    uint32_t w[8];
    const uint4 a = *reinterpret_cast<const uint4*>(sl + bins_at(lane, 0));
    const uint4 b = *reinterpret_cast<const uint4*>(sl + bins_at(lane, 1));
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    const G* sg = reinterpret_cast<const G*>(sl + kBinsSlot);
    any |= cur;
#pragma unroll
    for (int j0 = 0; j0 < kBatch; j0 += kGroup) {
      if ((cur >> j0) & ((1u << kGroup) - 1u)) {   // warp-uniform
        add_group(hist, lane, lane_bins, j0,
                  [&](int j) {
                    return ((cur >> j) & 1u)
                               ? static_cast<int>(
                                     (w[j / 4] >> (8 * (j % 4))) & 0xffu)
                               : lane_bins;
                  },
                  [&](int j, int c) {
                    return GhShared<G>::load(sg + j * kChannels + c);
                  });
      }
    }
    __syncwarp();
  }
  if (gridDim.x == 1) {
    write_out_slots(hist, out, f0, ftl, num_bin);
    return;
  }
  if (lane == 0) flags[part] = any != 0u ? 1 : 0;
  if (any != 0u) {
    write_partial_vec(hist, partials + part * tile_slots(num_bin), num_bin);
  }
}

constexpr int kSparseWarps = 16;     // the sparse pass's warps a block
constexpr int kChunkRows = 4096;     // listed rows it stages at a time
constexpr int kRowsPerThread = kChunkRows / (kSparseWarps * kLanes);
constexpr int kSplit = 8;            // blocks sharing a feature's rows

// Bytes of the sparse pass's shared memory at num_bin bins and `blocks`
// listing blocks: a [num_bin][3] histogram per warp, a chunk's rows' bins
// and gh (widened), and the blocks' row offsets.
inline int sparse_shared_bytes(int num_bin, long long blocks) {
  return kSparseWarps * num_bin * kChannels * 4 +
         kChunkRows * (1 + kChannels * 4) + static_cast<int>(blocks + 1) * 4;
}

// out[f] += the histogram of the rows that blocks listed (counts[g *
// n_ftiles + t] of them at lists + (g * n_ftiles + t) * kSparseRows, t
// = f's tile), for feature f = blockIdx.x, after reduce_flagged wrote the
// other blocks' sum to out. The listed rows, in block order and row
// order, are cut into kSplit equal shares, one per block (f, s =
// blockIdx.y), so that many SMs gather them. A block gathers its share's
// bins of f and gh into shared memory, a chunk at a time, and warp w adds
// its part of the chunk, 32 rows at a time, to its own histogram: the
// rows of a batch that share a bin (__match_any_sync) are summed in row
// order by the first of them, which alone adds the sum to the bin. The
// block sums its warps' histograms in warp order into share_h[f][s]; the
// last of f's blocks to arrive adds the shares to out[f] in share order.
// A fixed order of adds throughout, so two launches give the same bits; a
// bin no listed row reached adds +0.0, which changes no bit.
template <typename G>
__global__ void __launch_bounds__(kSparseWarps * kLanes)
hist_sparse_kernel(const uint8_t* __restrict__ bins,
                   const G* __restrict__ gh, const int* __restrict__ counts,
                   const int* __restrict__ lists,
                   typename Gh<G>::Acc* __restrict__ share_h,
                   int* __restrict__ arrived,
                   typename Gh<G>::Acc* __restrict__ out, long long ld,
                   int ft, int n_ftiles, int num_bin, int blocks) {
  using Acc = typename Gh<G>::Acc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* s_hist = reinterpret_cast<Acc*>(smem_raw);
  Acc* s_gh = s_hist + kSparseWarps * num_bin * kChannels;
  int* s_off = reinterpret_cast<int*>(s_gh + kChunkRows * kChannels);
  uint8_t* s_bin = reinterpret_cast<uint8_t*>(s_off + blocks + 1);
  __shared__ bool s_last;
  const int f = blockIdx.x, t = f / ft, share = blockIdx.y;
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int nh = num_bin * kChannels;
  wait_for_prior_grid();
  for (int g = threadIdx.x; g < blocks; g += blockDim.x) {
    s_off[g + 1] = __ldg(counts + g * n_ftiles + t);
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
  const uint8_t* col = bins + static_cast<long long>(f) * ld;
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
        row[k] = __ldg(lists + (static_cast<long long>(lo) * n_ftiles + t) *
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
      const int b = i < i1 ? s_bin[i] : num_bin;
      const bool adds = b < num_bin;
      // rows that add nothing each get a key of their own
      const unsigned peers = __match_any_sync(kFull, adds ? b : 256 + lane);
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
  Acc* mine = share_h + (static_cast<long long>(f) * kSplit + share) * nh;
  for (int q = threadIdx.x; q < nh; q += blockDim.x) {
    Acc sum = s_hist[q];
    for (int w = 1; w < kSparseWarps; ++w) sum += s_hist[w * nh + q];
    mine[q] = sum;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(arrived + f, 1) == kSplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const Acc* shares = share_h + static_cast<long long>(f) * kSplit * nh;
  Acc* o = out + static_cast<long long>(f) * nh;
  for (int q = threadIdx.x; q < nh; q += blockDim.x) {
    Acc sum = __ldcg(shares + q);
#pragma unroll
    for (int k = 1; k < kSplit; ++k) sum += __ldcg(shares + k * nh + q);
    o[q] = o[q] + sum;
  }
}

int g_shared_set[3][kMaxDevices];   // per mode, per device
int g_sparse_set[3][kMaxDevices];

template <typename G>
int resident(int num_bin, int mode, long long* blocks) {
  return static_cast<int>(resident_with(hist_featmajor_kernel<G>,
                                        g_shared_set[mode],
                                        fm_shared_bytes<G>(num_bin), blocks));
}

template <typename G>
int launch(const void* bins, const void* gh, const void* leaf_id,
           long long leaf, int* scratch, void* out, long long R, long long ld,
           int F, int num_bin, int mode, long long blocks,
           long long rows_per_block, cudaStream_t stream) {
  using Acc = typename Gh<G>::Acc;
  int ft = 0, n_ftiles = 0;
  feature_tiles(F, &ft, &n_ftiles);
  const bool fused = leaf_id != nullptr;
  const long long n_parts = blocks * n_ftiles;
  // the scratch layout of the note at the top of this file
  Acc* partials = reinterpret_cast<Acc*>(scratch);
  int* flags = scratch + n_parts * tile_slots(num_bin);
  int* counts = flags + n_parts;
  int* lists = counts + (fused ? blocks * n_ftiles : 0);
  unsigned* masks = reinterpret_cast<unsigned*>(
      lists + (fused ? blocks * n_ftiles * kSparseRows : 0));
  Acc* share_h = reinterpret_cast<Acc*>(masks + (fused ? (R + kBatch - 1) /
                                                             kBatch : 0));
  int* arrived = reinterpret_cast<int*>(
      share_h + (fused ? F * kSplit * num_bin * kChannels : 0));
  const int smem = fm_shared_bytes<G>(num_bin);
  cudaError_t err = allow_bytes(hist_featmajor_kernel<G>, g_shared_set[mode],
                                smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(bins) % 16 == 0) &&
                   (ld % 16 == 0);
  if (fused) {
    const long long n_batches = (R + kBatch - 1) / kBatch;
    const long long per_block = 8 * kMaskBatches;   // 8 warps a block
    const int mgrid = static_cast<int>(
        min((n_batches + per_block - 1) / per_block, 8192LL));
    batch_masks<<<mgrid, 8 * kLanes, 0, stream>>>(
        static_cast<const long long*>(leaf_id), leaf, R, masks, arrived, F);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_ftiles));
  err = launch_after(hist_featmajor_kernel<G>, grid, dim3(kLanes), smem,
                     stream, static_cast<const uint8_t*>(bins),
                     static_cast<const G*>(gh), fused ? masks : nullptr,
                     static_cast<Acc*>(out), partials, flags,
                     fused ? counts : nullptr, lists, R, ld, F, ft, num_bin,
                     rows_per_block, vec);
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  constexpr int kPerBlock = 4 * kReduceSlots;   // accumulators a block sums
  dim3 rgrid((tile_slots(num_bin) + kPerBlock - 1) / kPerBlock,
             static_cast<unsigned>(n_ftiles), 1);
  err = launch_after(reduce_flagged<Acc>, rgrid, dim3(kSegs * kReduceSlots),
                     0, stream, static_cast<const Acc*>(partials),
                     static_cast<const int*>(flags), static_cast<Acc*>(out),
                     static_cast<int>(blocks), F, ft, n_ftiles, num_bin);
  if (err != cudaSuccess || !fused) return static_cast<int>(err);
  const int sm = sparse_shared_bytes(num_bin, blocks);
  err = allow_bytes(hist_sparse_kernel<G>, g_sparse_set[mode], sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_after(hist_sparse_kernel<G>, dim3(F, kSplit),
                     dim3(kSparseWarps * kLanes), sm, stream,
                     static_cast<const uint8_t*>(bins),
                     static_cast<const G*>(gh),
                     static_cast<const int*>(counts),
                     static_cast<const int*>(lists), share_h, arrived,
                     static_cast<Acc*>(out), ld, ft, n_ftiles, num_bin,
                     static_cast<int>(blocks));
  return static_cast<int>(err);
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

// 4-byte words of scratch that lgbm_hist_featmajor needs (the layout of
// the note at the top of this file), for `fused` != 0 when leaf_id is
// given.
long long lgbm_hist_featmajor_scratch_words(long long R, int F, int num_bin,
                                            long long blocks, int fused) {
  const long long n_ftiles = (F + kLanes - 1) / kLanes;
  const long long n_parts = blocks * n_ftiles;
  long long words = n_parts * tile_slots(num_bin) + n_parts;
  if (fused) {
    words += blocks * n_ftiles * (1 + kSparseRows) + (R + kBatch - 1) / kBatch +
             static_cast<long long>(F) * (kSplit * num_bin * kChannels + 1);
  }
  return words;
}

// Launches the histogram over `blocks` row slices of rows_per_block rows
// (a multiple of 32; blocks * rows_per_block >= R) and, for blocks > 1,
// the reduction of their partials, on `stream`; returns
// cudaGetLastError() (0 = ok). leaf_id may be null (every row is added);
// otherwise only rows with leaf_id == leaf >= 0 (R < 2^31): batch_masks
// writes the rows' masks first, and for blocks > 1 the sparse pass adds
// the rows of the blocks that listed them last. `scratch` (16-byte
// aligned) holds lgbm_hist_featmajor_scratch_words words. gh must be
// 16-byte aligned. Launches on `device`; the device current before the
// call is current again after it.
int lgbm_hist_featmajor(const void* bins, const void* gh, const void* leaf_id,
                        long long leaf, void* scratch, void* out, long long R,
                        long long ld, int F, int num_bin, int mode,
                        long long blocks, long long rows_per_block,
                        int device, void* stream) {
  if (!valid_mode(num_bin, mode) || R <= 0 || ld < R || F <= 0 ||
      blocks < 1 || blocks > kMaxParts ||
      rows_per_block < kBatch || rows_per_block % kBatch != 0 ||
      blocks * rows_per_block < R || leaf < 0 ||
      (leaf_id != nullptr && R > 0x7fffffffLL) ||
      reinterpret_cast<uintptr_t>(gh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const OnDevice on(device);
  if (on.err != cudaSuccess) return static_cast<int>(on.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(scratch);
  if (mode == kF32) {
    return launch<float>(bins, gh, leaf_id, leaf, sc, out, R, ld, F, num_bin,
                         mode, blocks, rows_per_block, st);
  }
  return launch<int8_t>(bins, gh, leaf_id, leaf, sc, out, R, ld, F, num_bin,
                        mode, blocks, rows_per_block, st);
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
