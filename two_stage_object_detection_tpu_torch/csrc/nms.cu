// Greedy NMS over score-sorted boxes, for the RPN proposal path and the
// class-offset NMS of the detector's post-process.
//
// Replaces the TPU kernel `_batched_nms_kernel` of the JAX package
// (ops/pallas_proposals.py, its loop `_greedy_nms_rows`): `n_post` greedy
// select-and-suppress steps over boxes that are already decoded, clipped,
// min-size-masked (score -1e9) and cut to the top K by a stable sort.
//
// Because the rows arrive sorted by score, descending, ties by lower index,
// "select the best alive box" is "the first alive row", so greedy NMS in
// row order gives exactly the TPU kernel's selections.
//
// Design: tile-greedy, one launch, one thread-block cluster per image.
//  - The rows are cut into tiles of 64 and the tiles dealt round-robin to
//    the cluster's blocks (up to 8): each block holds its tiles' boxes and
//    one alive bit per row (valid and not yet suppressed) in shared memory.
//  - Tiles are resolved in row order.  Warp 0 of tile t's owner walks the
//    tile's own 64 x 64 suppression bits: the first alive row is kept,
//    clears the rows it suppresses, and so on, until `n_post` rows are kept
//    in all.  It writes the kept rows out, publishes their boxes in its
//    shared memory and raises its flag (a release store at cluster scope).
//    The bits were computed while tile t - 1 was walked, by the owner's
//    other threads, off the chain from one tile to the next.
//  - Warp 0 of every block acquires that flag through distributed shared
//    memory and copies the kept boxes; then all the block's threads clear
//    the alive bit of each of its rows in later tiles that one of them
//    suppresses, one row a thread, alive rows only.
//  - The walk stops at `n_post` kept, or after the last tile that holds a
//    valid row: later rows are never compared, and no mask goes to device
//    memory.  No cluster-wide barrier runs per tile: a block waits only for
//    the tile's owner, and the published boxes are double-buffered (an
//    owner reuses a buffer only after every other block has published a
//    later tile, and so has copied it).
//
// What bounds it on the H100: neither bytes (about 1 MB in per batch of 16
// at K=3000) nor operations (each kept row against the rows after it: some
// 14 M IoUs at K=3000, B=16), but the chain of tiles: per tile one walk,
// one flag passed between SMs, two block barriers and one suppression
// pass.  A cluster spreads an image, and its boxes, over up to 8 SMs.  A
// block's shared memory holds at most 219 tiles (1,032 bytes a tile), so
// an image of K rows needs at least ceil(K / 64 / 219) blocks and 8 blocks
// take up to 112,128 rows a launch (ops/proposals.py:nms_cluster_bounds;
// more rows go in chunks, below).  The
// launcher takes the largest cluster of which the card holds the whole
// batch at once, but never one below that floor (nms_pick_cluster): an
// H100 holds fewer than 16 clusters of 8 1024-thread blocks, so B=16 gets
// 4 at K=3000.
//
// Kernel 3 (csrc/proposals.cu) calls this walk too, over its whole table
// once launch A has sorted it, with K = N.
//
// More rows than 8 blocks hold (ops/proposals.py:nms_chunks): greedy NMS
// over sorted rows splits into chunks with no change to its result, since
// a row is kept exactly when no earlier kept row overlaps it by more than
// the threshold.  The wrapper launches the walk once a chunk, in order,
// each launch within its own cluster bounds; a launch reads the count kept
// so far (`kept_count`, zeroed by the wrapper and kept on the device: the
// host never reads it) and first clears its rows against the boxes already
// in the outputs, with the same IoU code, then walks its tiles and
// appends.  A launch that finds `n_post` already kept returns at once.
//
// The row index of each kept row (`out_index`): the walk also stores the
// row of each kept box in the whole [B, K] table (a chunk's launch is told
// its first row), and 0 in the slots not kept, as the plain version pads
// them.  The post-process gathers labels by it; the proposal paths drop it.
//
// Exactness: the IoU is computed with __fmul_rn/__fadd_rn/__fsub_rn in the
// order inter / (area + barea - inter + 1e-8), with area = (x2-x1)*(y2-y1),
// so nothing is contracted into an FMA, and the decision is
// __fdiv_rn(inter, denom) > thr.  The division is skipped only where the
// answer is proven without it (see iou_above), so every decision equals
// the plain PyTorch version's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kValidMin = -5e8f;   // NEG / 2: masked rows score -1e9

__device__ __forceinline__ float area_rn(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// __fdiv_rn(inter, denom) > thr for iou(a, b) = inter / denom, denom =
// area_b + area_a - inter + 1e-8.  Two shortcuts, both exact:
//  - inter = +0 (most pairs: the boxes do not meet): the quotient is +-0 or
//    NaN, never above a threshold >= 0;
//  - thr > 0, denom > 0 and p = thr * denom a normal float: the quotient q
//    of the reals is above thr * (1 + 2^-22) where inter > p * (1 + 2^-20)
//    (p and the product each carry at most 2^-24 of rounding), and then its
//    rounding stays above thr; it is at most thr where
//    inter < p * (1 - 2^-20), and then so is its rounding.  In between the
//    exact division decides.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b,
                                          float area_b, float thr) {
  const float ix1 = fmaxf(b.x, a.x), iy1 = fmaxf(b.y, a.y);
  const float ix2 = fminf(b.z, a.z), iy2 = fminf(b.w, a.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
  if (inter == 0.0f && thr >= 0.0f) return false;
  const float denom =
      __fadd_rn(__fsub_rn(__fadd_rn(area_b, area_a), inter), 1e-8f);
  if (thr > 0.0f && denom > 0.0f) {
    const float p = __fmul_rn(thr, denom);
    if (p >= 1e-30f && p <= 1e30f) {
      if (inter > __fmul_rn(p, 1.0f + 0x1p-20f)) return true;
      if (inter < __fmul_rn(p, 1.0f - 0x1p-20f)) return false;
    }
  }
  return __fdiv_rn(inter, denom) > thr;
}

// Tile t's owner publishes it by storing t + 1 to its `flag` with release
// semantics at cluster scope; a reader acquires the flag through
// distributed shared memory, after which the published boxes are visible.
__device__ __forceinline__ void store_release_cluster(int* p, int v) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int load_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The 64 x 64 suppression bits of one tile, by the block's upper 512
// threads (8 a row, 8 columns each): bit j of sup[i] is set where row i
// suppresses row j > i.  Every pair: the walk masks with the alive bits.
__device__ __forceinline__ void tile_suppression(const float4* tb, float thr,
                                                 unsigned long long* sup) {
  const int u = threadIdx.x - (kThreads - kTile * 8);
  if (u < 0) return;
  const int i = u >> 3, c = u & 7;
  const float4 bi = tb[i];
  const float ai = area_rn(bi);
  unsigned bits = 0;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = c * 8 + jj;
    if (j > i) {
      const float4 bj = tb[j];
      if (iou_above(bi, ai, bj, area_rn(bj), thr)) bits |= 1u << jj;
    }
  }
  reinterpret_cast<unsigned char*>(sup)[i * 8 + c] = (unsigned char)bits;
}

// Clear the alive bit of every row in alive words [w0, w1) that one of the
// `cnt` boxes in kept_box suppresses: one row a thread, one 32-row alive
// word a warp.  kept_box holds earlier rows, so the IoU is taken as the
// plain version takes it, with the kept box as the selected one.
__device__ __forceinline__ void clear_rows(const float4* box_s,
                                           uint32_t* alive, int w0, int w1,
                                           const float4* kept_box,
                                           const float* kept_area, int cnt,
                                           float thr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int w = w0 + warp; w < w1; w += kWarps) {
    const unsigned aw = alive[w];
    if (aw == 0u) continue;   // uniform in the warp
    bool dead = false;
    if ((aw >> lane) & 1u) {
      const float4 b = box_s[w * 32 + lane];
      const float ab = area_rn(b);
      // no early exit: few rows die per tile, and independent tests keep
      // more loads in flight
#pragma unroll 4
      for (int m = 0; m < cnt; ++m) {
        dead |= iou_above(kept_box[m], kept_area[m], b, ab, thr);
      }
    }
    const unsigned d = __ballot_sync(kFull, dead);
    if (lane == 0) alive[w] = aw & ~d;
  }
}

// grid (cluster size, B), cluster (cluster size, 1, 1), kThreads threads.
// The launch walks rows [0, k) of each image's `stride` rows (a chunk: the
// pointers start at the chunk's first row, which is row `row0` of the
// table; `out_index` gets row0 + the local row of each kept box).  With
// `kept_count`, the count each image kept in earlier chunks (the outputs'
// first slots) is read first and the new count written last.
// Dynamic shared memory: the block's tiles' boxes [tiles * 64] float4, then
// their alive bits [tiles * 2] uint32 (bit l of word w: local row 32w + l).
//
// Per tile t, in every block: warp 0 of t's owner walks the tile (its
// suppression bits were computed during tile t - 1 by the owner's upper
// threads) and publishes; warp 0 of every block waits for the publication,
// copies the kept boxes; one block barrier; all threads clear the alive
// bits of their later rows; one block barrier.  Meanwhile the owner of
// tile t + 1 computes that tile's suppression bits.
__global__ void __launch_bounds__(kThreads, 1)
nms_cluster_kernel(const float4* __restrict__ boxes,
                   const float* __restrict__ scores, int k, int stride,
                   int n_post, float thr, int tiles_per_block,
                   float4* __restrict__ out_boxes,
                   float* __restrict__ out_scores,
                   bool* __restrict__ out_valid, int* __restrict__ out_index,
                   int row0, int* __restrict__ kept_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box_s = reinterpret_cast<float4*>(smem);
  uint32_t* alive =
      reinterpret_cast<uint32_t*>(box_s + (size_t)tiles_per_block * kTile);
  __shared__ float4 pub_box[2][kTile];   // kept boxes of a tile I own
  __shared__ float pub_area[2][kTile];
  __shared__ int pub_cnt[2];
  __shared__ int flag;                   // tiles I own published: last t + 1
  __shared__ float4 kept_box[kTile];     // my copy of the tile's kept boxes
  __shared__ float kept_area[kTile];
  __shared__ int kept_cnt;
  __shared__ unsigned long long sup[2][kTile];   // by tile parity
  __shared__ int last_valid;

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_tiles = (k + kTile - 1) / kTile;
  const int my_tiles = rank < n_tiles ? (n_tiles - rank + cs - 1) / cs : 0;
  const float4* bb = boxes + (size_t)img * stride;
  const float* sc = scores + (size_t)img * stride;
  float4* ob = out_boxes + (size_t)img * n_post;
  float* os = out_scores + (size_t)img * n_post;
  bool* ov = out_valid + (size_t)img * n_post;
  int* oi = out_index + (size_t)img * n_post;
  // kept in earlier chunks: the same in every block of the cluster, so a
  // full image leaves before any cluster barrier, all blocks alike
  const int prior = kept_count != nullptr ? kept_count[img] : 0;
  if (prior >= n_post) return;

  // load my tiles (local tile l is tile l * cs + rank) and their alive bits
  if (threadIdx.x == 0) {
    last_valid = -1;
    flag = 0;
  }
  __syncthreads();
  int my_last = -1;
  for (int q = threadIdx.x; q < my_tiles * kTile; q += kThreads) {
    const int row = ((q / kTile) * cs + rank) * kTile + q % kTile;
    float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
    bool valid = false;
    if (row < k) {
      b = bb[row];
      valid = sc[row] > kValidMin;
    }
    box_s[q] = b;
    const unsigned m = __ballot_sync(kFull, valid);   // warps cover 32 rows
    if (lane == 0) alive[q / 32] = m;
    if (valid) my_last = row;
  }
  if (my_last >= 0) atomicMax(&last_valid, my_last);
  __syncthreads();
  if (rank == 0) tile_suppression(box_s, thr, sup[0]);   // tile 0
  cluster.sync();
  int last = -1;
  for (int r = 0; r < cs; ++r) {
    last = max(last, *cluster.map_shared_rank(&last_valid, r));
  }
  const int n_work = (last + kTile) / kTile;   // tiles up to the last valid row
  const int my_work = rank < n_work ? (n_work - rank + cs - 1) / cs : 0;

  // earlier chunks' kept boxes, 64 at a time from the outputs, clear my rows
  for (int m0 = 0; m0 < prior && my_work > 0; m0 += kTile) {
    const int cnt = min(kTile, prior - m0);
    if (threadIdx.x < cnt) {
      const float4 b = ob[m0 + threadIdx.x];
      kept_box[threadIdx.x] = b;
      kept_area[threadIdx.x] = area_rn(b);
    }
    __syncthreads();
    clear_rows(box_s, alive, 0, 2 * my_work, kept_box, kept_area, cnt, thr);
    __syncthreads();
  }

  int n_kept = prior;   // the same in every thread of the cluster
  for (int t = 0; t < n_work && n_kept < n_post; ++t) {
    const int owner = t % cs, buf = t & 1;
    if (owner == rank && warp == 0) {
      // walk tile t: lane l holds sup[l] and sup[l + 32]; the walk is uniform
      const int lt = t / cs;
      const unsigned long long a =
          (unsigned long long)alive[2 * lt + 1] << 32 | alive[2 * lt];
      const float4* tb = box_s + lt * kTile;
      const unsigned long long lo = sup[buf][lane], hi = sup[buf][lane + 32];
      unsigned long long cand = a, keep = 0ull;
      int cnt = 0;
      while (cand != 0ull && cnt < n_post - n_kept) {
        const int i = __ffsll((long long)cand) - 1;
        const unsigned long long s = __shfl_sync(kFull, i < 32 ? lo : hi, i & 31);
        keep |= 1ull << i;
        ++cnt;
        cand &= ~s & ~(1ull << i);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = lane + 32 * h;
        if ((keep >> i) & 1ull) {
          const int slot = __popcll(keep & ((1ull << i) - 1ull));
          const float4 b = tb[i];
          pub_box[buf][slot] = b;
          pub_area[buf][slot] = area_rn(b);
          ob[n_kept + slot] = b;
          os[n_kept + slot] = sc[t * kTile + i];
          ov[n_kept + slot] = true;
          oi[n_kept + slot] = row0 + t * kTile + i;
        }
      }
      if (lane == 0) pub_cnt[buf] = cnt;
      __syncwarp();
      if (lane == 0) store_release_cluster(&flag, t + 1);
    }
    if (t + 1 < n_work && (t + 1) % cs == rank) {
      tile_suppression(box_s + (t + 1) / cs * kTile, thr, sup[(t + 1) & 1]);
    }
    if (warp == 0) {
      // wait for tile t's publication (every lane acquires it), then copy
      // its kept boxes
      const int* f = cluster.map_shared_rank(&flag, owner);
      for (int spin = 0; load_acquire_cluster(f) <= t; ++spin) {
        if (spin > (1 << 22)) __trap();   // a lost publication: fail, not hang
      }
      const int cnt = *cluster.map_shared_rank(&pub_cnt[buf], owner);
      const float4* rb = cluster.map_shared_rank(&pub_box[buf][0], owner);
      const float* ra = cluster.map_shared_rank(&pub_area[buf][0], owner);
      for (int m = lane; m < cnt; m += 32) {
        kept_box[m] = rb[m];
        kept_area[m] = ra[m];
      }
      if (lane == 0) kept_cnt = cnt;
    }
    __syncthreads();
    const int cnt = kept_cnt;
    n_kept += cnt;
    if (n_kept >= n_post) break;
    if (cnt > 0) {
      // my tiles after t
      const int lt0 = t >= rank ? (t - rank) / cs + 1 : 0;
      clear_rows(box_s, alive, 2 * lt0, 2 * my_work, kept_box, kept_area, cnt,
                 thr);
    }
    __syncthreads();
  }
  if (rank == 0) {
    // slots a later chunk may still fill start zeroed and invalid
    for (int s = n_kept + threadIdx.x; s < n_post; s += kThreads) {
      ob[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      os[s] = 0.f;
      ov[s] = false;
      oi[s] = 0;
    }
    if (kept_count != nullptr && threadIdx.x == 0) kept_count[img] = n_kept;
  }
  cluster.sync();   // no block leaves while another may read its shared memory
}

// A launch of `cluster` blocks per image: its configuration (the cluster
// attribute points into `attr`), with the dynamic shared memory it needs
// allowed; false if the block cannot have that much.
bool launch_config(int batch, int k, int cluster, cudaStream_t stream,
                   cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg,
                   int* per_block) {
  const int n_tiles = (k + kTile - 1) / kTile;
  *per_block = (n_tiles + cluster - 1) / cluster;
  const size_t smem =
      (size_t)*per_block * (kTile * sizeof(float4) + 2 * sizeof(uint32_t));
  if (cudaFuncSetAttribute(nms_cluster_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess) {
    cudaGetLastError();   // clear the refusal
    return false;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, batch, 1);
  cfg->blockDim = dim3(kThreads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return true;
}

}  // namespace

// Blocks per image for a batch of `batch` images of `k` rows: the largest of
// max_cluster, max_cluster / 2, ..., min_cluster (ops/proposals.py:
// nms_cluster_bounds gives both; below min_cluster a block's shared memory
// cannot hold its rows) of which the card can hold all `batch` clusters at
// once (cudaOccupancyMaxActiveClusters), so that every image runs in one
// wave; else min_cluster.
extern "C" int nms_pick_cluster(int batch, int k, int max_cluster,
                                int min_cluster) {
  int best = max_cluster;
  for (int cs = max_cluster; cs >= min_cluster && cs >= 1;) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg;
    int per_block = 0, n_active = 0;
    if (!launch_config(batch, k, cs, nullptr, attr, &cfg, &per_block)) break;
    if (cudaOccupancyMaxActiveClusters(&n_active, (void*)nms_cluster_kernel,
                                       &cfg) != cudaSuccess) {
      cudaGetLastError();
      break;
    }
    best = cs;
    if (n_active >= batch) break;
    cs = (cs / 2 < min_cluster && cs > min_cluster) ? min_cluster : cs / 2;
  }
  return best;
}

// One launch over rows [0, k) of each image, `stride` rows apart (boxes and
// scores point at the chunk's first row).  `cluster`: blocks per image,
// 1..min(8, ceil(k / 64)) (nms_pick_cluster); launch_config refuses one
// whose blocks cannot hold their rows.  `out_index` ([batch, n_post]
// int32): the row of each kept box in the table, counted from the table's
// first row, which is `row0` rows before the chunk's.
// `kept_count` ([batch] int32, zeroed before the first chunk, or null for a
// single launch): read first, written last.  Returns a cudaError_t code.
extern "C" int nms_launch(const void* boxes, const void* scores, int batch,
                          int k, int stride, int n_post, float thr,
                          int cluster, void* out_boxes, void* out_scores,
                          void* out_valid, void* out_index, int row0,
                          void* kept_count, void* stream) {
  const int n_tiles = (k + kTile - 1) / kTile;
  if (batch < 1 || k < 1 || stride < k || n_post < 0 || row0 < 0 ||
      out_index == nullptr || cluster < 1 || cluster > kMaxCluster ||
      cluster > n_tiles) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int per_block = 0;
  if (!launch_config(batch, k, cluster, static_cast<cudaStream_t>(stream),
                     attr, &cfg, &per_block)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, nms_cluster_kernel, static_cast<const float4*>(boxes),
      static_cast<const float*>(scores), k, stride, n_post, thr, per_block,
      static_cast<float4*>(out_boxes), static_cast<float*>(out_scores),
      static_cast<bool*>(out_valid), static_cast<int*>(out_index), row0,
      static_cast<int*>(kept_count));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
