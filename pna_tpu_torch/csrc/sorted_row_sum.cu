// Sorted row sum: the port's deterministic scatter-add, for Hopper (sm_90a).
//
// It replaces no pallas_call.  In pna_tpu the VJP of a row gather and
// jax.ops.segment_sum (pna_tpu/ops/segment.py:33) are XLA scatter-adds, which
// add in a fixed order on the TPU and on the CPU; on the card, index_add_
// adds with float atomics in an order that changes from run to run.  This
// kernel is the port's counterpart of that scatter-add.  For every node n in
// [0, N):
//   out[n, :] = sum over i in [ptr[n], ptr[n+1]) of src[perm[i], :]
// where perm [E] is the stable sort of the scatter's index (absent: the
// identity, an index that is already sorted), key [E] the sorted index itself
// and ptr [N+1] its row pointers (ops/rowsum.py::index_layout).  Sorted
// positions outside [ptr[0], ptr[N]) belong to no node and are skipped; an
// empty node gets 0.  src is float32 or bfloat16 and out float32 or, from a
// bfloat16 src, bfloat16.  Every sum is taken in float32 and rounded once.
// Pointers are clamped into [0, E], keys into [-1, N] and perm into [0, E),
// so a bad layout cannot make the kernel leave its inputs.
//
// The order of addition is fixed by E, F and the layout alone, every output
// element has one writer, and there are no float atomics: two runs give the
// same bits.  ops/rowsum.py::sorted_row_sum_plain repeats the order:
//   1. the sorted positions are cut into tiles of kTile = 256, one block each
//      (and one per kFeat = 128 features), a tile into chunks of kChunk = 32,
//      one warp each, and a chunk into strips of S = 32 / R positions, one
//      lane group each (R the rows a warp holds, below).  A group adds each
//      node's rows of its strip in position order, from 0; a node inside the
//      strip is written at once;
//   2. (R > 1) a warp adds each node's strip pieces in strip order, from 0:
//      a node that began in the chunk and ends in it is written;
//   3. the block adds each node's chunk pieces in chunk order, from 0: a
//      node that began in the tile and ends in it is written; the piece of
//      the node still open at the tile's end goes to tail[t], that of the
//      node that began before the tile and ends in it (split) to head[t];
//   4. a second kernel merges each split node over tiles t0..t1: its m = t1 -
//      t0 + 1 tile pieces, tail[t0..t1-1] and head[t1], in kMergeRuns runs of
//      ceil(m / kMergeRuns), each run added in order from 0, then the runs in
//      order from 0.  The same kernel writes the zeros of the empty nodes.
// Both grids follow from E, N and F, so a hub is split without reading the
// degrees on the host: no synchronisation.
//
// Bound on this card: HBM bytes.  It must read src once (E F s bytes), perm
// and the keys, and write out once: at 1,000,000 rows x 64 float32 into
// 100,000 nodes about 0.29 GB, some 0.086 ms at 3.35 TB/s.  What the
// design does about it:
//   * no search of ptr: a block stages the keys of its tile and of its two
//     neighbouring positions in shared memory, and whether a node began
//     before a strip, a chunk or a tile or runs past it comes from
//     neighbouring keys: no dependent read stands between a block's start
//     and its first row, and none at a node's end;
//   * lanes fitted to F: a lane holds V = 4, 2 or 1 features of a row (by F;
//     one vector load where src is aligned too), a block spans F itself up to
//     128 features, and where a row needs nv = fc / V < 32 lanes a warp holds
//     R rows at once, R the largest power of two with R nv <= 32: F = 64
//     loads two rows of 16 lanes, F = 1 32 rows; the warp's combine of its
//     strips keeps a serial walk over pieces within 32 strips and 8 chunks;
//   * a merge only where a node is split, in blocks of 128 threads: the tile
//     pass records, for each tile, the split node that ends in it and (read
//     from ptr while the tile's rows load) its first tile, and the open node
//     if it is a hub of more than kMergeRuns tiles.  A merge block adds a
//     node of at most kMergeRuns pieces alone; a hub's runs are added each by
//     the block of the tile it starts in, and the last of them to arrive
//     (an int counter the tile pass zeroes) adds the runs.  The empty nodes
//     are found from ptr (ptr[n] == ptr[n+1]) in the merge blocks' shares of
//     [0, N), so a gap of any size is written by many blocks.
//
// With -DPNA_HOST_CHECK the source compiles with a host C++ compiler against
// a stub cuda_runtime.h (tests/test_torch_csrc_host.py); it uses no warp
// intrinsics and no bfloat16 header for that reason, every __syncthreads is
// reached by all the threads of the block, and nothing waits on another
// block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;
constexpr int kChunk = kWarp;               // sorted positions of a warp
constexpr int kTile = kWarps * kChunk;      // sorted positions of a block
constexpr int kThreads = kWarps * kWarp;
constexpr int kKeys = kTile + 2;            // k(pa - 1) .. k(pa + kTile)
constexpr int kFeat = 128;                  // features of a block, at most
constexpr int kHeld = kFeat / kWarp;        // features a lane holds of a row
constexpr int kUnroll = 4;                  // rows a lane group loads together
constexpr int kMergeRuns = 32;              // runs of a split node's merge
constexpr int kMergeThreads = 128;
constexpr int kMergeBatch = 8;              // pieces a thread loads at once
static_assert(kThreads == kTile, "a thread stages a position's row");

typedef unsigned short bf16_bits;

struct RowSumArgs {
  const void* src;       // [E, F] float32 or bfloat16
  const int* perm;       // [E] or null (the identity)
  const void* key;       // [E] int32, or int64 (key_i64)
  const int* ptr;        // [N+1]
  void* out;             // [N, F] float32 or bfloat16
  float* tail;           // [tiles, F]: the piece of the node past the tile
  float* head;           // [tiles, F]: the piece of the split node ending in it
  int* info;             // [5, tiles]: that node (or -1) and its first tile;
                         // the open node if it spans more than kMergeRuns
                         // tiles (or -1), its first and last tile
  int* arrived;          // [F / kFeat, tiles]: runs added of the hub ending
                         // in the tile
  int n_rows, n_nodes, n_feat, n_tiles, key_i64;
};

__device__ __forceinline__ int ld_ptr(const RowSumArgs& a, int k) {
  return min(max(__ldg(a.ptr + k), 0), a.n_rows);
}

__device__ __forceinline__ int ld_key(const RowSumArgs& a, int p) {
  const long long k =
      a.key_i64 ? __ldg(static_cast<const long long*>(a.key) + p)
                : static_cast<long long>(
                      __ldg(static_cast<const int*>(a.key) + p));
  return static_cast<int>(
      min(max(k, -1LL), static_cast<long long>(a.n_nodes)));
}

// bfloat16 bits -> float32 (exact) and float32 -> bfloat16 bits, rounded to
// nearest even, a NaN to the quiet NaN, as torch's conversion does
__device__ __forceinline__ float widen(bf16_bits h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

__device__ __forceinline__ void store(bf16_bits* p, float v) {
  unsigned u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    *p = 0x7fc0;
    return;
  }
  u += 0x7fffu + ((u >> 16) & 1u);
  *p = static_cast<bf16_bits>(u >> 16);
}

// V consecutive values of a row, widened to float32: one load of V values
// (kVec: the address is aligned to it) or V loads of one
template <int V, bool kVec>
__device__ __forceinline__ void load(const float* p, float* o) {
  if constexpr (kVec && V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else if constexpr (kVec && V == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = __ldg(p + i);
  }
}

template <int V, bool kVec>
__device__ __forceinline__ void load(const bf16_bits* p, float* o) {
  if constexpr (kVec && V == 4) {
    const unsigned long long v =
        __ldg(reinterpret_cast<const unsigned long long*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = widen(static_cast<bf16_bits>(v >> (16 * i)));
    }
  } else if constexpr (kVec && V == 2) {
    const unsigned v = __ldg(reinterpret_cast<const unsigned*>(p));
    o[0] = widen(static_cast<bf16_bits>(v));
    o[1] = widen(static_cast<bf16_bits>(v >> 16));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = widen(__ldg(p + i));
  }
}

// V floats from L2 (not the read-only path: another block may have written
// them in this kernel)
template <int V>
__device__ __forceinline__ void load_l2(const float* p, float* o) {
  if constexpr (V == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    o[0] = v.x;
    o[1] = v.y;
    o[2] = v.z;
    o[3] = v.w;
  } else if constexpr (V == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    o[0] = v.x;
    o[1] = v.y;
  } else {
    o[0] = __ldcg(p);
  }
}

// s_key[p - pa + 1] = k(p) for p in [pa - 1, pa + kTile]: the node of sorted
// position p, -1 before ptr[0] and N from ptr[N] on (so k(-1) = -1 and k(E)
// = N).  The caller synchronises before reading it.
__device__ void stage_keys(const RowSumArgs& a, int pa, int* s_key) {
  const int lo = ld_ptr(a, 0), hi = ld_ptr(a, a.n_nodes);
  for (int i = threadIdx.x; i < kKeys; i += kThreads) {
    const int p = pa - 1 + i;
    s_key[i] = p < lo ? -1 : p >= hi ? a.n_nodes : ld_key(a, p);
  }
}

// The lanes of a block of fc features: a lane holds V features of a row (nv
// slots a row); a warp holds `groups` rows at once, one a group of `width`
// lanes; a group adds a strip of `strip` positions alone.
struct Lanes {
  int nv, groups, width, strip;
};

template <int V>
__device__ __forceinline__ Lanes lanes_for(int fc) {
  Lanes l;
  l.nv = fc / V;
  l.groups = 1;
  while (2 * l.groups * l.nv <= kWarp) l.groups *= 2;
  l.width = l.groups > 1 ? l.nv : kWarp;
  l.strip = kChunk / l.groups;
  return l;
}

// The pieces of n consecutive parts (strips of a chunk, or chunks of a
// tile) of a span of positions: by part, the node begun before it (hn) and
// whether that node fills it (wh), the node begun in it and running past it
// (tn), and their partial rows (hd, tl: fc floats a part).  For item < n,
// the node whose head piece ends in part `item`; for item n, the node
// `open` still open at the span's end: summed for feature f from its first
// piece in the span, in part order from 0.
struct Chain {
  int node;         // -1: no node ends here
  float sum;
};

__device__ __forceinline__ Chain chain(int item, int f, int n, int fc,
                                       int open, const int* hn,
                                       const int* tn, const int* wh,
                                       const float* hd, const float* tl) {
  const bool ends = item < n;
  Chain c{ends ? hn[item] : open, 0.f};
  if (c.node < 0 || (ends && wh[item])) {
    c.node = -1;
    return c;
  }
  const int last = ends ? item : n - 1;
  if (!ends && tn[last] == c.node) {
    c.sum += tl[last * fc + f];
    return c;
  }
  int i = last - 1;
  while (i >= 0 && hn[i] == c.node && wh[i]) --i;
  if (i >= 0 && tn[i] == c.node) c.sum += tl[i * fc + f];
  for (int j = i + 1; j <= last; ++j) c.sum += hd[j * fc + f];
  return c;
}

// Pass 1: one block per (tile, kFeat features).
template <int V, bool kVec, typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
sorted_row_sum_tiles(const RowSumArgs a) {
  constexpr int kSlots = kHeld / V;
  __shared__ int s_key[kKeys];
  __shared__ int s_row[kTile];
  __shared__ int s_head_node[kTile];    // by strip: the node begun before it
  __shared__ int s_tail_node[kTile];    // begun in it and running past it
  __shared__ int s_whole[kTile];        // the head node fills the strip
  __shared__ float s_head[kWarps * kFeat];
  __shared__ float s_tail[kWarps * kFeat];
  __shared__ int s_chunk_node[3 * kWarps];   // by chunk: head, tail, whole
  __shared__ float s_chunk[2 * kWarps * kFeat];

  const int t = blockIdx.x;
  const int f0 = blockIdx.y * kFeat;
  const int fc = min(kFeat, a.n_feat - f0);
  const int pa = t * kTile;
  const int pb = min(pa + kTile, a.n_rows);
  const int tid = threadIdx.x;
  const int warp = tid / kWarp, lane = tid % kWarp;
  const int n_nodes = a.n_nodes;
  const long long nf = a.n_feat;
  const TIn* src = static_cast<const TIn*>(a.src) + f0;
  TOut* out = static_cast<TOut*>(a.out) + f0;

  stage_keys(a, pa, s_key);
  {
    const int p = pa + tid;
    s_row[tid] = p >= pb ? 0
                 : a.perm ? min(max(__ldg(a.perm + p), 0), a.n_rows - 1)
                          : p;
    s_head_node[tid] = -1;
    s_tail_node[tid] = -1;
    s_whole[tid] = 0;
    if (tid < 3 * kWarps) s_chunk_node[tid] = tid < 2 * kWarps ? -1 : 0;
  }
  __syncthreads();
  // the split node that began before the tile and ends in it, and the node
  // still open at the tile's end; their rows are read from ptr now, so that
  // the reads are in flight while the tile's rows load
  const int k_last = s_key[pb - pa];              // k(pb - 1)
  const int open = pb > pa && k_last >= 0 && k_last < n_nodes &&
                           s_key[pb - pa + 1] == k_last
                       ? k_last
                       : -1;
  int split_node = -1, split_first = 0, open_first = 0, open_end = 0;
  if (tid == 0 && blockIdx.y == 0) {
    const int n0 = s_key[1];
    if (pb > pa && n0 >= 0 && n0 < n_nodes && s_key[0] == n0 &&
        s_key[pb - pa + 1] != n0) {
      split_node = n0;
      split_first = ld_ptr(a, n0);
    }
    if (open >= 0) {
      open_first = ld_ptr(a, open);
      open_end = ld_ptr(a, open + 1);
    }
  }

  // 1. each lane group's strip, node by node in position order
  const Lanes ln = lanes_for<V>(fc);
  const int grp = lane / ln.width, g = lane % ln.width;
  const int q = warp * ln.groups + grp;
  if (grp < ln.groups) {
    const int s0 = pa + q * ln.strip, s1 = s0 + ln.strip;
    const int e1 = min(s1, pb);
    float acc[kHeld], head[kHeld], tail[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) acc[i] = head[i] = tail[i] = 0.f;
    int cur = -1, head_node = -1, tail_node = -1, whole = 0;
    // the piece of `cur` over the strip is complete: written (a node inside
    // the strip) or kept for the block (begun before it: head; running past
    // it: tail)
    auto flush = [&]() {
      if (cur < 0 || cur >= n_nodes) return;
      const bool began = s_key[s0 - pa] == cur;
      const bool runs = s_key[s1 - pa + 1] == cur;
      if (!began && !runs) {
        TOut* o = out + cur * nf;
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          const int sl = g + ln.width * i;
          if (sl < ln.nv) {
#pragma unroll
            for (int v = 0; v < V; ++v) store(o + sl * V + v, acc[i * V + v]);
          }
        }
        return;
      }
#pragma unroll
      for (int i = 0; i < kHeld; ++i) {
        if (began) {
          head[i] = acc[i];
        } else {
          tail[i] = acc[i];
        }
      }
      if (began) {
        head_node = cur;
        whole = runs;
      } else {
        tail_node = cur;
      }
    };
    for (int j0 = s0; j0 < e1; j0 += kUnroll) {
      float buf[kUnroll][kHeld];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < kHeld; ++i) buf[u][i] = 0.f;
        const int j = j0 + u;
        const int k = j < e1 ? s_key[j - pa + 1] : -1;
        if (k >= 0 && k < n_nodes) {
          const TIn* r = src + s_row[j - pa] * nf;
#pragma unroll
          for (int i = 0; i < kSlots; ++i) {
            const int sl = g + ln.width * i;
            if (sl < ln.nv) load<V, kVec>(r + sl * V, &buf[u][i * V]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        if (j < e1) {
          const int k = s_key[j - pa + 1];
          if (k != cur) {
            flush();
            cur = k;
#pragma unroll
            for (int i = 0; i < kHeld; ++i) acc[i] = 0.f;
          }
#pragma unroll
          for (int i = 0; i < kHeld; ++i) acc[i] += buf[u][i];
        }
      }
    }
    flush();
    if (head_node >= 0 || tail_node >= 0) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int sl = g + ln.width * i;
        if (sl < ln.nv) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            s_head[q * fc + sl * V + v] = head[i * V + v];
            s_tail[q * fc + sl * V + v] = tail[i * V + v];
          }
        }
      }
    }
    if (g == 0) {
      s_head_node[q] = head_node;
      s_tail_node[q] = tail_node;
      s_whole[q] = whole;
    }
  }
  __syncthreads();

  // 2. where a warp holds several rows (R > 1), the strips of each warp's
  // chunk of kChunk positions: a node that crosses a strip boundary and ends
  // in the chunk is written if it began in the chunk, else it is the
  // chunk's head piece; the node open at the chunk's end its tail piece (or,
  // begun before the chunk, its whole head piece).  With R = 1 a strip is a
  // chunk.
  const int* hn = s_head_node;
  const int* tn = s_tail_node;
  const int* wh = s_whole;
  const float* hd = s_head;
  const float* tl = s_tail;
  if (ln.groups > 1) {
    const int r = ln.groups;
    const int c0 = warp * kChunk;                   // s_key[c0] = k(c0 - 1)
    const int k_end = s_key[c0 + kChunk];           // k(c1 - 1)
    const int c_open = k_end >= 0 && k_end < n_nodes &&
                               s_key[c0 + kChunk + 1] == k_end
                           ? k_end
                           : -1;
    int* c_node = s_chunk_node;
    float* c_head = s_chunk;
    float* c_tail = s_chunk + kWarps * kFeat;
    for (int w = lane; w < (r + 1) * fc; w += kWarp) {
      const int item = w / fc, f = w - item * fc;
      const Chain c = chain(item, f, r, fc, c_open, hn + warp * r,
                            tn + warp * r, wh + warp * r,
                            hd + warp * r * fc, tl + warp * r * fc);
      if (c.node < 0) continue;
      const bool before = s_key[c0] == c.node;
      if (item == r && !before) {
        c_tail[warp * fc + f] = c.sum;
        if (f == 0) c_node[kWarps + warp] = c.node;
      } else if (before) {
        c_head[warp * fc + f] = c.sum;
        if (f == 0) {
          c_node[warp] = c.node;
          c_node[2 * kWarps + warp] = item == r;
        }
      } else {
        store(out + c.node * nf + f, c.sum);
      }
    }
    __syncthreads();
    hn = c_node;
    tn = c_node + kWarps;
    wh = c_node + 2 * kWarps;
    hd = c_head;
    tl = c_tail;
  }

  // 3. the nodes that cross a chunk boundary, each summed by one thread per
  // feature from its first piece in the tile: a node that ends in chunk
  // `item` (its head piece there is not whole), and the node still open at
  // the tile's end (item kWarps)
  for (int w = tid; w < (kWarps + 1) * fc; w += kThreads) {
    const int item = w / fc, f = w - item * fc;
    const Chain c = chain(item, f, kWarps, fc, open, hn, tn, wh, hd, tl);
    if (c.node < 0) continue;
    const long long at = t * nf + f0 + f;
    if (item == kWarps) {
      a.tail[at] = c.sum;
    } else if (s_key[0] == c.node) {     // began before the tile: split
      a.head[at] = c.sum;
    } else {
      store(out + c.node * nf + f, c.sum);
    }
  }
  if (tid == 0) {
    // the split node ending here, and the open node if it is a hub (its
    // runs are added by the merge blocks of the tiles they start in; the
    // last of them to arrive at the hub's last tile adds the runs)
    if (blockIdx.y == 0) {
      const int u0 = open_first / kTile, u1 = (open_end - 1) / kTile;
      int* info = a.info + t;
      const long long n = a.n_tiles;
      info[0] = split_node;
      info[n] = split_first / kTile;
      info[2 * n] = open >= 0 && u1 - u0 >= kMergeRuns ? open : -1;
      info[3 * n] = u0;
      info[4 * n] = u1;
    }
    a.arrived[blockIdx.y * a.n_tiles + t] = 0;
  }
}

// acc = 0 + piece(i0) + ... + piece(i1 - 1) for V features, in order, the
// loads of kMergeBatch pieces in flight together (from L2: .cg)
template <int V, typename Piece>
__device__ __forceinline__ void add_pieces(Piece piece, int i0, int i1,
                                           float* acc) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int k0 = i0; k0 < i1; k0 += kMergeBatch) {
    float x[kMergeBatch][V];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      load_l2<V>(piece(min(k0 + u, i1 - 1)), x[u]);
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      if (k0 + u < i1) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] += x[u][v];
      }
    }
  }
}

// Pass 2: the merge of each split node over tiles t0..t1, its m = t1 - t0 + 1
// tile pieces (tail[t0..t1-1], head[t1]) in kMergeRuns runs of q = ceil(m /
// kMergeRuns), each run added in order from 0, then the runs in order from
// 0.  Block t: for a node ending in tile t with m <= kMergeRuns (runs of one
// piece, so the sum of the pieces in order), the whole merge; for a hub
// (m > kMergeRuns) whose run starts in tile t before t1, that run, written
// over tail[t], and the last such block to arrive adds the runs (a run
// starting at t1 is head[t1] alone).  A thread takes V features.
template <int V, typename TOut>
__global__ void __launch_bounds__(kMergeThreads)
sorted_row_sum_merge(const RowSumArgs a) {
  __shared__ int s_ptr[kMergeThreads + 1];
  __shared__ int s_last;
  const int t = blockIdx.x;
  const int f0 = blockIdx.y * kFeat;
  const int fc = min(kFeat, a.n_feat - f0);
  const int nv = fc / V;
  const long long nf = a.n_feat;
  TOut* out = static_cast<TOut*>(a.out) + f0;
  const int sl = threadIdx.x;        // kMergeThreads >= kFeat: one pass
  // the empty nodes of the block's share of [0, N): 0
  {
    const int share = (a.n_nodes + gridDim.x - 1) / gridDim.x;
    const int r0 = min(t * share, a.n_nodes);
    const int r1 = min(r0 + share, a.n_nodes);
    for (int i = threadIdx.x; i <= r1 - r0; i += kMergeThreads) {
      s_ptr[i] = ld_ptr(a, r0 + i);
    }
    __syncthreads();
    const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
    for (int r = warp; r < r1 - r0; r += kMergeThreads / kWarp) {
      if (s_ptr[r] != s_ptr[r + 1]) continue;
      for (int f = lane; f < fc; f += kWarp) {
        store(out + (r0 + r) * nf + f, 0.f);
      }
    }
  }
  if (t >= a.n_tiles) return;
  const long long n = a.n_tiles;
  const int* info = a.info + t;
  const int end = info[0], t0 = info[n];
  const int hub = info[2 * n], u0 = info[3 * n], u1 = info[4 * n];
  const float* tail = a.tail + f0;
  const float* head = a.head + f0;
  if (end >= 0 && t - t0 < kMergeRuns && sl < nv) {
    float acc[V];
    add_pieces<V>([&](int i) {
      return (i < t ? tail + i * nf : head + t * nf) + sl * V;
    }, t0, t + 1, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) store(out + end * nf + sl * V + v, acc[v]);
  }
  if (hub < 0) return;                  // the same for the whole block
  const int m = u1 - u0 + 1;
  const int q = (m + kMergeRuns - 1) / kMergeRuns;
  if ((t - u0) % q != 0) return;
  // the run [t, t + q) of the hub, over its first piece
  if (sl < nv) {
    float acc[V];
    add_pieces<V>([&](int i) {
      return (i < u1 ? tail + i * nf : head + u1 * nf) + sl * V;
    }, t, min(t + q, u1 + 1), acc);
    float* o = a.tail + t * nf + f0 + sl * V;
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = acc[v];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int runs = (u1 - u0 + q - 1) / q;    // the runs that start before u1
    __threadfence();
    s_last = atomicAdd(a.arrived + blockIdx.y * n + u1, 1) == runs - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (!s_last || sl >= nv) return;
  float acc[V];
  add_pieces<V>([&](int r) {
    const int tr = u0 + r * q;
    return (tr < u1 ? tail + tr * nf : head + u1 * nf) + sl * V;
  }, 0, (m + q - 1) / q, acc);
#pragma unroll
  for (int v = 0; v < V; ++v) store(out + hub * nf + sl * V + v, acc[v]);
}

template <int V, bool kVec, typename TIn, typename TOut>
cudaError_t launch(const RowSumArgs& a, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(a.n_tiles),
                  static_cast<unsigned>((a.n_feat + kFeat - 1) / kFeat));
  auto tile_kernel = sorted_row_sum_tiles<V, kVec, TIn, TOut>;
  tile_kernel<<<grid, kThreads, 0, st>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  // at least a block a tile, and one for every kMergeThreads nodes
  const int by_nodes = (a.n_nodes + kMergeThreads - 1) / kMergeThreads;
  const dim3 merges(static_cast<unsigned>(max(a.n_tiles, by_nodes)), grid.y);
  auto merge_kernel = sorted_row_sum_merge<V, TOut>;
  merge_kernel<<<merges, kMergeThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// V by F alone (so the order of addition does not depend on where src
// lies), and one load of V values where src's address allows it
template <typename TIn, typename TOut>
cudaError_t launch_width(const RowSumArgs& a, cudaStream_t st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a.src);
  if (a.n_feat % 4 == 0) {
    return addr % (4 * sizeof(TIn)) == 0 ? launch<4, true, TIn, TOut>(a, st)
                                         : launch<4, false, TIn, TOut>(a, st);
  }
  if (a.n_feat % 2 == 0) {
    return addr % (2 * sizeof(TIn)) == 0 ? launch<2, true, TIn, TOut>(a, st)
                                         : launch<2, false, TIn, TOut>(a, st);
  }
  return launch<1, false, TIn, TOut>(a, st);
}

}  // namespace

// Sorted positions of one tile: the wrapper sizes the scratch with it.
extern "C" int pna_sorted_row_sum_tile() { return kTile; }

// src [E, F] (float32, or bfloat16 with src_bf16), perm [E] int32 or null,
// key [E] int32 (int64 with key_i64), ptr [N+1] int32; out [N, F]
// (float32, or bfloat16 with out_bf16, which needs a bfloat16 src), every
// row written; partials: [2, tiles, F] float32 and then [5 + ceil(F / 128),
// tiles] int32 of scratch, tiles = ceil(E / tile) (at least 1).  The key of
// every position in [ptr[0], ptr[N]) must be its node (key = the sorted
// index, ptr its row pointers).  Launches two kernels on `stream` and
// returns the cudaError_t of the launches.
extern "C" int pna_sorted_row_sum(const void* src, int src_bf16,
                                  const int* perm, const void* key,
                                  int key_i64, const int* ptr, int n_rows,
                                  int n_nodes, int n_feat, void* out,
                                  int out_bf16, float* partials,
                                  void* stream) {
  if (n_nodes <= 0 || n_feat <= 0) return static_cast<int>(cudaSuccess);
  if (n_rows < 0 || n_rows > INT32_MAX - 2 * kTile ||
      n_nodes > INT32_MAX - 2 * kTile || (out_bf16 && !src_bf16) ||
      (n_rows > 0 && !key)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_tiles = n_rows > 0 ? (n_rows + kTile - 1) / kTile : 1;
  const long long piece = static_cast<long long>(n_tiles) * n_feat;
  const RowSumArgs a{src, perm, key, ptr, out, partials, partials + piece,
                     reinterpret_cast<int*>(partials + 2 * piece),
                     reinterpret_cast<int*>(partials + 2 * piece) +
                         5LL * n_tiles,
                     n_rows, n_nodes, n_feat, n_tiles, key_i64 != 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (!src_bf16) {
    rc = launch_width<float, float>(a, st);
  } else if (out_bf16) {
    rc = launch_width<bf16_bits, bf16_bits>(a, st);
  } else {
    rc = launch_width<bf16_bits, float>(a, st);
  }
  return static_cast<int>(rc);
}
