// The pretrans message, and the tiled walk over edge segments that forms it,
// shared by K3 (csr_pretrans_sketch.cu) and K4 (csr_pretrans_dmsg.cu).
//
// For edge e into receiver r, feature f:
//   m = (u[snd[e], f] + v[r, f]) + sum_{k=0..Fe-1} ef[e, k] * ke[k, f]
// The k-sum starts from the first product and adds in increasing k; every
// operation is __fadd_rn/__fmul_rn, which nvcc never contracts into an FMA.
// K4 recomputes the message that K3 reduced, so both must form it with the
// same roundings in the same order: that keeps the max/min tie tests of the
// backward bit-exact (the JAX contract of sorted_pretrans_dmsg,
// pna_tpu/ops/pallas_kernels.py).  Both kernels therefore call one device
// function, pretrans_walk, which forms every message.  The plain PyTorch
// version in pna_tpu_torch/ops/csr_fused_kernels.py repeats this order with
// one multiply and one add per k, so its messages are bit-identical too.
// Tensor-core products add in an unspecified order and are not used.
//
// v, ef and ke are float32 or bfloat16 (T); bfloat16 values are widened to
// float32 on load, which is exact.  u is always float32.
//
// The walk.  The work list is a table of segments (csr_kernels.csr_segments
// in the Python package): every node's edge range is cut into segments of at
// most SEG edges, a node's segments are consecutive, an empty node has one
// empty segment.  Where no node is split the table is the row pointers
// themselves (seg_node and seg_slot null).  A block stages its slice of ke
// in shared memory once, then takes tiles of `tile_segs` consecutive
// segments in a grid-stride loop, and for each tile (in sub-tiles of at most
// `tile_edges` edges: whole segments each, except that a segment longer than
// a sub-tile, which csr_segments never makes but a caller's table may hold,
// is walked in consecutive sub-tiles, each continuing the one before):
//
//   stage    the segments' pointers, the senders, each edge's receiver and
//            the contiguous span of ef rows go to shared memory (ef and ke
//            widened to float32, rows padded to 16 bytes with zeros).  The
//            copy goes through registers, one warp per row, not through
//            cp.async or TMA: that widens bfloat16 once instead of at every
//            use, pads the rows, and takes any Fe and any alignment (rows of
//            200 or 100 bytes start 16-byte aligned only every other row).
//            What it gives up is a copy of the next sub-tile that overlaps
//            this one's product;
//   phase 1  the edge-feature term of the sub-tile is a small matrix product
//            [edges, Fe] x [Fe, F] on the CUDA cores, register-tiled: a
//            thread owns kEdgesPerThread = 4 edges (strided over the
//            sub-tile) times 4 neighbouring features, 16 running sums, and
//            per 4 steps of k reads 4 float4 of ke and one float4 of ef per
//            edge from shared memory for 128 multiplies and adds.  (A tile
//            of 8 edges a thread halves the shared loads per operation but
//            needs 96 registers, two blocks an SM; three blocks of the
//            smaller tile measured faster: the walk is bound by latency.)
//            Each sum is its own chain in increasing k, started from -0.0f
//            (-0 + p == p bit for bit), so the roundings are those of the
//            scalar loop.  Then the thread fetches u and v for its 16
//            (edge, feature) pairs, all loads in flight at once, forms m,
//            shows it to the kernel's own hook and stores it to a shared
//            [tile_edges, F] tile.  Messages never reach device memory;
//   phase 2  threads are (segment, feature): the kernel's own reduction of
//            its segment's messages from the shared tile (K3: the moment
//            sketch; K4: d_msg rows and their sum), written to the node's
//            outputs, or to a partial slot when the node is split.  A
//            sub-tile that continues a segment folds what the same thread
//            wrote for the segment's earlier part into its result first.
//
// Every output element and every partial has one writer thread; a second
// small kernel merges a split node's partials in a fixed order.  No atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "csr_common.cuh"

namespace pna {

constexpr int kMaxThreads = 288;     // 16 edge groups x 18 feature quads
constexpr int kBlocksPerSM = 3;      // at most 75 registers a thread
constexpr int kEdgesPerThread = 4;   // register tile: 4 edges x 4 features
constexpr int kMaxEdgeGroups = 16;   // sub-tile of at most 64 edges
constexpr int kMaxTileSegs = 128;    // segments of one tile
constexpr int kMaxFeatChunk = 128;   // features of one block (blockIdx.y)
constexpr int kSeg = 32;             // longest segment: csr_kernels.SEG
// the narrowest sub-tile still holds a whole segment
static_assert(kMaxThreads / (kMaxFeatChunk / 4) * kEdgesPerThread >= kSeg,
              "a sub-tile must hold a segment");

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct PretransArgs {
  const float* u;       // [n_u, F]
  const void* v;        // [N, F] of T
  const int* snd;       // [E]
  const int* seg_ptr;   // [S + 1]
  const int* seg_node;  // [S], or null: segment s is node s
  const int* seg_slot;  // [S] partial slot or -1, or null: no node is split
  const void* ef;       // [E, fe] of T
  const void* ke;       // [fe, F] of T
  int n_seg, n_nodes, n_u, n_edges, n_feat, fe;
  // launch geometry, filled by pretrans_geometry
  int feat_chunk;       // features of one block
  int quads;            // feat_chunk rounded up to 4, over 4
  int edge_groups;      // phase 1: threads are (edge group, feature quad)
  int groups;           // phase 2: threads are (segment slot, feature)
  int tile_segs;        // segments of one tile
  int tile_edges;       // edges of one sub-tile: 4 a thread and group
  int fe_pad;           // fe rounded up to 4
};

// What phase 2 sees of one sub-tile.  Thread (g, fl) owns feature f of the
// segments sa + g, sa + g + groups, ... < sb; segment ls spans the local
// edges [seg_ptr_s[ls] - e0, seg_ptr_s[ls + 1] - e0), cut to [0, ne); the
// message of local edge le at this thread's feature is m_s[le * ms + fl].
// With `cont`, segment sa began in an earlier sub-tile: its destination
// holds the result of that part, written by this same thread (g == 0), and
// this part is merged into it.
struct TileView {
  const float* m_s;
  const int* seg_ptr_s;
  const int* node_s;
  const int* slot_s;
  int sa, sb, e0, ne, ms, g, fl, f, groups;
  bool active, cont;
};

// One step of k for one edge and four features: acc[c] += x * b[c], the
// multiply and the add rounded separately.
__device__ __forceinline__ void pretrans_term(float (&acc)[4], float x,
                                              const float4& b) {
  acc[0] = __fadd_rn(acc[0], __fmul_rn(x, b.x));
  acc[1] = __fadd_rn(acc[1], __fmul_rn(x, b.y));
  acc[2] = __fadd_rn(acc[2], __fmul_rn(x, b.z));
  acc[3] = __fadd_rn(acc[3], __fmul_rn(x, b.w));
}

// The edge-feature term of N edges x 4 features: acc[i][c] = sum over k, in
// increasing k, of ef_s[edge i][k] * ke_s[k][4 fq + c], from -0.0f.  ef4
// points at this thread's first edge, row4 float4 apart from the next; ke4
// at its feature quad, `quads` float4 apart from the next k.  Rows and
// columns past fe hold zeros; the last fe % 4 terms are taken one by one so
// that no term is added that the scalar loop does not add.
template <int N>
__device__ __forceinline__ void pretrans_dot(const float4* __restrict__ ef4,
                                             int row4,
                                             const float4* __restrict__ ke4,
                                             int quads, int fe,
                                             float (&acc)[kEdgesPerThread][4]) {
  const int n_full = fe / 4;
#pragma unroll 2
  for (int k4 = 0; k4 < n_full; ++k4) {
    const float4 b0 = ke4[(4 * k4) * quads];
    const float4 b1 = ke4[(4 * k4 + 1) * quads];
    const float4 b2 = ke4[(4 * k4 + 2) * quads];
    const float4 b3 = ke4[(4 * k4 + 3) * quads];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 x = ef4[i * row4 + k4];
      pretrans_term(acc[i], x.x, b0);
      pretrans_term(acc[i], x.y, b1);
      pretrans_term(acc[i], x.z, b2);
      pretrans_term(acc[i], x.w, b3);
    }
  }
  const int rem = fe - 4 * n_full;   // 0..3 last terms
  if (rem > 0) {
    const float4 b0 = ke4[(4 * n_full) * quads];
    const float4 b1 = ke4[(4 * n_full + 1) * quads];
    const float4 b2 = ke4[(4 * n_full + 2) * quads];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 x = ef4[i * row4 + n_full];
      pretrans_term(acc[i], x.x, b0);
      if (rem > 1) pretrans_term(acc[i], x.y, b1);
      if (rem > 2) pretrans_term(acc[i], x.z, b2);
    }
  }
}

// pretrans_dot<n> for the run-time n in 0..N.
template <int N>
struct PretransDot {
  static __device__ __forceinline__ void run(
      int n, const float4* ef4, int row4, const float4* ke4, int quads,
      int fe, float (&acc)[kEdgesPerThread][4]) {
    if (n >= N) {
      pretrans_dot<N>(ef4, row4, ke4, quads, fe, acc);
    } else {
      PretransDot<N - 1>::run(n, ef4, row4, ke4, quads, fe, acc);
    }
  }
};
template <>
struct PretransDot<0> {
  static __device__ __forceinline__ void run(
      int, const float4*, int, const float4*, int, int,
      float (&)[kEdgesPerThread][4]) {}
};

// Forms every message of the block's tiles.  `phase2` is the kernel's own
// part: phase2.message(node_at, edge_at, n, m) sees each message as it is
// formed (m[0..n) are features f..f+n of one edge, node_at and edge_at the
// offsets of [node, f] and [edge, f] in an [., F] array) and may replace it
// by the value the tile should hold; phase2(tile) then reduces each sub-tile.
// kEdgeFeatures is false where fe == 0.
template <typename T, bool kEdgeFeatures, typename Phase2>
__device__ __forceinline__ void pretrans_walk(const PretransArgs& a,
                                              const Phase2& phase2) {
  extern __shared__ float4 pretrans_smem[];
  const int ms = 4 * a.quads;   // row stride of the ke slice and the messages
  float* ke_s = reinterpret_cast<float*>(pretrans_smem);   // [fe_pad, ms]
  float* ef_s = ke_s + a.fe_pad * ms;                // [tile_edges, fe_pad]
  float* m_s = ef_s + a.tile_edges * a.fe_pad;       // [tile_edges, ms]
  int* snd_s = reinterpret_cast<int*>(m_s + a.tile_edges * ms);
  int* enode_s = snd_s + a.tile_edges;
  __shared__ int seg_ptr_s[kMaxTileSegs + 1];
  __shared__ int node_s[kMaxTileSegs];
  __shared__ int slot_s[kMaxTileSegs];

  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int n_feat = a.n_feat;
  const int f_base = blockIdx.y * a.feat_chunk;
  const int fw = min(a.feat_chunk, n_feat - f_base);   // features here
  const float* __restrict__ u = a.u;
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const T* __restrict__ ef = static_cast<const T*>(a.ef);
  const T* __restrict__ ke = static_cast<const T*>(a.ke);

  // phase 1 coordinates
  const int eg = tid / a.quads;
  const int fq = tid - eg * a.quads;
  const bool p1_active = eg < a.edge_groups;
  // phase 2 coordinates
  TileView t;
  t.m_s = m_s;
  t.seg_ptr_s = seg_ptr_s;
  t.node_s = node_s;
  t.slot_s = slot_s;
  t.ms = ms;
  t.g = tid / a.feat_chunk;
  t.fl = tid - t.g * a.feat_chunk;
  t.f = f_base + t.fl;
  t.groups = a.groups;
  t.active = t.g < a.groups && t.fl < fw;

  if (kEdgeFeatures) {   // the block's slice of ke, pad rows and columns 0
    for (int i = tid; i < a.fe_pad * ms; i += n_threads) {
      const int k = i / ms;
      const int c = i - k * ms;
      ke_s[i] = (k < a.fe && c < fw)
                    ? widen(ke[static_cast<long long>(k) * n_feat + f_base + c])
                    : 0.f;
    }
  }

  const int n_tiles = (a.n_seg + a.tile_segs - 1) / a.tile_segs;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int s0 = tile * a.tile_segs;
    const int ns = min(a.tile_segs, a.n_seg - s0);
    __syncthreads();   // the previous tile's phase 2 has read the tables
    for (int i = tid; i <= ns; i += n_threads) {
      seg_ptr_s[i] = clampi(a.seg_ptr[s0 + i], 0, a.n_edges);
    }
    for (int i = tid; i < ns; i += n_threads) {
      node_s[i] = a.seg_node ? clampi(a.seg_node[s0 + i], 0, a.n_nodes - 1)
                             : s0 + i;
      slot_s[i] = a.seg_slot ? a.seg_slot[s0 + i] : -1;
    }
    __syncthreads();

    int sa = 0;
    int e0 = seg_ptr_s[0];
    bool cont = false;
    while (sa < ns) {
      // the sub-tile: from edge e0 of segment sa, as many whole segments as
      // fit tile_edges edges, found by bisection; where not even segment
      // sa's rest fits, tile_edges of its edges, and the next sub-tile
      // continues it
      int sb = sa + 1, hi = ns;
      while (sb < hi) {
        const int mid = (sb + hi + 1) / 2;
        if (seg_ptr_s[mid] - e0 <= a.tile_edges) {
          sb = mid;
        } else {
          hi = mid - 1;
        }
      }
      const int ne = clampi(seg_ptr_s[sb] - e0, 0, a.tile_edges);
      const bool more = seg_ptr_s[sb] - e0 > a.tile_edges;   // sb == sa + 1

      for (int i = tid; i < ne; i += n_threads) {
        snd_s[i] = clampi(a.snd[e0 + i], 0, a.n_u - 1);
      }
      for (int ls = sa + tid; ls < sb; ls += n_threads) {
        const int lo = clampi(seg_ptr_s[ls] - e0, 0, ne);
        const int up = clampi(seg_ptr_s[ls + 1] - e0, 0, ne);
        for (int i = lo; i < up; ++i) enode_s[i] = node_s[ls];
      }
      if (kEdgeFeatures) {
        // one warp per ef row: coalesced loads, widened, pad columns zero
        const int lane = tid % kWarp;
        for (int row = tid / kWarp; row < ne; row += n_threads / kWarp) {
          const T* src = ef + static_cast<long long>(e0 + row) * a.fe;
          float* dst = ef_s + row * a.fe_pad;
          for (int k = lane; k < a.fe_pad; k += kWarp) {
            dst[k] = k < a.fe ? widen(src[k]) : 0.f;
          }
        }
      }
      __syncthreads();

      // this thread's edges: eg, eg + edge_groups, ...; n_own of them
      const int n_own =
          p1_active && ne > eg ? (ne - eg + a.edge_groups - 1) / a.edge_groups
                               : 0;
      float acc[kEdgesPerThread][4];
#pragma unroll
      for (int i = 0; i < kEdgesPerThread; ++i) {
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = -0.f;
      }
      if (kEdgeFeatures && p1_active) {
        // the most edges a thread of this sub-tile owns: uniform over the
        // block, so the loop body carries no predicate; a thread that owns
        // one fewer computes a row of the tile that nobody stores
        const float4* ke4 = reinterpret_cast<const float4*>(ke_s) + fq;
        const float4* ef4 = reinterpret_cast<const float4*>(ef_s) +
                            eg * (a.fe_pad / 4);
        const int row4 = a.edge_groups * (a.fe_pad / 4);
        PretransDot<kEdgesPerThread>::run(
            (ne + a.edge_groups - 1) / a.edge_groups, ef4, row4, ke4, a.quads,
            a.fe, acc);
      }
      // m = (u + v) + acc, every load of the thread independent
#pragma unroll
      for (int i = 0; i < kEdgesPerThread; ++i) {
        if (i < n_own) {
          const int le = eg + i * a.edge_groups;
          const long long col0 = f_base + 4 * fq;
          const long long node_at =
              static_cast<long long>(enode_s[le]) * n_feat + col0;
          const float* u_row =
              u + static_cast<long long>(snd_s[le]) * n_feat + col0;
          const T* v_row = v + node_at;
          const int n_cols = min(4, fw - 4 * fq);   // <= 0 in a pad quad
          float m[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            m[c] = 0.f;
            if (c < n_cols) {
              m[c] = __fadd_rn(u_row[c], widen(v_row[c]));
              if (kEdgeFeatures) m[c] = __fadd_rn(m[c], acc[i][c]);
            }
          }
          phase2.message(node_at,
                         static_cast<long long>(e0 + le) * n_feat + col0,
                         n_cols, m);
          reinterpret_cast<float4*>(m_s + le * ms)[fq] =
              make_float4(m[0], m[1], m[2], m[3]);
        }
      }
      __syncthreads();

      t.sa = sa;
      t.sb = sb;
      t.e0 = e0;
      t.ne = ne;
      t.cont = cont;
      phase2(t);

      cont = more;
      if (more) {
        e0 += ne;
      } else {
        sa = sb;
        e0 = seg_ptr_s[sa];   // sa <= ns: the table holds ns + 1 pointers
      }
      if (sa < ns) __syncthreads();   // phase 2 has read the message tile
    }
  }
}

// Host side: the launch geometry of the walk for these sizes.
struct PretransLaunch {
  dim3 grid;
  dim3 block;
  size_t smem;
};

// Threads of a block: (edge group, feature quad) in phase 1 and at least
// one (segment, feature) row in phase 2, rounded up to whole warps.
inline int pretrans_threads(const PretransArgs& a) {
  int threads = a.edge_groups * a.quads;
  if (threads < a.feat_chunk) threads = a.feat_chunk;
  return (threads + kWarp - 1) / kWarp * kWarp;
}

// The tile of the walk for a.n_feat and a.fe (every geometry field but
// tile_segs); returns the dynamic shared memory of a block in bytes.
inline size_t pretrans_tile(PretransArgs& a) {
  const int n_chunks = (a.n_feat + kMaxFeatChunk - 1) / kMaxFeatChunk;
  a.feat_chunk = (a.n_feat + n_chunks - 1) / n_chunks;
  a.quads = (a.feat_chunk + 3) / 4;
  a.edge_groups = kMaxThreads / a.quads;
  if (a.edge_groups > kMaxEdgeGroups) a.edge_groups = kMaxEdgeGroups;
  a.tile_edges = a.edge_groups * kEdgesPerThread;   // >= 32 == SEG
  a.groups = pretrans_threads(a) / a.feat_chunk;
  a.fe_pad = (a.fe + 3) / 4 * 4;
  const int ms = 4 * a.quads;
  return sizeof(float) *
         (static_cast<size_t>(a.fe_pad) * ms +
          static_cast<size_t>(a.tile_edges) * (a.fe_pad + ms + 2));
}

inline cudaError_t pretrans_geometry(PretransArgs& a, PretransLaunch& l) {
  const int n_chunks = (a.n_feat + kMaxFeatChunk - 1) / kMaxFeatChunk;
  l.smem = pretrans_tile(a);
  if (l.smem > kSmemLimit) return cudaErrorInvalidValue;
  const int threads = pretrans_threads(a);

  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  // one tile per resident block where kMaxTileSegs allows it; else the
  // number of tiles is a multiple of the resident blocks, so that the last
  // round of the grid-stride loop is full
  const long long slots = static_cast<long long>(sms) * kBlocksPerSM;
  const long long rounds =
      (a.n_seg + slots * kMaxTileSegs - 1) / (slots * kMaxTileSegs);
  long long tile_segs = (a.n_seg + slots * rounds - 1) / (slots * rounds);
  if (tile_segs < 1) tile_segs = 1;
  if (tile_segs > kMaxTileSegs) tile_segs = kMaxTileSegs;
  a.tile_segs = static_cast<int>(tile_segs);
  const long long n_tiles = (a.n_seg + tile_segs - 1) / tile_segs;
  l.grid = dim3(static_cast<unsigned>(n_tiles < slots ? n_tiles : slots),
                static_cast<unsigned>(n_chunks));
  l.block = dim3(static_cast<unsigned>(threads));
  return cudaSuccess;
}

// Launches `kernel` with the geometry `l`.
template <typename Kernel, typename... Args>
cudaError_t pretrans_launch(Kernel kernel, const PretransLaunch& l,
                            cudaStream_t st, Args... args) {
  return launch_dynamic(kernel, l.grid, l.block, l.smem, st, args...);
}

}  // namespace pna
