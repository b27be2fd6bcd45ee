// K1: CSR moment sketch for Hopper (sm_90a).
//
// Replaces pna_tpu/ops/pallas_kernels.py::sorted_moment_sketch
// (kernel body _sketch_kernel).  For each node n and feature f, over the
// receiver-sorted edge range [ptr[n], ptr[n+1]):
//   sum, sum of squares, max, min, and (with ties) the number of edges whose
//   value equals the max and the min.  An empty node gets 0 for every moment
//   and 1 for both tie counts (the clamp of the TPU kernel).  Rows outside
//   [ptr[0], ptr[N]) enter nothing.
//
// Bound on this card: HBM bytes.  Each message value is read once and each
// output once written, a handful of float operations per value: at the
// flagship ZINC step (42,356 real edges, 19,792 nodes, F = 70) that is about
// 11.9 MB read and 33.2 MB written with ties, some 13.5 us at 3.35 TB/s;
// the operations are far below the float32 rate.
//
// What the first design lost time on.  It gave one warp to each (node, 32
// features): at a mean in-degree of 2.14 a warp loaded two pointers, then two
// or three 128-byte lines that depend on them, stored six lines and left, so
// the card held little memory in flight and waited on latency; at F = 70 the
// third warp of a node had 6 of 32 lanes at work and every 128-byte access
// began off a 32-byte sector; and a hub node's range was the serial loop of
// three warps (1.4 ms on an H100 for 13,107 edges).
//
// This design:
//   * the work list is the segment table that K3/K4 walk
//     (csr_kernels.csr_segments: ranges cut at SEG edges, so a hub spreads
//     over the card; the row pointers themselves where no node is split).  A
//     node with one segment writes its outputs directly; a split node's
//     segments write partials and a second kernel merges them in segment
//     order: the rules, the store and that kernel are segment_sketch.cuh,
//     shared with K3;
//   * a block takes tiles of `tile_segs` consecutive segments in a
//     grid-stride loop.  The message rows of consecutive segments are one
//     contiguous span of msg, so a span goes to shared memory by asynchronous
//     copies (cp.async, no registers on the way), all of its bytes in flight
//     at once whatever the degrees are.  There are two buffers: the next
//     span's table and copies are started before this span is reduced;
//   * threads then index the flat range (segment, feature) of the span: no
//     lane idles at F = 70, and as consecutive segments are consecutive
//     nodes the stores of each output are contiguous across node boundaries;
//   * a span holds at most `tile_edges` edges (what fits a buffer).  A tile
//     with more is taken in several spans of whole segments, and a segment
//     longer than a span (csr_segments makes none, a caller's table may) is
//     walked in consecutive spans, each folding the result of the one before,
//     which the same thread wrote, into its own (K3's rule).
//
// Alignment.  Rows are staged whole, for any F >= 1 and any pointers: the
// copy takes the span [e0 * F, (e0 + ne) * F) of floats exactly, never a byte
// before msg or past msg + E * F.  Its place in the buffer is shifted by the
// span's offset from a 16-byte boundary in device memory (0 to 3 floats), so
// that the two addresses of a copy are aligned alike: up to 3 floats at
// either end go as 4-byte copies, all between as 16-byte copies.  A buffer
// holds kBufEdges rows, at most kMaxBufFloats floats; a row longer than that
// (F > 12,288) does not fit and is refused.  Wide rows are not split over
// blockIdx.y as K3's features are: a slice of the rows would not be
// contiguous.
//
// Sums are taken in edge order inside a segment and in segment order across
// a split node's segments; every output element and every partial has one
// writer and there are no atomics, so two runs give the same bits.

#include <cuda_runtime.h>

#include <cstdint>

#include "csr_common.cuh"
#include "segment_sketch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileSegs = 128;      // segments of one tile
constexpr int kBufEdges = 64;          // rows a staging buffer is sized for
constexpr int kMaxBufFloats = 12288;   // 48 KB: the most one buffer holds

struct SketchArgs {
  const float* msg;      // [E, F]
  const int* seg_ptr;    // [S + 1]
  const int* seg_node;   // [S], or null: segment s is node s
  const int* seg_slot;   // [S] partial slot or -1, or null: no node is split
  int n_seg, n_nodes, n_edges, n_feat;
  // launch geometry, filled by sketch_geometry
  int tile_segs;         // segments of one tile
  int tile_edges;        // edges of one span
  int buf_floats;        // floats of one staging buffer, a multiple of 4
};

// One span: the edges [e0, e0 + ne) of the segments [sa, sb) of a tile.
// Every thread of the block holds the same values.
struct Span {
  int tile;    // n_tiles or more: no span is left
  int tb;      // which of the two tables holds the tile's segments
  int ns;      // segments of the tile
  int sa, sb;
  int e0, ne;
  bool cont;   // segment sa began in the span before
  bool more;   // segment sa (then sb == sa + 1) goes on in the next span
};

struct Tables {
  int seg_ptr[2][kMaxTileSegs + 1];   // clamped into [0, E]
  int node[2][kMaxTileSegs];
  int slot[2][kMaxTileSegs];
};

// The segments of `tile` into table sp.tb; the caller synchronises.
__device__ __forceinline__ void load_table(const SketchArgs& a, Tables& t,
                                           Span& sp) {
  const int s0 = sp.tile * a.tile_segs;
  sp.ns = min(a.tile_segs, a.n_seg - s0);
  for (int i = threadIdx.x; i <= sp.ns; i += kThreads) {
    t.seg_ptr[sp.tb][i] = pna::clampi(a.seg_ptr[s0 + i], 0, a.n_edges);
  }
  for (int i = threadIdx.x; i < sp.ns; i += kThreads) {
    t.node[sp.tb][i] =
        a.seg_node ? pna::clampi(a.seg_node[s0 + i], 0, a.n_nodes - 1)
                   : s0 + i;
    t.slot[sp.tb][i] = a.seg_slot ? a.seg_slot[s0 + i] : -1;
  }
}

// The span from edge e0 of segment sa: as many whole segments as fit
// tile_edges edges, found by bisection; where not even segment sa's rest
// fits, tile_edges of its edges, and the next span continues it.
__device__ __forceinline__ void span_extent(const SketchArgs& a,
                                            const Tables& t, Span& sp) {
  const int* seg_ptr_s = t.seg_ptr[sp.tb];
  int sb = sp.sa + 1, hi = sp.ns;
  while (sb < hi) {
    const int mid = (sb + hi + 1) / 2;
    if (seg_ptr_s[mid] - sp.e0 <= a.tile_edges) {
      sb = mid;
    } else {
      hi = mid - 1;
    }
  }
  sp.sb = sb;
  const int rest = seg_ptr_s[sb] - sp.e0;
  sp.more = rest > a.tile_edges;
  sp.ne = pna::clampi(rest, 0, a.tile_edges);
}

// The first span of sp.tile, whose table is loaded and visible.
__device__ __forceinline__ void first_span(const SketchArgs& a,
                                           const Tables& t, Span& sp) {
  sp.sa = 0;
  sp.e0 = t.seg_ptr[sp.tb][0];
  sp.cont = false;
  span_extent(a, t, sp);
}

// Where in its buffer a span's first float lies: the offset of its address
// in device memory from a 16-byte boundary, in floats.
__device__ __forceinline__ int span_shift(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Starts the copies of a span's message rows into `buf`.
__device__ __forceinline__ void stage_span(const SketchArgs& a, const Span& sp,
                                           float* buf) {
  const float* src = a.msg + static_cast<long long>(sp.e0) * a.n_feat;
  const int count = sp.ne * a.n_feat;   // at most buf_floats
  const int shift = span_shift(src);
  float* dst = buf + shift;
  const int head = min(count, (4 - shift) & 3);
  const int n_vec = (count - head) >> 2;
  const int tail = head + 4 * n_vec;
  const int tid = threadIdx.x;
  if (tid < head) pna::cp_async_4(dst + tid, src + tid);
  for (int i = tid; i < n_vec; i += kThreads) {
    pna::cp_async_16(dst + head + 4 * i, src + head + 4 * i);
  }
  if (tid < count - tail) pna::cp_async_4(dst + tail + tid, src + tail + tid);
}

// Threads over the flat (segment, feature) range of the span: thread i takes
// items i, i + kThreads, ...; item j is feature j % F of segment sa + j / F,
// so the thread of the first segment's feature f is the same in every span
// (the writer of a continued segment).
template <bool kTies>
__device__ __forceinline__ void reduce_span(const SketchArgs& a,
                                            const Tables& t, const Span& sp,
                                            const float* buf,
                                            const pna::SketchOut& o, int q0,
                                            int r0, int dq, int dr) {
  const int nf = a.n_feat;
  const float* m_s =
      buf + span_shift(a.msg + static_cast<long long>(sp.e0) * nf);
  const int* seg_ptr_s = t.seg_ptr[sp.tb];
  int ls = sp.sa + q0;
  int f = r0;
  while (ls < sp.sb) {
    const int lo = pna::clampi(seg_ptr_s[ls] - sp.e0, 0, sp.ne);
    const int hi = pna::clampi(seg_ptr_s[ls + 1] - sp.e0, 0, sp.ne);
    float s, sq, mx, mn, tmx, tmn;
    pna::sketch_column<kTies>(m_s + f, nf, lo, hi, s, sq, mx, mn, tmx, tmn);
    pna::sketch_store<kTies>(o, t.node[sp.tb][ls], t.slot[sp.tb][ls], f,
                             sp.cont && ls == sp.sa, s, sq, mx, mn, tmx, tmn);
    ls += dq;
    f += dr;
    if (f >= nf) {
      f -= nf;
      ++ls;
    }
  }
}

template <bool kTies>
__global__ void __launch_bounds__(kThreads)
csr_moment_sketch_kernel(const SketchArgs a, const pna::SketchOut o) {
  extern __shared__ float4 sketch_smem[];
  __shared__ Tables t;
  float* bufs = reinterpret_cast<float*>(sketch_smem);
  const int buf_stride = a.buf_floats + 4;   // room for the shift
  const int n_tiles = (a.n_seg + a.tile_segs - 1) / a.tile_segs;
  // this thread's first item and the step to its next, as (segment, feature)
  const int q0 = threadIdx.x / a.n_feat;
  const int r0 = threadIdx.x - q0 * a.n_feat;
  const int dq = kThreads / a.n_feat;
  const int dr = kThreads - dq * a.n_feat;

  Span cur;
  cur.tile = blockIdx.x;
  if (cur.tile >= n_tiles) return;
  cur.tb = 0;
  load_table(a, t, cur);
  __syncthreads();
  first_span(a, t, cur);
  stage_span(a, cur, bufs);
  pna::cp_async_commit();

  int k = 0;
  while (cur.tile < n_tiles) {
    // the span after this one; its table (where it opens a tile) and its
    // copies are started now and arrive while this span is reduced
    Span nxt = cur;
    if (cur.more) {
      nxt.e0 = cur.e0 + cur.ne;
      nxt.cont = true;
      span_extent(a, t, nxt);
    } else if (cur.sb < cur.ns) {
      nxt.sa = cur.sb;
      nxt.e0 = t.seg_ptr[cur.tb][cur.sb];
      nxt.cont = false;
      span_extent(a, t, nxt);
    } else {
      nxt.tile = cur.tile + gridDim.x;
      if (nxt.tile < n_tiles) {
        // the other table: its last reader was the reduction of the tile
        // before this one, which ended in a barrier
        nxt.tb = cur.tb ^ 1;
        load_table(a, t, nxt);
        __syncthreads();
        first_span(a, t, nxt);
      }
    }
    if (nxt.tile < n_tiles) stage_span(a, nxt, bufs + (k ^ 1) * buf_stride);
    pna::cp_async_commit();      // a group every round, empty or not
    pna::cp_async_wait<1>();     // this thread's copies of `cur` have landed
    __syncthreads();             // and everyone else's
    reduce_span<kTies>(a, t, cur, bufs + k * buf_stride, o, q0, r0, dq, dr);
    __syncthreads();   // buffer k and cur's table are free for the round after
    cur = nxt;
    k ^= 1;
  }
}

struct SketchLaunch {
  dim3 grid;
  size_t smem;
};

// Floats of one staging buffer for rows of n_feat floats.
inline int sketch_buf_floats(int n_feat) {
  const long long want =
      (static_cast<long long>(kBufEdges) * n_feat + 3) / 4 * 4;
  return static_cast<int>(want < kMaxBufFloats ? want : kMaxBufFloats);
}

template <typename Kernel>
cudaError_t sketch_geometry(Kernel kernel, SketchArgs& a, SketchLaunch& l) {
  a.buf_floats = sketch_buf_floats(a.n_feat);
  a.tile_edges = a.buf_floats / a.n_feat;
  if (a.tile_edges < 1) return cudaErrorInvalidValue;
  l.smem = 2 * sizeof(float) * static_cast<size_t>(a.buf_floats + 4);
  if (l.smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(l.smem));
    if (rc != cudaSuccess) return rc;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                     l.smem);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidValue;
  // Tiles of as many segments as fill three quarters of a span at the
  // table's mean segment length (a tile over a span's size is taken in
  // several spans), at most kMaxTileSegs; fewer where that leaves resident
  // blocks without a tile; and such that the last round of the grid-stride
  // loop is full.
  const long long slots = static_cast<long long>(sms) * per_sm;
  long long most = kMaxTileSegs;
  if (a.n_edges > 0) {
    most = 3LL * a.tile_edges * a.n_seg / (4LL * a.n_edges);
    most = most < 1 ? 1 : (most > kMaxTileSegs ? kMaxTileSegs : most);
  }
  const long long rounds = (a.n_seg + slots * most - 1) / (slots * most);
  long long tile_segs = (a.n_seg + slots * rounds - 1) / (slots * rounds);
  tile_segs = tile_segs < 1 ? 1 : (tile_segs > most ? most : tile_segs);
  a.tile_segs = static_cast<int>(tile_segs);
  const long long n_tiles = (a.n_seg + tile_segs - 1) / tile_segs;
  l.grid = dim3(static_cast<unsigned>(n_tiles < slots ? n_tiles : slots));
  return cudaSuccess;
}

template <bool kTies>
cudaError_t launch(SketchArgs& a, const pna::SketchOut& o, cudaStream_t st) {
  SketchLaunch l;
  const cudaError_t rc =
      sketch_geometry(csr_moment_sketch_kernel<kTies>, a, l);
  if (rc != cudaSuccess) return rc;
  csr_moment_sketch_kernel<kTies><<<l.grid, kThreads, l.smem, st>>>(a, o);
  return cudaGetLastError();
}

}  // namespace

// The widest row, in floats, that K1 stages: a wider msg is refused.
extern "C" int pna_csr_moment_sketch_max_feat() { return kMaxBufFloats; }

// msg [E, F] f32 row-major.  The segment table of the N nodes, as
// pna_csr_pretrans_sketch takes it: seg_ptr [S + 1] int32 nondecreasing,
// seg_node [S] and seg_slot [S] int32 (both null where no node is split:
// S == N and seg_ptr is the row pointers; a segment may have any length);
// split_node [n_split], split_ptr [n_split + 1] int32 and the scratch part
// [n_part, 6, F] f32 for the split nodes.  Outputs [N, F] f32 each (tmx/tmn
// only written when with_ties).  Launches on `stream` (one kernel, two where
// a node is split) and returns the cudaError_t of the launch.
extern "C" int pna_csr_moment_sketch(
    const float* msg, const int* seg_ptr, const int* seg_node,
    const int* seg_slot, const int* split_node, const int* split_ptr,
    int n_seg, int n_split, int n_part, int n_nodes, int n_edges, int n_feat,
    float* s, float* sq, float* mx, float* mn, float* tmx, float* tmn,
    float* part, int with_ties, void* stream) {
  if (n_nodes <= 0 || n_feat <= 0) return static_cast<int>(cudaSuccess);
  if (n_seg < n_nodes || n_edges < 0 ||
      (n_split > 0 && (part == nullptr || seg_slot == nullptr ||
                       seg_node == nullptr || n_part <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  SketchArgs a{msg, seg_ptr, seg_node, seg_slot, n_seg, n_nodes,
               n_edges, n_feat, 0, 0, 0};
  const pna::SketchOut o{s, sq, mx, mn, tmx, tmn,
                         n_split > 0 ? part : nullptr, n_feat, n_part};
  const cudaError_t rc = with_ties ? launch<true>(a, o, st)
                                   : launch<false>(a, o, st);
  if (rc != cudaSuccess || n_split <= 0) return static_cast<int>(rc);
  return static_cast<int>(pna::launch_sketch_merge(
      split_node, split_ptr, n_split, n_nodes, o, with_ties != 0, st));
}
