// K3: CSR moment sketch of the pretrans message, formed on chip, for Hopper
// (sm_90a).
//
// Replaces pna_tpu/ops/pallas_kernels.py::sorted_pretrans_sketch (kernel
// body _pretrans_sketch_kernel).  For each node n and feature f, over the
// receiver-sorted edge range [ptr[n], ptr[n+1]), with the message
//   m[e, f] = (u[snd[e], f] + v[n, f]) + sum_k ef[e, k] ke[k, f]
// (pretrans_msg.cuh), it gives K1's outputs: sum, sum of squares, max, min,
// and (with ties) the number of edges whose message equals the max and the
// min.  An empty node gets 0 for every moment and 1 for both tie counts.
// The [E, F] message never reaches device memory.
//
// u may have more rows than v (a ghost sender table: local rows followed by
// halo rows); snd indexes u and the segments span v's nodes.  Pointers are
// clamped into [0, E], senders into [0, Nu) and nodes into [0, N), so bad
// indices cannot leave the inputs (a clamped gather, as an XLA gather does).
//
// Bound on this card: HBM bytes.  u, v, ef and the senders are read once and
// six [N, F] outputs written: at the flagship ZINC step (42,356 real edges,
// 19,792 nodes, F = 70, Fe = 50, float32) about 53.1 MB with ties, some
// 15.8 us at 3.35 TB/s.  The operations, about 107 per (edge, feature) with
// the 50-term edge-feature dot, are 3.2e8: below that bound even at the
// non-FMA float32 rate, since the message forbids contraction.
//
// What the first design lost time on.  It was K1's node-owned walk: one warp
// per (node, 32 features) walked the node's edges, and for every (edge,
// feature) term it made a global load of ef[e, k], a strided global load
// of ke[k, f] and index arithmetic beside the multiply and the add: about
// 220 warp instructions per edge and warp where 100 do the arithmetic.
// F = 70 made three warps per node, the third with 6 of 32 lanes at work.
// A node of in-degree 2 gave its warp a serial chain of dependent loads and
// 50 dependent adds with nothing to overlap, and a hub node's whole range
// was walked by three warps: bound by instruction rate and latency, 7 times
// the byte bound at the flagship shapes and 3,900 times on a hub of 13,107
// edges.
//
// This design (pretrans_msg.cuh holds the walk, shared with K4):
//   * segments, not nodes, are the unit of work: a range longer than SEG
//     edges is cut, so a hub spreads over the card;
//   * the edge-feature term of a tile of up to 64 edges is a register-tiled
//     product on the CUDA cores: ef rows and the block's slice of ke are
//     staged once in shared memory, a thread owns 4 edges x 4 features and
//     reads 8 16-byte shared values per 128 operations, each running sum its
//     own chain in increasing k.  The work is spread over (edge, feature
//     quad) whatever node an edge belongs to, on 18 quads of 4 for F = 70
//     (70 of 72 lanes at work), with 16 independent chains per thread, all
//     of a thread's u and v loads in flight together, and three blocks of
//     288 threads on an SM;
//   * the messages go to a shared tile, and a (segment, feature) thread
//     reduces its segment from there with K1's arithmetic (a larger value
//     restarts the tie count at 1, an equal one adds 1);
//   * a node with one segment writes its outputs directly; a split node's
//     segments write partials [slot, 6, F], which a second kernel merges,
//     one block per split node: each of a few thread rows folds a contiguous
//     run of the partials in order, then one row folds the rows in order:
//     sums add; a larger max (smaller min) replaces value and tie count, an
//     equal one adds its count.  One writer per element, no atomics, a fixed
//     order: the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pretrans_msg.cuh"

namespace {

struct SketchOut {
  float* s;
  float* sq;
  float* mx;
  float* mn;
  float* tmx;    // null without ties
  float* tmn;
  float* part;   // [n_part, 6, F] partials of split nodes, or null
  int n_feat;
  int n_part;
};

// One more message into the running sketch, K1's rule.
template <bool kTies>
__device__ __forceinline__ void sketch_add(float m, float& s, float& sq,
                                           float& mx, float& mn, float& tmx,
                                           float& tmn) {
  s = __fadd_rn(s, m);
  sq = __fadd_rn(sq, __fmul_rn(m, m));
  if (kTies) {
    if (m > mx) {
      mx = m;
      tmx = 1.f;
    } else if (m == mx) {
      tmx += 1.f;
    }
    if (m < mn) {
      mn = m;
      tmn = 1.f;
    } else if (m == mn) {
      tmn += 1.f;
    }
  } else {
    mx = fmaxf(mx, m);
    mn = fminf(mn, m);
  }
}

// A partial sketch merged into a running one, in order.
template <bool kTies>
__device__ __forceinline__ void sketch_merge(float ps, float psq, float pmx,
                                             float pmn, float ptmx,
                                             float ptmn, float& s, float& sq,
                                             float& mx, float& mn, float& tmx,
                                             float& tmn) {
  s = __fadd_rn(s, ps);
  sq = __fadd_rn(sq, psq);
  if (kTies) {
    if (pmx > mx) {
      mx = pmx;
      tmx = ptmx;
    } else if (pmx == mx) {
      tmx += ptmx;
    }
    if (pmn < mn) {
      mn = pmn;
      tmn = ptmn;
    } else if (pmn == mn) {
      tmn += ptmn;
    }
  } else {
    mx = fmaxf(mx, pmx);
    mn = fminf(mn, pmn);
  }
}

// The sketch (s .. tmn) of the later part of a segment, folded into the
// sketch (ps .. ptmn) of its earlier part; the result is left in s .. tmn.
template <bool kTies>
__device__ __forceinline__ void sketch_resume(float ps, float psq, float pmx,
                                              float pmn, float ptmx,
                                              float ptmn, float& s, float& sq,
                                              float& mx, float& mn, float& tmx,
                                              float& tmn) {
  sketch_merge<kTies>(s, sq, mx, mn, tmx, tmn, ps, psq, pmx, pmn, ptmx, ptmn);
  s = ps;
  sq = psq;
  mx = pmx;
  mn = pmn;
  tmx = ptmx;
  tmn = ptmn;
}

template <bool kTies>
struct SketchPhase2 {
  SketchOut o;

  // the sketch reduces the messages themselves
  __device__ __forceinline__ void message(long long, long long, int,
                                          float (&)[4]) const {}

  __device__ __forceinline__ void operator()(const pna::TileView& t) const {
    if (!t.active) return;
    for (int ls = t.sa + t.g; ls < t.sb; ls += t.groups) {
      const int lo = pna::clampi(t.seg_ptr_s[ls] - t.e0, 0, t.ne);
      const int hi = pna::clampi(t.seg_ptr_s[ls + 1] - t.e0, 0, t.ne);
      float s = 0.f, sq = 0.f, mx = 0.f, mn = 0.f, tmx = 1.f, tmn = 1.f;
      if (hi > lo) {
        const float* col = t.m_s + t.fl;
        const float m0 = col[lo * t.ms];
        s = m0;
        sq = __fmul_rn(m0, m0);
        mx = m0;
        mn = m0;
        for (int le = lo + 1; le < hi; ++le) {
          sketch_add<kTies>(col[le * t.ms], s, sq, mx, mn, tmx, tmn);
        }
      }
      const int slot = t.slot_s[ls];
      const bool resume = t.cont && ls == t.sa;   // an earlier part exists
      if (slot < 0 || o.part == nullptr) {   // the node's only segment
        const long long at =
            static_cast<long long>(t.node_s[ls]) * o.n_feat + t.f;
        if (resume) {
          sketch_resume<kTies>(o.s[at], o.sq[at], o.mx[at], o.mn[at],
                               kTies ? o.tmx[at] : 1.f,
                               kTies ? o.tmn[at] : 1.f, s, sq, mx, mn, tmx,
                               tmn);
        }
        o.s[at] = s;
        o.sq[at] = sq;
        o.mx[at] = mx;
        o.mn[at] = mn;
        if (kTies) {
          o.tmx[at] = tmx;
          o.tmn[at] = tmn;
        }
      } else {
        float* q = o.part +
                   static_cast<long long>(min(slot, o.n_part - 1)) * 6 *
                       o.n_feat +
                   t.f;
        if (resume) {
          sketch_resume<kTies>(q[0], q[o.n_feat], q[2 * o.n_feat],
                               q[3 * o.n_feat],
                               kTies ? q[4 * o.n_feat] : 1.f,
                               kTies ? q[5 * o.n_feat] : 1.f, s, sq, mx, mn,
                               tmx, tmn);
        }
        q[0] = s;
        q[o.n_feat] = sq;
        q[2 * o.n_feat] = mx;
        q[3 * o.n_feat] = mn;
        if (kTies) {
          q[4 * o.n_feat] = tmx;
          q[5 * o.n_feat] = tmn;
        }
      }
    }
  }
};

template <typename T, bool kEdgeFeatures, bool kTies>
__global__ void __launch_bounds__(pna::kMaxThreads, pna::kBlocksPerSM)
csr_pretrans_sketch_kernel(const pna::PretransArgs a, const SketchOut o) {
  const SketchPhase2<kTies> phase2{o};
  pna::pretrans_walk<T, kEdgeFeatures>(a, phase2);
}

constexpr int kMergeThreads = 1024;

// One block per split node j.  Threads are (row c, feature): row c folds its
// contiguous share of the partials [split_ptr[j], split_ptr[j + 1]) in
// order, then row 0 folds the rows' results in order.  The order depends
// only on the sizes, so every run gives the same bits.
template <bool kTies>
__global__ void __launch_bounds__(kMergeThreads)
csr_pretrans_sketch_merge_kernel(const int* __restrict__ split_node,
                                 const int* __restrict__ split_ptr,
                                 int n_part, int n_nodes, const SketchOut o) {
  __shared__ float row_s[6][kMergeThreads];
  const int j = blockIdx.x;
  const int fw = min(o.n_feat, kMergeThreads);
  const int rows = kMergeThreads / fw;
  const int c = threadIdx.x / fw;
  const int fl = threadIdx.x - c * fw;
  const int node = pna::clampi(split_node[j], 0, n_nodes - 1);
  const int p0 = pna::clampi(split_ptr[j], 0, n_part);
  const int p1 = pna::clampi(split_ptr[j + 1], p0, n_part);
  const int share = (p1 - p0 + rows - 1) / rows;
  const int lo = min(p0 + c * share, p1);
  const int hi = min(lo + share, p1);
  const long long stride = 6LL * o.n_feat;
  const int nf = o.n_feat;
  for (int f0 = 0; f0 < nf; f0 += fw) {
    const int f = f0 + fl;
    const bool live = c < rows && f < nf;
    float s = 0.f, sq = 0.f, mx = 0.f, mn = 0.f, tmx = 1.f, tmn = 1.f;
    if (live && hi > lo) {
      const float* q = o.part + lo * stride + f;
      s = q[0];
      sq = q[nf];
      mx = q[2 * nf];
      mn = q[3 * nf];
      if (kTies) {
        tmx = q[4 * nf];
        tmn = q[5 * nf];
      }
#pragma unroll 4
      for (int p = lo + 1; p < hi; ++p) {
        q += stride;
        sketch_merge<kTies>(q[0], q[nf], q[2 * nf], q[3 * nf],
                            kTies ? q[4 * nf] : 1.f, kTies ? q[5 * nf] : 1.f,
                            s, sq, mx, mn, tmx, tmn);
      }
    }
    __syncthreads();   // the previous feature chunk's fold has read row_s
    row_s[0][threadIdx.x] = s;
    row_s[1][threadIdx.x] = sq;
    row_s[2][threadIdx.x] = mx;
    row_s[3][threadIdx.x] = mn;
    row_s[4][threadIdx.x] = tmx;
    row_s[5][threadIdx.x] = tmn;
    __syncthreads();
    if (c == 0 && f < nf) {
      // rows are filled in order, so row r is empty iff it starts at p1
      for (int r = 1; r < rows && p0 + r * share < p1; ++r) {
        const int at = r * fw + fl;
        sketch_merge<kTies>(row_s[0][at], row_s[1][at], row_s[2][at],
                            row_s[3][at], row_s[4][at], row_s[5][at], s, sq,
                            mx, mn, tmx, tmn);
      }
      const long long at = static_cast<long long>(node) * nf + f;
      o.s[at] = s;
      o.sq[at] = sq;
      o.mx[at] = mx;
      o.mn[at] = mn;
      if (kTies) {
        o.tmx[at] = tmx;
        o.tmn[at] = tmn;
      }
    }
  }
}

template <typename T, bool kEdgeFeatures>
cudaError_t launch_ties(const pna::PretransArgs& a,
                        const pna::PretransLaunch& l, const SketchOut& o,
                        bool ties, cudaStream_t st) {
  return ties ? pna::pretrans_launch(
                    csr_pretrans_sketch_kernel<T, kEdgeFeatures, true>, l, st,
                    a, o)
              : pna::pretrans_launch(
                    csr_pretrans_sketch_kernel<T, kEdgeFeatures, false>, l,
                    st, a, o);
}

template <typename T>
cudaError_t launch(const pna::PretransArgs& a, const pna::PretransLaunch& l,
                   const SketchOut& o, bool ties, cudaStream_t st) {
  return a.fe > 0 ? launch_ties<T, true>(a, l, o, ties, st)
                  : launch_ties<T, false>(a, l, o, ties, st);
}

}  // namespace

// The dynamic shared memory, in bytes, of a block of K3 or K4 for F = n_feat
// and Fe = fe, and the most a block may have: a launch with more is refused.
extern "C" long long pna_pretrans_shared_bytes(int n_feat, int fe) {
  pna::PretransArgs a{};
  a.n_feat = n_feat > 0 ? n_feat : 1;
  a.fe = fe > 0 ? fe : 0;
  return static_cast<long long>(pna::pretrans_tile(a));
}

extern "C" long long pna_pretrans_shared_limit() {
  return static_cast<long long>(pna::kSmemLimit);
}

// u [Nu, F] f32; v [N, F], ef [E, Fe] and ke [Fe, F] all float32
// (bf16 == 0) or all bfloat16 (bf16 == 1); snd [E] int32; fe == 0 for no
// edge features (ef, ke unused).  The segment table of the N nodes:
// seg_ptr [S + 1] int32 nondecreasing, seg_node [S] and seg_slot [S] int32
// (both null where no node is split: S == N and seg_ptr is the row
// pointers; a segment may have any length, though the table of
// csr_kernels.csr_segments keeps each to SEG edges so that a hub spreads);
// split_node [n_split], split_ptr [n_split + 1] int32 and the
// scratch part [n_part, 6, F] f32 for the split nodes.  Outputs [N, F] f32
// each (tmx/tmn only written when with_ties).  Launches on `stream` (one
// kernel, two where a node is split) and returns the cudaError_t of the
// launch.
extern "C" int pna_csr_pretrans_sketch(
    const float* u, const void* v, const int* snd, const int* seg_ptr,
    const int* seg_node, const int* seg_slot, const int* split_node,
    const int* split_ptr, const void* ef, const void* ke, int bf16, int n_seg,
    int n_split, int n_part, int n_nodes, int n_u, int n_edges, int n_feat,
    int fe, float* s, float* sq, float* mx, float* mn, float* tmx, float* tmn,
    float* part, int with_ties, void* stream) {
  if (n_nodes <= 0 || n_feat <= 0) return static_cast<int>(cudaSuccess);
  if (n_seg < n_nodes || fe < 0 || (n_u <= 0 && n_edges > 0) ||
      (n_split > 0 && (part == nullptr || seg_slot == nullptr ||
                       seg_node == nullptr || n_part <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  pna::PretransArgs a{u,     v,       snd, seg_ptr, seg_node, seg_slot, ef,
                      ke,    n_seg,   n_nodes, n_u, n_edges,  n_feat,   fe,
                      0,     0,       0,   0,       0,       0,        0};
  pna::PretransLaunch l;
  cudaError_t rc = pna::pretrans_geometry(a, l);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const SketchOut o{s, sq, mx, mn, tmx, tmn, n_split > 0 ? part : nullptr,
                    n_feat, n_part};
  rc = bf16 ? launch<__nv_bfloat16>(a, l, o, with_ties != 0, st)
            : launch<float>(a, l, o, with_ties != 0, st);
  if (rc != cudaSuccess || n_split <= 0) return static_cast<int>(rc);

  const dim3 grid(static_cast<unsigned>(n_split));
  if (with_ties) {
    csr_pretrans_sketch_merge_kernel<true><<<grid, kMergeThreads, 0, st>>>(
        split_node, split_ptr, n_part, n_nodes, o);
  } else {
    csr_pretrans_sketch_merge_kernel<false><<<grid, kMergeThreads, 0, st>>>(
        split_node, split_ptr, n_part, n_nodes, o);
  }
  return static_cast<int>(cudaGetLastError());
}
