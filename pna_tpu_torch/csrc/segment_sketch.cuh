// The moment sketch of a segment of messages and the merge of a split node's
// partial sketches, shared by K1 (csr_moment_sketch.cu) and K3
// (csr_pretrans_sketch.cu).
//
// A sketch is (sum, sum of squares, max, min, ties of the max, ties of the
// min) of one feature over a run of edges.  Both kernels reduce a segment's
// messages from a shared-memory tile, one thread per (segment, feature), and
// write the result to the node's outputs, or, where the node's range is cut
// into several segments, to a partial slot [slot, 6, F]; a second kernel then
// merges each split node's partials in segment order.  The rules:
//   * sums add in edge order; the square is __fmul_rn then __fadd_rn, never
//     an FMA, so the roundings are those of the plain PyTorch version;
//   * a larger value restarts the max's tie count at 1, an equal one adds 1
//     (likewise the min); merging two sketches, the larger max keeps its
//     count and equal maxima add their counts;
//   * an empty run is (0, 0, 0, 0, 1, 1);
//   * one writer per element, no atomics, an order fixed by the sizes: the
//     same bits every run.

#pragma once

#include <cuda_runtime.h>

#include "csr_common.cuh"

namespace pna {

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

// One more message into the running sketch.
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

// The sketch of the messages col[lo * stride], ..., col[(hi - 1) * stride]
// of a shared-memory tile, in that order.
template <bool kTies>
__device__ __forceinline__ void sketch_column(const float* col, int stride,
                                              int lo, int hi, float& s,
                                              float& sq, float& mx, float& mn,
                                              float& tmx, float& tmn) {
  s = sq = mx = mn = 0.f;
  tmx = tmn = 1.f;
  if (hi <= lo) return;
  const float m0 = col[lo * stride];
  s = m0;
  sq = __fmul_rn(m0, m0);
  mx = m0;
  mn = m0;
  for (int le = lo + 1; le < hi; ++le) {
    sketch_add<kTies>(col[le * stride], s, sq, mx, mn, tmx, tmn);
  }
}

// Writes the sketch of feature f of one segment: to the outputs of `node`
// where it is the node's only segment (slot < 0, or no partials at all),
// else to the partial `slot`.  With `resume` the destination holds the
// sketch of the segment's earlier part, written by this same thread, and
// this part is folded into it first.
template <bool kTies>
__device__ __forceinline__ void sketch_store(const SketchOut& o, int node,
                                             int slot, int f, bool resume,
                                             float s, float sq, float mx,
                                             float mn, float tmx, float tmn) {
  if (slot < 0 || o.part == nullptr) {
    const long long at = static_cast<long long>(node) * o.n_feat + f;
    if (resume) {
      sketch_resume<kTies>(o.s[at], o.sq[at], o.mx[at], o.mn[at],
                           kTies ? o.tmx[at] : 1.f, kTies ? o.tmn[at] : 1.f,
                           s, sq, mx, mn, tmx, tmn);
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
    const int nf = o.n_feat;
    float* q =
        o.part + static_cast<long long>(min(slot, o.n_part - 1)) * 6 * nf + f;
    if (resume) {
      sketch_resume<kTies>(q[0], q[nf], q[2 * nf], q[3 * nf],
                           kTies ? q[4 * nf] : 1.f, kTies ? q[5 * nf] : 1.f,
                           s, sq, mx, mn, tmx, tmn);
    }
    q[0] = s;
    q[nf] = sq;
    q[2 * nf] = mx;
    q[3 * nf] = mn;
    if (kTies) {
      q[4 * nf] = tmx;
      q[5 * nf] = tmn;
    }
  }
}

constexpr int kMergeThreads = 1024;

// One block per split node j.  Threads are (row c, feature): row c folds its
// contiguous share of the partials [split_ptr[j], split_ptr[j + 1]) in
// order, then row 0 folds the rows' results in order.  The order depends
// only on the sizes, so every run gives the same bits.
template <bool kTies>
__global__ void __launch_bounds__(kMergeThreads)
sketch_merge_kernel(const int* __restrict__ split_node,
                    const int* __restrict__ split_ptr, int n_part, int n_nodes,
                    const SketchOut o) {
  __shared__ float row_s[6][kMergeThreads];
  const int j = blockIdx.x;
  const int fw = min(o.n_feat, kMergeThreads);
  const int rows = kMergeThreads / fw;
  const int c = threadIdx.x / fw;
  const int fl = threadIdx.x - c * fw;
  const int node = clampi(split_node[j], 0, n_nodes - 1);
  const int p0 = clampi(split_ptr[j], 0, n_part);
  const int p1 = clampi(split_ptr[j + 1], p0, n_part);
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

// The merge of the n_split split nodes, after the kernel that wrote their
// partials, on the same stream.
inline cudaError_t launch_sketch_merge(const int* split_node,
                                       const int* split_ptr, int n_split,
                                       int n_nodes, const SketchOut& o,
                                       bool ties, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n_split));
  if (ties) {
    sketch_merge_kernel<true><<<grid, kMergeThreads, 0, st>>>(
        split_node, split_ptr, o.n_part, n_nodes, o);
  } else {
    sketch_merge_kernel<false><<<grid, kMergeThreads, 0, st>>>(
        split_node, split_ptr, o.n_part, n_nodes, o);
  }
  return cudaGetLastError();
}

}  // namespace pna
