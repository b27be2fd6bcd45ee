// Graph attention over a receiver-sorted layout (GAT, Velickovic et al.,
// arXiv:1710.10903), forward and backward, for Hopper (sm_90a).
//
// It replaces no pallas_call: the JAX package has no attention kernel, and
// its sparse GAT layer (pna_tpu/nn/layers.py) gathers an [E, F_head] tensor
// per head.  Here, with hW [Nt, H*F] (the projected sender table; its first
// N rows are the receivers' own), the per-node head scores s_src [Nt, H],
// s_dst [N, H] and node i's in-edges [ptr[i], ptr[i+1]) plus its self term:
//   e_ij  = LeakyReLU_0.2(s_dst[i] + s_src[j])     j in N(i) and j = i
//   a_ij  = exp(e_ij - m_i) / l_i,  m_i = max_j e_ij,  l_i = sum_j exp(..)
//   out_i = sum_j a_ij hW[j]                          (per head)
// and the backward, given d_out [N, H*F]:
//   d_ij    = a_ij (d_out_i . hW_j - d_out_i . out_i) LeakyReLU'(z_ij)
//   d_s_dst[i] = sum_j d_ij              (a receiver sum)
//   d_s_src[j] = sum_i d_ij              (a sender sum)
//   d_hW[j] = sum_i a_ij d_out_i + d_s_src[j] a_src + d_s_dst[j] a_dst
// (the last term for j < N): the sums over i in sender order, d_s_dst's
// over j in receiver order.
//
// Bound on this card: bytes.  At the large graph's wide layers (625,000
// receivers, 6.25M in-edges, H = 4 heads of 256) every edge moves a 4 KB
// row: the forward reads hW[j] (a power-law sender table, whose hub rows
// stay in L2), the backward's sender pass reads d_out[i] (random rows, no
// reuse).  No [E, H*F] tensor is ever written, and the backward reads no
// row a second time per edge: only the per-edge head scalars d_ij ([E, H])
// pass from its sender pass to its receiver sums, and the forward keeps
// only m and l ([N, H]) for the backward.
//
// The backward's three passes, and where each sum is formed:
//   1. the pre-pass (gat_attend_bwd_recv_kernel), a warp a receiver:
//      delta_i = d_out_i . out_i per head, reading out and d_out once;
//   2. the sender pass (gat_attend_bwd_send_kernel), a warp a segment of
//      sender j's sorted out-edges, hW_j in registers: for each edge d_out_i
//      gathered once, a_ij from the head scalars, the dot d_out_i . hW_j,
//      d_ij; a_ij d_out_i and d_ij summed by sender in sender order, d_ij
//      written to de_e.  A node of one segment finishes its row there: its
//      self term (d_jj kept in de_self), then d_s_src[j] a_src;
//   3. a split sender's merge (gat_attend_merge_runs_kernel, then
//      gat_attend_merge_final_kernel): its slots summed in kRuns runs, the
//      runs in order, then its self term, d_s_dst[j] (self first, then its
//      in-edges' d_ij in receiver order) and both score terms.  The final
//      kernel's warps past the split senders are the post-pass: per other
//      receiver i, d_s_dst[i] summed the same way and d_s_dst[i] a_dst added
//      to the row the sender pass rounded and stored, which gives the float
//      one expression would.  Halo rows (j >= N) take no self or a_dst term.
//
// What the design does about it:
//   * a warp per row of work (a receiver, a sender segment, a merge run):
//     lane l holds features l + 32k of each head (k < KH), so a head's dot
//     product is a warp sum with no shared memory, any head width up to
//     32 KH works (121, PPI's label count, is no multiple of 4), and a row's
//     KH x H loads are independent and in flight together;
//   * the forward takes the maximum over the head scalars first (4 bytes a
//     head an edge), then one pass over the rows with the weights final, so
//     no running sum is ever rescaled;
//   * the sender pass loads the next edge's indices ahead of each edge's
//     sums, and lane h computes head h's scalar terms, so a receiver's side
//     costs four scalars a lane beside its row; register caps
//     (kSendBlocks, kFinalBlocks) buy the warps that keep rows in flight;
//   * the sender pass walks the senders' stable sort (the row sum's sender
//     layout) in segments of at most SEG edges (ops/csr_gat.py): a hub's
//     segments write partial rows to scratch, which the merge sums, each in
//     a fixed order.  One writer for every output element, no atomics, so
//     two launches give the same bits;
//   * every sum is __fadd_rn / __fmul_rn in a fixed order (warp sums by
//     xor butterfly, so every lane holds the same value), and expf is the
//     full-precision one, so ops/csr_gat.py's plain versions repeat the
//     kernels' roundings.
//
// With -DPNA_HOST_CHECK the source compiles with a host C++ compiler against
// the stub cuda_runtime.h of tests/test_torch_csrc_host.py: a block is then
// one warp, and a warp's shuffle goes through a static buffer.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

#ifdef PNA_HOST_CHECK
constexpr int kWarps = 1;
#else
constexpr int kWarps = 4;
#endif
constexpr int kThreads = 32 * kWarps;
constexpr int kRuns = 64;       // runs of a split sender's merge
constexpr float kSlope = 0.2f;  // LeakyReLU's negative slope
// Blocks an SM must hold of the sender pass and of the final kernel: caps
// of 128 and 64 registers a thread, which buy the warps that keep rows in
// flight.  The final kernel's split-sender warps spill under its cap; they
// are few (715 at the GAT cell) beside its post-pass warps, a receiver each.
constexpr int kSendBlocks = 4;
constexpr int kFinalBlocks = 8;

__device__ __forceinline__ float f_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float f_mul(float a, float b) {
  return __fmul_rn(a, b);
}
#ifdef PNA_HOST_CHECK
inline float f_sub(float a, float b) {
  volatile float r = a - b;
  return r;
}
inline float f_div(float a, float b) {
  volatile float r = a / b;
  return r;
}
// lane l's value from lane `from(l)`, through a buffer between two barriers
template <typename From>
inline float lane_read(float v, From from) {
  static float buf[32];
  const int l = static_cast<int>(threadIdx.x) & 31;
  buf[l] = v;
  __syncthreads();
  const float r = buf[from(l)];
  __syncthreads();
  return r;
}
inline float lane_xor(float v, int o) {
  return lane_read(v, [o](int l) { return l ^ o; });
}
inline float lane_get(float v, int src) {
  return lane_read(v, [src](int) { return src; });
}
#else
__device__ __forceinline__ float f_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float f_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float lane_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
// lane `src`'s v, in every lane
__device__ __forceinline__ float lane_get(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}
#endif

// the warp's sum of v, the same in every lane: halves folded 16, 8, 4, 2, 1
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = f_add(v, lane_xor(v, o));
  return v;
}

__device__ __forceinline__ float lrelu(float z) {
  return z > 0.f ? z : f_mul(z, kSlope);
}

__device__ __forceinline__ int clamp_to(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ int warp_id() {
  return static_cast<int>(blockIdx.x) * kWarps +
         (static_cast<int>(threadIdx.x) >> 5);
}

struct Dims {
  int n_nodes;   // receivers N
  int n_table;   // sender table rows Nt (>= N: the first N are receivers)
  int n_edges;   // real edges E: positions [0, E)
  int heads;     // H
  int head_dim;  // F
};

struct FwdArgs {
  const float* hw;     // [Nt, H*F]
  const float* s_src;  // [Nt, H]
  const float* s_dst;  // [N, H]
  const int* senders;  // [>= E], receiver order
  const int* ptr;      // [N+1]
  float* out;          // [N, H*F]
  float* m;            // [N, H]
  float* l;            // [N, H]
  Dims d;
};

template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads)
gat_attend_fwd_kernel(const FwdArgs a) {
  const int i = warp_id();
  if (i >= a.d.n_nodes) return;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  const int lo = clamp_to(__ldg(a.ptr + i), 0, a.d.n_edges);
  const int hi = clamp_to(__ldg(a.ptr + i + 1), lo, a.d.n_edges);
  float sd[MAXH], mx[MAXH], den[MAXH], acc[MAXH][KH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    sd[h] = mx[h] = den[h] = 0.f;
    if (h < H) {
      sd[h] = __ldg(a.s_dst + static_cast<long long>(i) * H + h);
      mx[h] = lrelu(f_add(sd[h], __ldg(a.s_src +
                                       static_cast<long long>(i) * H + h)));
    }
#pragma unroll
    for (int k = 0; k < KH; ++k) acc[h][k] = 0.f;
  }
  // the maximum over the self term and the in-edges, from the head scalars
  for (int p = lo; p < hi; ++p) {
    const int j = clamp_to(__ldg(a.senders + p), 0, a.d.n_table - 1);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        mx[h] = fmaxf(mx[h], lrelu(f_add(sd[h], __ldg(
                                  a.s_src + static_cast<long long>(j) * H + h))));
      }
    }
  }
  // one pass over the rows: self first, then the in-edges in order
  auto take = [&](int j) {
    const float* row = a.hw + static_cast<long long>(j) * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const float w = expf(f_sub(
            lrelu(f_add(sd[h],
                        __ldg(a.s_src + static_cast<long long>(j) * H + h))),
            mx[h]));
        den[h] = f_add(den[h], w);
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) {
            acc[h][k] = f_add(acc[h][k], f_mul(w, __ldg(row + h * F + c)));
          }
        }
      }
    }
  };
  take(i);
  for (int p = lo; p < hi; ++p) {
    take(clamp_to(__ldg(a.senders + p), 0, a.d.n_table - 1));
  }
  float* orow = a.out + static_cast<long long>(i) * HF;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int c = lane + 32 * k;
        if (c < F) orow[h * F + c] = f_div(acc[h][k], den[h]);
      }
      if (lane == h) {
        a.m[static_cast<long long>(i) * H + h] = mx[h];
        a.l[static_cast<long long>(i) * H + h] = den[h];
      }
    }
  }
}

struct BwdArgs {
  // the forward's inputs and what it kept
  const float* hw;     // [Nt, H*F]
  const float* s_src;  // [Nt, H]
  const float* s_dst;  // [N, H]
  const float* out;    // [N, H*F]
  const float* m;      // [N, H]
  const float* l;      // [N, H]
  const float* a_src;  // [H, F]
  const float* a_dst;  // [H, F]
  const float* d_out;  // [N, H*F]
  const int* ptr;      // [N+1]
  // the sender layout: the stable sort of the senders and its segments
  const int* sperm;     // [E]: receiver-order position of each sorted edge
  const int* srows;     // [E]: the receiver of each sorted edge
  const int* seg_lo;    // [n_seg]
  const int* seg_hi;    // [n_seg]
  const int* seg_node;  // [n_seg]
  const int* seg_slot;  // [n_seg]: -1 for a node's only segment
  const int* split_node;  // [n_split], ascending
  const int* split_slot;  // [n_split + 1]
  int n_seg, n_split;
  // scratch
  float* delta;    // [N, H]: d_out_i . out_i
  float* de_e;     // [E, H]: d_ij, receiver order
  float* de_self;  // [N, H]: d_ii of a node finished by the sender pass
  float* part;     // [slots, H*F]
  float* part_ds;  // [slots, H]
  float* runs;     // [n_split * kRuns, H*F]
  float* runs_ds;  // [n_split * kRuns, H]
  // outputs
  float* d_hw;     // [Nt, H*F]
  float* d_s_src;  // [Nt, H]
  float* d_s_dst;  // [N, H]
  Dims d;
};

// A row [H*F] in lane slots (zeros past F and H).
template <int KH, int MAXH>
__device__ __forceinline__ void load_row(const float* row, const Dims& d,
                                         int lane, float (&x)[MAXH][KH]) {
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int c = lane + 32 * k;
      x[h][k] = h < d.heads && c < d.head_dim ? __ldg(row + h * d.head_dim + c)
                                              : 0.f;
    }
  }
}

// The pre-pass: per receiver i and head, delta = d_out_i . out_i.
template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads)
gat_attend_bwd_recv_kernel(const BwdArgs a) {
  const int i = warp_id();
  if (i >= a.d.n_nodes) return;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  float g[MAXH][KH], o[MAXH][KH];
  load_row<KH, MAXH>(a.d_out + i * HF, a.d, lane, g);
  load_row<KH, MAXH>(a.out + i * HF, a.d, lane, o);
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        if (lane + 32 * k < F) p = f_add(p, f_mul(g[h][k], o[h][k]));
      }
      const float s = warp_sum(p);
      if (lane == h) a.delta[static_cast<long long>(i) * H + h] = s;
    }
  }
}

// Receiver i's side of an edge (i, j): d_out_i in lane slots, and lane h's
// (h < H) head scalars s_dst, m, l and delta of i.
template <int KH, int MAXH>
struct Recv {
  float g[MAXH][KH];
  float sd, mx, den, dl;
};

template <int KH, int MAXH>
__device__ __forceinline__ void load_recv(const BwdArgs& a, int i, int lane,
                                          Recv<KH, MAXH>& r) {
  load_row<KH, MAXH>(a.d_out + static_cast<long long>(i) * a.d.heads *
                                   a.d.head_dim, a.d, lane, r.g);
  r.sd = r.mx = r.dl = 0.f;
  r.den = 1.f;
  if (lane < a.d.heads) {
    const long long at = static_cast<long long>(i) * a.d.heads + lane;
    r.sd = __ldg(a.s_dst + at);
    r.mx = __ldg(a.m + at);
    r.den = __ldg(a.l + at);
    r.dl = __ldg(a.delta + at);
  }
}

// Edge (i, j), from r (i's side), hj (hW_j in lane slots) and ss (lane h's
// s_src[j]): a_ij d_out_i added into acc; returns lane h's d_ij.  The
// weight comes from head scalars alone, so the sum by sender never waits
// for the dot products' warp sums.
template <int KH, int MAXH>
__device__ __forceinline__ float edge_terms(const Dims& d, int lane,
                                            const Recv<KH, MAXH>& r,
                                            const float (&hj)[MAXH][KH],
                                            float ss,
                                            float (&acc)[MAXH][KH]) {
  const float z = f_add(r.sd, ss);
  const float al = f_div(expf(f_sub(lrelu(z), r.mx)), r.den);
  float dot = 0.f;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < d.heads) {
      const float w = lane_get(al, h);
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        if (lane + 32 * k < d.head_dim) {
          acc[h][k] = f_add(acc[h][k], f_mul(w, r.g[h][k]));
          p = f_add(p, f_mul(r.g[h][k], hj[h][k]));
        }
      }
      const float s = warp_sum(p);
      if (lane == h) dot = s;
    }
  }
  const float dv = f_mul(al, f_sub(dot, r.dl));
  return z > 0.f ? dv : f_mul(dv, kSlope);
}

// d_s_dst[i] of lane h's head, stored: the self term, then i's in-edges'
// d_ij in receiver order.
__device__ __forceinline__ float recv_sum(const BwdArgs& a, int i, int lane,
                                          float self) {
  float s = f_add(0.f, self);
  if (lane < a.d.heads) {
    const int lo = clamp_to(__ldg(a.ptr + i), 0, a.d.n_edges);
    const int hi = clamp_to(__ldg(a.ptr + i + 1), lo, a.d.n_edges);
#pragma unroll 4
    for (int p = lo; p < hi; ++p) {
      s = f_add(s, __ldg(a.de_e + static_cast<long long>(p) * a.d.heads +
                         lane));
    }
    a.d_s_dst[static_cast<long long>(i) * a.d.heads + lane] = s;
  }
  return s;
}

// Sender j's row of d_hW and d_s_src from its summed edge terms (ds[h] the
// same in every lane), hj its row of hW: for j < N its self term added,
// then d_s_src[j] a_src.  With `dst` (a split sender, finished by the merge)
// d_s_dst[j] is summed here and d_s_dst[j] a_dst added to the rounded row;
// without, d_jj goes to de_self and the post-pass adds that term.
template <int KH, int MAXH>
__device__ __forceinline__ void finish(const BwdArgs& a, int j, int lane,
                                       const float (&hj)[MAXH][KH],
                                       float (&acc)[MAXH][KH],
                                       float (&ds)[MAXH], bool dst) {
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  const bool local = j < a.d.n_nodes;
  float dsd = 0.f;
  if (local) {
    Recv<KH, MAXH> r;
    load_recv<KH, MAXH>(a, j, lane, r);
    const float ss = lane < H ? __ldg(a.s_src + static_cast<long long>(j) * H +
                                      lane)
                              : 0.f;
    const float dv = edge_terms<KH, MAXH>(a.d, lane, r, hj, ss, acc);
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) ds[h] = f_add(ds[h], lane_get(dv, h));
    }
    if (dst) {
      dsd = recv_sum(a, j, lane, dv);
    } else if (lane < H) {
      a.de_self[static_cast<long long>(j) * H + lane] = dv;
    }
  }
  float* drow = a.d_hw + static_cast<long long>(j) * HF;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
      const float wd = local && dst ? lane_get(dsd, h) : 0.f;
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int c = lane + 32 * k;
        if (c < F) {
          float t = f_add(acc[h][k], f_mul(ds[h], __ldg(a.a_src + h * F + c)));
          if (local && dst) t = f_add(t, f_mul(wd, __ldg(a.a_dst + h * F + c)));
          drow[h * F + c] = t;
        }
      }
      if (lane == h) a.d_s_src[static_cast<long long>(j) * H + h] = ds[h];
    }
  }
}

// The sender pass: per segment of sender j's sorted out-edges, hW_j held
// in registers, each edge's d_out_i gathered once for both its dot
// products (d_ij, written to de_e) and the sum of a_ij d_out_i, the next
// edge's indices loaded ahead of each edge's sums.  A node's only
// segment finishes its row, a split node's segments write partial rows.
template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads, kSendBlocks)
gat_attend_bwd_send_kernel(const BwdArgs a) {
  const int s = warp_id();
  if (s >= a.n_seg) return;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  const int j = clamp_to(__ldg(a.seg_node + s), 0, a.d.n_table - 1);
  const int q0 = clamp_to(__ldg(a.seg_lo + s), 0, a.d.n_edges);
  const int q1 = clamp_to(__ldg(a.seg_hi + s), q0, a.d.n_edges);
  const int slot = __ldg(a.seg_slot + s);
  float hj[MAXH][KH], acc[MAXH][KH];
  load_row<KH, MAXH>(a.hw + j * HF, a.d, lane, hj);
  const float ss =
      lane < H ? __ldg(a.s_src + static_cast<long long>(j) * H + lane) : 0.f;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
#pragma unroll
    for (int k = 0; k < KH; ++k) acc[h][k] = 0.f;
  }
  float ds = 0.f;  // lane h's head
  auto edge_at = [&](int q, int* e, int* i) {
    if (q < q1) {
      *e = clamp_to(__ldg(a.sperm + q), 0, a.d.n_edges - 1);
      *i = clamp_to(__ldg(a.srows + q), 0, a.d.n_nodes - 1);
    }
  };
  int e = 0, i = 0;
  edge_at(q0, &e, &i);
  for (int q = q0; q < q1; ++q) {
    Recv<KH, MAXH> r;
    load_recv<KH, MAXH>(a, i, lane, r);
    const int at = e;
    edge_at(q + 1, &e, &i);  // the next edge's indices, ahead of the sums
    const float dv = edge_terms<KH, MAXH>(a.d, lane, r, hj, ss, acc);
    ds = f_add(ds, dv);
    if (lane < H) a.de_e[static_cast<long long>(at) * H + lane] = dv;
  }
  if (slot < 0) {
    float dsh[MAXH];
#pragma unroll
    for (int h = 0; h < MAXH; ++h) dsh[h] = h < H ? lane_get(ds, h) : 0.f;
    finish<KH, MAXH>(a, j, lane, hj, acc, dsh, false);
    return;
  }
  float* prow = a.part + static_cast<long long>(slot) * HF;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int c = lane + 32 * k;
        if (c < F) prow[h * F + c] = acc[h][k];
      }
    }
  }
  if (lane < H) a.part_ds[static_cast<long long>(slot) * H + lane] = ds;
}

// A split sender's slots [s0, s1) in kRuns runs of ceil(m / kRuns) slots;
// run r's sum, from 0 and in slot order, per element.
__device__ __forceinline__ void run_of(const BwdArgs& a, int q, int r,
                                       int* b0, int* b1) {
  const int s0 = __ldg(a.split_slot + q), s1 = __ldg(a.split_slot + q + 1);
  const int len = (s1 - s0 + kRuns - 1) / kRuns;
  *b0 = min(s0 + r * len, s1);
  *b1 = min(*b0 + len, s1);
}

template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads)
gat_attend_merge_runs_kernel(const BwdArgs a) {
  const int w = warp_id();
  if (w >= a.n_split * kRuns) return;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int q = w / kRuns, r = w - q * kRuns;
  int b0, b1;
  run_of(a, q, r, &b0, &b1);
  if (b0 >= b1) return;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  float acc[MAXH][KH], ds[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    ds[h] = 0.f;
#pragma unroll
    for (int k = 0; k < KH; ++k) acc[h][k] = 0.f;
  }
  // slot by slot, a whole row's loads in flight at once
  for (int s = b0; s < b1; ++s) {
    const float* prow = a.part + static_cast<long long>(s) * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        ds[h] = f_add(ds[h], __ldg(a.part_ds + static_cast<long long>(s) * H + h));
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) acc[h][k] = f_add(acc[h][k], __ldg(prow + h * F + c));
        }
      }
    }
  }
  float* rrow = a.runs + static_cast<long long>(w) * HF;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int c = lane + 32 * k;
        if (c < F) rrow[h * F + c] = acc[h][k];
      }
      if (lane == h) a.runs_ds[static_cast<long long>(w) * H + h] = ds[h];
    }
  }
}

// Whether receiver i is a split sender (split_node is ascending).
__device__ __forceinline__ bool is_split(const BwdArgs& a, int i) {
  int lo = 0, hi = a.n_split;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a.split_node + mid) < i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < a.n_split && __ldg(a.split_node + lo) == i;
}

// Warps [0, n_split): a split sender's runs summed in order, then finished
// like a whole node, its d_s_dst and a_dst term included.  Warps past them,
// the post-pass: receiver i (not a split sender) sums d_s_dst[i] and adds
// d_s_dst[i] a_dst into the row the sender pass wrote.
template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads, kFinalBlocks)
gat_attend_merge_final_kernel(const BwdArgs a) {
  const int w = warp_id();
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  if (w >= a.n_split) {
    const int i = w - a.n_split;
    if (i >= a.d.n_nodes) return;
    // the row and the self term in flight before the split check
    float t[MAXH][KH];
    load_row<KH, MAXH>(a.d_hw + i * HF, a.d, lane, t);
    const float self =
        lane < H ? a.de_self[static_cast<long long>(i) * H + lane] : 0.f;
    if (is_split(a, i)) return;
    const float dsd = recv_sum(a, i, lane, self);
    float* drow = a.d_hw + static_cast<long long>(i) * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const float wd = lane_get(dsd, h);
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) {
            drow[h * F + c] =
                f_add(t[h][k], f_mul(wd, __ldg(a.a_dst + h * F + c)));
          }
        }
      }
    }
    return;
  }
  const int q = w;
  const int j = clamp_to(__ldg(a.split_node + q), 0, a.d.n_table - 1);
  float acc[MAXH][KH], ds[MAXH], hj[MAXH][KH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    ds[h] = 0.f;
#pragma unroll
    for (int k = 0; k < KH; ++k) acc[h][k] = 0.f;
  }
  for (int r = 0; r < kRuns; ++r) {
    int b0, b1;
    run_of(a, q, r, &b0, &b1);
    if (b0 >= b1) break;
    const long long rw = static_cast<long long>(q) * kRuns + r;
    const float* rrow = a.runs + rw * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        ds[h] = f_add(ds[h], __ldg(a.runs_ds + rw * H + h));
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) acc[h][k] = f_add(acc[h][k], __ldg(rrow + h * F + c));
        }
      }
    }
  }
  load_row<KH, MAXH>(a.hw + j * HF, a.d, lane, hj);
  finish<KH, MAXH>(a, j, lane, hj, acc, ds, true);
}

unsigned blocks_for(long long warps) {
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

template <int KH, int MAXH>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t st) {
  void (*fwd)(FwdArgs) = gat_attend_fwd_kernel<KH, MAXH>;
  fwd<<<dim3(blocks_for(a.d.n_nodes)), dim3(kThreads), 0, st>>>(a);
  return cudaGetLastError();
}

template <int KH, int MAXH>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  void (*recv)(BwdArgs) = gat_attend_bwd_recv_kernel<KH, MAXH>;
  void (*send)(BwdArgs) = gat_attend_bwd_send_kernel<KH, MAXH>;
  void (*merge_runs)(BwdArgs) = gat_attend_merge_runs_kernel<KH, MAXH>;
  void (*merge_final)(BwdArgs) = gat_attend_merge_final_kernel<KH, MAXH>;
  recv<<<dim3(blocks_for(a.d.n_nodes)), dim3(kThreads), 0, st>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  send<<<dim3(blocks_for(a.n_seg)), dim3(kThreads), 0, st>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  if (a.n_split > 0) {
    merge_runs<<<dim3(blocks_for(static_cast<long long>(a.n_split) * kRuns)),
                 dim3(kThreads), 0, st>>>(a);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
  }
  merge_final<<<dim3(blocks_for(static_cast<long long>(a.n_split) +
                                a.d.n_nodes)),
                dim3(kThreads), 0, st>>>(a);
  return cudaGetLastError();
}

struct FwdLaunch {
  const FwdArgs* a;
  cudaStream_t st;
  template <int KH, int MAXH>
  cudaError_t operator()() const {
    return launch_fwd<KH, MAXH>(*a, st);
  }
};

struct BwdLaunch {
  const BwdArgs* a;
  cudaStream_t st;
  template <int KH, int MAXH>
  cudaError_t operator()() const {
    return launch_bwd<KH, MAXH>(*a, st);
  }
};

// Slots of a lane a head: the least of 1, 2, 4, 8 with 32 KH >= F; heads a
// warp holds: 4 or 8.  0: the shape is refused.
int slots_for(int head_dim) {
  for (int kh = 1; kh <= 8; kh *= 2) {
    if (32 * kh >= head_dim) return kh;
  }
  return 0;
}

bool dims_ok(const Dims& d) {
  if (d.n_nodes <= 0 || d.n_table < d.n_nodes || d.n_edges < 0) return false;
  if (d.heads < 1 || d.heads > 8 || d.head_dim < 1) return false;
  const int kh = slots_for(d.head_dim);
  if (kh == 0 || (kh == 8 && d.heads > 4)) return false;
  // a merge run's warp id stays an int
  return static_cast<long long>(d.n_table) * kRuns < INT_MAX;
}

// Calls f.template operator()<KH, MAXH>() for the instance of these dims.
template <typename Fn>
cudaError_t dispatch(const Dims& d, const Fn& fn) {
  const int kh = slots_for(d.head_dim);
  const bool wide = d.heads > 4;
  switch (kh) {
    case 1:
      return wide ? fn.template operator()<1, 8>() : fn.template operator()<1, 4>();
    case 2:
      return wide ? fn.template operator()<2, 8>() : fn.template operator()<2, 4>();
    case 4:
      return wide ? fn.template operator()<4, 8>() : fn.template operator()<4, 4>();
    default:
      return fn.template operator()<8, 4>();
  }
}

}  // namespace

// The runs of a split sender's merge (the scratch `runs` holds n_split x
// this many rows).
extern "C" int pna_gat_attend_runs() { return kRuns; }

// Forward: hw [Nt, H F], s_src [Nt, H], s_dst [N, H] f32; senders and ptr
// int32; out [N, H F], m and l [N, H] f32, every row written.  Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int pna_gat_attend_fwd(const float* hw, const float* s_src,
                                  const float* s_dst, const int* senders,
                                  const int* ptr, int n_nodes, int n_table,
                                  int n_edges, int heads, int head_dim,
                                  float* out, float* m, float* l,
                                  void* stream) {
  const Dims d{n_nodes, n_table, n_edges, heads, head_dim};
  if (!dims_ok(d)) return static_cast<int>(cudaErrorInvalidValue);
  const FwdArgs a{hw, s_src, s_dst, senders, ptr, out, m, l, d};
  return static_cast<int>(
      dispatch(d, FwdLaunch{&a, static_cast<cudaStream_t>(stream)}));
}

// Backward: the forward's inputs, out, m and l, a_src and a_dst [H, F],
// d_out [N, H F]; ptr and the sender layout (ops/csr_gat.py::GATLayout);
// scratch delta [N, H], de_e [E, H], de_self [N, H], part [slots, H F],
// part_ds [slots, H], runs [n_split kRuns, H F], runs_ds [n_split kRuns, H];
// out d_hw [Nt, H F], d_s_src [Nt, H], d_s_dst [N, H], every row written.
// Three or four kernels on `stream`; returns the first launch error.
extern "C" int pna_gat_attend_bwd(
    const float* hw, const float* s_src, const float* s_dst, const float* out,
    const float* m, const float* l, const float* a_src, const float* a_dst,
    const float* d_out, const int* ptr, const int* sperm, const int* srows,
    const int* seg_lo, const int* seg_hi, const int* seg_node,
    const int* seg_slot, const int* split_node, const int* split_slot,
    int n_seg, int n_split, float* delta, float* de_e, float* de_self,
    float* part, float* part_ds, float* runs, float* runs_ds, float* d_hw,
    float* d_s_src, float* d_s_dst, int n_nodes, int n_table, int n_edges,
    int heads, int head_dim, void* stream) {
  const Dims d{n_nodes, n_table, n_edges, heads, head_dim};
  if (!dims_ok(d) || n_seg < n_table || n_split < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{hw,       s_src,      s_dst,      out,     m,
                  l,        a_src,      a_dst,      d_out,   ptr,
                  sperm,    srows,      seg_lo,     seg_hi,  seg_node,
                  seg_slot, split_node, split_slot, n_seg,   n_split,
                  delta,    de_e,       de_self,    part,    part_ds,
                  runs,     runs_ds,    d_hw,       d_s_src, d_s_dst,
                  d};
  return static_cast<int>(
      dispatch(d, BwdLaunch{&a, static_cast<cudaStream_t>(stream)}));
}
