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
// (the last term for j < N), the sums over i walked in sender order.
//
// Bound on this card: bytes.  At the large graph's wide layers (625,000
// receivers, 6.25M in-edges, H = 4 heads of 256) every edge moves a 4 KB
// row: the forward and the receiver pass read hW[j] (a power-law sender
// table, whose hub rows stay in L2), the sender pass reads d_out[i] (random
// rows, no reuse).  No [E, H*F] tensor is ever written: only per-edge head
// scalars (a_ij and d_ij, [E, H]) pass from the receiver pass to the sender
// pass, and the forward keeps only m and l ([N, H]) for the backward.
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
//   * the sender pass walks the senders' stable sort (the row sum's sender
//     layout) in segments of at most SEG edges (ops/csr_gat.py).  A node of
//     one segment writes its row; a hub's segments write partial rows to
//     scratch, which a second kernel sums in kRuns runs and a third sums and
//     finishes, each in a fixed order.  One writer for every output element, no atomics,
//     so two launches give the same bits;
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
inline float lane_xor(float v, int o) {
  static float buf[32];
  const int l = static_cast<int>(threadIdx.x) & 31;
  buf[l] = v;
  __syncthreads();
  const float r = buf[l ^ o];
  __syncthreads();
  return r;
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
  const int* senders;  // [>= E], receiver order
  const int* ptr;      // [N+1]
  // the sender layout: the stable sort of the senders and its segments
  const int* sperm;     // [E]: receiver-order position of each sorted edge
  const int* srows;     // [E]: the receiver of each sorted edge
  const int* seg_lo;    // [n_seg]
  const int* seg_hi;    // [n_seg]
  const int* seg_node;  // [n_seg]
  const int* seg_slot;  // [n_seg]: -1 for a node's only segment
  const int* split_node;  // [n_split]
  const int* split_slot;  // [n_split + 1]
  int n_seg, n_split;
  // scratch
  float* alpha_e;     // [E, H]
  float* de_e;        // [E, H]
  float* alpha_self;  // [N, H]
  float* de_self;     // [N, H]
  float* part;        // [slots, H*F]
  float* part_ds;     // [slots, H]
  float* runs;        // [n_split * kRuns, H*F]
  float* runs_ds;     // [n_split * kRuns, H]
  // outputs
  float* d_hw;     // [Nt, H*F]
  float* d_s_src;  // [Nt, H]
  float* d_s_dst;  // [N, H]
  Dims d;
};

// The receiver pass: per receiver i, delta = d_out_i . out_i per head, then
// for the self term and each in-edge the weight a_ij and d_ij (written as
// head scalars), and d_s_dst[i], their sum.
template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads)
gat_attend_bwd_recv_kernel(const BwdArgs a) {
  const int i = warp_id();
  if (i >= a.d.n_nodes) return;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  const int lo = clamp_to(__ldg(a.ptr + i), 0, a.d.n_edges);
  const int hi = clamp_to(__ldg(a.ptr + i + 1), lo, a.d.n_edges);
  float g[MAXH][KH], sd[MAXH], mx[MAXH], den[MAXH], delta[MAXH], dsd[MAXH];
  const float* grow = a.d_out + static_cast<long long>(i) * HF;
  const float* orow = a.out + static_cast<long long>(i) * HF;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    sd[h] = mx[h] = den[h] = delta[h] = dsd[h] = 0.f;
    float p = 0.f;
#pragma unroll
    for (int k = 0; k < KH; ++k) {
      const int c = lane + 32 * k;
      g[h][k] = 0.f;
      if (h < H && c < F) {
        g[h][k] = __ldg(grow + h * F + c);
        p = f_add(p, f_mul(g[h][k], __ldg(orow + h * F + c)));
      }
    }
    if (h < H) {
      delta[h] = warp_sum(p);
      const long long at = static_cast<long long>(i) * H + h;
      sd[h] = __ldg(a.s_dst + at);
      mx[h] = __ldg(a.m + at);
      den[h] = __ldg(a.l + at);
    }
  }
  auto edge = [&](int j, float* alpha, float* de) {
    const float* row = a.hw + static_cast<long long>(j) * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) p = f_add(p, f_mul(g[h][k], __ldg(row + h * F + c)));
        }
        const float dot = warp_sum(p);
        const float z = f_add(
            sd[h], __ldg(a.s_src + static_cast<long long>(j) * H + h));
        const float al = f_div(expf(f_sub(lrelu(z), mx[h])), den[h]);
        float dv = f_mul(al, f_sub(dot, delta[h]));
        if (!(z > 0.f)) dv = f_mul(dv, kSlope);
        dsd[h] = f_add(dsd[h], dv);
        if (lane == h) {
          alpha[h] = al;
          de[h] = dv;
        }
      }
    }
  };
  edge(i, a.alpha_self + static_cast<long long>(i) * H,
       a.de_self + static_cast<long long>(i) * H);
  for (int p = lo; p < hi; ++p) {
    edge(clamp_to(__ldg(a.senders + p), 0, a.d.n_table - 1),
         a.alpha_e + static_cast<long long>(p) * H,
         a.de_e + static_cast<long long>(p) * H);
  }
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H && lane == h) a.d_s_dst[static_cast<long long>(i) * H + h] = dsd[h];
  }
}

// Sender j's row of d_hW and d_s_src from its summed edge terms: its self
// term (j < N) added, then d_s_src[j] a_src and d_s_dst[j] a_dst.
template <int KH, int MAXH>
__device__ __forceinline__ void finish(const BwdArgs& a, int j, int lane,
                                       float (&acc)[MAXH][KH],
                                       float (&ds)[MAXH]) {
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  const bool local = j < a.d.n_nodes;
  const float* grow = a.d_out + static_cast<long long>(j) * HF;
  float* drow = a.d_hw + static_cast<long long>(j) * HF;
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    if (h < H) {
      float dsd = 0.f;
      if (local) {
        const long long at = static_cast<long long>(j) * H + h;
        const float al = __ldg(a.alpha_self + at);
        ds[h] = f_add(ds[h], __ldg(a.de_self + at));
        dsd = __ldg(a.d_s_dst + at);
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) {
            acc[h][k] = f_add(acc[h][k], f_mul(al, __ldg(grow + h * F + c)));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int c = lane + 32 * k;
        if (c < F) {
          float t = f_add(acc[h][k], f_mul(ds[h], __ldg(a.a_src + h * F + c)));
          if (local) t = f_add(t, f_mul(dsd, __ldg(a.a_dst + h * F + c)));
          drow[h * F + c] = t;
        }
      }
      if (lane == h) a.d_s_src[static_cast<long long>(j) * H + h] = ds[h];
    }
  }
}

// The sender pass: per segment of a sender's sorted out-edges, the sum of
// a_ij d_out_i and of d_ij; a node's only segment finishes its row, a split
// node's segments write partial rows.
template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads)
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
  float acc[MAXH][KH], ds[MAXH];
#pragma unroll
  for (int h = 0; h < MAXH; ++h) {
    ds[h] = 0.f;
#pragma unroll
    for (int k = 0; k < KH; ++k) acc[h][k] = 0.f;
  }
  for (int q = q0; q < q1; ++q) {
    const int e = clamp_to(__ldg(a.sperm + q), 0, a.d.n_edges - 1);
    const int i = clamp_to(__ldg(a.srows + q), 0, a.d.n_nodes - 1);
    const float* grow = a.d_out + static_cast<long long>(i) * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        const long long at = static_cast<long long>(e) * H + h;
        const float al = __ldg(a.alpha_e + at);
        ds[h] = f_add(ds[h], __ldg(a.de_e + at));
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) {
            acc[h][k] = f_add(acc[h][k], f_mul(al, __ldg(grow + h * F + c)));
          }
        }
      }
    }
  }
  if (slot < 0) {
    finish<KH, MAXH>(a, j, lane, acc, ds);
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
      if (lane == h) a.part_ds[static_cast<long long>(slot) * H + h] = ds[h];
    }
  }
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

// A split sender's runs summed in order, then finished like a whole node.
template <int KH, int MAXH>
__global__ void __launch_bounds__(kThreads)
gat_attend_merge_final_kernel(const BwdArgs a) {
  const int q = warp_id();
  if (q >= a.n_split) return;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int H = a.d.heads, F = a.d.head_dim;
  const long long HF = static_cast<long long>(H) * F;
  const int j = clamp_to(__ldg(a.split_node + q), 0, a.d.n_table - 1);
  float acc[MAXH][KH], ds[MAXH];
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
    const long long w = static_cast<long long>(q) * kRuns + r;
    const float* rrow = a.runs + w * HF;
#pragma unroll
    for (int h = 0; h < MAXH; ++h) {
      if (h < H) {
        ds[h] = f_add(ds[h], __ldg(a.runs_ds + w * H + h));
#pragma unroll
        for (int k = 0; k < KH; ++k) {
          const int c = lane + 32 * k;
          if (c < F) acc[h][k] = f_add(acc[h][k], __ldg(rrow + h * F + c));
        }
      }
    }
  }
  finish<KH, MAXH>(a, j, lane, acc, ds);
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
  if (rc != cudaSuccess || a.n_split == 0) return rc;
  merge_runs<<<dim3(blocks_for(static_cast<long long>(a.n_split) * kRuns)),
               dim3(kThreads), 0, st>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return rc;
  merge_final<<<dim3(blocks_for(a.n_split)), dim3(kThreads), 0, st>>>(a);
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
// d_out [N, H F]; the sender layout (ops/csr_gat.py::GATLayout); scratch
// alpha_e and de_e [E, H], alpha_self and de_self [N, H], part [slots, H F],
// part_ds [slots, H], runs [n_split kRuns, H F], runs_ds [n_split kRuns, H];
// out d_hw [Nt, H F], d_s_src [Nt, H], d_s_dst [N, H], every row written.
// Two to four kernels on `stream`; returns the first launch error.
extern "C" int pna_gat_attend_bwd(
    const float* hw, const float* s_src, const float* s_dst, const float* out,
    const float* m, const float* l, const float* a_src, const float* a_dst,
    const float* d_out, const int* senders, const int* ptr, const int* sperm,
    const int* srows, const int* seg_lo, const int* seg_hi,
    const int* seg_node, const int* seg_slot, const int* split_node,
    const int* split_slot, int n_seg, int n_split, float* alpha_e,
    float* de_e, float* alpha_self, float* de_self, float* part,
    float* part_ds, float* runs, float* runs_ds, float* d_hw,
    float* d_s_src, float* d_s_dst, int n_nodes, int n_table, int n_edges,
    int heads, int head_dim, void* stream) {
  const Dims d{n_nodes, n_table, n_edges, heads, head_dim};
  if (!dims_ok(d) || n_seg < n_table || n_split < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdArgs a{hw,       s_src,    s_dst,      out,        m,
                  l,        a_src,    a_dst,      d_out,      senders,
                  ptr,      sperm,    srows,      seg_lo,     seg_hi,
                  seg_node, seg_slot, split_node, split_slot, n_seg,
                  n_split,  alpha_e,  de_e,       alpha_self, de_self,
                  part,     part_ds,  runs,       runs_ds,    d_hw,
                  d_s_src,  d_s_dst,  d};
  return static_cast<int>(
      dispatch(d, BwdLaunch{&a, static_cast<cudaStream_t>(stream)}));
}
