// K4: gradient of the fused pretrans message for Hopper (sm_90a).
//
// Replaces pna_tpu/ops/pallas_kernels.py::sorted_pretrans_dmsg (kernel body
// _fused_dmsg_kernel), the backward of K3.  For every edge e in node r's
// receiver-sorted range [ptr[r], ptr[r+1]) it recomputes the message m[e]
// with K3's arithmetic (pretrans_msg.cuh, so the tie tests against K3's
// max/min are bit-exact) and writes
//   d_msg[e] = g_lin[r] + 2 m[e] g_quad[r]
//              + [m[e] == mx[r]] g_max[r] + [m[e] == mn[r]] g_min[r]
//   d_v[r]   = sum over the edges e of r of d_msg[e]
// Rows of d_msg outside every node's range (pad edges past ptr[N], rows
// before ptr[0]) are written as 0, so the caller needs no mask.  d_v is
// written for every node (0 for an empty one).  Both outputs are float32.
//
// Bound on this card: HBM bytes.  u, v, ef, the senders and the six [N, F]
// node fields are read once, d_msg [E, F] and d_v [N, F] written once: at the
// flagship ZINC step (42,356 real edges, 19,792 nodes, F = 70, Fe = 50,
// float32) about 70.5 MB, some 21 us at 3.35 TB/s (62.0 MB and 18.5 us
// without edge features).
//
// What the first design lost time on: K3's node-owned walk, one warp per
// (node, 32 features), with a global load of ef and of ke for every term of
// the edge-feature dot, a third warp with 6 of 32 lanes at work at F = 70, a
// serial chain per node, and a hub's whole range on three warps (see
// csr_pretrans_sketch.cu): 5.8 times the byte bound at the flagship shapes.
//
// This design shares K3's walk (pretrans_msg.cuh): segments as the unit of
// work, the edge-feature term of a tile as a register-tiled product on the
// CUDA cores from ef rows and a ke slice staged in shared memory, messages
// in a shared tile.  The thread that forms a message turns it at once into
// its d_msg value (K2's expression with __fmul_rn/__fadd_rn, the plain
// version's roundings; the six node fields of its 32 (edge, feature) pairs
// are independent loads, all in flight together), writes it to the row and
// leaves it in the tile.  Phase 2, one thread per (segment, feature), adds
// the segment's d_msg values from the tile in edge order: no load from
// device memory waits on another.  A node with one segment writes
// d_v directly; a split node's segments write partials [slot, F], which a
// second kernel adds, one block per split node, in a fixed order.  The TPU
// kernel merges boundary chunks shared by two node tiles by
// read-modify-write, which is safe only on its in-order grid; here every row
// and every partial has exactly one writer, so there is no such merge and no
// atomic, and every run gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "pretrans_msg.cuh"

namespace {

struct DmsgIo {
  const float* g_lin;
  const float* g_quad;
  const float* g_max;
  const float* g_min;
  const float* mx;
  const float* mn;
  float* d_msg;   // [E, F]
  float* d_v;     // [N, F]
  float* part;    // [n_part, F] partial d_v of split nodes, or null
  int n_feat;
  int n_part;
};

struct DmsgPhase2 {
  DmsgIo o;

  // each message becomes its d_msg value as soon as it is formed: the row is
  // written from here and the tile holds d_msg for the per-segment sums
  __device__ __forceinline__ void message(long long node_at,
                                          long long edge_at, int n,
                                          float (&m)[4]) const {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < n) {
        const float gl = o.g_lin[node_at + c];
        const float gq = o.g_quad[node_at + c];
        const float gx = o.g_max[node_at + c];
        const float gn = o.g_min[node_at + c];
        const float vx = o.mx[node_at + c];
        const float vn = o.mn[node_at + c];
        float d = __fadd_rn(gl, __fmul_rn(__fmul_rn(2.f, m[c]), gq));
        if (m[c] == vx) d = __fadd_rn(d, gx);
        if (m[c] == vn) d = __fadd_rn(d, gn);
        o.d_msg[edge_at + c] = d;
        m[c] = d;
      }
    }
  }

  // d_v of each segment: its d_msg values added in edge order
  __device__ __forceinline__ void operator()(const pna::TileView& t) const {
    if (!t.active) return;
    for (int ls = t.sa + t.g; ls < t.sb; ls += t.groups) {
      const int lo = pna::clampi(t.seg_ptr_s[ls] - t.e0, 0, t.ne);
      const int hi = pna::clampi(t.seg_ptr_s[ls + 1] - t.e0, 0, t.ne);
      const float* col = t.m_s + t.fl;
      float dv = 0.f;
      for (int le = lo; le < hi; ++le) {
        dv = (le == lo) ? col[le * t.ms] : __fadd_rn(dv, col[le * t.ms]);
      }
      const int slot = t.slot_s[ls];
      float* dst =
          (slot < 0 || o.part == nullptr)   // the node's only segment
              ? o.d_v + static_cast<long long>(t.node_s[ls]) * o.n_feat + t.f
              : o.part +
                    static_cast<long long>(min(slot, o.n_part - 1)) *
                        o.n_feat +
                    t.f;
      // a segment continued from an earlier sub-tile adds to that part's sum
      *dst = (t.cont && ls == t.sa) ? __fadd_rn(*dst, dv) : dv;
    }
  }
};

template <typename T, bool kEdgeFeatures>
__global__ void __launch_bounds__(pna::kMaxThreads, pna::kBlocksPerSM)
csr_pretrans_dmsg_kernel(const pna::PretransArgs a, const DmsgIo o) {
  const DmsgPhase2 phase2{o};
  pna::pretrans_walk<T, kEdgeFeatures>(a, phase2);

  // rows outside every node's range: 0
  const int g = threadIdx.x / a.feat_chunk;
  const int f = blockIdx.y * a.feat_chunk + threadIdx.x - g * a.feat_chunk;
  if (g >= a.groups || f >= a.n_feat || f >= (blockIdx.y + 1) * a.feat_chunk) {
    return;
  }
  const int first = pna::clampi(a.seg_ptr[0], 0, a.n_edges);
  const int last = pna::clampi(a.seg_ptr[a.n_seg], first, a.n_edges);
  const int n_out = first + (a.n_edges - last);
  for (long long i = static_cast<long long>(blockIdx.x) * a.groups + g;
       i < n_out; i += static_cast<long long>(gridDim.x) * a.groups) {
    const long long row = i < first ? i : last + (i - first);
    o.d_msg[row * a.n_feat + f] = 0.f;
  }
}

constexpr int kMergeThreads = 1024;

// One block per split node j.  Threads are (row c, feature): row c adds its
// contiguous share of the partials [split_ptr[j], split_ptr[j + 1]) in
// order, then row 0 adds the rows' sums in order.
__global__ void __launch_bounds__(kMergeThreads)
csr_pretrans_dmsg_merge_kernel(const int* __restrict__ split_node,
                               const int* __restrict__ split_ptr, int n_nodes,
                               const DmsgIo o) {
  __shared__ float row_s[kMergeThreads];
  const int j = blockIdx.x;
  const int nf = o.n_feat;
  const int fw = min(nf, kMergeThreads);
  const int rows = kMergeThreads / fw;
  const int c = threadIdx.x / fw;
  const int fl = threadIdx.x - c * fw;
  const int node = pna::clampi(split_node[j], 0, n_nodes - 1);
  const int p0 = pna::clampi(split_ptr[j], 0, o.n_part);
  const int p1 = pna::clampi(split_ptr[j + 1], p0, o.n_part);
  const int share = (p1 - p0 + rows - 1) / rows;
  const int lo = min(p0 + c * share, p1);
  const int hi = min(lo + share, p1);
  for (int f0 = 0; f0 < nf; f0 += fw) {
    const int f = f0 + fl;
    float dv = 0.f;
    if (c < rows && f < nf && hi > lo) {
      const float* q = o.part + static_cast<long long>(lo) * nf + f;
      dv = q[0];
#pragma unroll 4
      for (int p = lo + 1; p < hi; ++p) {
        q += nf;
        dv = __fadd_rn(dv, q[0]);
      }
    }
    __syncthreads();   // the previous feature chunk's fold has read row_s
    row_s[threadIdx.x] = dv;
    __syncthreads();
    if (c == 0 && f < nf) {
      for (int r = 1; r < rows && p0 + r * share < p1; ++r) {
        dv = __fadd_rn(dv, row_s[r * fw + fl]);
      }
      o.d_v[static_cast<long long>(node) * nf + f] = dv;
    }
  }
}

template <typename T>
cudaError_t launch(const pna::PretransArgs& a, const pna::PretransLaunch& l,
                   const DmsgIo& o, cudaStream_t st) {
  return a.fe > 0 ? pna::pretrans_launch(csr_pretrans_dmsg_kernel<T, true>, l,
                                         st, a, o)
                  : pna::pretrans_launch(csr_pretrans_dmsg_kernel<T, false>,
                                         l, st, a, o);
}

}  // namespace

// Inputs and segment table as pna_csr_pretrans_sketch, plus the six node
// fields [N, F] f32 (g_max/g_min already divided by the tie counts; mx/mn
// K3's max/min); d_msg [E, F] f32 and d_v [N, F] f32; part [n_part, F] f32
// scratch for the split nodes.  Launches on `stream` (one kernel, two where a
// node is split) and returns the cudaError_t of the launch.
extern "C" int pna_csr_pretrans_dmsg(
    const float* u, const void* v, const int* snd, const int* seg_ptr,
    const int* seg_node, const int* seg_slot, const int* split_node,
    const int* split_ptr, const void* ef, const void* ke, int bf16,
    const float* g_lin, const float* g_quad, const float* g_max,
    const float* g_min, const float* mx, const float* mn, int n_seg,
    int n_split, int n_part, int n_nodes, int n_u, int n_edges, int n_feat,
    int fe, float* d_msg, float* d_v, float* part, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_feat <= 0) return static_cast<int>(cudaSuccess);
  if (n_nodes <= 0) {   // no node owns a row: every row is 0
    if (n_edges <= 0) return static_cast<int>(cudaSuccess);
    return static_cast<int>(cudaMemsetAsync(
        d_msg, 0, sizeof(float) * static_cast<size_t>(n_edges) * n_feat, st));
  }
  if (n_seg < n_nodes || fe < 0 || (n_u <= 0 && n_edges > 0) ||
      (n_split > 0 && (part == nullptr || seg_slot == nullptr ||
                       seg_node == nullptr || n_part <= 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pna::PretransArgs a{u,     v,       snd, seg_ptr, seg_node, seg_slot, ef,
                      ke,    n_seg,   n_nodes, n_u, n_edges,  n_feat,   fe,
                      0,     0,       0,   0,       0,       0,        0};
  pna::PretransLaunch l;
  cudaError_t rc = pna::pretrans_geometry(a, l);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const DmsgIo o{g_lin, g_quad, g_max, g_min, mx, mn, d_msg, d_v,
                 n_split > 0 ? part : nullptr, n_feat, n_part};
  rc = bf16 ? launch<__nv_bfloat16>(a, l, o, st) : launch<float>(a, l, o, st);
  if (rc != cudaSuccess || n_split <= 0) return static_cast<int>(rc);

  csr_pretrans_dmsg_merge_kernel<<<dim3(static_cast<unsigned>(n_split)),
                                   kMergeThreads, 0, st>>>(
      split_node, split_ptr, n_nodes, o);
  return static_cast<int>(cudaGetLastError());
}
