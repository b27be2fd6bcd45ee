// K2: CSR message gradient for Hopper (sm_90a).
//
// Replaces pna_tpu/ops/pallas_kernels.py::sorted_dmsg (kernel body
// _dmsg_kernel).  For every edge e in node r's receiver-sorted range
// [ptr[r], ptr[r+1]):
//   d_msg[e] = g_lin[r] + 2 msg[e] g_quad[r]
//              + [msg[e] == mx[r]] g_max[r] + [msg[e] == mn[r]] g_min[r]
// Rows outside every node's range (pad edges past ptr[N], rows before
// ptr[0]) are written as 0, so the caller needs no mask.
//
// Bound on this card: HBM bytes.  It reads the messages, one int32 per row
// and six [N, F] node fields once and writes d_msg once: at the flagship ZINC
// step (42,356 real edges, 19,792 nodes, F = 70) about 45.3 MB read and
// 11.9 MB written, some 17 us at 3.35 TB/s.
//
// What the first design lost time on.  It was node-owned, K1's first walk:
// one warp per (node, 32 features) read its pointers, then its six field
// values and its two or three message lines, a chain of dependent loads with
// little in flight; 26 of 96 lanes idle at F = 70; a hub's 13,107 rows the
// serial loop of three warps (1.4 ms on an H100).
//
// This design is edge-owned: d_msg[e, f] needs only msg[e, f] and six node
// values, so nothing forces a warp per node.  Threads index the flat range
// [0, E * F) of d_msg, four neighbouring floats a thread (one 16-byte load
// of msg and one 16-byte store; a block starts at a row that is a multiple
// of 4, so its part of the flat range starts 16-byte aligned for any F
// where msg and d_msg do; tensors that do not take the same walk with
// 4-byte accesses).  The receiver of a row comes from an int32 array
// row_node [E] that the layout holds (a value outside [0, N) for a row in no
// node's range: the Python side builds it from the row pointers once per
// batch, without synchronisation).  Neighbouring rows share a receiver, so the
// node fields come from device memory once and from L1/L2 after; reads and
// writes of the [E, F] arrays are fully coalesced; a hub's rows spread over
// the card like any others, with no special case and no merge.  Every row
// has exactly one writer, so the boundary-chunk read-modify-write merge of
// the TPU kernel (safe there only because the TPU grid runs in order) has no
// counterpart here.  The arithmetic uses __fmul_rn/__fadd_rn, which nvcc does
// not contract into FMAs, so each element takes the plain version's roundings
// in the plain version's order; the tie tests compare against the max/min
// values K1 selected from the same messages and are exact.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockFloats = 2048;   // floats of d_msg a block aims to write

struct DmsgArgs {
  const float* msg;        // [E, F]
  const int* row_node;     // [E]; outside [0, N): the row belongs to no node
  const float* g_lin;      // [N, F] each
  const float* g_quad;
  const float* g_max;
  const float* g_min;
  const float* mx;
  const float* mn;
  float* d_msg;            // [E, F]
  int n_nodes, n_edges, n_feat;
  int block_rows;          // rows of one block, a multiple of 4
};

// d_msg of message m at feature f of a row of node r (outside [0, N): no
// node, so a bad row_node cannot leave the node fields either).
__device__ __forceinline__ float dmsg_value(const DmsgArgs& a, int r, int f,
                                            float m) {
  if (r < 0 || r >= a.n_nodes) return 0.f;
  const long long at = static_cast<long long>(r) * a.n_feat + f;
  const float gl = __ldg(a.g_lin + at);
  const float gq = __ldg(a.g_quad + at);
  const float gx = __ldg(a.g_max + at);
  const float gn = __ldg(a.g_min + at);
  const float vx = __ldg(a.mx + at);
  const float vn = __ldg(a.mn + at);
  float d = __fadd_rn(gl, __fmul_rn(__fmul_rn(2.f, m), gq));
  if (m == vx) d = __fadd_rn(d, gx);
  if (m == vn) d = __fadd_rn(d, gn);
  return d;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
csr_dmsg_kernel(const DmsgArgs a) {
  const int nf = a.n_feat;
  const long long row0 = static_cast<long long>(blockIdx.x) * a.block_rows;
  const int rows =
      static_cast<int>(min(static_cast<long long>(a.block_rows),
                           a.n_edges - row0));
  const int count = rows * nf;              // floats of this block
  const float* msg = a.msg + row0 * nf;
  float* d_msg = a.d_msg + row0 * nf;
  const int* row_node = a.row_node + row0;
  const int n_vec = kVec ? count / 4 : 0;

  // a block's vectors are at most two a thread: both iterations' loads are
  // started together.  msg and d_msg are touched once (streaming hints), so
  // that the node fields, which neighbouring rows share, stay cached
#pragma unroll 2
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const float4 m4 = __ldcs(reinterpret_cast<const float4*>(msg) + v);
    const float m[4] = {m4.x, m4.y, m4.z, m4.w};
    float d[4];
    int e = (4 * v) / nf;
    int f = 4 * v - e * nf;
    int r = __ldg(row_node + e);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      d[c] = dmsg_value(a, r, f, m[c]);
      if (++f == nf && c < 3) {   // the next float opens a row
        f = 0;
        ++e;
        if (e < rows) r = __ldg(row_node + e);
      }
    }
    __stcs(reinterpret_cast<float4*>(d_msg) + v,
           make_float4(d[0], d[1], d[2], d[3]));
  }
  // what is left: the last count % 4 floats, or all of them without vectors
  for (int j = 4 * n_vec + threadIdx.x; j < count; j += kThreads) {
    const int e = j / nf;
    d_msg[j] = dmsg_value(a, __ldg(row_node + e), j - e * nf, msg[j]);
  }
}

}  // namespace

// msg [E, F] f32 row-major, row_node [E] int32 (the node of each row, a value
// outside [0, N) for a row in no node's range), the six node fields [N, F]
// f32; d_msg [E, F] f32, every row written.  Launches on `stream` and returns the cudaError_t
// of the launch.
extern "C" int pna_csr_dmsg(const float* msg, const int* row_node,
                            const float* g_lin, const float* g_quad,
                            const float* g_max, const float* g_min,
                            const float* mx, const float* mn,
                            int n_nodes, int n_edges, int n_feat,
                            float* d_msg, void* stream) {
  if (n_edges <= 0 || n_feat <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0) {   // no node owns a row: every row is 0
    return static_cast<int>(cudaMemsetAsync(
        d_msg, 0, sizeof(float) * static_cast<size_t>(n_edges) * n_feat, st));
  }
  int block_rows = kBlockFloats / n_feat / 4 * 4;
  if (block_rows < 4) block_rows = 4;
  if (static_cast<long long>(block_rows) * n_feat > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DmsgArgs a{msg, row_node, g_lin, g_quad, g_max, g_min, mx, mn, d_msg,
                   n_nodes, n_edges, n_feat, block_rows};
  const dim3 grid(static_cast<unsigned>(
      (static_cast<long long>(n_edges) + block_rows - 1) / block_rows));
  const bool vec = ((reinterpret_cast<uintptr_t>(msg) |
                     reinterpret_cast<uintptr_t>(d_msg)) & 15) == 0;
  if (vec) {
    csr_dmsg_kernel<true><<<grid, kThreads, 0, st>>>(a);
  } else {
    csr_dmsg_kernel<false><<<grid, kThreads, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Message of a cudaError_t returned by a launcher of this library.
extern "C" const char* pna_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
