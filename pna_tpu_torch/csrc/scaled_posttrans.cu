// The PNA layer's first posttrans layer with its scaler contraction, for
// Hopper (sm_90a).
//
// It replaces no pallas_call: JAX's fused layer folds the scaler axis into
// the output of one XLA matmul with a block-diagonal weight and contracts it
// with an einsum.  For tower t of T and node n, with the aggregator bank
// Z [N, A, T FT] (the layout of ops/csr_bank.py::csr_raw_bank,
// ops/csr_fused.py::csr_fused_bank and ops/partial_stats.py::finalize_bank),
// the tower's input h_t (its FT columns of h [N, T FT], or all of h [N, FT]
// when the towers share it), the scaler weights w [S, N] and the posttrans
// weights as the layer stores them, kp [T, (A S + 1) FT, FO] and bp [T, FO]:
//   y[n,t,o,s] = sum_{a,f} Z[n,a,t,f] kp[t, FT + (s A + a) FT + f, o]
//   out[n,t,o] = sum_f h_t[n,f] kp[t,f,o] + sum_s w[s,n] y[n,t,o,s] + bp[t,o]
// The forward is one kernel; the backward one kernel that writes d_Z, d_h
// and a partial d_kp, d_bp per block, and a merge that sums the partials in
// block order.  ops/posttrans.py holds the wrapper, the plain version and
// the autograd function.
//
// Bound on this card, at the large graph's layer (N 625,000, T 4, FT = FO =
// 16, A 4, S 3): the forward reads Z (0.64 GB), h (0.16 GB) and w, and
// writes out (0.16 GB): 0.97 GB, 0.29 ms at 3.35 TB/s; it does 2 N T (A S FT
// FO + FT FO) = 16.6 GFLOP, 0.25 ms at 67 TFLOP/s.  The backward reads d_out,
// Z, h and w and writes d_Z and d_h: 1.77 GB, 0.53 ms; and twice the
// forward's operations, 0.50 ms.  The two lines lie close, so the design
// keeps both the bytes and the float32 FMA pipes busy:
//   * a block takes one tower (blockIdx % T) and walks tiles of 128 nodes;
//     the grid is the blocks the card holds at once (2 an SM).  It stages
//     its tower's weights, as stored, once, and each tile's Z, h, w (and
//     d_out) rows transposed into shared memory from 16-byte loads of each
//     node's 64-byte chunks (8-byte at FT = 14), every load of a thread
//     issued before its first store;
//   * the forward's thread holds 4 nodes x 4 outputs x S scalers (48 float32
//     accumulators at the cell): per row of Z it loads the 4 nodes' values
//     as one 16-byte word and 12 weights, which every lane of the warp
//     shares, and does 48 FMAs; then it contracts its S products with the
//     nodes' w in registers and adds the h part and the bias; no
//     [N, T FO S] product and no zero block of a block-diagonal weight
//     exists;
//   * the backward forms d_y = d_out w where it needs it, in registers: each
//     lane keeps a KPT rows x OPB outputs x S tile of the tower's d_kp (rows
//     interleaved over the lanes, so the warp's 16-byte loads hit distinct
//     banks) over the tiles it walks, and the h rows' and the bias's sums
//     beside it; then a warp per aggregator forms d_Z for 4 nodes x FT
//     columns a lane (one d_out word and S w words give S d_y words) and a
//     thread per node d_h.  A block walks tiles b, b + n_part, ... and
//     writes its partial once; the merge sums the n_part partials of each
//     entry in block order.  No atomics: two runs give the same bits;
//   * out, d_Z and d_h go through shared memory, as the inputs came, so that
//     a warp writes whole 32-byte sectors of 8 nodes' chunks: written from
//     registers, each lane's 16-byte piece of a 1 KB-strided row cost the
//     forward 0.35 of its 0.75 ms (H100, 700 W, 625,000 nodes).  Measured
//     there (L2 flushed): forward 0.61 ms, backward 1.59 ms;
//   * float32 FMA on the CUDA cores, no TF32.  With `rnd` (a bfloat16
//     compute dtype) every operand is rounded to bfloat16 as it is staged,
//     y before its contraction, d_y as it is formed, and d_Z and d_kp as
//     they are written: the roundings of ops/posttrans.py's plain version;
//   * specialised on the widths it reads from kp (FT, FO, A, S); the towers
//     T are a runtime count, so a rank of tower TP runs its local towers.
//     ops/posttrans.py takes the plain version for another shape.
//
// With -DPNA_HOST_CHECK the source compiles with a host C++ compiler against
// the stub cuda_runtime.h of tests/test_torch_csrc_host.py.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "csr_common.cuh"

namespace {

constexpr int kNodes = 4;                      // nodes a thread holds
static_assert(kNodes == 4, "a thread's nodes are one float4");
constexpr int kTile = pna::kWarp * kNodes;     // nodes a block stages
constexpr int kStride = kTile + 4;             // floats of a staged row

__host__ __device__ constexpr int vec_of(int w) {
  return w % 4 == 0 ? 4 : (w % 2 == 0 ? 2 : 1);
}
__host__ __device__ constexpr int min_of(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ constexpr int up4(int x) { return (x + 3) / 4 * 4; }

// The lanes of a warp over its [ft, c] block of d_kp: kg x cg lanes (kg | ft,
// cg | c, at most 32), as many as divide it, then the fewest loads a step
// (ft / kg + c / cg).  want_kg: return kg, else cg.
constexpr int lane_groups(int ft, int c, bool want_kg) {
  int best_kg = 1, best_cg = 1, best_use = 0, best_cost = 1 << 30;
  for (int kg = 1; kg <= ft && kg <= pna::kWarp; ++kg) {
    if (ft % kg != 0) continue;
    for (int cg = 1; cg <= c && kg * cg <= pna::kWarp; ++cg) {
      if (c % cg != 0) continue;
      const int use = kg * cg, cost = ft / kg + c / cg;
      if (use > best_use || (use == best_use && cost < best_cost)) {
        best_kg = kg;
        best_cg = cg;
        best_use = use;
        best_cost = cost;
      }
    }
  }
  return want_kg ? best_kg : best_cg;
}

template <int FT_, int FO_, int A_, int S_>
struct Shape {
  static constexpr int FT = FT_, FO = FO_, A = A_, S = S_;
  static constexpr int K = A * FT;                 // aggregator rows a tower
  static constexpr int C = FO * S;                 // columns (o, s)
  static constexpr int OPT = vec_of(FO);           // outputs a forward lane
  static constexpr int FWD_THREADS = pna::kWarp * (FO / OPT);
  static constexpr int BWD_THREADS = pna::kWarp * A;
  static constexpr int VF = vec_of(FT);            // vector of an FT chunk
  static constexpr int VW = min_of(vec_of(OPT * S), vec_of(C));
  // a backward lane's d_kp tile: KPT rows x OPB outputs (x S scalers)
  static constexpr int KG = lane_groups(FT, FO, true);
  static constexpr int OG = lane_groups(FT, FO, false);
  static constexpr int KPT = FT / KG, OPB = FO / OG;
  // the h rows' and the bias's entries of d_kp a thread sums
  static constexpr int NKH = (FT * FO + FO + BWD_THREADS - 1) / BWD_THREADS;
  static constexpr int P = K * C + FT * FO + FO;   // floats of a partial
  // shared memory, floats; every array starts on 16 bytes
  static constexpr int FWD_SMEM =
      up4(K * C) + up4(FT * FO) + (K + FT + FO) * kStride + S * kTile;
  static constexpr int BWD_SMEM =
      up4(C * K) + up4(FO * FT) + (K + FT + FO) * kStride + S * kTile;
};

// The cell's layers, ZINC's layers (70 = 5 x 14 wide, the last 60 = 5 x 12
// out): (FT, FO, A, S).
#define PNA_POSTTRANS_SHAPES(X) \
  X(16, 16, 4, 3)               \
  X(14, 14, 4, 3)               \
  X(14, 12, 4, 3)

struct Args {
  const float* z;      // [N, A, T FT]
  const float* h;      // [N, h_width]; tower t reads FT from t h_step
  const float* w;      // [S, N]
  const float* kp;     // [T, (A S + 1) FT, FO]
  const float* bp;     // [T, FO]
  const float* d_out;  // [N, T, FO]
  float* out;          // [N, T, FO]
  float* d_z;          // [N, A, T FT]
  float* d_h;          // [N, T FT]: tower t's term in columns t FT..
  float* part;         // [T, n_part, P]
  float* d_kp;         // [T, (A S + 1) FT, FO]
  float* d_bp;         // [T, FO]
  int n, towers, h_width, h_step, rnd, n_part;
};

// x rounded to bfloat16 (to nearest, ties to even, as torch's cast) and
// widened back: a float32 with 8 bits of mantissa.
__device__ __forceinline__ float to_bf16(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return x;  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ float rounded(float x, int rnd) {
  return rnd ? to_bf16(x) : x;
}

// V floats from global memory (16- or 8-byte loads where V says so).
template <int V>
__device__ __forceinline__ void load_global(const float* p, float* r) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = q.x, r[1] = q.y;
  } else {
    r[0] = __ldg(p);
  }
}

// W floats from shared memory in vectors of V.
template <int V, int W>
__device__ __forceinline__ void load_shared(const float* p, float* r) {
#pragma unroll
  for (int i = 0; i < W; i += V) {
    if constexpr (V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      r[i] = q.x, r[i + 1] = q.y, r[i + 2] = q.z, r[i + 3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = *reinterpret_cast<const float2*>(p + i);
      r[i] = q.x, r[i + 1] = q.y;
    } else {
      r[i] = p[i];
    }
  }
}

// W floats to global memory in vectors of V.
template <int V, int W>
__device__ __forceinline__ void store_global(float* p, const float* r) {
#pragma unroll
  for (int i = 0; i < W; i += V) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p + i) =
          float4{r[i], r[i + 1], r[i + 2], r[i + 3]};
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p + i) = float2{r[i], r[i + 1]};
    } else {
      p[i] = r[i];
    }
  }
}

__device__ __forceinline__ void unpack(const float* p, float* r) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  r[0] = q.x, r[1] = q.y, r[2] = q.z, r[3] = q.w;
}

// The tile's CH chunks of W floats a node (chunk ch of node m at src + m
// row + ch step), held in registers between `load` and `store`, so that a
// thread's loads (16 of 16 bytes for Z at the cell) are all in flight
// before its first store.  Consecutive threads load consecutive vectors of
// a chunk, then the next node's; `store` writes them to rows ch W + f of
// dst, node n0 + j at column j, 0 past the last node.
template <int W, int CH, int THREADS>
struct Rows {
  static constexpr int V = vec_of(W), NV = W / V, TOTAL = kTile * CH * NV;
  static constexpr int ITER = (TOTAL + THREADS - 1) / THREADS;
  float r[ITER][V];

  __device__ __forceinline__ void load(const float* src, long long row,
                                       long long step, long long n0, int n) {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int v = i % NV, j = (i / NV) % kTile, ch = i / (NV * kTile);
      if (i < TOTAL && n0 + j < n) {
        load_global<V>(src + (n0 + j) * row + ch * step + v * V, r[it]);
      } else {
#pragma unroll
        for (int q = 0; q < V; ++q) r[it][q] = 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(float* dst, int rnd) const {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int v = i % NV, j = (i / NV) % kTile, ch = i / (NV * kTile);
      if (i >= TOTAL) break;
#pragma unroll
      for (int q = 0; q < V; ++q) {
        dst[(ch * W + v * V + q) * kStride + j] = rounded(r[it][q], rnd);
      }
    }
  }
};

// The inverse of Rows: rows ch W + f of src (node n0 + j at column j) to the
// tile's CH chunks of W floats a node (chunk ch of node m at dst + m row + ch
// step), rounded; consecutive threads write consecutive vectors of a chunk,
// so that a warp writes whole 32-byte sectors (8 nodes' 64-byte chunks at
// the cell) and not a 16-byte piece of each of 32 rows.
template <int W, int CH, int THREADS>
__device__ __forceinline__ void write_rows(const float* src, float* dst,
                                           long long row, long long step,
                                           long long n0, int n, int rnd) {
  constexpr int V = vec_of(W), NV = W / V, TOTAL = kTile * CH * NV;
#pragma unroll 4
  for (int i = threadIdx.x; i < TOTAL; i += THREADS) {
    const int v = i % NV, j = (i / NV) % kTile, ch = i / (NV * kTile);
    if (n0 + j >= n) continue;
    float r[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      r[q] = rounded(src[(ch * W + v * V + q) * kStride + j], rnd);
    }
    store_global<V, V>(dst + (n0 + j) * row + ch * step + v * V, r);
  }
}

// The tile's scaler weights, alike: sw[s kTile + j] = w[s, n0 + j].
template <int S, int THREADS>
struct Scalers {
  static constexpr int ITER = (S * kTile + THREADS - 1) / THREADS;
  float r[ITER];

  __device__ __forceinline__ void load(const float* w, long long n0, int n) {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = threadIdx.x + it * THREADS, s = i / kTile, j = i % kTile;
      r[it] = i < S * kTile && n0 + j < n
                  ? __ldg(w + static_cast<long long>(s) * n + n0 + j)
                  : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* sw, int rnd) const {
#pragma unroll
    for (int it = 0; it < ITER; ++it) {
      const int i = threadIdx.x + it * THREADS;
      if (i < S * kTile) sw[i] = rounded(r[it], rnd);
    }
  }
};

// Tower kt's weights: the aggregator rows as wk[k C + c] (forward) or
// wk[c K + k] (kTransposed, backward), k = a FT + f, c = o S + s; the h rows
// as kh[f FO + o] or kh[o FT + f].  Read in kp's order, every load of a
// thread issued before its first store.
template <class Sh, bool kTransposed, int THREADS>
__device__ __forceinline__ void stage_weights(float* wk, float* kh,
                                              const float* kt, int rnd) {
  constexpr int FT = Sh::FT, FO = Sh::FO, S = Sh::S, K = Sh::K, C = Sh::C;
  constexpr int ALL = K * C + FT * FO;
  constexpr int ITER = (ALL + THREADS - 1) / THREADS;
  float r[ITER];
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    r[it] = i < ALL ? __ldg(kt + i) : 0.f;   // kp's rows: h, then (s, a, f)
  }
#pragma unroll
  for (int it = 0; it < ITER; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i >= ALL) break;
    const float v = rounded(r[it], rnd);
    if (i < FT * FO) {
      const int f = i / FO, o = i % FO;
      kh[kTransposed ? o * FT + f : i] = v;
    } else {
      const int r_ = (i - FT * FO) / FO, o = i % FO;  // r_ = (s A + a) FT + f
      const int s = r_ / K, k = r_ % K, c = o * S + s;
      wk[kTransposed ? c * K + k : k * C + c] = v;
    }
  }
}

// A block of T blocks takes tower blockIdx % T and walks its tiles blockIdx /
// T, + gridDim / T, ...; its tower's weights are staged once.
template <class Sh>
__global__ void __launch_bounds__(Sh::FWD_THREADS, 2)
    scaled_posttrans_fwd_kernel(Args a) {
  constexpr int FT = Sh::FT, FO = Sh::FO, A = Sh::A, S = Sh::S;
  constexpr int K = Sh::K, C = Sh::C, OPT = Sh::OPT;
  constexpr int THREADS = Sh::FWD_THREADS;
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);  // [K][C]
  float* khs = ws + up4(K * C);                // [FT][FO]
  float* zs = khs + up4(FT * FO);              // [K][kStride]
  float* hs = zs + K * kStride;                // [FT][kStride]
  float* sw = hs + FT * kStride;               // [S][kTile]
  float* os = sw + S * kTile;                  // [FO][kStride]: out
  const int T = a.towers, t = blockIdx.x % T;
  const long long stride = gridDim.x / T;
  const long long tiles = (static_cast<long long>(a.n) + kTile - 1) / kTile;
  const float* kt = a.kp + static_cast<long long>(t) * (A * S + 1) * FT * FO;
  const float* zt = a.z + t * FT;
  const float* ht = a.h + static_cast<long long>(t) * a.h_step;
  const long long zrow = static_cast<long long>(A) * T * FT;
  stage_weights<Sh, false, THREADS>(ws, khs, kt, a.rnd);
  Rows<FT, A, THREADS> zr;
  Rows<FT, 1, THREADS> hr;
  Scalers<S, THREADS> wr;
  const int lane = threadIdx.x % pna::kWarp;
  const int o0 = threadIdx.x / pna::kWarp * OPT;
  float bv[OPT];
  load_global<OPT>(a.bp + t * FO + o0, bv);

  for (long long tile = blockIdx.x / T; tile < tiles; tile += stride) {
    const long long n0 = tile * kTile;
    zr.load(zt, zrow, static_cast<long long>(T) * FT, n0, a.n);
    hr.load(ht, a.h_width, 0, n0, a.n);
    wr.load(a.w, n0, a.n);
    __syncthreads();  // the last tile's readers are done
    zr.store(zs, a.rnd);
    hr.store(hs, a.rnd);
    wr.store(sw, a.rnd);
    __syncthreads();

    // y: 4 nodes x OPT outputs x S scalers
    float acc[kNodes][OPT * S];
#pragma unroll
    for (int m = 0; m < kNodes; ++m) {
#pragma unroll
      for (int j = 0; j < OPT * S; ++j) acc[m][j] = 0.f;
    }
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float z[kNodes], wv[OPT * S];
      unpack(zs + k * kStride + kNodes * lane, z);
      load_shared<Sh::VW, OPT * S>(ws + k * C + o0 * S, wv);
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
#pragma unroll
        for (int j = 0; j < OPT * S; ++j) {
          acc[m][j] = fmaf(z[m], wv[j], acc[m][j]);
        }
      }
    }
    // the scaler contraction, then the h part and the bias
    float res[kNodes][OPT];
    {
      float wn[S][kNodes];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        unpack(sw + s * kTile + kNodes * lane, wn[s]);
      }
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
#pragma unroll
        for (int i = 0; i < OPT; ++i) {
          float y = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            y = fmaf(rounded(acc[m][i * S + s], a.rnd), wn[s][m], y);
          }
          res[m][i] = y;
        }
      }
    }
#pragma unroll 4
    for (int f = 0; f < FT; ++f) {
      float hv[kNodes], kv[OPT];
      unpack(hs + f * kStride + kNodes * lane, hv);
      load_shared<OPT, OPT>(khs + f * FO + o0, kv);
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
#pragma unroll
        for (int i = 0; i < OPT; ++i) {
          res[m][i] = fmaf(hv[m], kv[i], res[m][i]);
        }
      }
    }
    // out through shared memory, then whole sectors to global memory
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      *reinterpret_cast<float4*>(os + (o0 + i) * kStride + kNodes * lane) =
          float4{res[0][i] + bv[i], res[1][i] + bv[i], res[2][i] + bv[i],
                 res[3][i] + bv[i]};
    }
    __syncthreads();
    write_rows<FO, 1, THREADS>(os, a.out + t * FO,
                               static_cast<long long>(T) * FO, 0, n0, a.n,
                               0);
  }
}

// d_y[m][s] = d_out[o] w[s] of the lane's 4 nodes (columns j0 ..), rounded.
template <int S>
__device__ __forceinline__ void scaled_grads(const float* dos_o,
                                             const float* sw, int j0,
                                             int rnd, float dy[S][kNodes]) {
  float d[kNodes];
  unpack(dos_o + j0, d);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    float wn[kNodes];
    unpack(sw + s * kTile + j0, wn);
#pragma unroll
    for (int m = 0; m < kNodes; ++m) dy[s][m] = rounded(d[m] * wn[m], rnd);
  }
}

// A block of T blocks takes tower blockIdx % T and walks its tiles blockIdx /
// T, + n_part, ...; it writes its partial d_kp and d_bp once.
template <class Sh>
__global__ void __launch_bounds__(Sh::BWD_THREADS, 2)
    scaled_posttrans_bwd_kernel(Args a) {
  constexpr int FT = Sh::FT, FO = Sh::FO, A = Sh::A, S = Sh::S;
  constexpr int K = Sh::K, C = Sh::C, KG = Sh::KG, OG = Sh::OG;
  constexpr int KPT = Sh::KPT, OPB = Sh::OPB, NKH = Sh::NKH;
  constexpr int THREADS = Sh::BWD_THREADS, P = Sh::P;
  extern __shared__ float4 smem[];
  float* wts = reinterpret_cast<float*>(smem);  // [C][K]
  float* khts = wts + up4(C * K);               // [FO][FT]
  float* zs = khts + up4(FO * FT);              // [K][kStride]
  float* hs = zs + K * kStride;                 // [FT][kStride]
  float* dos = hs + FT * kStride;               // [FO][kStride]
  float* sw = dos + FO * kStride;               // [S][kTile]
  const int T = a.towers, t = blockIdx.x % T, b = blockIdx.x / T;
  const float* kt = a.kp + static_cast<long long>(t) * (A * S + 1) * FT * FO;
  stage_weights<Sh, true, THREADS>(wts, khts, kt, a.rnd);

  const int tid = threadIdx.x, lane = tid % pna::kWarp;
  const int warp = tid / pna::kWarp;          // the aggregator of d_Z
  const int kg = lane % KG, og = lane / KG;   // this lane's d_kp tile
  const bool owns = lane < KG * OG;
  // d_kp: rows warp FT + i KG + kg, columns (j OG + og) S + s
  float dk[KPT][OPB][S];
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
#pragma unroll
    for (int j = 0; j < OPB; ++j) {
#pragma unroll
      for (int s = 0; s < S; ++s) dk[i][j][s] = 0.f;
    }
  }
  // the h rows' entries (e < FT FO) and the bias's, a sum per node slot
  float dkh[NKH][kNodes];
#pragma unroll
  for (int r = 0; r < NKH; ++r) {
#pragma unroll
    for (int m = 0; m < kNodes; ++m) dkh[r][m] = 0.f;
  }

  const long long tiles = (static_cast<long long>(a.n) + kTile - 1) / kTile;
  Rows<FT, A, THREADS> zr;
  Rows<FT, 1, THREADS> hr;
  Rows<FO, 1, THREADS> dr;
  Scalers<S, THREADS> wr;
  for (long long tile = b; tile < tiles; tile += a.n_part) {
    const long long n0 = tile * kTile;
    zr.load(a.z + t * FT, static_cast<long long>(A) * T * FT,
            static_cast<long long>(T) * FT, n0, a.n);
    hr.load(a.h + static_cast<long long>(t) * a.h_step, a.h_width, 0, n0,
            a.n);
    dr.load(a.d_out + t * FO, static_cast<long long>(T) * FO, 0, n0, a.n);
    wr.load(a.w, n0, a.n);
    __syncthreads();  // the last tile's readers are done
    zr.store(zs, a.rnd);
    hr.store(hs, a.rnd);
    dr.store(dos, 0);
    wr.store(sw, a.rnd);
    __syncthreads();

    // d_kp's aggregator rows: Z^T d_y over the tile's nodes
    if (owns) {
#pragma unroll 1
      for (int j0 = 0; j0 < kTile; j0 += kNodes) {
        float zv[KPT][kNodes];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          unpack(zs + (warp * FT + i * KG + kg) * kStride + j0, zv[i]);
        }
#pragma unroll
        for (int j = 0; j < OPB; ++j) {
          float dy[S][kNodes];
          scaled_grads<S>(dos + (j * OG + og) * kStride, sw, j0, a.rnd, dy);
#pragma unroll
          for (int i = 0; i < KPT; ++i) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
#pragma unroll
              for (int m = 0; m < kNodes; ++m) {
                dk[i][j][s] = fmaf(zv[i][m], dy[s][m], dk[i][j][s]);
              }
            }
          }
        }
      }
    }
    // the h rows' entries h^T d_out and the bias's (h = 1), one sum a slot
#pragma unroll
    for (int r = 0; r < NKH; ++r) {
      const int e = tid + r * THREADS;
      if (e >= FT * FO + FO) break;
      const bool bias = e >= FT * FO;
      const float* hrow = hs + (bias ? 0 : e / FO) * kStride;
      const float* drow = dos + (bias ? e - FT * FO : e % FO) * kStride;
#pragma unroll 4
      for (int j0 = 0; j0 < kTile; j0 += kNodes) {
        float hv[kNodes], dv[kNodes];
        unpack(hrow + j0, hv);
        unpack(drow + j0, dv);
#pragma unroll
        for (int m = 0; m < kNodes; ++m) {
          dkh[r][m] = bias ? dkh[r][m] + dv[m]
                           : fmaf(hv[m], dv[m], dkh[r][m]);
        }
      }
    }
    __syncthreads();  // Z, h read: their rows take d_Z and d_h
    // d_Z: this warp's aggregator, 4 nodes x FT a lane
    {
      float acc[kNodes][FT];
#pragma unroll
      for (int m = 0; m < kNodes; ++m) {
#pragma unroll
        for (int f = 0; f < FT; ++f) acc[m][f] = 0.f;
      }
#pragma unroll 1
      for (int o = 0; o < FO; ++o) {
        float dy[S][kNodes];
        scaled_grads<S>(dos + o * kStride, sw, kNodes * lane, a.rnd, dy);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          float wk[FT];
          load_shared<Sh::VF, FT>(wts + (o * S + s) * K + warp * FT, wk);
#pragma unroll
          for (int m = 0; m < kNodes; ++m) {
#pragma unroll
            for (int f = 0; f < FT; ++f) {
              acc[m][f] = fmaf(dy[s][m], wk[f], acc[m][f]);
            }
          }
        }
      }
      // into zs, whose rows the d_kp phase has read
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        *reinterpret_cast<float4*>(zs + (warp * FT + f) * kStride +
                                   kNodes * lane) =
            float4{acc[0][f], acc[1][f], acc[2][f], acc[3][f]};
      }
    }
    // d_h: a node a thread
    for (int j = tid; j < kTile; j += THREADS) {
      float acc[FT];
#pragma unroll
      for (int f = 0; f < FT; ++f) acc[f] = 0.f;
#pragma unroll 4
      for (int o = 0; o < FO; ++o) {
        float kv[FT];
        const float d = dos[o * kStride + j];
        load_shared<Sh::VF, FT>(khts + o * FT, kv);
#pragma unroll
        for (int f = 0; f < FT; ++f) acc[f] = fmaf(d, kv[f], acc[f]);
      }
#pragma unroll
      for (int f = 0; f < FT; ++f) hs[f * kStride + j] = acc[f];  // as zs
    }
    __syncthreads();
    write_rows<FT, A, THREADS>(zs, a.d_z + t * FT,
                               static_cast<long long>(A) * T * FT,
                               static_cast<long long>(T) * FT, n0, a.n,
                               a.rnd);
    write_rows<FT, 1, THREADS>(hs, a.d_h + t * FT,
                               static_cast<long long>(T) * FT, 0, n0, a.n, 0);
  }

  float* pt = a.part + (static_cast<long long>(t) * a.n_part + b) * P;
  if (owns) {
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
#pragma unroll
      for (int j = 0; j < OPB; ++j) {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          pt[(warp * FT + i * KG + kg) * C + (j * OG + og) * S + s] =
              dk[i][j][s];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NKH; ++r) {
    const int e = tid + r * THREADS;
    if (e < FT * FO + FO) {
      pt[K * C + e] = (dkh[r][0] + dkh[r][1]) + (dkh[r][2] + dkh[r][3]);
    }
  }
}

// d_kp and d_bp: each entry the sum of its n_part partials in block order.
template <class Sh>
__global__ void scaled_posttrans_merge_kernel(Args a) {
  constexpr int FT = Sh::FT, FO = Sh::FO, A = Sh::A, S = Sh::S;
  constexpr int K = Sh::K, C = Sh::C, P = Sh::P;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.towers * P) return;
  const int t = i / P, e = i % P;
  const float* src = a.part + static_cast<long long>(t) * a.n_part * P + e;
  float sum = 0.f;
  for (int b = 0; b < a.n_part; ++b) sum += src[static_cast<long long>(b) * P];
  float* dkt = a.d_kp + static_cast<long long>(t) * (A * S + 1) * FT * FO;
  if (e < K * C) {
    const int k = e / C, c = e % C, s = c % S, o = c / S;
    dkt[(FT + s * K + k) * FO + o] = rounded(sum, a.rnd);
  } else if (e < K * C + FT * FO) {
    dkt[e - K * C] = rounded(sum, a.rnd);
  } else {
    a.d_bp[t * FO + e - K * C - FT * FO] = sum;
  }
}

// Calls f(Shape<...>{}) for the instantiated shape (ft, fo, na, ns); false
// where there is none.
template <class F>
bool with_shape(int ft, int fo, int na, int ns, F&& f) {
#define PNA_POSTTRANS_CASE(FT, FO, A, S)                    \
  if (ft == FT && fo == FO && na == A && ns == S) {         \
    f(Shape<FT, FO, A, S>{});                               \
    return true;                                            \
  }
  PNA_POSTTRANS_SHAPES(PNA_POSTTRANS_CASE)
#undef PNA_POSTTRANS_CASE
  return false;
}

// Blocks a tower of `kernel` (`threads` threads, `smem` floats): the blocks
// the card holds at once, shared by the towers (at least one).
cudaError_t per_tower(void (*kernel)(Args), int threads, int smem,
                      int towers, int* blocks) {
  const size_t bytes = static_cast<size_t>(smem) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc != cudaSuccess) return rc;
  rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                     threads, bytes);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidValue;
  const int each = sms * per_sm / towers;
  *blocks = each < 1 ? 1 : each;
  return cudaSuccess;
}

// At most `blocks` blocks a tower, and one a 128-node tile of n nodes.
int clamp_to_tiles(int blocks, int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  return static_cast<int>(blocks < tiles ? blocks : tiles);
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool sizes_ok(int n, int towers, int ft, int h_width, int h_step) {
  if (n < 0 || towers < 1 || ft < 1) return false;
  if (h_step != 0 && h_step != ft) return false;
  return h_width % ft == 0 && h_width >= (towers - 1) * h_step + ft;
}

}  // namespace

// 1 where the kernels are built for the widths (ft, fo, na, ns), else 0.
extern "C" int pna_scaled_posttrans_supported(int ft, int fo, int na,
                                              int ns) {
  return with_shape(ft, fo, na, ns, [](auto) {}) ? 1 : 0;
}

// The forward's and the backward's blocks a tower for `towers` towers on the
// current card, in *fwd_blocks and *n_part: the blocks the card holds at
// once, which a launch cuts to one a tile.  Read once a shape and card: the
// occupancy query costs host time a launch should not.  Returns the
// cudaError_t.
extern "C" int pna_scaled_posttrans_grid(int towers, int ft, int fo, int na,
                                         int ns, int* fwd_blocks,
                                         int* n_part) {
  cudaError_t rc = cudaErrorInvalidValue;
  *fwd_blocks = *n_part = 0;
  if (towers < 1) return static_cast<int>(rc);
  with_shape(ft, fo, na, ns, [&](auto sh) {
    using Sh = decltype(sh);
    rc = per_tower(scaled_posttrans_fwd_kernel<Sh>, Sh::FWD_THREADS,
                   Sh::FWD_SMEM, towers, fwd_blocks);
    if (rc != cudaSuccess) return;
    rc = per_tower(scaled_posttrans_bwd_kernel<Sh>, Sh::BWD_THREADS,
                   Sh::BWD_SMEM, towers, n_part);
  });
  return static_cast<int>(rc);
}

// The forward: z [n, na, towers ft], h [n, h_width] (tower t reads ft floats
// from column t h_step: h_step ft, or 0 where the towers share h), w [ns,
// n], kp [towers, (na ns + 1) ft, fo], bp [towers, fo], f32 row-major and
// 16-byte aligned -> out [n, towers, fo], every row written, by at most
// `blocks` blocks a tower (pna_scaled_posttrans_grid's; one a tile at
// most).  rnd: round the operands to bfloat16.  Launches on `stream` and
// returns the cudaError_t.
extern "C" int pna_scaled_posttrans_fwd(const float* z, const float* h,
                                        const float* w, const float* kp,
                                        const float* bp, int n, int towers,
                                        int ft, int fo, int na, int ns,
                                        int h_width, int h_step, int rnd,
                                        int blocks, float* out,
                                        void* stream) {
  if (!sizes_ok(n, towers, ft, h_width, h_step)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  if (!(aligned(z) && aligned(h) && aligned(w) && aligned(kp) &&
        aligned(bp) && aligned(out))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{z,       h,      w,       kp,     bp,  nullptr, out, nullptr,
         nullptr, nullptr, nullptr, nullptr, n, towers,  h_width, h_step,
         rnd,     0};
  cudaError_t rc = cudaErrorInvalidValue;
  with_shape(ft, fo, na, ns, [&](auto sh) {
    using Sh = decltype(sh);
    const int b = clamp_to_tiles(blocks, n);
    if (b < 1 || static_cast<long long>(b) * towers > INT_MAX) return;
    rc = pna::launch_dynamic(scaled_posttrans_fwd_kernel<Sh>,
                             dim3(static_cast<unsigned>(b * towers)),
                             dim3(Sh::FWD_THREADS),
                             Sh::FWD_SMEM * sizeof(float), st, a);
  });
  return static_cast<int>(rc);
}

// The backward: the forward's inputs (bp aside), d_out [n, towers, fo], the
// partials part [towers, n_part, P] (n_part from pna_scaled_posttrans_grid;
// a launch takes u = min(n_part, tiles) blocks a tower and uses the first
// towers u P floats of part) -> d_z [n, na, towers ft], d_h [n, towers ft]
// (tower t's term in columns t ft..: where the towers share h, their sum is
// d_h), d_kp [towers, (na ns + 1) ft, fo], d_bp [towers, fo], every entry
// written.  Two kernels on `stream`; returns the cudaError_t.
extern "C" int pna_scaled_posttrans_bwd(
    const float* z, const float* h, const float* w, const float* kp,
    const float* d_out, int n, int towers, int ft, int fo, int na, int ns,
    int h_width, int h_step, int rnd, int n_part, float* part, float* d_z,
    float* d_h, float* d_kp, float* d_bp, void* stream) {
  if (!sizes_ok(n, towers, ft, h_width, h_step) || n_part < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!(aligned(z) && aligned(h) && aligned(w) && aligned(kp) &&
        aligned(d_out) && aligned(part) && aligned(d_z) && aligned(d_h) &&
        aligned(d_kp) && aligned(d_bp))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int used = clamp_to_tiles(n_part, n);
  Args a{z,   h,   w,    kp,   nullptr, d_out, nullptr, d_z,    d_h,
         part, d_kp, d_bp, n, towers,  h_width, h_step, rnd, used};
  cudaError_t rc = cudaErrorInvalidValue;
  with_shape(ft, fo, na, ns, [&](auto sh) {
    using Sh = decltype(sh);
    if (static_cast<long long>(used) * towers > INT_MAX) return;
    rc = pna::launch_dynamic(scaled_posttrans_bwd_kernel<Sh>,
                             dim3(static_cast<unsigned>(used * towers)),
                             dim3(Sh::BWD_THREADS),
                             Sh::BWD_SMEM * sizeof(float), st, a);
    if (rc != cudaSuccess) return;
    constexpr int kMergeThreads = 256;
    const int entries = towers * Sh::P;
    scaled_posttrans_merge_kernel<Sh>
        <<<dim3((entries + kMergeThreads - 1) / kMergeThreads),
           kMergeThreads, 0, st>>>(a);
    rc = cudaGetLastError();
  });
  return static_cast<int>(rc);
}
