"""K1, K2 and the row sum's CUDA sources, compiled for the host and run on
the CPU.

There is no nvcc and no card where these tests run, but most of what can go
wrong in pna_tpu_torch/csrc/csr_moment_sketch.cu and csr_dmsg.cu is indexing:
tiles, spans, the shift of a staged span, the flat (segment, feature) walk,
continued segments, partial slots, the merge.  So the sources are compiled
with g++ (-DPNA_HOST_CHECK) against a stub ``cuda_runtime.h`` that runs each
block's threads as OS threads with a barrier for ``__syncthreads`` (blocks one
after another, so a ``__shared__`` array is a static one), with ``cp.async`` as
a plain copy, and with a card of 2 SMs so that every block walks several
tiles.  The C entry points are then called on CPU tensors and held to the
plain PyTorch versions: max, min and tie counts equal, sums within 1e-5 of
the summed magnitudes (another order), d_msg rtol 1e-5 / atol 1e-6 with pad
rows exactly 0.  The row sum (``csrc/sorted_row_sum.cu``) must equal its
plain version bit for bit: the plain version repeats its order of addition
and the CPU's ``index_add_`` adds in index order.  For the row sum the stub
also has an int ``atomicAdd``, ``__threadfence`` and ``__ldcg``; since
blocks run one after another, the last block to arrive at a hub's counter is
the last in order.  What this cannot show (that nvcc accepts the sources,
the real cp.async, times) is left to tests/test_torch_cuda.py and
chip_smoke.py on a card.  Skips where there is no g++."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pna_tpu_torch.ops import build
from pna_tpu_torch.ops import csr_fused_kernels as fk
from pna_tpu_torch.ops import csr_kernels as ck
from pna_tpu_torch.ops import rowsum
from tests.test_torch_cuda import CASES, layout_case, sketch_case

STUB = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <pthread.h>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };

namespace pna_stub {
extern thread_local dim3 tid, bid;
extern dim3 bdim, gdim;
extern pthread_barrier_t barrier;
extern void* dyn_smem;
}
#define threadIdx pna_stub::tid
#define blockIdx pna_stub::bid
#define blockDim pna_stub::bdim
#define gridDim pna_stub::gdim

using std::max;
using std::min;
inline void __syncthreads() { pthread_barrier_wait(&pna_stub::barrier); }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(unsigned u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  memcpy(&u, &f, 4);
  return u;
}
template <typename T> inline T __ldcs(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
template <typename T> inline void __stcs(T* p, T v) { *p = v; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "stub"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  *v = 2;   // a card of 2 SMs: blocks walk several tiles
  return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) { *n = 2; return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return cudaSuccess;
}

namespace pna_stub {
template <typename K, typename... A>
void launch(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
            A... args) {
  bdim = block;
  gdim = grid;
  // poisoned, so that a read of shared memory nobody wrote shows
  std::vector<float> mem(smem / 4 + 8, std::nanf(""));
  dyn_smem = reinterpret_cast<void*>(
      (reinterpret_cast<uintptr_t>(mem.data()) + 15) & ~uintptr_t(15));
  for (unsigned by = 0; by < grid.y; ++by) {
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      pthread_barrier_init(&barrier, nullptr, block.x);
      std::vector<std::thread> threads;
      for (unsigned t = 0; t < block.x; ++t) {
        threads.emplace_back([=] {
          tid = dim3(t);
          bid = dim3(bx, by);
          kernel(args...);
        });
      }
      for (auto& th : threads) th.join();
      pthread_barrier_destroy(&barrier);
    }
  }
}
}
"""

GLOBALS = r"""
#include <cuda_runtime.h>
namespace pna_stub {
thread_local dim3 tid, bid;
dim3 bdim, gdim;
pthread_barrier_t barrier;
void* dyn_smem;
}
"""


def _for_host(src: str) -> str:
    """kernel<<<grid, block, smem, stream>>>(args) -> a call of the stub's
    launcher; the dynamic shared array -> the stub's buffer."""
    src = re.sub(r"([\w:]+(?:<\w+>)?)\s*<<<(.*?)>>>\(",
                 r"pna_stub::launch(\1, \2, ", src, flags=re.S)
    return re.sub(r"extern __shared__ float4 (\w+)\[\];",
                  r"float4* \1 = static_cast<float4*>(pna_stub::dyn_smem);",
                  src)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the host")
    tmp = tmp_path_factory.mktemp("csrc_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "stub_globals.cu.cpp").write_text(GLOBALS)
    units = ["stub_globals.cu.cpp"]
    for name in os.listdir(build.CSRC_DIR):
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            text = _for_host(f.read())
        if name in ("csr_moment_sketch.cu", "csr_dmsg.cu",
                    "sorted_row_sum.cu"):
            name += ".cpp"
            units.append(name)
        (tmp / name).write_text(text)
    so = tmp / "libhost.so"
    out = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
         "-DPNA_HOST_CHECK", f"-I{tmp}", *units, "-o", str(so)],
        cwd=tmp, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pna_csr_moment_sketch.argtypes = [p] * 6 + [i] * 6 + [p] * 7 + [i, p]
    lib.pna_csr_dmsg.argtypes = [p] * 8 + [i] * 3 + [p, p]
    lib.pna_sorted_row_sum.argtypes = [p, i, p, p, i, p, i, i, i, p, i, p,
                                       p]
    return lib


def _sketch(lib, msg, segs, with_ties):
    n, f = segs.n_nodes, msg.shape[1]
    outs = torch.full((6 if with_ties else 4, n, f), float("nan"))
    part = torch.full((max(segs.n_part, 1), 6, f), float("nan"))
    ptrs = [o.data_ptr() for o in outs] + [None] * (6 - len(outs))
    rc = lib.pna_csr_moment_sketch(
        msg.data_ptr(), segs.seg_ptr.data_ptr(), ck._at(segs.seg_node),
        ck._at(segs.seg_slot), ck._at(segs.split_node),
        ck._at(segs.split_ptr), segs.n_seg, segs.n_split, segs.n_part, n,
        msg.shape[0], f, *ptrs, part.data_ptr(),
        int(with_ties), None)
    assert rc == 0
    return tuple(outs.unbind(0))


def _hold_sketch(got, want, msg, ptr):
    scale = ck.csr_moment_sketch_plain(msg.abs(), ptr)[0]
    assert torch.all((got[0] - want[0]).abs() <= 1e-5 * scale + 1e-6)
    assert torch.all((got[1] - want[1]).abs() <= 1e-5 * want[1] + 1e-6)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)


def _dmsg(lib, msg, segs, fields):
    out = torch.full_like(msg, float("nan"))
    rn = segs.row_node(msg.shape[0])
    rc = lib.pna_csr_dmsg(msg.data_ptr(), rn.data_ptr(),
                          *[x.data_ptr() for x in fields], segs.n_nodes,
                          msg.shape[0], msg.shape[1], out.data_ptr(), None)
    assert rc == 0
    return out


def _fields(got6, seed):
    gen = torch.Generator().manual_seed(seed)
    fields = [torch.randn(got6[0].shape, generator=gen) for _ in range(4)]
    fields[2] /= got6[4]
    fields[3] /= got6[5]
    return fields + [got6[2], got6[3]]


@pytest.mark.parametrize("case", CASES)
def test_host_kernels_match_plain_on_the_layout_cases(lib, case):
    """The layout cases of the card tests (empty nodes, N > 128, a hub,
    clamped pointers with pad rows), with the cut table and with the row
    pointers as the table (the hub then is one segment of many spans)."""
    msg, ptr = (torch.from_numpy(x) for x in layout_case(case))
    n = ptr.numel() - 1
    whole = ck.CSRSegments(seg_ptr=ptr, n_seg=n, n_nodes=n)
    for segs in (ck.csr_segments(ptr), whole):
        for with_ties in (False, True):
            got = _sketch(lib, msg, segs, with_ties)
            _hold_sketch(got, ck.csr_moment_sketch_plain(msg, ptr, with_ties),
                         msg, ptr)
        fields = _fields(got, 1)
        d = _dmsg(lib, msg, segs, fields)
        want = ck.csr_dmsg_plain(msg, ptr, *fields)
        torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-6)
        assert torch.all(d[int(ptr[-1]):] == 0)


@pytest.mark.parametrize("f", [1, 33, 70, 75, 128, 300])
def test_host_kernels_at_every_width(lib, f):
    """Whole and split nodes, ties across segment cuts, pad rows, at widths
    whose rows start on every alignment: 4-byte (75, 33, 1), 8-byte (70),
    16-byte (128, 300); msg itself starts 4 bytes off a 16-byte boundary."""
    msg, ptr, tie_node = sketch_case(f)
    msg, ptr = torch.from_numpy(msg), torch.from_numpy(ptr)
    off = torch.empty(msg.numel() + 1)[1:].view(msg.shape)
    off.copy_(msg)
    assert off.data_ptr() % 16 == 4          # not 16-byte aligned
    segs = ck.csr_segments(ptr)
    assert segs.n_split == 4
    for m in (msg, off):
        for with_ties in (False, True):
            got = _sketch(lib, m, segs, with_ties)
            _hold_sketch(got, ck.csr_moment_sketch_plain(m, ptr, with_ties),
                         m, ptr)
        assert torch.all(got[4][tie_node] == 2)
        assert torch.all(got[5][tie_node] == 2)
        fields = _fields(got, f)
        d = _dmsg(lib, m, segs, fields)
        want = ck.csr_dmsg_plain(m, ptr, *fields)
        torch.testing.assert_close(d, want, rtol=1e-5, atol=1e-6)
        assert torch.all(d[int(ptr[-1]):] == 0)
        assert torch.all(d[:int(ptr[0])] == 0)


def test_host_sketch_partials_are_the_segment_sketches(lib):
    """Before the merge, K1 on a table without split bookkeeping (every
    segment its own 'node') gives the per-segment sketches; merged by
    merge_segment_sketches_plain they are the node sketches."""
    msg, ptr, _ = sketch_case(12)
    msg, ptr = torch.from_numpy(msg), torch.from_numpy(ptr)
    segs = ck.csr_segments(ptr)
    per_seg = ck.CSRSegments(seg_ptr=segs.seg_ptr, n_seg=segs.n_seg,
                             n_nodes=segs.n_seg)
    parts = _sketch(lib, msg, per_seg, True)
    want_parts = ck.csr_moment_sketch_plain(msg, segs.seg_ptr, True)
    for g, w in zip(parts[2:], want_parts[2:]):
        assert torch.equal(g, w)
    got = fk.merge_segment_sketches_plain(parts, segs)
    _hold_sketch(got, ck.csr_moment_sketch_plain(msg, ptr, True), msg, ptr)


def test_host_sketch_wide_rows_take_several_spans_a_segment(lib):
    """At F = 3,000 a staging buffer holds 4 rows, so every segment of more
    edges is continued over spans; F = 12,288 still fits one row."""
    rng = np.random.RandomState(0)
    deg = np.array([0, 5, 1, 9, 0, 4, 33])
    ptr = torch.from_numpy(
        np.concatenate([[0], np.cumsum(deg)]).astype(np.int32))
    msg = torch.from_numpy(
        rng.randint(-3, 4, (int(ptr[-1]) + 2, 3000)).astype(np.float32))
    for segs in (ck.csr_segments(ptr), None):
        if segs is None:
            n = ptr.numel() - 1
            segs = ck.CSRSegments(seg_ptr=ptr, n_seg=n, n_nodes=n)
        got = _sketch(lib, msg, segs, True)
        for g, w in zip(got, ck.csr_moment_sketch_plain(msg, ptr, True)):
            assert torch.equal(g, w)       # small integers: exact sums too
    wide = torch.from_numpy(rng.randn(3, 12288).astype(np.float32))
    p = torch.tensor([0, 2, 3], dtype=torch.int32)
    got = _sketch(lib, wide, ck.csr_segments(p), False)
    _hold_sketch(got, ck.csr_moment_sketch_plain(wide, p), wide, p)


def test_host_dmsg_nan_in_pad_rows_does_not_leak(lib):
    msg, ptr = (torch.from_numpy(x) for x in layout_case("clamped"))
    msg = msg.clone()
    msg[-1] = float("nan")
    n = ptr.numel() - 1
    segs = ck.CSRSegments(seg_ptr=ptr, n_seg=n, n_nodes=n)
    got = _sketch(lib, msg, segs, True)
    d = _dmsg(lib, msg, segs, _fields(got, 3))
    assert torch.all(d[int(ptr[-1]):] == 0)
    assert bool(torch.isfinite(d).all())


def _row_sum(lib, src, perm, ptr, keys, out_dtype):
    n, e, f = ptr.numel() - 1, src.shape[0], src.shape[1]
    out = torch.full((n, f), float("nan"), dtype=out_dtype)
    tiles = max(1, -(-e // rowsum.TILE))
    part = torch.full((tiles * (2 * f + 5 + -(-f // rowsum.FEAT)),),
                      float("nan"))
    rc = lib.pna_sorted_row_sum(
        src.data_ptr(), int(src.dtype == torch.bfloat16), ck._at(perm),
        keys.data_ptr(), int(keys.dtype == torch.int64),
        ptr.data_ptr(), e, n, f, out.data_ptr(),
        int(out_dtype == torch.bfloat16), part.data_ptr(), None)
    assert rc == 0
    return out


# name -> (rows, nodes, features, index kind)
ROW_SUM_CASES = {
    "hub_over_34_tiles": (8800, 40, 8, "hub"),       # merge runs of 2
    "empty_rows": (600, 500, 70, "unsorted"),        # more rows than edges
    "sorted_perm_none": (1000, 60, 1, "sorted"),
    "two_feature_blocks": (900, 50, 130, "unsorted"),  # strips of 32 and 1
    "ids_out_of_range": (700, 30, 12, "out_of_range"),
    "no_rows": (0, 20, 5, "unsorted"),
    "width_1": (1500, 300, 1, "unsorted"),           # 32 rows a warp
    "width_2": (1200, 200, 2, "unsorted"),           # 16 rows a warp
    "width_50": (1100, 150, 50, "unsorted"),         # 25 lanes, 2 features
    "width_64_hub": (2600, 90, 64, "hub"),           # 2 rows a warp, 10 tiles
    "width_70": (1000, 120, 70, "sorted"),           # 35 lanes of 2
    "gaps": (1300, 400, 3, "gaps"),   # empty before, after and in between
    "padded_tail": (1200, 80, 6, "padded"),          # keys past ptr[N]
}


def _row_sum_index(kind, rng, e, n):
    """The index of one case, and the row pointers to use where they are
    not the layout's (the padded tail)."""
    idx = rng.randint(0, n, e)
    if kind == "hub":
        idx[rng.rand(e) < 0.95] = 7
    elif kind == "sorted":
        idx = np.sort(idx)
    elif kind == "out_of_range":
        idx[::5] = n + 3
    elif kind == "gaps":            # rows 0-39, 60-299 and 320-399 empty
        idx = np.where(rng.rand(e) < 0.5, rng.randint(40, 60, e),
                       rng.randint(300, 320, e))
    elif kind == "padded":          # a partition's part: sorted real edges,
        real = e * 4 // 5           # then padding with id 0 past ptr[N]
        idx = np.concatenate([np.sort(idx[:real]), np.zeros(e - real, int)])
        return idx, torch.from_numpy(np.searchsorted(
            idx[:real], np.arange(n + 1)).astype(np.int32))
    return idx, None


@pytest.mark.parametrize("case", list(ROW_SUM_CASES))
def test_host_row_sum_equals_plain(lib, case):
    """Every output row written (the output starts as NaN), float32 and
    bfloat16 in, float32 and bfloat16 out, rows that start on the vector
    width and rows that start 4 bytes off (the scalar loads), with the
    layout's int32 keys and with int64 keys (the index itself where it is
    sorted): the kernel's bits are the plain version's.  The widths take
    every lane layout (F = 1, 2: 32 and 16 rows a warp; 64: 2; 50, 70: one
    row of 2-feature lanes; 130: a block of 128 and one of 2), hubs span
    tiles, empty rows lie before the first key, after the last and in long
    gaps, and a sorted index with padding past ptr[N] (a partition's part)
    keeps its padding out."""
    e, n, f, kind = ROW_SUM_CASES[case]
    rng = np.random.RandomState(sorted(ROW_SUM_CASES).index(case))
    idx, ptr = _row_sum_index(kind, rng, e, n)
    src = torch.from_numpy(rng.randn(e, f).astype(np.float32) * 100)
    lay = rowsum.index_layout(torch.from_numpy(idx), n)
    if kind in ("sorted", "padded"):
        perm, keys = None, torch.from_numpy(idx)
        ptr = lay.ptr if ptr is None else ptr
    else:
        perm, keys, ptr = lay.perm, lay.keys, lay.ptr
    if kind == "gaps":
        deg = torch.diff(ptr)
        assert deg[:40].sum() == deg[60:300].sum() == deg[320:].sum() == 0
    off = torch.empty(src.numel() + 1)[1:].view(src.shape)
    off.copy_(src)
    runs = [(x, sd, od, keys.int()) for x in (src, off)
            for sd, od in ((torch.float32, torch.float32),
                           (torch.bfloat16, torch.bfloat16),
                           (torch.bfloat16, torch.float32))]
    runs += [(x, torch.float32, torch.float32, keys.long())
             for x in (src, off)]
    for x, sd, od, k in runs:
        xs = x if sd == torch.float32 else x.to(sd)
        got = _row_sum(lib, xs, perm, ptr, k, od)
        want = rowsum.sorted_row_sum_plain(xs, perm, ptr, od)
        assert torch.equal(got, want), (sd, od, k.dtype)


def test_host_row_sum_refuses_no_keys(lib):
    """The kernel reads each position's row from the keys: a call with rows
    and no keys is refused before any launch, and the output is left as it
    was."""
    src = torch.ones(40, 3)
    lay = rowsum.index_layout(torch.arange(40) % 7, 7)
    out = torch.full((7, 3), float("nan"))
    part = torch.full((1 * (2 * 3 + 5 + 1),), float("nan"))
    rc = lib.pna_sorted_row_sum(
        src.data_ptr(), 0, lay.perm.data_ptr(), None, 0, lay.ptr.data_ptr(),
        40, 7, 3, out.data_ptr(), 0, part.data_ptr(), None)
    assert rc != 0
    assert bool(torch.isnan(out).all())
