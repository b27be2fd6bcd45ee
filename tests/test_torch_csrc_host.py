"""K1 and K2's CUDA sources, compiled for the host and run on the CPU.

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
rows exactly 0.  What this cannot show (that nvcc accepts the sources, the
real cp.async, times) is left to tests/test_torch_cuda.py and chip_smoke.py
on a card.  Skips where there is no g++."""

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
template <typename T> inline T __ldcs(const T* p) { return *p; }
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
        if name in ("csr_moment_sketch.cu", "csr_dmsg.cu"):
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
