"""The GAT attention kernels' CUDA source, compiled for the host and run on
the CPU against their plain versions.

``pna_tpu_torch/csrc/csr_gat_attend.cu`` is compiled with g++
(-DPNA_HOST_CHECK) against the stub ``cuda_runtime.h`` of
``tests/test_torch_csrc_host.py``: a block is one warp of 32 OS threads, a
warp's shuffle goes through a static buffer between two barriers, and
blocks run one after another.  What it can show is the indexing: lane
slots of heads of any width (5, 8, 40, 121), the receiver ranges with the
self term, the segments of the senders' sort, a hub split into slots and
merged in runs of several slots, ghost sender rows past N, every output row
written.  The host's ``expf`` is not the card's, so values are held to the
plain versions within 2e-6 of their scale, not bit for bit (the card's
tests hold them bit for bit).  Skips where there is no g++."""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch

from pna_tpu_torch.ops import build
from pna_tpu_torch.ops import csr_gat as cg
from tests.test_torch_csrc_host import GLOBALS, STUB, _for_host
from tests.test_torch_gat_kernels import attention_case


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels' sources for the host")
    tmp = tmp_path_factory.mktemp("gat_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    (tmp / "stub_globals.cpp").write_text(GLOBALS)
    with open(os.path.join(build.CSRC_DIR, "csr_gat_attend.cu")) as f:
        (tmp / "csr_gat_attend.cpp").write_text(_for_host(f.read()))
    so = tmp / "libgat.so"
    out = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fPIC", "-shared", "-pthread",
         "-DPNA_HOST_CHECK", f"-I{tmp}", "stub_globals.cpp",
         "csr_gat_attend.cpp", "-o", str(so)],
        cwd=tmp, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pna_gat_attend_fwd.argtypes = [p] * 5 + [i] * 5 + [p] * 4
    lib.pna_gat_attend_bwd.argtypes = ([p] * 18 + [i] * 2 + [p] * 10
                                       + [i] * 5 + [p])
    return lib


def _nan(*shape):
    return torch.full(shape, float("nan"))


def _host_fwd(lib, hw, s_src, s_dst, lay):
    n, heads = s_dst.shape
    f = hw.shape[1] // heads
    out, m, l = _nan(n, heads * f), _nan(n, heads), _nan(n, heads)
    rc = lib.pna_gat_attend_fwd(
        hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
        lay.senders.data_ptr(), lay.ptr.data_ptr(), n, lay.n_table,
        lay.n_edges, heads, f, out.data_ptr(), m.data_ptr(), l.data_ptr(),
        None)
    assert rc == 0
    return out, m, l


def _host_bwd(lib, hw, s_src, s_dst, out, m, l, a_src, a_dst, d_out, lay):
    n, heads = s_dst.shape
    nt, e = lay.n_table, lay.n_edges
    f = hw.shape[1] // heads
    scratch = [_nan(n, heads), _nan(e, heads), _nan(n, heads),
               _nan(lay.n_slots, heads * f),
               _nan(lay.n_slots, heads),
               _nan(lay.n_split * cg.RUNS, heads * f),
               _nan(lay.n_split * cg.RUNS, heads)]
    res = [_nan(nt, heads * f), _nan(nt, heads), _nan(n, heads)]
    rc = lib.pna_gat_attend_bwd(
        hw.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(), out.data_ptr(),
        m.data_ptr(), l.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(),
        d_out.data_ptr(), lay.ptr.data_ptr(), lay.sperm.data_ptr(), lay.srows.data_ptr(), lay.seg_lo.data_ptr(),
        lay.seg_hi.data_ptr(), lay.seg_node.data_ptr(),
        lay.seg_slot.data_ptr(), lay.split_node.data_ptr(),
        lay.split_slot.data_ptr(), lay.n_seg, lay.n_split,
        *[x.data_ptr() for x in scratch], *[x.data_ptr() for x in res],
        n, nt, e, heads, f, None)
    assert rc == 0
    return res


def _close(got, want):
    assert not torch.isnan(got).any()
    scale = want.abs().max().clamp(min=1.0)
    assert (got - want).abs().max() <= 2e-6 * scale


@pytest.mark.parametrize("heads,f,seg", [(4, 8, 128), (4, 8, 3), (6, 5, 3),
                                         (2, 40, 8), (3, 121, 16),
                                         (4, 8, 2), (4, 8, 1024)])
def test_host_attend_matches_plain(lib, heads, f, seg):
    """Forward and backward at the layout of ``attention_case`` (a hub of
    ~40% of the edges, a node with no in-edges, 4 ghost rows), with the
    senders cut in segments of ``seg``: at 3 the hub's slots outnumber
    the merge's runs, so runs hold several slots; at 2 split senders are
    receivers with in-edges (their d_s_dst and a_dst term formed by the
    merge) and ghost rows; at 1024 no sender is split, and the merge's last
    kernel runs the post-pass alone."""
    c = attention_case(heads, f, seg=seg)
    lay = c['lay']
    if seg == 3:
        assert int(lay.split_slot.diff().max()) > cg.RUNS
    split = lay.split_node.long()
    if seg == 2:
        local = split[split < c['n']]
        assert int((lay.ptr[local + 1] - lay.ptr[local] > 0).sum()) > 1
        assert int(split.max()) >= c['n']
    if seg == 1024:
        assert lay.n_split == 0
    out, m, l = _host_fwd(lib, c['hw'], c['s_src'], c['s_dst'], lay)
    want = cg.csr_gat_attend_plain(c['hw'], c['s_src'], c['s_dst'], lay)
    for got, w in zip((out, m, l), want):
        _close(got, w)
    d_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    got = _host_bwd(lib, c['hw'], c['s_src'], c['s_dst'], *want, c['a_src'],
                    c['a_dst'], d_out, lay)
    ref = cg.csr_gat_attend_bwd_plain(c['hw'], c['s_src'], c['s_dst'], *want,
                                      c['a_src'], c['a_dst'], d_out, lay)
    for g, w in zip(got, ref):
        _close(g, w)
