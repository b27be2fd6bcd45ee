"""The PNA layer's first posttrans layer with its scaler contraction.

For tower t of T and node n, with the aggregator bank ``z`` [N, A, T*Ft],
the towers' input ``h`` ([N, T*Ft], tower t reading its Ft columns, or
[N, Ft] shared by every tower), the scaler weights ``w`` [S, N] and the
posttrans weights as the layer stores them, ``kp`` [T, (A*S + 1)*Ft, Fo]
(rows [0, Ft) the h part, row Ft + (s*A + a)*Ft + f aggregator a's column f
under scaler s) and ``bp`` [T, Fo]:

    y[n, t, :, s] = sum_{a, f} z[n, a, t*Ft + f] kp[t, Ft + (s*A + a)*Ft + f]
    out[n, t] = h_t[n] kp[t, :Ft] + sum_s w[s, n] y[n, t, :, s] + bp[t]

-> out [N, T, Fo] float32.

* ``scaled_posttrans_plain``: the function as the layer computed it before
  the kernel (the scaler axis folded into the output of one matmul with a
  block-diagonal weight [A*T*Ft, T*Fo*S], the S products contracted with
  ``w`` by an einsum), through autograd; every operand rounded to the
  compute dtype ``cdt`` and the products summed in float32.  The CPU and
  every shape the kernels are not built for take it.
* ``scaled_posttrans_fwd`` / ``scaled_posttrans_bwd``: the CUDA kernels
  (``pna_tpu_torch/csrc/scaled_posttrans.cu``; they replace no TPU kernel):
  one forward kernel, and a backward kernel that writes ``d_z``, ``d_h`` and
  per block a partial ``d_kp``, ``d_bp``, which a second kernel sums in block
  order (no atomics: two runs give the same bits).  With a bfloat16 ``cdt``
  they round where the plain version does.
* ``ScaledPosttrans``: the autograd function over the kernels (CUDA
  tensors only).  ``w`` takes no gradient (every caller derives it from the
  layout's degrees): the function raises if ``w`` requires one.
* ``scaled_posttrans``: the layer's entry: the function over the kernels on
  a CUDA tensor of a shape they are built for, else the plain version.

Launch counts: ``scaled_posttrans_fwd.launches``,
``scaled_posttrans_bwd.launches`` (``launch_counts()``), one each a layer's
forward and backward with nodes (nothing launches without them).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from pna_tpu_torch.ops import build


def round_to(x: torch.Tensor, cdt) -> torch.Tensor:
    """``x`` rounded to the compute dtype and widened back to float32: a
    matmul operand in ``cdt`` whose products are summed in float32."""
    if cdt == torch.float32:
        return x
    return x.to(cdt).to(torch.float32)


def tower_ein(x, k, cdt=torch.float32):
    """x [..., T, fi], k [T, fi, fo] -> [..., T, fo] float32 as one matmul
    with the block-diagonal weight, on operands rounded to ``cdt``."""
    T, fi, fo = k.shape
    kb = round_to(torch.block_diag(*k.unbind(0)), cdt)     # [T*fi, T*fo]
    lead = x.shape[:-2]
    return (round_to(x.reshape(lead + (T * fi,)), cdt) @ kb).reshape(
        lead + (T, fo))


def shared_ein(x, k, cdt=torch.float32):
    """x [..., fi] shared by every tower, k [T, fi, fo] -> [..., T, fo]
    float32, on operands rounded to ``cdt``."""
    T, fi, fo = k.shape
    kb = round_to(k.permute(1, 0, 2).reshape(fi, T * fo), cdt)
    return (round_to(x, cdt) @ kb).reshape(x.shape[:-1] + (T, fo))


def _shape(z, kp, w):
    """(N, A, T, Ft, Fo, S) of the inputs; raises where they disagree."""
    if z.ndim != 3 or kp.ndim != 3 or w.ndim != 2:
        raise ValueError(f"scaled_posttrans: z [N, A, T*Ft], kp [T, R, Fo] "
                         f"and w [S, N], got {tuple(z.shape)}, "
                         f"{tuple(kp.shape)}, {tuple(w.shape)}")
    n, a, tf = z.shape
    t, rows, fo = kp.shape
    s = w.shape[0]
    if tf % t or rows != (a * s + 1) * (tf // t) or w.shape[1] != n:
        raise ValueError(f"scaled_posttrans: z {tuple(z.shape)}, kp "
                         f"{tuple(kp.shape)} and w {tuple(w.shape)} do not "
                         "agree")
    return n, a, t, tf // t, fo, s


def scaled_posttrans_plain(z, h, w, kp, bp, shared=False,
                           cdt=torch.float32):
    """The plain version: out [N, T, Fo] float32, through autograd."""
    N, A, T, Ft, Fo, S = _shape(z, kp, w)
    k_h = kp[:, :Ft]                                    # [T, Ft, Fo]
    # rows of kp per tower: [0:Ft] = h part; Ft + s*A*Ft + a*Ft + f
    k_agg = kp[:, Ft:].reshape(T, S, A, Ft, Fo)
    if shared:
        out = shared_ein(h, k_h, cdt)
    else:
        out = tower_ein(h.reshape(N, T, Ft), k_h, cdt)
    eye = torch.eye(T, dtype=kp.dtype, device=kp.device)
    W = round_to(torch.einsum('tsafo,tu->atfuos', k_agg, eye).reshape(
        A * T * Ft, T * Fo * S), cdt)
    y = (round_to(z.reshape(N, A * T * Ft), cdt) @ W).reshape(N, T, Fo, S)
    return out + torch.einsum('ntos,sn->nto', round_to(y, cdt),
                              round_to(w, cdt)) + bp


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = build.load()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pna_scaled_posttrans_supported.argtypes = [i] * 4
    lib.pna_scaled_posttrans_supported.restype = i
    lib.pna_scaled_posttrans_grid.argtypes = [i] * 5 + [
        ctypes.POINTER(ctypes.c_int)] * 2
    lib.pna_scaled_posttrans_grid.restype = i
    # z, h, w, kp, bp, 9 sizes (n .. h_step), rnd, blocks, out, the stream
    lib.pna_scaled_posttrans_fwd.argtypes = [p] * 5 + [i] * 10 + [p, p]
    lib.pna_scaled_posttrans_fwd.restype = i
    # z, h, w, kp, d_out, 9 sizes, rnd, n_part, part, d_z, d_h, d_kp, d_bp,
    # the stream
    lib.pna_scaled_posttrans_bwd.argtypes = [p] * 5 + [i] * 10 + [p] * 6
    lib.pna_scaled_posttrans_bwd.restype = i
    return lib


def _ready(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels read."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=None)
def _built(Ft, Fo, A, S) -> bool:
    return bool(_lib().pna_scaled_posttrans_supported(Ft, Fo, A, S))


def kernel_supports(z, kp, w) -> bool:
    """Whether the kernels take these inputs: float32 CUDA tensors at widths
    (Ft, Fo, A, S) they are built for."""
    if not (z.is_cuda and z.dtype == kp.dtype == w.dtype == torch.float32):
        return False
    _, A, _, Ft, Fo, S = _shape(z, kp, w)
    return _built(Ft, Fo, A, S)


@functools.lru_cache(maxsize=None)
def _resident(T, Ft, Fo, A, S, device_index):
    """(forward, backward) blocks a tower: the blocks the card holds at
    once, shared by the towers; a launch cuts them to one a 128-node tile.
    Read once a shape and card (the occupancy query costs host time a step
    should not)."""
    lib = _lib()
    fwd, bwd = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        rc = lib.pna_scaled_posttrans_grid(T, Ft, Fo, A, S,
                                           ctypes.byref(fwd),
                                           ctypes.byref(bwd))
    build.check(lib, rc, 'scaled_posttrans')
    return fwd.value, bwd.value


def _on(dev):
    """The device context a launch on ``dev`` needs: none where ``dev`` is
    the current device already, as in a step."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _h_layout(h, N, T, Ft, shared):
    """(h_width, h_step) of the kernels' h argument."""
    want = (N, Ft) if shared else (N, T * Ft)
    if tuple(h.shape) != want:
        raise ValueError(f"scaled_posttrans: h must be {want}, got "
                         f"{tuple(h.shape)}")
    return (Ft, 0) if shared else (T * Ft, Ft)


def scaled_posttrans_fwd(z, h, w, kp, bp, shared=False, cdt=torch.float32):
    """The forward kernel: out [N, T, Fo] float32.  One call with nodes
    counts one launch; without nodes nothing launches."""
    N, A, T, Ft, Fo, S = _shape(z, kp, w)
    h_width, h_step = _h_layout(h, N, T, Ft, shared)
    dev = z.device
    out = torch.empty((N, T, Fo), dtype=torch.float32, device=dev)
    if N == 0:
        return out
    z, h, w, kp, bp = (_ready(x) for x in (z, h, w, kp, bp))
    lib = _lib()
    blocks = _resident(T, Ft, Fo, A, S, dev.index)[0]
    with _on(dev):
        rc = lib.pna_scaled_posttrans_fwd(
            z.data_ptr(), h.data_ptr(), w.data_ptr(), kp.data_ptr(),
            bp.data_ptr(), N, T, Ft, Fo, A, S, h_width, h_step,
            int(cdt != torch.float32), blocks, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, 'scaled_posttrans_fwd')
    scaled_posttrans_fwd.launches += 1
    return out


scaled_posttrans_fwd.launches = 0


def scaled_posttrans_bwd(z, h, w, kp, d_out, shared=False,
                         cdt=torch.float32):
    """The backward kernels: (d_z, d_h, d_kp, d_bp), the gradients of the
    forward's z, h, kp and bp (d_h not rounded to ``cdt``: that is the
    backward of the caller's cast of h).  One call with nodes counts one
    launch: the backward kernel and the merge of its partials; without
    nodes nothing launches."""
    N, A, T, Ft, Fo, S = _shape(z, kp, w)
    h_width, h_step = _h_layout(h, N, T, Ft, shared)
    dev = z.device
    if N == 0:
        return (torch.zeros_like(z), torch.zeros_like(h),
                torch.zeros_like(kp),
                torch.zeros((T, Fo), dtype=torch.float32, device=dev))
    z, h, w, kp, d_out = (_ready(x) for x in (z, h, w, kp, d_out))
    lib = _lib()
    n_part = _resident(T, Ft, Fo, A, S, dev.index)[1]
    P = A * S * Ft * Fo + Ft * Fo + Fo
    part = torch.empty((T, n_part, P), dtype=torch.float32, device=dev)
    d_z = torch.empty((N, A, T * Ft), dtype=torch.float32, device=dev)
    d_h = torch.empty((N, T * Ft), dtype=torch.float32, device=dev)
    d_kp = torch.empty(kp.shape, dtype=torch.float32, device=dev)
    d_bp = torch.empty((T, Fo), dtype=torch.float32, device=dev)
    with _on(dev):
        rc = lib.pna_scaled_posttrans_bwd(
            z.data_ptr(), h.data_ptr(), w.data_ptr(), kp.data_ptr(),
            d_out.data_ptr(), N, T, Ft, Fo, A, S, h_width, h_step,
            int(cdt != torch.float32), n_part, part.data_ptr(),
            d_z.data_ptr(), d_h.data_ptr(), d_kp.data_ptr(),
            d_bp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, 'scaled_posttrans_bwd')
    scaled_posttrans_bwd.launches += 1
    if shared:
        d_h = d_h.reshape(N, T, Ft).sum(1)
    return d_z, d_h, d_kp, d_bp


scaled_posttrans_bwd.launches = 0

KERNELS = (scaled_posttrans_fwd, scaled_posttrans_bwd)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


class ScaledPosttrans(torch.autograd.Function):
    """out [N, T, Fo] as a function of ``z``, ``h``, ``kp`` and ``bp``, by
    the kernels (CUDA tensors); ``w`` takes no gradient."""

    @staticmethod
    def forward(ctx, z, h, kp, bp, w, shared, cdt):
        if ctx.needs_input_grad[4]:
            raise ValueError("scaled_posttrans: w takes no gradient (the "
                             "scaler weights come from the degrees)")
        ctx.save_for_backward(z, h, kp, w)
        ctx.shared, ctx.cdt = shared, cdt
        return scaled_posttrans_fwd(z, h, w, kp, bp, shared, cdt)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out):
        z, h, kp, w = ctx.saved_tensors
        d_z, d_h, d_kp, d_bp = scaled_posttrans_bwd(
            z, h, w, kp, d_out, ctx.shared, ctx.cdt)
        return d_z, d_h, d_kp, d_bp, None, None, None


def scaled_posttrans(z, h, w, kp, bp, *, shared=False, cdt=torch.float32):
    """The layer's posttrans layer 0 with the scalers: z [N, A, T*Ft], h
    [N, T*Ft] (or [N, Ft] with ``shared``), w [S, N], kp, bp -> out
    [N, T, Fo] float32.  The kernels on a CUDA tensor of a shape they are
    built for (h rounded to ``cdt`` first, whose cast's backward rounds its
    gradient as the plain version's does), else the plain version."""
    if kernel_supports(z, kp, w):
        if cdt != torch.float32 or h.dtype != torch.float32:
            h = round_to(h, cdt).float()
        return ScaledPosttrans.apply(z, h, kp, bp, w, shared, cdt)
    return scaled_posttrans_plain(z, h, w, kp, bp, shared, cdt)
