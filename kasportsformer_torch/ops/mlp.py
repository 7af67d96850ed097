"""LayerNorm-folded MLP tail (K3) and its plain PyTorch version.

`fused_mlp_ln(x, gamma, beta, w1, b1, w2, b2, ls2, eps)` computes the
FormerModule tail `x + ls2 * (GELU(LN(x) W1^T + b1) W2^T + b2)` over the last
axis, with float32 LayerNorm statistics and exact-erf GELU. Weights are in
the torch `nn.Linear` layout: `w1` (hidden, C), `w2` (C, hidden). It is the
port of `kasportsformer_tpu/ops/mlp.py:fused_mlp_ln` (Pallas kernel
`_mlp_ln_kernel`, plain formulation `_mlp_ln_xla`).

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/mlp_ln.cu` (float32 on the CUDA cores, bfloat16 on the tensor cores)
or raises; on a CPU tensor it runs `fused_mlp_ln_reference`. The kernel
masks the tail rows of a ragged M, so any number of rows works. It evaluates
GELU with erf in every dtype (the TPU kernel's bf16 path used the tanh form,
up to 4.8e-4 away).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kasportsformer_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_WIDTH = 128
_CHUNK = 64


def fused_mlp_ln_reference(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                           ls2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version, numerically `_mlp_ln_xla`: LN in float32, rounded to the
    input dtype, then fc1 -> exact GELU -> fc2 in the input dtype."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    a = ((xf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(dt)
    h = F.gelu(F.linear(a, w1.to(dt), b1.to(dt)))
    y = F.linear(h, w2.to(dt), b2.to(dt))
    return x + ls2.to(dt) * y


def _kernel() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.library("mlp_ln")
    fn = lib.kasf_mlp_ln
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(x, gamma, beta, w1, b1, w2, b2, ls2, eps) -> torch.Tensor:
    dt, dev = x.dtype, x.device
    if dev.type != "cuda":
        raise ValueError("mlp_ln kernel takes CUDA tensors")
    if dt not in _DTYPE_CODE:
        raise TypeError(f"mlp_ln kernel takes float32 or bfloat16, got {dt}")
    c = x.shape[-1]
    hidden = w1.shape[0]
    if (c != _WIDTH or tuple(w1.shape) != (hidden, c)
            or tuple(w2.shape) != (c, hidden) or hidden % _CHUNK):
        raise ValueError(f"mlp_ln kernel takes C={_WIDTH} and a hidden width "
                         f"that is a multiple of {_CHUNK}; got x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if any(t.numel() != c for t in (gamma, beta, b2, ls2)) or b1.numel() != hidden:
        raise ValueError("mlp_ln kernel: gamma, beta, b2, ls2 must have C "
                         "elements and b1 the hidden width")
    if any(t.device != dev for t in (gamma, beta, w1, b1, w2, b2, ls2)):
        raise ValueError("mlp_ln kernel takes all tensors on one CUDA device")

    def prep(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        # no copy for operands already in the dtype, dense and aligned
        return _build.aligned(t.to(dtype).contiguous())

    xc = prep(x.reshape(-1, c), dt)
    m = xc.shape[0]
    out = torch.empty_like(xc)
    if m == 0:
        return out.reshape(x.shape)
    # keep every converted operand alive until the launch has been queued
    ops = (xc, prep(gamma, torch.float32), prep(beta, torch.float32),
           prep(w1, dt), prep(b1, dt), prep(w2, dt), prep(b2, dt),
           prep(ls2, torch.float32))
    lib, fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_DTYPE_CODE[dt], *(t.data_ptr() for t in ops),
                  out.data_ptr(), m, c, hidden, float(eps), stream)
    _build.check(lib, code, "mlp_ln kernel launch")
    fused_mlp_ln.launches += 1
    return out.reshape(x.shape)


def fused_mlp_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, ls2: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """x + ls2 * MLP(LN(x)) over the last axis of x (..., C).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Pass ls2 = ones for a tail without LayerScale. `fused_mlp_ln.launches`
    counts kernel launches."""
    if x.device.type == "cpu":
        return fused_mlp_ln_reference(x, gamma, beta, w1, b1, w2, b2, ls2, eps)
    return _launch(x, gamma, beta, w1, b1, w2, b2, ls2, eps)


fused_mlp_ln.launches = 0
