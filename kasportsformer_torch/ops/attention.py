"""Per-head masked attention core (K1) and its plain PyTorch version.

`masked_sdpa(q, k, v, scale, num_heads)` computes, for every (B, G) of
(B, G, N, C) inputs and every head h of width D = C / num_heads,
`softmax(q_h k_h^T * scale) v_h` over the N axis. It is the port of
`kasportsformer_tpu/ops/attention.py:masked_sdpa` (Pallas kernel
`_attn_kernel`, plain formulation `masked_sdpa_xla`).

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/masked_sdpa.cu` or raises; on a CPU tensor it runs
`masked_sdpa_reference`. The kernel subtracts the exact per-head max of the
logits, so no head can underflow to 0/0: the JAX package's NaN guards
(`nan_guarded`, `guard_scope`, the stable re-run) have nothing to guard here
and are not ported.
"""

from __future__ import annotations

import ctypes

import torch

from kasportsformer_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 16  # the only width built: the flagship's 128 channels / 8 heads
_MAX_N = 32


def masked_sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, num_heads: int) -> torch.Tensor:
    """Plain per-head softmax attention on (..., N, C) inputs, numerically
    `masked_sdpa_xla`: logits in the input dtype, softmax in float32, the
    probabilities rounded back to the input dtype before the value product."""
    c = q.shape[-1]
    d = c // num_heads

    def heads(z: torch.Tensor) -> torch.Tensor:  # (..., N, C) -> (..., H, N, D)
        return z.unflatten(-1, (num_heads, d)).transpose(-3, -2)

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, heads(v)).transpose(-3, -2).flatten(-2)


def _kernel() -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    lib = _build.library("masked_sdpa")
    fn = lib.kasf_masked_sdpa
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            num_heads: int) -> torch.Tensor:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"masked_sdpa kernel takes equal (B, G, N, C) q/k/v, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("masked_sdpa kernel takes q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"masked_sdpa kernel takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, g, n, c = q.shape
    if c != _HEAD_DIM * num_heads:
        raise ValueError(f"masked_sdpa kernel takes heads of width "
                         f"{_HEAD_DIM}, got C={c} over {num_heads} heads")
    if n > _MAX_N or num_heads * n > 1024:
        raise ValueError(f"masked_sdpa kernel takes N <= {_MAX_N}, got {n}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("masked_sdpa kernel needs channel stride 1")
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    out = torch.empty((b, g, n, c), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _kernel()
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), strides, b, g, n, c,
                  num_heads, float(scale), stream)
    _build.check(lib, code, "masked_sdpa kernel launch")
    masked_sdpa.launches += 1
    return out


def masked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, num_heads: int) -> torch.Tensor:
    """Per-head attention over N of (B, G, N, C) q/k/v -> (B, G, N, C).

    CPU tensors take the plain version; CUDA tensors launch the kernel, which
    accepts strided views (channel stride 1; an operand whose rows are not
    16-byte aligned is copied first) and returns a contiguous output.
    `masked_sdpa.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return masked_sdpa_reference(q, k, v, scale, num_heads)
    return _launch(q, k, v, scale, num_heads)


masked_sdpa.launches = 0
