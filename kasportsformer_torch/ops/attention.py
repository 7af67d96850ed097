"""Per-head masked attention core: forward (K1), backward (K2), autograd,
and their plain PyTorch versions.

`masked_sdpa(q, k, v, scale, num_heads)` computes, for every (B, G) of
(B, G, N, C) inputs (a flat (M, N, C) token stream enters as the view
(1, M, N, C)) and every head h of width D = C / num_heads,
`softmax(q_h k_h^T * scale) v_h` over the N axis. It is the port of
`kasportsformer_tpu/ops/attention.py:masked_sdpa` (Pallas kernel
`_attn_kernel`, plain formulation `masked_sdpa_xla`).

On a CUDA tensor the wrapper runs `MaskedSdpaFunction`, an autograd
Function whose forward launches the hand-written kernel K1
(`csrc/masked_sdpa.cu`) and whose backward launches K2
(`csrc/masked_sdpa_bwd.cu`, the port of `_attn_bwd_kernel` behind the JAX
VJP `_masked_sdpa_bwd`); an input it cannot take raises. On a CPU tensor it
runs `masked_sdpa_reference` under plain autograd. Both kernels subtract the
exact per-head max of the logits, so no head can underflow to 0/0: the JAX
package's NaN guards (`nan_guarded`, `guard_scope`, the stable re-run, and
the train step's `guarded_grads_fn`) have nothing to guard here and are not
ported.
"""

from __future__ import annotations

import ctypes

import torch

from kasportsformer_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# (head widths, largest C, largest N) each kernel takes, as its launcher
# checks them: K1 and K2 the flagship's 16 and the zoo's 8 (MotionAGFormer-XS
# and hierarchical), 32 (DSTFormer) and 64 (MixSTE), any number of heads up
# to C = 512, N up to their 32-row stage
LIMITS = {"masked_sdpa": ((8, 16, 32, 64), 512, 32),
          "masked_sdpa_bwd": ((8, 16, 32, 64), 512, 32)}


def masked_sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, num_heads: int) -> torch.Tensor:
    """Plain per-head softmax attention on (..., N, C) inputs, numerically
    `masked_sdpa_xla`: logits in the input dtype, softmax in float32 (float64
    for float64 inputs), the probabilities rounded back to the input dtype
    before the value product."""
    c = q.shape[-1]
    d = c // num_heads

    def heads(z: torch.Tensor) -> torch.Tensor:  # (..., N, C) -> (..., H, N, D)
        return z.unflatten(-1, (num_heads, d)).transpose(-3, -2)

    logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    probs = torch.softmax(logits.to(torch.promote_types(q.dtype, torch.float32)),
                          dim=-1).to(q.dtype)
    return torch.matmul(probs, heads(v)).transpose(-3, -2).flatten(-2)


def masked_sdpa_bwd_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, g: torch.Tensor, scale: float,
                              num_heads: int
                              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward of `masked_sdpa_reference` on (..., N, C) inputs and
    output gradient g, in the closed form of K2 (and of the JAX kernel
    `_attn_bwd_kernel`): P recomputed with a float32 softmax,
    dV = P^T g, dP = g V^T, dS = P (dP - rowsum(P dP)) scale, dq = dS K,
    dk = dS^T q per head. Every product is formed in float32 (float64 for
    float64 inputs) from the inputs widened; P (for dV only) and dS are
    rounded to the input dtype before their products and the three results
    once at the end, where `_attn_bwd_kernel` rounds them
    (`preferred_element_type=f32` products of bf16 operands). Returns
    (dq, dk, dv)."""
    c = q.shape[-1]
    d = c // num_heads
    dt = q.dtype
    ct = torch.promote_types(dt, torch.float32)

    def heads(z: torch.Tensor) -> torch.Tensor:  # (..., N, C) -> (..., H, N, D), widened
        return z.to(dt).to(ct).unflatten(-1, (num_heads, d)).transpose(-3, -2)

    def merge(z: torch.Tensor) -> torch.Tensor:  # (..., H, N, D) -> (..., N, C), rounded
        return z.transpose(-3, -2).flatten(-2).to(dt)

    def rounded(z: torch.Tensor) -> torch.Tensor:  # to the input dtype and back
        return z.to(dt).to(ct)

    qh, kh, vh, gh = (heads(z) for z in (q, k, v, g))
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    dprobs = torch.matmul(gh, vh.transpose(-1, -2))
    ds = rounded(probs * (dprobs - (probs * dprobs).sum(-1, keepdim=True)) * scale)
    dv = torch.matmul(rounded(probs).transpose(-1, -2), gh)
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    return merge(dq), merge(dk), merge(dv)


def _fn(name: str, n_ptrs: int) -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    return _build.bind(name, f"kasf_{name}",
                       [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])


def _check_operands(what: str, num_heads: int, *ts: torch.Tensor) -> None:
    q = ts[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what} kernel takes equal (B, G, N, C) operands, "
                         f"got {[tuple(t.shape) for t in ts]}")
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{what} kernel takes its operands on one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what} kernel takes float32 or bfloat16, got "
                        f"{[t.dtype for t in ts]}")
    n, c = q.shape[2], q.shape[3]
    widths, max_c, max_n = LIMITS[what]
    if c % num_heads or c // num_heads not in widths or c > max_c:
        raise ValueError(f"{what} kernel takes heads of width {widths} and "
                         f"C <= {max_c}, got C={c} over {num_heads} heads")
    if n > max_n:
        raise ValueError(f"{what} kernel takes N <= {max_n}, got N={n}")
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError(f"{what} kernel needs channel stride 1")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            num_heads: int) -> torch.Tensor:
    """K1 on operands `_check_operands` accepted and `_build.aligned` made."""
    b, g, n, c = q.shape
    out = torch.empty((b, g, n, c), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib, fn = _fn("masked_sdpa", 4)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *out.stride())
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), strides, b, g, n, c,
                  num_heads, float(scale), _stream(q.device))
    _build.check(lib, code, "masked_sdpa kernel launch")
    masked_sdpa.launches += 1
    return out


def masked_sdpa_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, scale: float, num_heads: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2: (dq, dk, dv) of `masked_sdpa` at (q, k, v) for the output
    gradient g, all (B, G, N, C) CUDA tensors of one dtype (strided views
    with channel stride 1 are read in place; a gradient of another layout is
    made contiguous). The results are contiguous. `masked_sdpa_bwd.launches`
    counts kernel launches."""
    if g.stride(-1) != 1:  # e.g. the expanded gradient of a sum
        g = g.contiguous()
    _check_operands("masked_sdpa_bwd", num_heads, q, k, v, g)
    q, k, v, g = (_build.aligned(t) for t in (q, k, v, g))
    b, gg, n, c = q.shape
    dq, dk, dv = (torch.empty((b, gg, n, c), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    if dq.numel() == 0:
        return dq, dk, dv
    lib, fn = _fn("masked_sdpa_bwd", 7)
    strides = (ctypes.c_longlong * 16)(
        *q.stride(), *k.stride(), *v.stride(), *g.stride())
    with torch.cuda.device(q.device):
        code = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), strides, b, gg, n, c, num_heads,
                  float(scale), _stream(q.device))
    _build.check(lib, code, "masked_sdpa_bwd kernel launch")
    masked_sdpa_bwd.launches += 1
    return dq, dk, dv


masked_sdpa_bwd.launches = 0


class MaskedSdpaFunction(torch.autograd.Function):
    """K1 forward, K2 backward (the port of the JAX custom VJP
    `_masked_sdpa_fwd` / `_masked_sdpa_bwd`). The residuals are q, k and v
    as given: strided views are saved without a copy, and an operand that
    `_build.aligned` had to copy is saved as that copy."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, num_heads: int):
        _check_operands("masked_sdpa", num_heads, q, k, v)
        q, k, v = (_build.aligned(t) for t in (q, k, v))
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.num_heads = scale, num_heads
        return _launch(q, k, v, scale, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = masked_sdpa_bwd(q, k, v, g, ctx.scale, ctx.num_heads)
        return dq, dk, dv, None, None


def masked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, num_heads: int) -> torch.Tensor:
    """Per-head attention over N of (B, G, N, C) q/k/v -> (B, G, N, C); a
    flat (M, N, C) stream goes to the kernel as the view (1, M, N, C).

    CPU tensors take the plain version (plain autograd); CUDA tensors go
    through `MaskedSdpaFunction`: K1 forward (head widths 8, 16, 32 and 64),
    which accepts strided views (channel stride 1; an operand whose rows are
    not 16-byte aligned is copied first) and returns a contiguous output, and
    K2 backward (the same head widths). `masked_sdpa.launches` counts K1
    launches."""
    if q.device.type == "cpu":
        return masked_sdpa_reference(q, k, v, scale, num_heads)
    if q.dim() == 3:
        return MaskedSdpaFunction.apply(q[None], k[None], v[None], scale,
                                        num_heads)[0]
    return MaskedSdpaFunction.apply(q, k, v, scale, num_heads)


masked_sdpa.launches = 0


def masked_sdpa_kernel_info(dtype: torch.dtype, d: int, n: int = 32) -> dict:
    """K1's instantiation for `dtype`, head width `d` and, at d = 8 in
    float32, N = `n` (one a block of four rows) on the current CUDA device,
    as the runtime reports it: threads a block (at most: at d = 8 in float32
    a launch takes 8 ceil(N / 2) rounded up to a warp), registers a thread,
    dynamic shared memory a block, local memory (spills) a thread in bytes,
    blocks resident a SM, the rows a stage holds of q, k or v, and the
    ring's stages. Builds the kernel if needed; launches nothing."""
    lib = _build.library("masked_sdpa")
    info = (ctypes.c_int * 7)(*([-1] * 7))
    fn = lib.kasf_masked_sdpa_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(_DTYPE_CODE[dtype], d, n, info)
    return dict(zip(("threads", "registers", "smem_bytes", "spill_bytes",
                     "blocks_per_sm", "tile_rows", "stages"), info))


def masked_sdpa_bwd_kernel_info(dtype: torch.dtype, n: int = 32,
                                d: int = 16) -> dict:
    """K2's instantiation for `dtype`, head width `d` (8, 16, 32 or 64) and
    N = `n` (one a block of four rows; in bfloat16 at d = 16 one a block of
    eight keys) on the current CUDA device, as the runtime reports it:
    threads a block, registers a thread, dynamic shared memory a block,
    local memory (spills) a thread in bytes, blocks resident a SM, the tile
    (heads of one sequence; rows, N padded to a multiple of four, or of
    eight), the persistent grid (blocks resident on the device: a launch of
    more tiles walks them with this many blocks), and `mma`: 1 where the
    instantiation is `masked_sdpa_bwd_mma_kernel` (bfloat16 at d = 16, on
    the tensor cores, rounding P and dS to bfloat16 as `_attn_bwd_kernel`
    does), 0 for `masked_sdpa_bwd_kernel` (exact float32 on the CUDA cores,
    only dq, dk and dv rounded). Builds the kernel if needed; launches
    nothing."""
    lib = _build.library("masked_sdpa_bwd")
    info = (ctypes.c_int * 9)(*([-1] * 9))
    fn = lib.kasf_masked_sdpa_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(_DTYPE_CODE[dtype], d, n, info)
    return dict(zip(("threads", "registers", "smem_bytes", "spill_bytes",
                     "blocks_per_sm", "tile_heads", "tile_rows", "grid", "mma"), info))
