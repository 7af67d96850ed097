"""The MLP kernels: the LayerNorm-folded MLP tail, forward (K3) and backward
(K4), the plain fused MLP (K5), their autograd Functions and their plain
PyTorch versions.

`fused_mlp_ln(x, gamma, beta, w1, b1, w2, b2, ls2, eps)` computes the
FormerModule tail `x + ls2 * (GELU(LN(x) W1^T + b1) W2^T + b2)` over the last
axis, with float32 LayerNorm statistics and exact-erf GELU. Weights are in
the torch `nn.Linear` layout: `w1` (hidden, C), `w2` (C, hidden). It is the
port of `kasportsformer_tpu/ops/mlp.py:fused_mlp_ln` (Pallas kernel
`_mlp_ln_kernel`, plain formulation `_mlp_ln_xla`).

On a CUDA tensor the wrapper runs `FusedMlpLnFunction`, an autograd
Function whose forward launches the hand-written kernel K3 (`csrc/mlp_ln.cu`
on the tile of `csrc/mlp_tile.cuh`) and whose backward
launches K4 (`csrc/mlp_ln_bwd.cu`, the port of `_mlp_ln_bwd_kernel` behind
the JAX VJP `_fused_mlp_ln_bwd`); an input it cannot take raises. On a CPU
tensor it runs `fused_mlp_ln_reference` under plain autograd. The kernel
masks the tail rows of a ragged M, so any number of rows works. It evaluates
GELU with erf in every dtype (the TPU kernel's bf16 path used the tanh form,
up to 4.8e-4 away). K3 takes C in {64, 128, 256, 512} (the flagship's 128
and the zoo's widths) and K4 the flagship's C = 128.

K3's tile: a block takes tiles of R token rows, normalises each once into
shared memory, and walks the hidden width in chunks of 64 columns, so the
hidden never reaches device memory. Every tile streams all of W1 and W2
from L2, so R sets a launch's L2 reads, ceil(M / R) * 2*C*H*itemsize.
- bfloat16: `mma.sync` m16n8k16 with f32 accumulators; R = 128 at
  C <= 256 and 64 at C = 512. At C <= 128 four warps each own 32 rows and
  every output channel, and fc1's accumulators (16 hidden columns at a
  time), after b1, GELU and the bf16 pack, go straight into fc2 as A
  fragments: the hidden stays in registers. At C >= 256 eight warps split
  fc1's hidden columns and fc2's output channels and exchange the bf16
  hidden once through shared memory. The weight chunks come through a ring
  of 16-byte `cp.async` copies, chunk j+1 in flight while chunk j is
  multiplied. L2 reads at M = 58,752: 30 MB at C/H 64/256, 120 MB at
  128/512, 481 MB at 256/1024, 1.93 GB at 512/1024.
- float32 on the CUDA cores (`fmaf`, exact). At C <= 128: persistent
  blocks, at most one wave, walk 112-row tiles (whole waves at the main
  path's M = 58,752 and 14,688). One thread brings the next tile's rows in
  by a bulk copy while the tile is multiplied, and LayerNorm runs once a
  tile from that stage. A first small kernel writes the weights transposed
  into a workspace the wrapper allocates, so each 64-column chunk of W1 or
  W2 arrives by one bulk copy, the next chunk (the next tile's first after
  the last) in flight while one is multiplied; fc1 and fc2 run 7 x 8
  register tiles, fc1 over two channel halves. At C = 256 and 512 a block
  takes one tile of 64 or 32 rows.
`fused_mlp_ln_kernel_info` reports each instantiation's tile, registers,
shared memory and spills as the runtime sees them, and the blocks of a
launch over m rows.

K4 is three launches: a dx pass (112-row tiles, exact f32 on the CUDA cores
from either dtype, the weights through a cp.async ring), a weight pass (one
block per hidden chunk of 64 and row split, walking the split's 40-row tiles
with the next tile's rows in flight by a bulk copy and dW1, G = g^T h and
db1 kept in registers, exact f32 too) and a reduce that sums both passes'
partials in a fixed order. The library chooses both passes' tiles and the
weight pass's row splits; `fused_mlp_ln_bwd_kernel_info` reports both
passes' instantiations.

`fused_mlp(x, w1, b1, w2, b2)` computes fc1 -> exact GELU -> fc2 over the last
axis, the port of `kasportsformer_tpu/ops/mlp.py:fused_mlp` (Pallas kernel
`_mlp_kernel`, plain formulation `_mlp_xla`). On a CUDA tensor it runs
`FusedMlpFunction`, whose forward launches K5 (`csrc/mlp.cu`, the hidden-chunk
tile of K3 with LayerNorm and the residual switched off) and whose backward,
like the JAX VJP `_fused_mlp_bwd`, recomputes through the plain version.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from kasportsformer_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# model widths each kernel is built for: K3 and K5 the flagship's 128 and the
# zoo's 64 (MotionAGFormer hierarchical), 256 (DSTFormer) and 512 (MixSTE);
# K4 the flagship's only
_WIDTHS = {"mlp_ln": (64, 128, 256, 512), "mlp_ln_bwd": (128,),
           "mlp": (64, 128, 256, 512)}
_CHUNK = 64
_MAX_HIDDEN = 2048


def fused_mlp_ln_reference(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, w1: torch.Tensor,
                           b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                           ls2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Plain version, numerically `_mlp_ln_xla`: LN in float32 (float64 for
    float64 inputs), rounded to the input dtype, then fc1 -> exact GELU -> fc2
    in the input dtype."""
    dt = x.dtype
    xf = x.to(torch.promote_types(dt, torch.float32))
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    a = ((xf - mean) * torch.rsqrt(var + eps) * gamma + beta).to(dt)
    h = F.gelu(F.linear(a, w1.to(dt), b1.to(dt)))
    y = F.linear(h, w2.to(dt), b2.to(dt))
    return x + ls2.to(dt) * y


def fused_mlp_reference(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                        w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Plain version, numerically `_mlp_xla`: fc1 -> exact GELU -> fc2 in the
    input dtype, weights in the torch (out, in) layout."""
    dt = x.dtype
    h = F.gelu(F.linear(x, w1.to(dt), b1.to(dt)))
    return F.linear(h, w2.to(dt), b2.to(dt))


def _gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz GELU(z) = Phi(z) + z phi(z), the exact-erf form."""
    cdf = 0.5 * (1.0 + torch.erf(z * 0.5 ** 0.5))
    return cdf + z * torch.exp(-0.5 * z * z) * (2.0 * math.pi) ** -0.5


def fused_mlp_ln_bwd_reference(x: torch.Tensor, gamma: torch.Tensor,
                               beta: torch.Tensor, w1: torch.Tensor,
                               b1: torch.Tensor, w2: torch.Tensor,
                               b2: torch.Tensor, ls2: torch.Tensor,
                               g: torch.Tensor, eps: float = 1e-5
                               ) -> tuple[torch.Tensor, ...]:
    """Plain backward of `fused_mlp_ln_reference` for the output gradient g,
    in the closed form of K4 (and of the JAX kernel `_mlp_ln_bwd_kernel`):
    LN -> fc1 -> GELU -> fc2 recomputed, products accumulated in float32,
    LN(x), the hidden, do = g * ls2 and dz rounded to the input dtype where
    the JAX kernel rounds them. Weights in the torch (out, in) layout.
    Returns (dx, dgamma, dbeta, dw1, db1, dw2, db2, dls2): dx like x, the
    rest float32."""
    dt, c = x.dtype, x.shape[-1]
    xf = x.reshape(-1, c).float()
    gf = g.reshape(-1, c).float()
    # operands rounded to dt, products summed in float32
    w1c, w2c = w1.to(dt).float(), w2.to(dt).float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mean) * rstd
    a = (xhat * gamma.float() + beta.float()).to(dt).float()
    z = torch.matmul(a, w1c.t()) + b1.to(dt).float()
    h = F.gelu(z).to(dt).float()
    o = torch.matmul(h, w2c.t()) + b2.to(dt).float()
    do = (gf * ls2.float()).to(dt).float()
    dz = torch.matmul(do, w2c) * _gelu_grad(z)
    dzb = dz.to(dt).float()
    da = torch.matmul(dzb, w1c)
    dxhat = da * gamma.float()
    dx = gf + rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                      - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return (dx.to(dt).reshape(x.shape), (da * xhat).sum(0), da.sum(0),
            torch.matmul(dzb.t(), a), dz.sum(0), torch.matmul(do.t(), h),
            do.sum(0), (gf * o).sum(0))


def _fn(name: str, n_ptrs: int, n_tail: list) -> tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    return _build.bind(name, f"kasf_{name}",
                       [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + n_tail)


def _check_linears(what: str, x, w1, b1, w2, b2) -> None:
    dt, dev = x.dtype, x.device
    if dev.type != "cuda":
        raise ValueError(f"{what} kernels take CUDA tensors")
    if dt not in _DTYPE_CODE:
        raise TypeError(f"{what} kernels take float32 or bfloat16, got {dt}")
    c = x.shape[-1]
    hidden = w1.shape[0]
    if (c not in _WIDTHS[what] or tuple(w1.shape) != (hidden, c)
            or tuple(w2.shape) != (c, hidden) or hidden % _CHUNK
            or not 0 < hidden <= _MAX_HIDDEN):
        raise ValueError(f"{what} kernel takes C in {_WIDTHS[what]} and a "
                         f"hidden width that is a multiple of {_CHUNK} up to "
                         f"{_MAX_HIDDEN}; got x {tuple(x.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if b1.numel() != hidden or b2.numel() != c:
        raise ValueError(f"{what} kernel: b1 must have the hidden width and "
                         "b2 C elements")
    if any(t.device != dev for t in (w1, b1, w2, b2)):
        raise ValueError(f"{what} kernel takes all tensors on one CUDA device")


def _check(what: str, x, gamma, beta, w1, b1, w2, b2, ls2) -> None:
    _check_linears(what, x, w1, b1, w2, b2)
    c = x.shape[-1]
    if any(t.numel() != c for t in (gamma, beta, ls2)):
        raise ValueError(f"{what} kernel: gamma, beta, ls2 must have C elements")
    if any(t.device != x.device for t in (gamma, beta, ls2)):
        raise ValueError(f"{what} kernel takes all tensors on one CUDA device")


def _prep(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # no copy for operands already in the dtype, dense and aligned
    return _build.aligned(t.to(dtype).contiguous())


def _operands(x, gamma, beta, w1, b1, w2, b2, ls2) -> tuple[torch.Tensor, ...]:
    """(x as (M, C), gamma, beta, w1, b1, w2, b2, ls2) as the kernels take
    them: x and the linears' weights and biases in x's dtype, the rest
    float32, all dense and aligned."""
    dt = x.dtype
    return (_prep(x.reshape(-1, x.shape[-1]), dt), _prep(gamma, torch.float32),
            _prep(beta, torch.float32), _prep(w1, dt), _prep(b1, dt),
            _prep(w2, dt), _prep(b2, dt), _prep(ls2, torch.float32))


def _workspace(lib: ctypes.CDLL, name: str, x: torch.Tensor,
               hidden: int) -> torch.Tensor | None:
    """The scratch a K3/K5 launch needs (the persistent float32 tile's
    transposed weights), as the library sizes it; None where it needs
    none."""
    size = getattr(lib, f"kasf_{name}_workspace")
    if size.argtypes is None:
        size.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_longlong
    n = size(_DTYPE_CODE[x.dtype], x.shape[-1], hidden)
    return torch.empty(n, dtype=torch.float32, device=x.device) if n else None


def _launch(ops: tuple[torch.Tensor, ...], eps: float) -> torch.Tensor:
    """K3 on `_operands`; returns (M, C)."""
    xc = ops[0]
    m, c = xc.shape
    hidden = ops[3].shape[0]
    out = torch.empty_like(xc)
    if m == 0:
        return out
    lib, fn = _fn("mlp_ln", 10, [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_void_p])
    work = _workspace(lib, "mlp_ln", xc, hidden)
    dev = xc.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_DTYPE_CODE[xc.dtype], *(t.data_ptr() for t in ops),
                  out.data_ptr(), None if work is None else work.data_ptr(),
                  m, c, hidden, float(eps), stream)
    _build.check(lib, code, "mlp_ln kernel launch")
    fused_mlp_ln.launches += 1
    return out


def _kernel_info(name: str, dtype: torch.dtype, c: int, m: int) -> dict:
    lib = _build.library(name)
    info = (ctypes.c_int * 7)(*([-1] * 7))
    fn = getattr(lib, f"kasf_{name}_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(_DTYPE_CODE[dtype], c, m, info)
    return dict(zip(("threads", "rows", "registers", "smem_bytes",
                     "spill_bytes", "blocks_per_sm", "grid"), info))


def fused_mlp_ln_kernel_info(dtype: torch.dtype, c: int,
                             m: int = 58752) -> dict:
    """K3's instantiation for `dtype` and width `c` on the current CUDA
    device, as the runtime reports it: threads a block and token rows a
    tile, registers a thread, dynamic shared memory a block, local memory
    (spills) a thread in bytes, blocks resident a SM, and `grid`, the blocks
    of a launch over `m` rows (a tile each, or, for the persistent float32
    tile at C <= 128, at most one wave of blocks, each walking tiles
    blockIdx, + grid, ...). Builds the kernel if needed; launches
    nothing."""
    return _kernel_info("mlp_ln", dtype, c, m)


def fused_mlp_kernel_info(dtype: torch.dtype, c: int, m: int = 58752) -> dict:
    """K5's instantiation, reported as `fused_mlp_ln_kernel_info` reports
    K3's."""
    return _kernel_info("mlp", dtype, c, m)


_BWD_DX_KEYS = ("threads", "rows", "registers", "smem_bytes", "spill_bytes",
                "blocks_per_sm")
_BWD_W_KEYS = ("threads", "rows", "chunk", "splits", "registers", "smem_bytes",
               "spill_bytes", "blocks_per_sm")


def fused_mlp_ln_bwd_kernel_info(dtype: torch.dtype, m: int = 14688,
                                 hidden: int = 512) -> dict:
    """The instantiations of K4's first two launches for `dtype` at C = 128,
    as the runtime reports them: {"dx_pass": ..., "weight_pass": ...}. Each
    has threads a block, registers a thread, dynamic shared memory a block,
    local memory (spills) a thread in bytes and blocks resident a SM; `rows`
    is the pass's row tile (the dx pass runs ceil(m / rows) blocks), the
    weight pass also has `chunk`, its hidden columns a block, and `splits`,
    its row splits for m rows and this hidden width (a grid of
    hidden / chunk x splits blocks). Builds the kernel if needed; launches
    nothing."""
    lib = _build.library("mlp_ln_bwd")
    info = (ctypes.c_int * 14)(*([-1] * 14))
    fn = lib.kasf_mlp_ln_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(_DTYPE_CODE[dtype], 128, m, hidden, info)
    return {"dx_pass": dict(zip(_BWD_DX_KEYS, info[:6])),
            "weight_pass": dict(zip(_BWD_W_KEYS, info[6:]))}


def _launch_bwd(ops: tuple[torch.Tensor, ...], g: torch.Tensor,
                eps: float) -> tuple[torch.Tensor, ...]:
    """K4 on `_operands` and the (M, C) output gradient g of x's dtype."""
    xc = ops[0]
    m, c = xc.shape
    hidden = ops[3].shape[0]
    dev, f32 = xc.device, torch.float32
    dx = torch.empty_like(xc)
    grads = [torch.empty(s, dtype=f32, device=dev) for s in
             (c, c, (hidden, c), hidden, (c, hidden), c, c)]
    if m == 0:
        for t in grads:
            t.zero_()
        return (dx, *grads)
    lib, fn = _fn("mlp_ln_bwd", 18, [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p])
    size = lib.kasf_mlp_ln_bwd_workspace
    size.argtypes = [ctypes.c_longlong, ctypes.c_int]
    size.restype = ctypes.c_longlong
    work = torch.empty(size(m, hidden), dtype=f32, device=dev)
    ptrs = [t.data_ptr() for t in (xc, g, *ops[1:], dx, *grads, work)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_DTYPE_CODE[xc.dtype], *ptrs, m, c, hidden, float(eps),
                  stream)
    _build.check(lib, code, "mlp_ln_bwd kernel launch")
    fused_mlp_ln_bwd.launches += 1
    return (dx, *grads)


def fused_mlp_ln_bwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     b2: torch.Tensor, ls2: torch.Tensor, g: torch.Tensor,
                     eps: float = 1e-5) -> tuple[torch.Tensor, ...]:
    """K4: the gradients (dx, dgamma, dbeta, dw1, db1, dw2, db2, dls2) of
    `fused_mlp_ln` at these inputs for the output gradient g, on CUDA
    tensors: dx like x, the rest float32. The kernel sums the parameter
    gradients over the rows in a fixed order, so reruns are bitwise equal.
    `fused_mlp_ln_bwd.launches` counts kernel launches."""
    _check("mlp_ln_bwd", x, gamma, beta, w1, b1, w2, b2, ls2)
    ops = _operands(x, gamma, beta, w1, b1, w2, b2, ls2)
    gc = _prep(g.reshape(-1, x.shape[-1]), x.dtype)
    dx, *rest = _launch_bwd(ops, gc, eps)
    return (dx.reshape(x.shape), *rest)


fused_mlp_ln_bwd.launches = 0


class FusedMlpLnFunction(torch.autograd.Function):
    """K3 forward, K4 backward (the port of the JAX custom VJP
    `_fused_mlp_ln_fwd` / `_fused_mlp_ln_bwd`). It takes the parameters in
    their own dtype (float32 under autograd) and makes the copies in x's
    dtype itself; it saves those copies and x, and returns each parameter's
    gradient in that parameter's dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, ls2, eps: float):
        _check("mlp_ln", x, gamma, beta, w1, b1, w2, b2, ls2)
        ops = _operands(x, gamma, beta, w1, b1, w2, b2, ls2)
        ctx.save_for_backward(*ops)
        ctx.eps, ctx.x_shape = eps, x.shape
        ctx.dtypes = [t.dtype for t in (gamma, beta, w1, b1, w2, b2, ls2)]
        return _launch(ops, eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        ops = ctx.saved_tensors
        _check("mlp_ln_bwd", *ops)  # K4 has the flagship's width only
        xc = ops[0]
        gc = _prep(g.reshape(xc.shape), xc.dtype)
        dx, *rest = _launch_bwd(ops, gc, ctx.eps)
        rest = [t.to(d) for t, d in zip(rest, ctx.dtypes)]
        return (dx.reshape(ctx.x_shape), *rest, None)


def fused_mlp_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, ls2: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """x + ls2 * MLP(LN(x)) over the last axis of x (..., C).

    CPU tensors take the plain version (plain autograd); CUDA tensors go
    through `FusedMlpLnFunction` (K3 forward, K4 backward; K4 only at
    C = 128, so a tail of another width under autograd raises in the
    backward). Pass ls2 = ones for a tail without LayerScale.
    `fused_mlp_ln.launches` counts K3 launches."""
    if x.device.type == "cpu":
        return fused_mlp_ln_reference(x, gamma, beta, w1, b1, w2, b2, ls2, eps)
    return FusedMlpLnFunction.apply(x, gamma, beta, w1, b1, w2, b2, ls2, eps)


fused_mlp_ln.launches = 0


# ------------------------------------------------------------ K5


def _launch_mlp(x, w1, b1, w2, b2) -> torch.Tensor:
    """K5 on (M, C) x and the linears, all in x's dtype, dense and aligned."""
    m, c = x.shape
    out = torch.empty_like(x)
    if m == 0:
        return out
    lib, fn = _fn("mlp", 7, [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    work = _workspace(lib, "mlp", x, w1.shape[0])
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_DTYPE_CODE[x.dtype], *(t.data_ptr() for t in (x, w1, b1, w2, b2)),
                  out.data_ptr(), None if work is None else work.data_ptr(),
                  m, c, w1.shape[0], stream)
    _build.check(lib, code, "mlp kernel launch")
    fused_mlp.launches += 1
    return out


class FusedMlpFunction(torch.autograd.Function):
    """K5 forward; the backward recomputes through the plain version under
    autograd, as the JAX VJP `_fused_mlp_bwd` recomputes through `_mlp_xla`
    (the TPU has no backward kernel for it either). Parameters come in their
    own dtype and their gradients leave in it."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        _check_linears("mlp", x, w1, b1, w2, b2)
        dt = x.dtype
        ops = [_prep(t, dt) for t in (x.reshape(-1, x.shape[-1]), w1, b1, w2, b2)]
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _launch_mlp(*ops).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = fused_mlp_reference(*inputs)
        return torch.autograd.grad(y, inputs, g)


def fused_mlp(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """fc1 -> exact GELU -> fc2 over the last axis of x (..., C), weights in
    the torch (out, in) layout: w1 (H, C), w2 (C, H).

    CPU tensors take the plain version (plain autograd); CUDA tensors go
    through `FusedMlpFunction` (K5 forward, a plain recompute backward); an
    input K5 cannot take raises. `fused_mlp.launches` counts K5 launches."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, w1, b1, w2, b2)
    return FusedMlpFunction.apply(x, w1, b1, w2, b2)


fused_mlp.launches = 0
