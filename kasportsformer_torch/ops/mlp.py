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
up to 4.8e-4 away). K3 and K4 take C in {64, 128, 256, 512} (the flagship's
128 and the zoo's widths: MotionAGFormer-XS and hierarchical, DSTFormer,
MixSTE); K4 at C = 64 a hidden width that is a multiple of 128.

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
  register tiles, fc1 over two channel halves. At C = 256 and 512 a
  thread-block cluster of two blocks takes each tile, block b half the
  channels (112 rows of 128 channels a block at C = 256, 56 rows of 256 at
  512): LayerNorm's row statistics and fc1's partial sums over each block's
  channels are summed across the cluster through distributed shared memory
  in rank order (a reduce-scatter, then the finished hidden gathered into
  both blocks), and each block runs fc2 into its own output channels. The
  clusters are persistent too, at most as many as the card holds at once.
`fused_mlp_ln_kernel_info` reports each instantiation's tile, cluster,
registers, shared memory and spills as the runtime sees them, and the blocks
of a launch over m rows.

K4 is three launches, each a template on C. In float32, and in bfloat16 at
C = 64, 256 and 512, the passes compute in f32 from either dtype (on the
CUDA cores; at C = 64 the weight pass in 3xTF32 on the tensor cores) and
round only dx. In bfloat16 at C = 128 both passes run on the tensor cores
(`mma.sync` m16n8k16, f32 accumulators) and round LN(x), the hidden, do =
g * ls2 and dz to bfloat16 where the TPU kernel rounds them, as
`fused_mlp_ln_bwd_reference` does in bfloat16 (the weight gradient of fc2
stays ls2 * g^T h, from g as it is, not from the rounded do): the dx pass
one block of 7 warps a 112-row tile, a warp's 16 rows keeping their a and
do fragments in registers and each 16 hidden columns' dz going from fc1's
and dh's accumulators straight into da as A fragments; the weight pass the
C = 128 grid and row splits, a split's rows in steps of 64, h and dz through
shared memory in bfloat16 into the outer products. The dx pass at C = 64
and 128 (float32) runs one block a 112-row
tile, the weights through a cp.async ring in chunks of 32 hidden columns; at
C = 64 the block is two warp groups, each over half the hidden width with its
own ring and named barrier (fc1, dh, dz and da of its chunks), whose halves
of da are added once, in one order, through shared memory. At 256
and 512 a small stage launch first writes W1 and W2 transposed, in float32
and cut into channel halves, into the workspace; the dx pass then runs a
thread-block cluster of two blocks a tile (112 or 56 rows), each over half
the channels and each weight chunk by one bulk copy: fc1's and dh's partial
sums meet by a reduce-scatter through distributed shared memory, each block
finishes dz for half of a chunk's 32 columns and sends it to the other, and
each keeps da for its own channels. The other two launches are a weight
pass and a reduce. The weight pass walks a row split's tiles with the next
tile's rows in flight and keeps dW1, G = g^T h and db1 of a hidden chunk in
registers over the split (f32 as above): at C = 128 one block per (chunk of
64 columns, split), 40-row tiles by bulk copies (at C = 64 chunks of 128
columns and 56-row tiles); at 256 and 512 a
thread-block cluster of two blocks per (chunk, split), each over half the
channels (chunks of 64 and 32 columns, tiles of 48 and 32 rows, its rows by
strided tensor copies, its weights from the stage launch): LayerNorm's row
sums and fc1's and dh's partial sums meet through distributed shared memory
in rank order, each block finishes h and dz for half the chunk's columns
and sends them to the other. The reduce sums both passes' partials in
index order: one wave of blocks, each thread a float4 of the
weight partials with 16 splits' loads written before its adds, and a ninth
warp summing the dx partials' chains, a lane each, from a stage that the
whole block copies. The library chooses both passes' tiles and the weight pass's row
splits (`fused_mlp_ln_bwd_partition` mirrors them);
`fused_mlp_ln_bwd_kernel_info` reports the three launches' instantiations.
`fused_mlp_ln_bwd_reduce` runs the reduce alone on a caller's workspace,
and `fused_mlp_ln_bwd_reduce_reference` is its plain version.

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
# model widths each kernel is built for: the flagship's 128 and the zoo's 64
# (MotionAGFormer-XS and hierarchical), 256 (DSTFormer) and 512 (MixSTE)
_WIDTHS = {"mlp_ln": (64, 128, 256, 512), "mlp_ln_bwd": (64, 128, 256, 512),
           "mlp": (64, 128, 256, 512)}
_CHUNK = 64
_MAX_HIDDEN = 2048


def _hidden_step(what: str, c: int) -> int:
    """The hidden widths a kernel takes at width c are multiples of this:
    64, but 128 for K4 at C = 64 (its weight pass's chunk)."""
    return 2 * _CHUNK if what == "mlp_ln_bwd" and c == 64 else _CHUNK


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
    step = _hidden_step(what, c)
    if (c not in _WIDTHS[what] or tuple(w1.shape) != (hidden, c)
            or tuple(w2.shape) != (c, hidden) or hidden % step
            or not 0 < hidden <= _MAX_HIDDEN):
        raise ValueError(f"{what} kernel takes C in {_WIDTHS[what]} and a "
                         f"hidden width that is a multiple of {step} up to "
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
    """The scratch a K3/K5 launch needs (the float32 tiles' transposed
    weights), as the library sizes it; None where it needs none."""
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


_INFO_KEYS = ("threads", "rows", "registers", "smem_bytes", "spill_bytes",
              "blocks_per_sm", "grid", "cluster", "resident")


def _kernel_info(name: str, dtype: torch.dtype, c: int, m: int) -> dict:
    lib = _build.library(name)
    info = (ctypes.c_int * len(_INFO_KEYS))(*([-1] * len(_INFO_KEYS)))
    fn = getattr(lib, f"kasf_{name}_info")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(_DTYPE_CODE[dtype], c, m, info)
    return dict(zip(_INFO_KEYS, info))


def fused_mlp_ln_kernel_info(dtype: torch.dtype, c: int,
                             m: int = 58752) -> dict:
    """K3's instantiation for `dtype` and width `c` on the current CUDA
    device, as the runtime reports it: threads a block and token rows a
    tile, registers a thread, dynamic shared memory a block, local memory
    (spills) a thread in bytes, blocks a SM holds, `cluster`, the blocks
    that share a tile (2 for float32 at C >= 256, else 1), `resident`,
    the blocks the card holds at once (whole clusters, each within one GPC),
    and `grid`, the blocks of a launch over `m` rows (a tile each in
    bfloat16; in float32 at most `resident` blocks, each block or cluster
    walking tiles). Builds the kernel if needed; launches nothing."""
    return _kernel_info("mlp_ln", dtype, c, m)


def fused_mlp_kernel_info(dtype: torch.dtype, c: int, m: int = 58752) -> dict:
    """K5's instantiation, reported as `fused_mlp_ln_kernel_info` reports
    K3's."""
    return _kernel_info("mlp", dtype, c, m)


_BWD_DX_KEYS = ("threads", "rows", "registers", "smem_bytes", "spill_bytes",
                "blocks_per_sm")
_BWD_DX_MORE = ("cluster", "resident", "grid")  # info[20:23]
_BWD_DX_GROUPS = ("groups",)  # info[26]
_BWD_W_KEYS = ("threads", "rows", "chunk", "splits", "registers", "smem_bytes",
               "spill_bytes", "blocks_per_sm")
_BWD_W_MORE = ("cluster", "resident", "grid")  # info[23:26]
_BWD_R_KEYS = ("threads", "blocks", "registers", "smem_bytes", "spill_bytes",
               "blocks_per_sm")
# K4's partition of the rows at each width C: (dx pass rows a tile, weight
# pass rows a tile, weight pass hidden columns a chunk, weight pass blocks a
# chunk), as csrc/mlp_ln_bwd.cu's dxp::Cfg<C>::kR or dxc::Cfg<C>::kR (a
# cluster's tile), wp::Cfg<C> or wpc::Cfg<C> (kR, kJ; a cluster of two
# at 256 and 512) make them; wp::kSMs
_BWD_TILES = {64: (112, 56, 128, 1), 128: (112, 40, 64, 1), 256: (112, 48, 64, 2),
              512: (56, 32, 32, 2)}
_SMS = 132


def fused_mlp_ln_bwd_partition(m: int, hidden: int, c: int = 128) -> dict:
    """K4's partition of m rows at this hidden width and width c, as its
    library makes it (`w_splits` in csrc/mlp_ln_bwd.cu): the dx pass's
    `dx_tiles` tiles of `dx_rows` rows, one partial each; the weight pass's
    tiles of `w_rows` rows in `splits` row splits of `per_split` consecutive
    tiles (trailing splits may be empty and leave zeros), one partial each:
    as many splits as 132 SMs hold of the hidden / chunk blocks (clusters
    of two at C = 256 and 512) a split takes.
    The workspace holds the dx partials (dx_tiles, 3, C), then the weight
    partials, each dW1 (hidden, C), G = g^T h (C, hidden) and db1
    (hidden), which the reduce reads, then `stage` floats: at C = 256 and
    512 the stage launch's float32 W1 and W2^T, each as two channel halves
    of (hidden, C / 2 + 4) (rows padded as the dx pass's chunk buffers are),
    and b1."""
    dx_rows, w_rows, chunk, cluster = _BWD_TILES[c]
    w_tiles = -(-m // w_rows)
    splits = max(1, min(w_tiles, _SMS // (cluster * (hidden // chunk))))
    return dict(dx_rows=dx_rows, dx_tiles=-(-m // dx_rows),
                w_rows=w_rows, splits=splits, per_split=-(-w_tiles // splits),
                stage=0 if c <= 128 else 2 * hidden * (c + 8) + hidden)


def fused_mlp_ln_bwd_kernel_info(dtype: torch.dtype, m: int = 14688,
                                 hidden: int = 512, c: int = 128) -> dict:
    """The instantiations of K4's three launches for `dtype` at width `c`,
    as the runtime reports them: {"dx_pass": ..., "weight_pass": ...,
    "reduce": ...}. Each has threads a block, registers a thread, shared
    memory a block (dynamic in the passes, static in the reduce but for its
    dynamic share at C = 64), local
    memory (spills) a thread in bytes and blocks resident a SM; `rows` is a
    pass's row tile (the dx pass has ceil(m / rows) tiles); the dx pass also
    has `cluster`, the blocks that share a tile (1 at C = 64 and 128, 2 at
    256 and 512), `resident`, the clusters (at C <= 128 blocks) the card
    holds at once, `grid`, the blocks of its launch over m rows (a tile
    each at C <= 128; at most `resident` clusters, each walking tiles,
    beyond), and `groups`, the warp groups a block, each over its share of
    the hidden width (2 at C = 64, else 1); the
    weight pass has `chunk`, its hidden columns a block (a cluster's, each
    block over half the channels, at 256 and 512), `splits`, its row
    splits for m rows and this hidden width (the same partition in both
    dtypes; in bfloat16 at C = 128 a block walks its split's rows in steps
    of 64), `cluster`, the blocks that
    share a chunk and split (1 at C <= 128, 2 at 256 and 512), `resident`,
    the clusters the card holds at once, and `grid`, the blocks of its
    launch (hidden / chunk x splits clusters, one wave); the reduce has
    `blocks`, its grid at this hidden width (132 at C = 64: a block a G
    row, H floats of dW1 or a quarter of db1). Builds the kernel if needed;
    launches nothing."""
    lib = _build.library("mlp_ln_bwd")
    n = (len(_BWD_DX_KEYS) + len(_BWD_W_KEYS) + len(_BWD_R_KEYS)
         + len(_BWD_DX_MORE) + len(_BWD_W_MORE) + len(_BWD_DX_GROUPS))
    info = (ctypes.c_int * n)(*([-1] * n))
    fn = lib.kasf_mlp_ln_bwd_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(_DTYPE_CODE[dtype], c, m, hidden, info)
    return {"dx_pass": dict(zip(_BWD_DX_KEYS + _BWD_DX_MORE + _BWD_DX_GROUPS,
                                info[:6] + info[20:23] + info[26:27])),
            "weight_pass": dict(zip(_BWD_W_KEYS + _BWD_W_MORE, info[6:14] + info[23:26])),
            "reduce": dict(zip(_BWD_R_KEYS, info[14:20]))}


def _bwd_workspace_size(m: int, hidden: int, c: int = 128) -> int:
    """Floats of workspace K4 needs for m rows, hidden width and width c,
    as its library sizes it."""
    size = _build.library("mlp_ln_bwd").kasf_mlp_ln_bwd_workspace
    if size.argtypes is None:
        size.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
        size.restype = ctypes.c_longlong
    return size(m, c, hidden)


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
    work = torch.empty(_bwd_workspace_size(m, hidden, c), dtype=f32, device=dev)
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


def _reduce_parts(work: torch.Tensor, c: int, hidden: int,
                  m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The workspace's dx partials (dx_tiles, 3, c) and weight partials
    (splits, 2 hidden c + hidden); raises unless it has their size."""
    p = fused_mlp_ln_bwd_partition(m, hidden, c)
    n_dx, n_w = p["dx_tiles"] * 3 * c, p["splits"] * (2 * hidden * c + hidden)
    if work.dtype != torch.float32 or work.numel() != n_dx + n_w:
        raise ValueError(f"mlp_ln_bwd reduce: the workspace for m = {m}, hidden "
                         f"= {hidden} is {n_dx + n_w} float32 elements; got "
                         f"{work.numel()} {work.dtype}")
    flat = work.reshape(-1)
    return flat[:n_dx].view(p["dx_tiles"], 3, c), flat[n_dx:].view(p["splits"], -1)


def fused_mlp_ln_bwd_reduce_reference(work: torch.Tensor, w2: torch.Tensor,
                                      b2: torch.Tensor, ls2: torch.Tensor,
                                      m: int) -> tuple[torch.Tensor, ...]:
    """Plain version of K4's reduce (`fused_mlp_ln_bwd_reduce`) on a
    workspace laid out as `fused_mlp_ln_bwd_partition(m, hidden, C)` says.
    Every partial sum runs in index order as acc = acc + part[s], as the
    kernel's does, so on the card dgamma, dbeta, dw1, db1, dw2 and db2 equal
    the kernel's bit for bit; dls2, a dot product over the hidden width, is
    grouped otherwise. Returns (dgamma, dbeta, dw1, db1, dw2, db2, dls2) in
    float32."""
    c, hidden = w2.shape
    part_dx, part_w = _reduce_parts(work, c, hidden, m)

    def ordered(parts: torch.Tensor) -> torch.Tensor:
        acc = torch.zeros_like(parts[0])
        for s in range(parts.shape[0]):
            acc = acc + parts[s]
        return acc

    sx, sw = ordered(part_dx), ordered(part_w)
    gg = sw[hidden * c:2 * hidden * c].view(c, hidden)
    ls = ls2.float()
    return (sx[0], sx[1], sw[:hidden * c].view(hidden, c), sw[2 * hidden * c:],
            ls[:, None] * gg, ls * sx[2], (w2.float() * gg).sum(1) + b2.float() * sx[2])


def fused_mlp_ln_bwd_reduce(work: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                            ls2: torch.Tensor, m: int) -> tuple[torch.Tensor, ...]:
    """K4's third launch alone, on CUDA tensors: the reduce over a float32
    workspace laid out as K4's two passes leave it for m rows
    (`fused_mlp_ln_bwd_partition`), with w2 (C, hidden) and b2 of the
    kernel's dtype and ls2 float32. Returns (dgamma, dbeta, dw1, db1, dw2,
    db2, dls2) in float32, as `fused_mlp_ln_bwd` does.
    `fused_mlp_ln_bwd_reduce.launches` counts kernel launches."""
    if work.device.type != "cuda":
        raise ValueError("the mlp_ln_bwd reduce kernel takes CUDA tensors")
    dt, dev = w2.dtype, work.device
    if dt not in _DTYPE_CODE:
        raise TypeError(f"mlp_ln_bwd reduce takes float32 or bfloat16, got {dt}")
    c, hidden = w2.shape
    step = _hidden_step("mlp_ln_bwd", c)
    if (c not in _WIDTHS["mlp_ln_bwd"] or hidden % step
            or not 0 < hidden <= _MAX_HIDDEN or b2.numel() != c
            or ls2.numel() != c or m < 1):
        raise ValueError(f"mlp_ln_bwd reduce takes w2 (C, hidden), C in "
                         f"{_WIDTHS['mlp_ln_bwd']}, hidden a multiple of {step} "
                         f"up to {_MAX_HIDDEN}, b2 and ls2 of C elements and "
                         f"m >= 1; got w2 {tuple(w2.shape)}, b2 {b2.numel()}, "
                         f"ls2 {ls2.numel()}, m {m}")
    if any(t.device != dev for t in (w2, b2, ls2)):
        raise ValueError("mlp_ln_bwd reduce takes all tensors on one CUDA device")
    _reduce_parts(work, c, hidden, m)
    ops = [_prep(work.reshape(-1), torch.float32), _prep(w2, dt), _prep(b2, dt),
           _prep(ls2, torch.float32)]
    grads = [torch.empty(s, dtype=torch.float32, device=dev) for s in
             (c, c, (hidden, c), hidden, (c, hidden), c, c)]
    lib, fn = _build.bind("mlp_ln_bwd", "kasf_mlp_ln_bwd_reduce",
                          [ctypes.c_int] + [ctypes.c_void_p] * 11
                          + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                             ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(_DTYPE_CODE[dt], *(t.data_ptr() for t in (*ops, *grads)),
                  m, c, hidden, stream)
    _build.check(lib, code, "mlp_ln_bwd reduce kernel launch")
    fused_mlp_ln_bwd_reduce.launches += 1
    return tuple(grads)


fused_mlp_ln_bwd_reduce.launches = 0


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
        _check("mlp_ln_bwd", *ops)  # K4 at C = 64 takes H in multiples of 128
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
    through `FusedMlpLnFunction` (K3 forward, K4 backward; a tail of width
    64 whose hidden width is not a multiple of 128 raises in the backward).
    Pass ls2 = ones for a tail without LayerScale.
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
