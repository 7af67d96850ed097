"""kasportsformer_torch's CUDA kernels against their plain PyTorch versions,
on the card. Every test here carries the `cuda` marker and skips without a
CUDA device; the file imports neither JAX nor the JAX package, so it runs on
a machine that has only PyTorch: `python -m pytest tests/test_torch_cuda.py`.
"""

import pytest
import torch

from kasportsformer_torch.ops.attention import (
    masked_sdpa,
    masked_sdpa_bwd,
    masked_sdpa_bwd_reference,
    masked_sdpa_reference,
)
from kasportsformer_torch.ops.mlp import (
    fused_mlp,
    fused_mlp_kernel_info,
    fused_mlp_ln,
    fused_mlp_ln_bwd,
    fused_mlp_ln_bwd_kernel_info,
    fused_mlp_ln_bwd_reference,
    fused_mlp_ln_kernel_info,
    fused_mlp_ln_reference,
    fused_mlp_reference,
)

pytestmark = pytest.mark.cuda

# Each kernel is held to its plain version run in float32 on the same inputs,
# the error scaled by max(1, |y|). float32: summation order only. bfloat16:
# K1 rounds its unnormalised probabilities (a tensor-core operand) and its
# output, half a unit in the last place each (<= 6e-3); K3
# also rounds the LayerNorm output and the hidden activations, the operands
# of its tensor-core products, and K5 the hidden activations.
# K2 and K4 compute in f32 from either dtype and round only their
# activation gradients (K4's parameter gradients are f32 sums over the rows,
# held against their largest entry).
TOL = {"masked_sdpa": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
       "fused_mlp_ln": {torch.float32: 1e-4, torch.bfloat16: 2e-2},
       "masked_sdpa_bwd": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
       "fused_mlp_ln_bwd": {torch.float32: 1e-4, torch.bfloat16: 1e-2},
       "fused_mlp": {torch.float32: 1e-4, torch.bfloat16: 2e-2}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return ((g - w).abs() / w.abs().clamp(min=1.0)).max().item()


def _sum_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_masked_sdpa_kernel_matches_plain(cuda, dtype, mode):
    """Strided q/k/v: column slices of one qkv projection, permuted views in
    temporal mode, as the model passes them."""
    qkv = torch.randn(4, 27, 17, 384, device="cuda", generator=cuda).to(dtype)
    q, k, v = qkv.split(128, dim=-1)
    if mode == "temporal":
        q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    before = masked_sdpa.launches
    got = masked_sdpa(q, k, v, 0.25, 8)
    want = masked_sdpa_reference(q.float(), k.float(), v.float(), 0.25, 8)
    assert masked_sdpa.launches == before + 1
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["masked_sdpa"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_sdpa_kernel_unaligned_rows(cuda, dtype):
    """Rows that do not start on a 16-byte boundary are copied to aligned
    storage before the kernel's vector loads."""
    qkv = torch.randn(3, 27, 17, 385, device="cuda", generator=cuda).to(dtype)
    q, k, v = qkv[..., 1:129], qkv[..., 129:257], qkv[..., 257:385]
    got = masked_sdpa(q, k, v, 0.25, 8)
    want = masked_sdpa_reference(q.float(), k.float(), v.float(), 0.25, 8)
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["masked_sdpa"][dtype])


def test_masked_sdpa_kernel_large_interhead_spread(cuda):
    """Exact per-head max: a head ~1e4 below another stays finite."""
    q, k, v = (torch.randn(2, 4, 17, 128, device="cuda", generator=cuda)
               for _ in range(3))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    got = masked_sdpa(q, k, v, 0.25, 8)
    assert torch.isfinite(got).all()
    assert (got - masked_sdpa_reference(q, k, v, 0.25, 8)).abs().max() <= 1e-4
    qb, kb, vb = (z.bfloat16() for z in (q, k, v))
    gotb = masked_sdpa(qb, kb, vb, 0.25, 8)
    wantb = masked_sdpa_reference(qb.float(), kb.float(), vb.float(), 0.25, 8)
    assert torch.isfinite(gotb).all()
    assert _scaled_err(gotb, wantb) <= TOL["masked_sdpa"][torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
@pytest.mark.parametrize("n", [1, 2, 16, 17, 27, 32])
def test_masked_sdpa_kernel_rows_and_widths(cuda, dtype, d, n):
    """Every N the 32-row stage pads (one m-tile or two, a ragged last key
    tile) at every head width, on strided views: column slices of one qkv
    projection, permuted (B,T,J,C)->(B,J,T,C)."""
    c = 128
    qkv = torch.randn(3, n, 5, 3 * c, device="cuda", generator=cuda).to(dtype)
    q, k, v = (z.transpose(1, 2) for z in qkv.split(c, dim=-1))
    before = masked_sdpa.launches
    got = masked_sdpa(q, k, v, d ** -0.5, c // d)
    want = masked_sdpa_reference(q.float(), k.float(), v.float(), d ** -0.5, c // d)
    assert masked_sdpa.launches == before + 1 and got.shape == q.shape
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["masked_sdpa"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,g,c,heads", [(1, 1, 128, 8), (133, 3, 512, 8),
                                         (7, 5, 192, 3), (2, 9, 40, 5)])
def test_masked_sdpa_kernel_tiles_off_the_grid(cuda, dtype, b, g, c, heads):
    """Tile counts that are no multiple of the persistent grid (one tile;
    133 x 3 sequences of four head groups), and a last head group with fewer
    heads than the others (3 heads of 64, 5 of 8)."""
    q, k, v = (torch.randn(b, g, 27, c, device="cuda", generator=cuda).to(dtype)
               for _ in range(3))
    d = c // heads
    got = masked_sdpa(q, k, v, d ** -0.5, heads)
    want = masked_sdpa_reference(q.float(), k.float(), v.float(), d ** -0.5, heads)
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["masked_sdpa"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 64])
def test_masked_sdpa_kernel_one_hot_probabilities(cuda, dtype, d):
    """One key dominates each head (key 3h+1 of head h), so every query row
    of head h is that key's value row: a permutation of the fragments' rows,
    keys or channels shows as a wrong row, not as a small error."""
    n, c = 27, 128
    heads = c // d
    q = torch.rand(4, 3, n, c, device="cuda", generator=cuda) + 0.5
    k = 0.01 * torch.randn(4, 3, n, c, device="cuda", generator=cuda)
    v = torch.randn(4, 3, n, c, device="cuda", generator=cuda)
    keys = [(3 * h + 1) % n for h in range(heads)]
    for h, j in enumerate(keys):
        k[:, :, j, h * d:(h + 1) * d] = 20.0  # its logit >= 10 sqrt(D) above
    q, k, v = (z.to(dtype) for z in (q, k, v))
    got = masked_sdpa(q, k, v, d ** -0.5, heads).float()
    for h, j in enumerate(keys):
        want = v[:, :, j:j + 1, h * d:(h + 1) * d].float().expand(-1, -1, n, -1)
        assert _scaled_err(got[..., h * d:(h + 1) * d], want) <= TOL["masked_sdpa"][dtype]


def _mlp_args(gen, m: int, dtype, c: int = 128, hidden: int = 512):
    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=gen)

    return (randn(m, c).to(dtype), 1 + randn(c, scale=0.1), randn(c, scale=0.1),
            randn(hidden, c, scale=c ** -0.5).to(dtype),
            randn(hidden, scale=0.1).to(dtype),
            randn(c, hidden, scale=hidden ** -0.5).to(dtype),
            randn(c, scale=0.1).to(dtype),
            torch.rand(c, device="cuda", generator=gen))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [58752, 1377])
def test_fused_mlp_ln_kernel_matches_plain(cuda, dtype, m):
    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device="cuda", generator=cuda)

    x = randn(m, 128).to(dtype)
    gamma, beta = 1 + randn(128, scale=0.1), randn(128, scale=0.1)
    w1 = randn(512, 128, scale=128 ** -0.5).to(dtype)
    b1 = randn(512, scale=0.1).to(dtype)
    w2 = randn(128, 512, scale=512 ** -0.5).to(dtype)
    b2 = randn(128, scale=0.1).to(dtype)
    ls2 = torch.rand(128, device="cuda", generator=cuda)
    args = (x, gamma, beta, w1, b1, w2, b2, ls2, 1e-5)
    before = fused_mlp_ln.launches
    got = fused_mlp_ln(*args)
    want = fused_mlp_ln_reference(*(a.float() for a in args[:-1]), args[-1])
    assert fused_mlp_ln.launches == before + 1
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["fused_mlp_ln"][dtype])


def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.randn(2, 3, 40, 128, device="cuda", generator=cuda)  # N > 32
    with pytest.raises(ValueError, match="N <= 32"):
        masked_sdpa(q, q, q, 0.25, 8)
    with pytest.raises(ValueError, match="heads of width"):  # 1 head of 128
        masked_sdpa(q[:, :, :17], q[:, :, :17], q[:, :, :17], 0.25, 1)
    with pytest.raises(TypeError):
        masked_sdpa(q.half(), q.half(), q.half(), 0.25, 8)
    x = torch.randn(8, 96, device="cuda", generator=cuda)  # C = 96
    w = torch.randn(256, 96, device="cuda", generator=cuda)
    with pytest.raises(ValueError, match="C in"):
        fused_mlp_ln(x, x[0], x[0], w, w[:, 0], w.T, x[0], x[0])
    with pytest.raises(ValueError, match="C in"):
        fused_mlp(x, w, w[:, 0], w.T, x[0])
    x, w = x[:, :64], w[:, :64]  # K4 has the flagship's C = 128 only
    with pytest.raises(ValueError, match="C in"):
        fused_mlp_ln_bwd(x, x[0], x[0], w, w[:, 0], w.T, x[0], x[0], x)


def _zoo_views(gen, dtype):
    """Strided q/k/v at the zoo's head widths: D = 8 as (B,T,J,C) and its
    temporal permutation, D = 32 as a flat (M,N,C) stream and DSTFormer's
    grouped (B,J,F,C) view, D = 64 as a flat stream."""
    def split(shape, c):
        qkv = torch.randn(*shape, 3 * c, device="cuda", generator=gen).to(dtype)
        return qkv.split(c, dim=-1)

    mag, dst = split((4, 27, 17), 64), split((4 * 27, 17), 256)
    return {"D8": mag, "D8 temporal": tuple(z.transpose(1, 2) for z in mag),
            "D32": dst, "D32 grouped": tuple(z.reshape(4, 27, 17, 256).transpose(1, 2)
                                             for z in dst),
            "D64": split((4 * 17, 27), 512)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["D8", "D8 temporal", "D32", "D32 grouped", "D64"])
def test_masked_sdpa_kernel_zoo_widths(cuda, dtype, name):
    q, k, v = _zoo_views(cuda, dtype)[name]
    before = masked_sdpa.launches
    got = masked_sdpa(q, k, v, 0.2, 8)
    want = masked_sdpa_reference(q.float(), k.float(), v.float(), 0.2, 8)
    assert masked_sdpa.launches == before + 1 and got.shape == q.shape
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["masked_sdpa"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hidden,eps", [(64, 256, 1e-5), (256, 1024, 1e-5),
                                          (512, 1024, 1e-6)])
def test_fused_mlp_ln_kernel_zoo_widths(cuda, dtype, c, hidden, eps):
    args = _mlp_args(cuda, 1377, dtype, c, hidden)
    before = fused_mlp_ln.launches
    got = fused_mlp_ln(*args, eps)
    want = fused_mlp_ln_reference(*(a.float() for a in args), eps)
    assert fused_mlp_ln.launches == before + 1
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["fused_mlp_ln"][dtype])


# the models' hidden width at each of K3's widths
_HIDDEN = {64: 256, 128: 512, 256: 1024, 512: 1024}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("rows", ["1", "R-1", "R+1"])
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_fused_mlp_kernels_tile_edges(cuda, dtype, c, rows, kernel):
    """M = 1 and one row either side of the tile's R rows: the tail rows of
    the last tile are masked, never stored."""
    info = fused_mlp_ln_kernel_info if kernel == "K3" else fused_mlp_kernel_info
    r = info(dtype, c)["rows"]
    assert r > 1
    m = {"1": 1, "R-1": r - 1, "R+1": r + 1}[rows]
    args = _mlp_args(cuda, m, dtype, c, _HIDDEN[c])
    if kernel == "K3":
        got = fused_mlp_ln(*args, 1e-5)
        want = fused_mlp_ln_reference(*(a.float() for a in args), 1e-5)
    else:
        x, _, _, w1, b1, w2, b2, _ = args
        got = fused_mlp(x, w1, b1, w2, b2)
        want = fused_mlp_reference(*(a.float() for a in (x, w1, b1, w2, b2)))
    name = "fused_mlp_ln" if kernel == "K3" else "fused_mlp"
    assert got.shape == (m, c)
    assert torch.isfinite(got).all() and _scaled_err(got, want) <= TOL[name][dtype]


def _walk_rows(info, dtype, c: int, walk: str) -> int:
    """M for a walk of K3's or K5's tiles, from the tile and blocks a SM the
    library reports: "three tiles a block" is three waves of tiles less half
    a tile (a persistent block walks exactly three, the last of them
    ragged), "a wave and a row" one wave of full tiles and a tile of one
    row (a persistent block walks it second). Checks the reported grid:
    persistent blocks (float32 at C <= 128) are at most one wave, the other
    tiles a block each."""
    r = info(dtype, c)["rows"]
    wave = (torch.cuda.get_device_properties(0).multi_processor_count
            * info(dtype, c)["blocks_per_sm"])
    m = 3 * wave * r - r // 2 if walk == "three tiles a block" else wave * r + 1
    tiles = -(-m // r)
    persistent = dtype == torch.float32 and c <= 128
    assert info(dtype, c, m)["grid"] == (min(tiles, wave) if persistent else tiles)
    return m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("walk", ["three tiles a block", "a wave and a row"])
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_fused_mlp_kernels_walk_the_tiles(cuda, dtype, c, walk, kernel):
    """Persistent blocks that walk several tiles (the raw stage refilled,
    the weight ring carried from one tile into the next, the last tile
    ragged or one row): every row right."""
    info = fused_mlp_ln_kernel_info if kernel == "K3" else fused_mlp_kernel_info
    m = _walk_rows(info, dtype, c, walk)
    args = _mlp_args(cuda, m, dtype, c, _HIDDEN[c])
    if kernel == "K3":
        got = fused_mlp_ln(*args, 1e-5)
        want = fused_mlp_ln_reference(*(a.float() for a in args), 1e-5)
    else:
        x, _, _, w1, b1, w2, b2, _ = args
        got = fused_mlp(x, w1, b1, w2, b2)
        want = fused_mlp_reference(*(a.float() for a in (x, w1, b1, w2, b2)))
    name = "fused_mlp_ln" if kernel == "K3" else "fused_mlp"
    assert got.shape == (m, c)
    assert torch.isfinite(got).all() and _scaled_err(got, want) <= TOL[name][dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
@pytest.mark.parametrize("hidden", [64, 2048])
def test_fused_mlp_ln_kernel_hidden_extremes(cuda, dtype, c, hidden):
    """One hidden chunk, and the most the launcher takes (32 chunks: the
    ring wraps many times), where every persistent block walks three
    tiles."""
    m = _walk_rows(fused_mlp_ln_kernel_info, dtype, c, "three tiles a block")
    args = _mlp_args(cuda, m, dtype, c, hidden)
    got = fused_mlp_ln(*args, 1e-5)
    want = fused_mlp_ln_reference(*(a.float() for a in args), 1e-5)
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["fused_mlp_ln"][dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_fused_mlp_ln_kernel_one_hot_hidden(cuda, dtype, c):
    """Row i is 0.5 at channel k(i) and 0 elsewhere, so LN(x) peaks at
    k(i); W1 sends channel k to hidden unit u(k) alone and b1 = -3 keeps
    every other unit near GELU(-3) ~ -0.004; W2 sends unit u to output
    channel o(u). So one hidden unit dominates each row (~8 at C = 128)
    and lands on a known channel: a permuted accumulator -> A-fragment
    mapping or a misplaced hidden exchange shows as a wrong channel."""
    hidden, m = _HIDDEN[c], 777
    rows = torch.arange(m, device="cuda")
    k = (7 * rows) % c
    unit = (3 * torch.arange(c, device="cuda") + 1) % hidden  # distinct
    out_ch = (5 * torch.arange(hidden, device="cuda") + 2) % c
    x = torch.zeros(m, c, device="cuda")
    x[rows, k] = 0.5
    w1 = torch.zeros(hidden, c, device="cuda")
    w1[unit, torch.arange(c, device="cuda")] = 1.0
    w2 = torch.zeros(c, hidden, device="cuda")
    w2[out_ch, torch.arange(hidden, device="cuda")] = 1.0
    b1 = torch.full((hidden,), -3.0, device="cuda")
    ones, zeros = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    args = (x.to(dtype), ones, zeros, w1.to(dtype), b1.to(dtype), w2.to(dtype),
            zeros.to(dtype), ones)
    got = fused_mlp_ln(*args, 1e-5)
    want = fused_mlp_ln_reference(*(a.float() for a in args), 1e-5)
    assert torch.equal(got.float().argmax(-1), out_ch[unit[k]])
    assert _scaled_err(got, want) <= TOL["fused_mlp_ln"][dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 128, 256, 512])
def test_fused_mlp_ln_kernel_reruns_bitwise_equal(cuda, dtype, c):
    args = _mlp_args(cuda, 1377, dtype, c, _HIDDEN[c])
    first = fused_mlp_ln(*args, 1e-5)
    assert torch.equal(fused_mlp_ln(*args, 1e-5), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hidden", [(64, 256), (128, 512), (256, 1024), (512, 2048)])
def test_fused_mlp_kernel_matches_plain(cuda, dtype, c, hidden):
    x, _, _, w1, b1, w2, b2, _ = _mlp_args(cuda, 1377, dtype, c, hidden)
    before = fused_mlp.launches
    got = fused_mlp(x.reshape(3, 459, c), w1, b1, w2, b2)
    want = fused_mlp_reference(*(a.float() for a in (x, w1, b1, w2, b2)))
    assert fused_mlp.launches == before + 1 and got.shape == (3, 459, c)
    assert (torch.isfinite(got).all()
            and _scaled_err(got.reshape(-1, c), want) <= TOL["fused_mlp"][dtype])


def test_fused_mlp_function_gradients_match_plain_autograd(cuda):
    """K5's Function recomputes its backward through the plain version: the
    gradients equal plain autograd's, in the parameters' float32."""
    x, _, _, w1, b1, w2, b2, _ = _mlp_args(cuda, 1377, torch.float32)
    leaves = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    out = fused_mlp(*leaves)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    leaves2 = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
    want = torch.autograd.grad(fused_mlp_reference(*leaves2), leaves2, g)
    for a, w in zip(got, want):
        assert a.dtype == torch.float32 and _sum_err(a, w) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["spatial", "temporal"])
def test_masked_sdpa_bwd_kernel_matches_plain(cuda, dtype, mode):
    """Strided q/k/v from one qkv projection; in temporal mode the permuted
    views and a transposed gradient, as autograd hands them over."""
    qkv = torch.randn(4, 27, 17, 384, device="cuda", generator=cuda).to(dtype)
    g = torch.randn(4, 27, 17, 128, device="cuda", generator=cuda).to(dtype)
    q, k, v = qkv.split(128, dim=-1)
    if mode == "temporal":
        q, k, v, g = (z.transpose(1, 2) for z in (q, k, v, g))
    before = masked_sdpa_bwd.launches
    got = masked_sdpa_bwd(q, k, v, g, 0.25, 8)
    want = masked_sdpa_bwd_reference(*(z.float() for z in (q, k, v, g)), 0.25, 8)
    assert masked_sdpa_bwd.launches == before + 1
    for a, w in zip(got, want):
        assert a.is_contiguous() and torch.isfinite(a).all()
        assert _scaled_err(a, w) <= TOL["masked_sdpa_bwd"][dtype]


def test_masked_sdpa_bwd_kernel_large_interhead_spread(cuda):
    q, k, v, g = (torch.randn(2, 4, 17, 128, device="cuda", generator=cuda)
                  for _ in range(4))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    for a, w in zip(masked_sdpa_bwd(q, k, v, g, 0.25, 8),
                    masked_sdpa_bwd_reference(q, k, v, g, 0.25, 8)):
        assert torch.isfinite(a).all() and _scaled_err(a, w) <= 1e-4




def _bwd_matches_plain(args, g, dtype) -> tuple[torch.Tensor, ...]:
    """K4 once (one launch counted) against its plain version in float32 on
    the same inputs: dx per element, the parameter gradients against their
    largest entry; a rerun bitwise equal (no atomics). Returns K4's
    gradients."""
    before = fused_mlp_ln_bwd.launches
    got = fused_mlp_ln_bwd(*args, g, 1e-5)
    assert fused_mlp_ln_bwd.launches == before + 1
    want = fused_mlp_ln_bwd_reference(*(a.float() for a in args), g.float(), 1e-5)
    tol = TOL["fused_mlp_ln_bwd"][dtype]
    assert got[0].dtype == dtype and torch.isfinite(got[0]).all()
    assert _scaled_err(got[0], want[0]) <= tol
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32 and _sum_err(a, w) <= tol
    again = fused_mlp_ln_bwd(*args, g, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [14688, 1377, 5])
def test_fused_mlp_ln_bwd_kernel_matches_plain(cuda, dtype, m):
    args = _mlp_args(cuda, m, dtype)
    g = torch.randn(m, 128, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["1", "R-1", "R", "R+1"])
def test_fused_mlp_ln_bwd_kernel_tile_edges(cuda, dtype, rows):
    """M = 1, and the dx pass's tile of R rows and one row either side: the
    tail rows of the last tile are masked, and the reduce sums one partial
    a tile."""
    r = fused_mlp_ln_bwd_kernel_info(dtype)["dx_pass"]["rows"]
    assert r > 1
    m = {"1": 1, "R-1": r - 1, "R": r, "R+1": r + 1}[rows]
    args = _mlp_args(cuda, m, dtype)
    g = torch.randn(m, 128, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", ["1", "R-1", "R", "R+1", "empty splits"])
def test_fused_mlp_ln_bwd_weight_pass_tile_edges(cuda, dtype, rows):
    """M = 1, the weight pass's tile of R rows and one row either side (its
    tail rows masked), and M = 17 R: 17 tiles over 16 row splits of
    ceil(17 / 16) = 2 tiles leave the last splits empty, and their zero
    partials enter the reduce."""
    r = fused_mlp_ln_bwd_kernel_info(dtype)["weight_pass"]["rows"]
    assert r > 1
    m = {"1": 1, "R-1": r - 1, "R": r, "R+1": r + 1, "empty splits": 17 * r}[rows]
    if rows == "empty splits":
        splits = fused_mlp_ln_bwd_kernel_info(dtype, m, 512)["weight_pass"]["splits"]
        tiles = -(-m // r)
        assert (splits - 1) * -(-tiles // splits) >= tiles
    args = _mlp_args(cuda, m, dtype)
    g = torch.randn(m, 128, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_ln_bwd_kernel_nearly_constant_rows(cuda, dtype):
    """Rows 0.25 + 0.01 * noise: rstd ~ 100, so dx is ~100 times g's scale
    and the prologue's and the epilogue's LayerNorm statistics must agree.
    Here f32 itself loses about rstd times more of dx, so two f32 versions
    that sum in different orders can differ by more than the usual limit.
    So dx is held to float64 autograd of `fused_mlp_ln_reference` on the
    same inputs, within twice the f32 plain version's own distance from it
    and never looser than the usual limit; the parameter gradients to the
    f32 plain version at the usual limit."""
    m = 1377
    args = list(_mlp_args(cuda, m, dtype))
    noise = torch.randn(m, 128, device="cuda", generator=cuda)
    args[0] = (0.25 + 0.01 * noise).to(dtype)
    g = torch.randn(m, 128, device="cuda", generator=cuda).to(dtype)
    got = fused_mlp_ln_bwd(*args, g, 1e-5)
    again = fused_mlp_ln_bwd(*args, g, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    plain = fused_mlp_ln_bwd_reference(*(a.float() for a in args), g.float(), 1e-5)
    tol = TOL["fused_mlp_ln_bwd"][dtype]
    for a, w in zip(got[1:], plain[1:]):
        assert _sum_err(a, w) <= tol
    leaves = [a.detach().cpu().double().requires_grad_() for a in args]
    (exact,) = torch.autograd.grad(fused_mlp_ln_reference(*leaves, 1e-5), leaves[0],
                                   g.cpu().double())
    limit = max(tol, 2 * _scaled_err(plain[0].cpu(), exact))
    assert torch.isfinite(got[0]).all() and _scaled_err(got[0].cpu(), exact) <= limit


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_ln_bwd_kernel_one_hot_hidden(cuda, dtype):
    """Row i is 0.5 at channel k(i) and 0 elsewhere, so LN(x) is ~11.3 at
    k(i); W1 sends channel k to hidden unit u(k) alone, and b1 = -6 keeps
    every other unit's GELU' below 1e-7; W2 gives unit u a scale s(u) of
    its own, and g = ls2 = 1. So dz is one hot per row, s(u(k(i))) at
    u(k(i)), and da is one hot at channel k(i): dbeta[c], the dx pass's
    partial sums, is the number of rows with k(i) = c times s(u(c)). A
    permuted W1 chunk or dz exchange moves da to another channel."""
    c, hidden, m = 128, 512, 1377
    dev = "cuda"
    rows = torch.arange(m, device=dev)
    k = (7 * rows) % c
    unit = (3 * torch.arange(c, device=dev) + 1) % hidden  # distinct
    scale = (1 + torch.arange(hidden, device=dev) / hidden).to(dtype).float()
    x = torch.zeros(m, c, device=dev)
    x[rows, k] = 0.5
    w1 = torch.zeros(hidden, c, device=dev)
    w1[unit, torch.arange(c, device=dev)] = 1.0
    w2 = torch.zeros(c, hidden, device=dev)
    w2[(5 * torch.arange(hidden, device=dev) + 2) % c, torch.arange(hidden, device=dev)] = scale
    b1 = torch.full((hidden,), -6.0, device=dev)
    ones, zeros = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    args = (x.to(dtype), ones, zeros, w1.to(dtype), b1.to(dtype), w2.to(dtype),
            zeros.to(dtype), ones)
    got = _bwd_matches_plain(args, torch.ones(m, c, device=dev).to(dtype), dtype)
    expect = torch.bincount(k, minlength=c).float() * scale[unit]
    assert (got[2] - expect).abs().max() <= 1e-3 * expect.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_ln_bwd_weight_pass_one_hot(cuda, dtype):
    """Row i reaches one hidden unit through one channel: x is 0.5 at
    channel k(i) and beta cancels LN(x) elsewhere, so a is A = 0.5 rstd at
    k(i) alone; W1 sends channel k to unit u(k) alone and b1 = -6 keeps
    every other unit's GELU and GELU' below 4e-8; g is one hot at channel
    m(i), with k and m different functions of the row, and W2 (exact in
    bfloat16) has an entry of its own at each (channel, unit). So dW1 is
    nonzero only at (u(k), k), sum over the rows with k(i) = k of
    A GELU'(A - 6) W2[m(i), u(k)], and G = dW2 (ls2 = 1) only at
    (m(i), u(k(i))), GELU(A - 6) per row: a permuted hidden chunk, row or
    channel in the weight pass moves an entry."""
    c, hidden, m = 128, 512, 1377
    dev = "cuda"
    rows, chans = torch.arange(m, device=dev), torch.arange(c, device=dev)
    k, mi = (7 * rows) % c, (5 * rows + 3) % c
    unit = (3 * chans + 1) % hidden  # distinct
    w2 = 1 + ((5 * chans[:, None] + 3 * torch.arange(hidden, device=dev)) % 16) / 16
    x = torch.zeros(m, c, device=dev)
    x[rows, k] = 0.5
    # LayerNorm of a one-hot row in float64: xhat at k and elsewhere
    row = x[0].double()
    xhat = (row - row.mean()) / torch.sqrt(row.var(unbiased=False) + 1e-5)
    big, rest = xhat[k[0]].item(), xhat[(k[0] + 1) % c].item()
    w1 = torch.zeros(hidden, c, device=dev)
    w1[unit, chans] = 1.0
    ones = torch.ones(c, device=dev)
    args = (x.to(dtype), ones, torch.full((c,), -rest, device=dev), w1.to(dtype),
            torch.full((hidden,), -6.0, device=dev).to(dtype), w2.to(dtype),
            torch.zeros(c, device=dev).to(dtype), ones)
    g = torch.zeros(m, c, device=dev)
    g[rows, mi] = 1.0
    got = _bwd_matches_plain(args, g.to(dtype), dtype)
    z = torch.tensor(big - rest - 6.0, dtype=torch.float64)
    cdf = 0.5 * (1 + torch.erf(z / 2 ** 0.5))
    gelu, grad = (z * cdf).item(), (cdf + z * torch.exp(-z * z / 2) / (2 * torch.pi) ** 0.5).item()
    dz = w2.double()[mi, unit[k]] * grad  # a row's dz at its unit
    dw1 = torch.zeros(hidden, c, dtype=torch.float64, device=dev)
    dw1.index_put_((unit[k], k), dz * (big - rest), accumulate=True)
    gg = torch.zeros(c, hidden, dtype=torch.float64, device=dev)
    gg.index_put_((mi, unit[k]), torch.full((m,), gelu, dtype=torch.float64, device=dev),
                  accumulate=True)
    db1 = torch.zeros(hidden, dtype=torch.float64, device=dev)
    db1.index_put_((unit[k],), dz, accumulate=True)
    for name, a, want in (("dw1", got[3], dw1), ("db1", got[4], db1), ("dw2", got[5], gg)):
        err = (a.double() - want).abs().max() / want.abs().max()
        assert err <= 1e-3, f"{name}: {err.item():.2e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_match_plain_autograd(cuda, dtype):
    """Each Function's gradients (K2, K4) against autograd of its plain
    version on the same inputs, in float32 parameters as the model holds
    them; the outputs carry a grad_fn."""
    qkv = torch.randn(2, 27, 17, 384, device="cuda", generator=cuda).to(dtype)
    for fn, ref, tol in ((masked_sdpa, masked_sdpa_reference, "masked_sdpa_bwd"),):
        leaf = qkv.detach().float().requires_grad_()
        q, k, v = leaf.to(dtype).split(128, dim=-1)
        out = fn(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), 0.25, 8)
        assert out.grad_fn is not None
        g = torch.randn_like(out)
        (got,) = torch.autograd.grad(out, leaf, g)
        leaf2 = qkv.detach().float().requires_grad_()
        q2, k2, v2 = leaf2.split(128, dim=-1)
        out2 = ref(q2.transpose(1, 2), k2.transpose(1, 2), v2.transpose(1, 2), 0.25, 8)
        (want,) = torch.autograd.grad(out2, leaf2, g.float())
        assert _scaled_err(got, want) <= TOL[tol][dtype]
    args = _mlp_args(cuda, 1377, dtype)
    params = [a.detach().float().requires_grad_() for a in args[1:]]
    x = args[0].detach().float().requires_grad_()
    out = fused_mlp_ln(x.to(dtype).reshape(3, 27, 17, 128), *params)
    assert out.grad_fn is not None
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, [x, *params], g)
    assert all(t.dtype == torch.float32 for t in got)
    x2 = x.detach().requires_grad_()
    p2 = [p.detach().requires_grad_() for p in params]
    want_args = [x2.to(dtype).float()] + [p.to(dtype).float() if i in (2, 3, 4, 5)
                                          else p for i, p in enumerate(p2)]
    out2 = fused_mlp_ln_reference(want_args[0].reshape(3, 27, 17, 128), *want_args[1:])
    want = torch.autograd.grad(out2, [x2, *p2], g.float())
    tol = TOL["fused_mlp_ln_bwd"][dtype]
    assert _scaled_err(got[0], want[0]) <= tol
    for a, w in zip(got[1:], want[1:]):
        assert _sum_err(a, w) <= tol
