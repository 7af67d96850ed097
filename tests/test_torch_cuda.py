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
    masked_sdpa_bwd_kernel_info,
    masked_sdpa_bwd_reference,
    masked_sdpa_kernel_info,
    masked_sdpa_reference,
)
from kasportsformer_torch.ops.mlp import (
    _bwd_workspace_size,
    fused_mlp,
    fused_mlp_kernel_info,
    fused_mlp_ln,
    fused_mlp_ln_bwd,
    fused_mlp_ln_bwd_kernel_info,
    fused_mlp_ln_bwd_partition,
    fused_mlp_ln_bwd_reduce,
    fused_mlp_ln_bwd_reduce_reference,
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
# held against their largest entry), but K2 in bfloat16 at heads of 16 and
# K4 in bfloat16 at C = 128: their tensor-core kernels round P and dS (K2),
# LN(x), the hidden, do and dz (K4) to bfloat16 where the TPU kernels do, so
# there they are held to the plain version run in bfloat16, a gradient at a
# time (K2_BF16_D16, K4_BF16_C128), and K4's distance from the f32 plain
# version to twice that plain version's own.
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
@pytest.mark.parametrize("seqs", [1, 3, 3457])
@pytest.mark.parametrize("heads", [8, 16])
@pytest.mark.parametrize("n", [1, 17, 27, 32])
@pytest.mark.parametrize("view", ["strided", "permuted"])
def test_masked_sdpa_kernel_heads_of_8_sequence_counts(cuda, dtype, seqs, heads, n, view):
    """K1 at heads of 8 on odd counts of sequences (1, 3 and 3,457: a grid
    that walks no whole number of tiles a block), at 8 and 16 heads (one
    head group a sequence or two, each a tile of its own), at N its
    instantiations pad differently (1, 17, 27, 32), on column slices of one
    qkv projection and on their (B,T,J,C)->(B,J,T,C) permutation; against
    the plain version, and a rerun bitwise equal."""
    c = 8 * heads
    if view == "strided":
        q, k, v = torch.randn(1, seqs, n, 3 * c, device="cuda",
                              generator=cuda).to(dtype).split(c, dim=-1)
    else:
        q, k, v = (z.transpose(1, 2) for z in torch.randn(
            1, n, seqs, 3 * c, device="cuda", generator=cuda).to(dtype).split(c, dim=-1))
    before = masked_sdpa.launches
    got = masked_sdpa(q, k, v, 8 ** -0.5, heads)
    want = masked_sdpa_reference(q.float(), k.float(), v.float(), 8 ** -0.5, heads)
    assert masked_sdpa.launches == before + 1 and got.shape == q.shape
    assert (torch.isfinite(got).all()
            and _scaled_err(got, want) <= TOL["masked_sdpa"][dtype])
    assert torch.equal(got, masked_sdpa(q, k, v, 8 ** -0.5, heads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_sdpa_kernel_heads_of_8_instantiations(cuda, dtype):
    """K1 at heads of 8 in f32 has one instantiation a block of four rows N
    is padded to: a tile of one sequence's head group, its stages of N rows
    (a lane a head and pair of rows), a two-stage ring, at least one block a
    SM, no spill. bf16 at heads of 8 and every other width keep the
    128-channel (at heads of 8, 64-channel) tiles of 32 rows."""
    if dtype == torch.float32:
        for n in range(4, 33, 4):
            info = masked_sdpa_kernel_info(dtype, 8, n)
            assert (info["tile_rows"], info["stages"]) == (n, 2), info
            assert info["threads"] == 32 * -(-8 * n // 2 // 32), info
            assert info["spill_bytes"] == 0 and info["blocks_per_sm"] >= 1, info
            assert info["smem_bytes"] == 2 * 3 * n * (64 + 4) * 4, info
    for d in (8, 16, 32, 64) if dtype == torch.bfloat16 else (16, 32, 64):
        info = masked_sdpa_kernel_info(dtype, d)
        assert (info["tile_rows"], info["stages"], info["spill_bytes"]) == (32, 2, 0), info


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
    x, w = x[:, :64], w[:192, :64]  # K4 at C = 64 takes hidden multiples of 128
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


def _tiles_at_once(info, dtype, c: int) -> int:
    """Tiles the card takes at once: the blocks it holds at once over the
    blocks of a tile (a cluster of two blocks in float32 at C >= 256)."""
    i = info(dtype, c)
    return i["resident"] // i["cluster"]


def _walk_rows(info, dtype, c: int, walk: str) -> int:
    """M for a walk of K3's or K5's tiles, from the tile and the blocks the
    card holds at once as the library reports them: "three tiles a block"
    is three waves of tiles less half a tile (a persistent block or cluster
    walks exactly three, the last of them ragged), "a wave and a row" one
    wave of full tiles and a tile of one row (a persistent block or cluster
    walks it second). Checks the reported grid: float32's persistent blocks
    (C <= 128) and clusters (C >= 256) are at most one wave, bfloat16 a
    block a tile."""
    r, cluster = info(dtype, c)["rows"], info(dtype, c)["cluster"]
    wave = _tiles_at_once(info, dtype, c)
    m = 3 * wave * r - r // 2 if walk == "three tiles a block" else wave * r + 1
    tiles = -(-m // r)
    persistent = dtype == torch.float32
    assert info(dtype, c, m)["grid"] == (min(tiles, wave) * cluster if persistent else tiles)
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


def _k3_or_k5(kernel: str, args):
    """(kernel output, plain version in float32) of K3 or K5 on _mlp_args."""
    if kernel == "K3":
        return (fused_mlp_ln(*args, 1e-5),
                fused_mlp_ln_reference(*(a.float() for a in args), 1e-5))
    x, _, _, w1, b1, w2, b2, _ = args
    return (fused_mlp(x, w1, b1, w2, b2),
            fused_mlp_reference(*(a.float() for a in (x, w1, b1, w2, b2))))


@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("rows", ["under a tile", "clusters without a tile",
                                  "a row over whole tiles"])
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_fused_mlp_kernels_cluster_walks(cuda, c, rows, kernel):
    """float32 at C >= 256, where a cluster of two blocks takes a tile, each
    over half the channels: M under one tile (one cluster, ragged), a second
    round of tiles for half the clusters (the others leave after one tile),
    and a last tile of one row walked third by the first cluster."""
    info = fused_mlp_ln_kernel_info if kernel == "K3" else fused_mlp_kernel_info
    r, cluster = info(torch.float32, c)["rows"], info(torch.float32, c)["cluster"]
    assert cluster == 2
    wave = _tiles_at_once(info, torch.float32, c)
    m = {"under a tile": r - 37, "clusters without a tile": (wave + wave // 2) * r - 5,
         "a row over whole tiles": 2 * wave * r + 1}[rows]
    assert info(torch.float32, c, m)["grid"] == min(-(-m // r), wave) * cluster
    got, want = _k3_or_k5(kernel, _mlp_args(cuda, m, torch.float32, c, _HIDDEN[c]))
    name = "fused_mlp_ln" if kernel == "K3" else "fused_mlp"
    assert got.shape == (m, c)
    assert torch.isfinite(got).all() and _scaled_err(got, want) <= TOL[name][torch.float32]


@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("kernel", ["K3", "K5"])
def test_fused_mlp_kernels_one_hot_across_the_cluster(cuda, c, kernel):
    """float32 at C >= 256: row i is one-hot at input channel k = i mod C,
    in block k // (C / nb)'s slice (nb blocks a cluster, as the library
    reports); W1 sends channel k to one hidden unit u(k) whose column of its
    chunk the next block finishes, and W2 sends unit u to an output channel
    in the block after that one; b1 = -3 keeps every other unit near
    GELU(-3). So each row's dominant hidden value crosses the cluster twice
    (partial sums to u's block, the finished column to every block) and
    lands on a known channel: a slot, rank or column mixed up in either
    exchange shows as a wrong channel, not as rounding. Every slice, every
    finishing block and every output slice comes up in turn."""
    info = fused_mlp_ln_kernel_info if kernel == "K3" else fused_mlp_kernel_info
    hidden, m, nb = _HIDDEN[c], 777, info(torch.float32, c)["cluster"]
    assert nb > 1
    w, cs = 64 // nb, c // nb  # a chunk's columns a block finishes; its channels
    chunks = hidden // 64
    k = torch.arange(c, device="cuda")
    unit = 64 * (k % chunks) + w * ((k // cs + 1) % nb) + (k // chunks) % w
    u = torch.arange(hidden, device="cuda")
    out_ch = cs * (((u % 64) // w + 1) % nb) + (u // 8) % cs
    rows = torch.arange(m, device="cuda")
    x = torch.zeros(m, c, device="cuda")
    x[rows, rows % c] = 0.5 if kernel == "K3" else 8.0
    w1 = torch.zeros(hidden, c, device="cuda")
    w1[unit, k] = 1.0
    w2 = torch.zeros(c, hidden, device="cuda")
    w2[out_ch, u] = 1.0
    b1 = torch.full((hidden,), -3.0, device="cuda")
    ones, zeros = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
    got, want = _k3_or_k5(kernel, (x, ones, zeros, w1, b1, w2, zeros, ones))
    assert torch.equal(got.argmax(-1), out_ch[unit[rows % c]])
    name = "fused_mlp_ln" if kernel == "K3" else "fused_mlp"
    assert _scaled_err(got, want) <= TOL[name][torch.float32]


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
    _bwd_holds((q, k, v, g), 8, dtype)


def test_masked_sdpa_bwd_kernel_large_interhead_spread(cuda):
    q, k, v, g = (torch.randn(2, 4, 17, 128, device="cuda", generator=cuda)
                  for _ in range(4))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    for a, w in zip(masked_sdpa_bwd(q, k, v, g, 0.25, 8),
                    masked_sdpa_bwd_reference(q, k, v, g, 0.25, 8)):
        assert torch.isfinite(a).all() and _scaled_err(a, w) <= 1e-4


def _bwd_views(gen, b: int, g: int, n: int, heads: int, dtype, d: int = 16):
    """q, k, v as column slices of one qkv projection and the gradient a
    slice of a wider tensor, all permuted (B,T,J,C)->(B,J,T,C): four
    leading strides each, channel stride 1, as the model's temporal
    attention hands them over; heads of d channels."""
    c = d * heads
    qkv = torch.randn(b, n, g, 3 * c, device="cuda", generator=gen).to(dtype)
    gw = torch.randn(b, n, g, c + 16, device="cuda", generator=gen).to(dtype)
    return tuple(z.transpose(1, 2) for z in (*qkv.split(c, dim=-1), gw[..., 16:]))


# K2 in bfloat16 at heads of 16 against the plain version in bfloat16, dq, dk
# and dv each as a whole: mean |a - b| / mean |b| (_mean_err), where the
# kernel reads <= 2.1e-6 and K2 in float32 on the same values, rounding only
# its results, >= 1.59e-3 from N = 17 on (chip_smoke.K2_BF16_LIMITS, read by
# scripts/k2_bf16_limits.py); per element both lie within an ulp (1e-2)
K2_BF16_D16 = (1e-4, 1e-4, 1e-4)


def _mean_err(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float(), want.float()
    return ((g - w).abs().mean() / w.abs().mean().clamp(min=1e-30)).item()


def _bwd_holds(args, heads: int, dtype, scale: float = 0.25):
    """K2 once (one launch counted) against its plain version: in float32 on
    the same inputs, per element; in bfloat16 at heads of 16 (the
    tensor-core kernel, which rounds P and dS) the plain version run in
    bfloat16, per element within 1e-2 and each result's mean error within
    K2_BF16_D16. Returns K2's gradients."""
    n, d = args[0].shape[-2], args[0].shape[-1] // heads
    rounds = dtype == torch.bfloat16 and d == 16
    assert masked_sdpa_bwd_kernel_info(dtype, n, d=d)["mma"] == int(rounds)
    before = masked_sdpa_bwd.launches
    got = masked_sdpa_bwd(*args, scale, heads)
    assert masked_sdpa_bwd.launches == before + 1
    want = masked_sdpa_bwd_reference(*(args if rounds else (z.float() for z in args)),
                                     scale, heads)
    for i, (a, w) in enumerate(zip(got, want)):
        assert a.dtype == dtype and a.shape == args[0].shape and a.is_contiguous()
        assert torch.isfinite(a).all()
        assert _scaled_err(a, w) <= TOL["masked_sdpa_bwd"][dtype]
        if rounds:
            assert _mean_err(a, w) <= K2_BF16_D16[i], (i, _mean_err(a, w))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [8, 5, 1])
@pytest.mark.parametrize("n", [1, 2, 16, 17, 27, 32])
def test_masked_sdpa_bwd_kernel_rows_and_heads(cuda, dtype, heads, n):
    """Every N the 32-row stage pads (key and row blocks of four, a ragged
    last block, one row) at C = 128, 80 (a last head group of one head) and
    16, on strided, permuted views."""
    _bwd_holds(_bwd_views(cuda, 3, 5, n, heads, dtype), heads, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiles", ["one", "short last group", "a wave and one"])
def test_masked_sdpa_bwd_kernel_tiles_off_the_grid(cuda, dtype, tiles):
    """B G = 1 (one tile); 133 x 3 sequences of 6 heads (two head groups,
    the last of two heads); and one tile past the persistent grid that
    `masked_sdpa_bwd_kernel_info` reports, so one block walks two tiles
    and the ring refills a stage."""
    info = masked_sdpa_bwd_kernel_info(dtype, 27)
    assert info["spill_bytes"] == 0 and info["grid"] > 0
    assert info["mma"] == int(dtype == torch.bfloat16)  # masked_sdpa_bwd_mma_kernel
    b, g, heads = {"one": (1, 1, 8), "short last group": (133, 3, 6),
                   "a wave and one": (info["grid"] + 1, 1, info["tile_heads"])}[tiles]
    args = tuple(torch.randn(b, g, 27, 16 * heads, device="cuda", generator=cuda)
                 .to(dtype) for _ in range(4))
    _bwd_holds(args, heads, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_sdpa_bwd_kernel_one_hot_probabilities(cuda, dtype):
    """One key dominates each head (key 3h+1 of head h), so P is one-hot:
    dv of that key is the sum of g over the rows and every other key's dv
    is 0, dq and dk are (near) 0. A permutation of rows, keys or heads in
    the passes shows as a wrong row, not as a small error."""
    n, heads = 27, 8
    q = torch.rand(4, 3, n, 128, device="cuda", generator=cuda) + 0.5
    k = 0.01 * torch.randn(4, 3, n, 128, device="cuda", generator=cuda)
    v, g = (torch.randn(4, 3, n, 128, device="cuda", generator=cuda) for _ in range(2))
    keys = [(3 * h + 1) % n for h in range(heads)]
    for h, j in enumerate(keys):
        k[:, :, j, h * 16:(h + 1) * 16] = 20.0  # its logit >= 40 above the rest
    args = tuple(z.to(dtype) for z in (q, k, v, g))
    _, _, dv = _bwd_holds(args, heads, dtype)
    gf = args[3].float()
    for h, j in enumerate(keys):
        cols = slice(h * 16, (h + 1) * 16)
        want = torch.zeros_like(gf[..., cols])
        want[:, :, j] = gf[..., cols].sum(2)
        assert _scaled_err(dv[..., cols], want) <= TOL["masked_sdpa_bwd"][dtype]


@pytest.mark.parametrize("n", [2, 17, 27, 32])
def test_masked_sdpa_bwd_kernel_bf16_limits_fail_a_kernel_that_does_not_round(cuda, n):
    """The bfloat16 checks at heads of 16 tell a kernel that rounds P and dS
    from one that does not: K2 in float32 on the same values, its results
    rounded to bfloat16 (the CUDA-core kernel's numerics), lies over a
    K2_BF16_D16 limit of the plain version in bfloat16, where the kernel
    holds (strided, permuted views)."""
    args = _bwd_views(cuda, 8, 27, n, 8, torch.bfloat16)
    _bwd_holds(args, 8, torch.bfloat16)
    want = masked_sdpa_bwd_reference(*args, 0.25, 8)
    control = masked_sdpa_bwd(*(z.float() for z in args), 0.25, 8)
    means = [_mean_err(a.to(torch.bfloat16), w) for a, w in zip(control, want)]
    assert any(m > lim for m, lim in zip(means, K2_BF16_D16)), means


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_sdpa_bwd_kernel_reruns_bitwise_equal(cuda, dtype):
    """Every sum in a fixed order, no atomics: a rerun gives the same bits
    (the flagship's temporal views, more tiles than the grid)."""
    args = _bwd_views(cuda, 32, 17, 27, 8, dtype)
    got = _bwd_holds(args, 8, dtype)
    again = masked_sdpa_bwd(*args, 0.25, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))




# K4 in bfloat16 at C = 128 against the plain version in bfloat16, in the
# order of its gradients (dx, dgamma, dbeta, dW1, db1, dW2, db2, dls2): dx
# per element within an ulp of its bfloat16 (2^-7) and a margin; dW2 and
# db2, which the kernel takes from g and the plain version from do rounded
# to bfloat16, within that rounding (2^-8 of their largest entry); dgamma,
# dbeta, db1 and dls2 within 1e-3 of their largest entry and dW1 within
# 2e-3 (its sums over a few rows move by a flip of dz's rounding), where a
# kernel that does not round LN(x), the hidden, do and dz lands at 2.0e-3
# or more on each (chip_smoke.K4_BF16_LIMITS, read by
# scripts/k4_bf16_limits.py)
K4_BF16_C128 = (1e-2, 1e-3, 1e-3, 2e-3, 1e-3, 2 ** -8, 2 ** -8, 1e-3)


def _grad_errs(got, want) -> list[float]:
    """K4's eight gradients against want's: dx per element, the parameter
    gradients against their largest entry."""
    return [_scaled_err(got[0], want[0])] + [_sum_err(a, w) for a, w in zip(got[1:], want[1:])]


def _bwd_matches_plain(args, g, dtype, eps: float = 1e-5) -> tuple[torch.Tensor, ...]:
    """K4 once (one launch counted) against its plain version in float32 on
    the same inputs (in bfloat16 at C = 128, the tensor-core passes: the
    plain version run in bfloat16 at K4_BF16_C128's limits, and within twice
    its distance from the float32 plain version): dx per element, the
    parameter gradients against their largest entry; a rerun bitwise equal
    (no atomics). Returns K4's gradients."""
    before = fused_mlp_ln_bwd.launches
    got = fused_mlp_ln_bwd(*args, g, eps)
    assert fused_mlp_ln_bwd.launches == before + 1
    exact = fused_mlp_ln_bwd_reference(*(a.float() for a in args), g.float(), eps)
    mma = dtype == torch.bfloat16 and args[0].shape[-1] == 128
    want = fused_mlp_ln_bwd_reference(*args, g, eps) if mma else exact
    tol = TOL["fused_mlp_ln_bwd"][dtype]
    assert got[0].dtype == dtype and torch.isfinite(got[0]).all()
    assert all(a.dtype == torch.float32 for a in got[1:])
    errs = _grad_errs(got, want)
    assert all(e <= lim for e, lim in zip(errs, K4_BF16_C128 if mma else [tol] * 8)), errs
    if mma:
        assert max(_grad_errs(got, exact)) <= 2 * max(_grad_errs(want, exact))
    again = fused_mlp_ln_bwd(*args, g, eps)
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
    f32 plain version at the usual limit. In bfloat16 the tensor-core
    passes round LN(x), the hidden, do and dz as the TPU kernel does, and
    rstd times that rounding reaches dx; the plain version run in bfloat16
    rounds alike, so all eight gradients are held to it directly: the
    parameter gradients at K4_BF16_C128's limits, dx within 1e-2 of its
    largest entry and per element, scaled by max(1, |y|), within 0.2. A sum
    order that moves a value of dz or LN(x) across a rounding edge moves its
    row's dx by rstd times that ulp (up to 0.1 per element, 4.8e-3 of the
    largest entry, on the card); a kernel that does not round is 0.44 per
    element away (scripts/k4_bf16_limits.py)."""
    m = 1377
    args = list(_mlp_args(cuda, m, dtype))
    noise = torch.randn(m, 128, device="cuda", generator=cuda)
    args[0] = (0.25 + 0.01 * noise).to(dtype)
    g = torch.randn(m, 128, device="cuda", generator=cuda).to(dtype)
    got = fused_mlp_ln_bwd(*args, g, 1e-5)
    again = fused_mlp_ln_bwd(*args, g, 1e-5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.isfinite(got[0]).all()
    if dtype == torch.bfloat16:
        plain = fused_mlp_ln_bwd_reference(*args, g, 1e-5)
        errs = _grad_errs(got, plain)
        assert errs[0] <= 0.2 and _sum_err(got[0], plain[0]) <= 1e-2, errs
        assert all(e <= lim for e, lim in zip(errs[1:], K4_BF16_C128[1:])), errs
        return
    plain = fused_mlp_ln_bwd_reference(*(a.float() for a in args), g.float(), 1e-5)
    tol = TOL["fused_mlp_ln_bwd"][dtype]
    for a, w in zip(got[1:], plain[1:]):
        assert _sum_err(a, w) <= tol
    leaves = [a.detach().cpu().double().requires_grad_() for a in args]
    (exact,) = torch.autograd.grad(fused_mlp_ln_reference(*leaves, 1e-5), leaves[0],
                                   g.cpu().double())
    limit = max(tol, 2 * _scaled_err(plain[0].cpu(), exact))
    assert _scaled_err(got[0].cpu(), exact) <= limit


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
    channel in the weight pass moves an entry. In bfloat16 the tensor-core
    passes round A, GELU(A - 6) and dz to bfloat16 (db1 sums dz before
    that), and so does the expected value."""
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

    def rounded(v: torch.Tensor) -> torch.Tensor:  # where the bf16 passes round
        return v.to(torch.bfloat16).double() if dtype == torch.bfloat16 else v

    a_k = rounded(torch.tensor(big - rest, dtype=torch.float64))
    z = a_k - 6.0
    cdf = 0.5 * (1 + torch.erf(z / 2 ** 0.5))
    gelu = rounded(z * cdf).item()
    grad = (cdf + z * torch.exp(-z * z / 2) / (2 * torch.pi) ** 0.5).item()
    dz = w2.double()[mi, unit[k]] * grad  # a row's dz at its unit
    dw1 = torch.zeros(hidden, c, dtype=torch.float64, device=dev)
    dw1.index_put_((unit[k], k), rounded(dz) * a_k.item(), accumulate=True)
    gg = torch.zeros(c, hidden, dtype=torch.float64, device=dev)
    gg.index_put_((mi, unit[k]), torch.full((m,), gelu, dtype=torch.float64, device=dev),
                  accumulate=True)
    db1 = torch.zeros(hidden, dtype=torch.float64, device=dev)
    db1.index_put_((unit[k],), dz, accumulate=True)
    for name, a, want in (("dw1", got[3], dw1), ("db1", got[4], db1), ("dw2", got[5], gg)):
        err = (a.double() - want).abs().max() / want.abs().max()
        assert err <= 1e-3, f"{name}: {err.item():.2e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,hidden", [(14688, 512), (1377, 512), (58752, 64),
                                      (1377, 192), (300, 2048)])
def test_fused_mlp_ln_bwd_reduce_alone_bitwise_plain(cuda, dtype, m, hidden):
    """K4's reduce alone on seeded partials against its plain version on the
    card: dgamma, dbeta, dw1, db1, dw2 and db2 bit for bit (both sum in
    index order), dls2 (grouped otherwise) within K4's limit against its
    largest entry; a rerun bitwise equal. The step's M = 14,688 at H = 512
    (2 G rows a channel block); M = 1,377 (16 splits of 3 tiles, the last
    four empty); H = 64 (8 rows a block, 132 splits; 132 tiles restage the
    dx partials, 168 at a time, at M = 58,752); H = 192 (5 rows a block, the
    last block 3);
    H = 2048 (a row of 512 float4s a block, two a thread)."""
    p = fused_mlp_ln_bwd_partition(m, hidden)
    n = p["dx_tiles"] * 3 * 128 + p["splits"] * (2 * hidden * 128 + hidden)
    work = torch.randn(n, device="cuda", generator=cuda)
    w2 = torch.randn(128, hidden, device="cuda", generator=cuda).to(dtype)
    b2 = torch.randn(128, device="cuda", generator=cuda).to(dtype)
    ls2 = torch.rand(128, device="cuda", generator=cuda)
    before = fused_mlp_ln_bwd_reduce.launches
    got = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    assert fused_mlp_ln_bwd_reduce.launches == before + 1
    want = fused_mlp_ln_bwd_reduce_reference(work, w2, b2, ls2, m)
    names = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, a, w in zip(names, got, want):
        assert a.dtype == torch.float32 and torch.equal(a, w), name
    assert _sum_err(got[6], want[6]) <= TOL["fused_mlp_ln_bwd"][dtype]
    again = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_fused_mlp_ln_bwd_partition_matches_library(cuda):
    """The Python mirror of K4's partition against the library's: both
    passes' tiles, the weight pass's splits and the workspace's size at
    several M and H; the reduce's instantiation without spills in either
    dtype; a workspace of another size is refused."""
    for m in (1, 40, 300, 1377, 14688, 58752):
        for hidden in (64, 128, 192, 512, 1024, 2048):
            p = fused_mlp_ln_bwd_partition(m, hidden)
            for dtype in (torch.float32, torch.bfloat16):  # bf16: the tensor-core passes
                info = fused_mlp_ln_bwd_kernel_info(dtype, m, hidden)
                assert (p["dx_rows"], p["w_rows"], p["splits"]) == (
                    info["dx_pass"]["rows"], info["weight_pass"]["rows"],
                    info["weight_pass"]["splits"]), (m, hidden, dtype)
            assert _bwd_workspace_size(m, hidden) == (
                p["dx_tiles"] * 3 * 128 + p["splits"] * (2 * hidden * 128 + hidden))
    for dtype in (torch.float32, torch.bfloat16):
        red = fused_mlp_ln_bwd_kernel_info(dtype)["reduce"]
        assert red["spill_bytes"] == 0 and red["registers"] > 0, red
        assert red["blocks"] <= 132 * red["blocks_per_sm"], red
    w2 = torch.zeros(128, 512, device="cuda")
    with pytest.raises(ValueError, match="workspace"):
        fused_mlp_ln_bwd_reduce(torch.zeros(10, device="cuda"), w2, w2[:, 0], w2[:, 0], 8)


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


# ------------------------------------------------------------ the zoo's training widths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["D8 spatial", "D8 temporal", "D32 flat", "D32 grouped",
                                  "D64 flat", "D64 temporal"])
def test_masked_sdpa_bwd_kernel_zoo_widths(cuda, dtype, name):
    """K2 at the zoo's heads, as its models hand them over at batch 4:
    MotionAGFormer-XS's and hierarchical's 8 heads of 8 (C = 64) on
    (B, T, J, C) and on its (B, J, T, C) permutation with a transposed
    gradient; DSTFormer's 8 heads of 32 (C = 256) on the flat (B*F, J, C)
    stream (entering as (1, M, N, C)) and on the grouped (B, J, F, C) view of
    its temporal attention with a transposed gradient, MixSTE's 8 heads of 64
    (C = 512) on flat spatial and temporal streams; column slices of one qkv
    projection; a rerun bitwise equal."""
    d = int(name.split()[0][1:])
    c, b = 8 * d, 4
    shape = {"D8 spatial": (b, 27, 17), "D8 temporal": (b, 27, 17),
             "D32 flat": (1, b * 27, 17), "D32 grouped": (b, 27, 17),
             "D64 flat": (1, b * 27, 17), "D64 temporal": (1, b * 17, 27)}[name]
    qkv = torch.randn(*shape, 3 * c, device="cuda", generator=cuda).to(dtype)
    g = torch.randn(*shape, c, device="cuda", generator=cuda).to(dtype)
    q, k, v = qkv.split(c, dim=-1)
    if name in ("D32 grouped", "D8 temporal"):
        q, k, v, g = (z.transpose(1, 2) for z in (q, k, v, g))
    got = _bwd_holds((q, k, v, g), 8, dtype, d ** -0.5)
    again = masked_sdpa_bwd(q, k, v, g, d ** -0.5, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,heads", [(8, 8), (8, 5), (8, 12), (32, 8), (32, 3), (64, 8),
                                     (64, 1)])
@pytest.mark.parametrize("n", [1, 2, 16, 17, 27, 32])
def test_masked_sdpa_bwd_kernel_rows_and_wide_heads(cuda, dtype, d, heads, n):
    """Every N the stage pads at heads of 8 (C = 64; C = 40, a short group
    of five of the 64-channel tile's eight heads; C = 96, a group of eight
    then one of four), 32 (C = 256, and C = 96: a last head group of one
    head) and 64 (C = 512 and one head), on strided, permuted views: a lane
    of pass 1 takes keys kl + 4 (D / 16) k (kl + 4 k at D = 8), so every key
    block and padded key is covered; at D = 8 the stage holds the
    instantiation's 4 NB rows."""
    _bwd_holds(_bwd_views(cuda, 3, 5, n, heads, dtype, d), heads, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 64])
def test_masked_sdpa_bwd_kernel_wide_heads_walk_the_grid(cuda, dtype, d):
    """One tile past the persistent grid at heads of 8, 32 and 64, so one
    block walks two tiles and the ring refills a stage; no instantiation
    spills. A tile is 64 channels: eight heads at D = 8, whose 28-row
    buffers leave two blocks a SM."""
    info = masked_sdpa_bwd_kernel_info(dtype, 27, d=d)
    assert info["spill_bytes"] == 0 and info["tile_heads"] == 64 // d, info
    assert d != 8 or (info["tile_rows"] == 28 and info["blocks_per_sm"] >= 2), info
    args = tuple(torch.randn(info["grid"] + 1, 1, 27, d * info["tile_heads"],
                             device="cuda", generator=cuda).to(dtype) for _ in range(4))
    _bwd_holds(args, info["tile_heads"], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,hidden,eps", [(64, 256, 1e-5), (256, 1024, 1e-5),
                                          (512, 1024, 1e-6)])
@pytest.mark.parametrize("m", [14688, 1377, 5])
def test_fused_mlp_ln_bwd_kernel_zoo_widths(cuda, dtype, c, hidden, eps, m):
    """K4 at MotionAGFormer-XS's and hierarchical's 64/256, DSTFormer's
    256/1024 and MixSTE's 512/1024 (LayerNorm eps 1e-6): the train step's
    M = 14,688, a ragged 1,377 and 5 rows; all eight gradients against the
    plain version, a rerun bitwise equal."""
    args = _mlp_args(cuda, m, dtype, c, hidden)
    g = torch.randn(m, c, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype, eps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [64, 256, 512])
@pytest.mark.parametrize("edge", ["dx R-1", "dx R+1", "w R-1", "w R", "w R+1",
                                  "split-1", "split+1", "empty splits"])
def test_fused_mlp_ln_bwd_kernel_zoo_tile_edges(cuda, dtype, c, edge):
    """Each pass's tile of R rows at the zoo's widths (112, 112 and 56 rows in
    the dx pass's tile at C = 64, 256 and 512, 56, 48 and 32 in the weight
    pass's) and one row either side; one row either side of the weight
    pass's splits of one tile each at H = 1,024 (16 splits at C = 64, 4 at
    256, 2 at 512: the last tile of one more split holds a row, and a
    trailing split is empty); and 17 weight-pass tiles over the 16 row
    splits of 8 blocks a split (hidden chunks of 128 at C = 64, H = 1,024;
    4 chunks of clusters of two, H = 256 at C = 256, 128 at 512): the last
    splits' blocks stay without rows and their zero partials enter the
    reduce."""
    cluster = 1 if c == 64 else 2
    hidden = 8 * (8192 * cluster // c) // cluster if edge == "empty splits" else 1024
    info = fused_mlp_ln_bwd_kernel_info(dtype, 14688, hidden, c=c)
    r_dx, r_w = info["dx_pass"]["rows"], info["weight_pass"]["rows"]
    n = fused_mlp_ln_bwd_partition(10 ** 6, hidden, c)["splits"]  # as many as the card takes
    m = {"dx R-1": r_dx - 1, "dx R+1": r_dx + 1, "w R-1": r_w - 1, "w R": r_w,
         "w R+1": r_w + 1, "split-1": n * r_w - 1, "split+1": n * r_w + 1,
         "empty splits": 17 * r_w}[edge]
    if edge == "empty splits":
        p = fused_mlp_ln_bwd_partition(m, hidden, c)
        assert p["splits"] == 16 and info["weight_pass"]["cluster"] == cluster, (p, info)
        assert (p["splits"] - 1) * p["per_split"] >= -(-m // r_w), p
    args = _mlp_args(cuda, m, dtype, c, hidden)
    g = torch.randn(m, c, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,hidden,c", [(14688, 1024, 256), (14688, 1024, 512),
                                        (1377, 64, 512), (300, 2048, 256),
                                        (14688, 256, 64), (1377, 2048, 64)])
def test_fused_mlp_ln_bwd_reduce_alone_bitwise_plain_zoo_widths(cuda, dtype, m, hidden, c):
    """K4's reduce alone at C = 64, 256 and 512 on seeded partials against
    its plain version: six gradients bit for bit, dls2 within K4's limit, a
    rerun bitwise equal; at 256 a hidden block's eight dW1 rows are two
    float4s a thread, at 512 the grid of equal blocks takes H = 64 (33
    splits, five mbarriers a part, db1 in sixteen blocks) and 1,024, at 64
    the segment grid takes H = 256 and 2,048 (8 splits, a G row of 512
    float4s, 16 a lane)."""
    p = fused_mlp_ln_bwd_partition(m, hidden, c)
    n = p["dx_tiles"] * 3 * c + p["splits"] * (2 * hidden * c + hidden)
    work = torch.randn(n, device="cuda", generator=cuda)
    w2 = torch.randn(c, hidden, device="cuda", generator=cuda).to(dtype)
    b2 = torch.randn(c, device="cuda", generator=cuda).to(dtype)
    ls2 = torch.rand(c, device="cuda", generator=cuda)
    got = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    want = fused_mlp_ln_bwd_reduce_reference(work, w2, b2, ls2, m)
    for a, w in zip(got[:6], want[:6]):
        assert torch.equal(a, w)
    assert _sum_err(got[6], want[6]) <= TOL["fused_mlp_ln_bwd"][dtype]
    again = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [14688, 1377, 5])
def test_fused_mlp_ln_bwd_reduce_c64_segments(cuda, dtype, m):
    """K4's reduce alone at MotionAGFormer-XS's and hierarchical's 64/256 (its
    segment grid: a block a G row, H floats of dW1 or a quarter of db1, every
    split's segment by bulk copies) on seeded partials of the train step's 14,688
    rows (66 splits), a ragged 1,377 and 5 rows (one split, one dx tile):
    dgamma, dbeta, dw1, db1, dw2 and db2 bit for bit against the plain
    version, dls2 within K4's limit, a rerun bitwise equal; no spill, and a
    grid that covers the SMs."""
    p = fused_mlp_ln_bwd_partition(m, 256, 64)
    work = torch.randn(_bwd_workspace_size(m, 256, 64), device="cuda", generator=cuda)
    w2 = torch.randn(64, 256, device="cuda", generator=cuda).to(dtype)
    b2 = torch.randn(64, device="cuda", generator=cuda).to(dtype)
    ls2 = torch.rand(64, device="cuda", generator=cuda)
    got = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    want = fused_mlp_ln_bwd_reduce_reference(work, w2, b2, ls2, m)
    names = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, a, w in zip(names, got, want):
        assert a.dtype == torch.float32 and torch.equal(a, w), name
    assert _sum_err(got[6], want[6]) <= TOL["fused_mlp_ln_bwd"][torch.float32]
    again = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    red = fused_mlp_ln_bwd_kernel_info(dtype, m, 256, c=64)["reduce"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert red["spill_bytes"] == 0 and red["registers"] > 0, red
    assert red["blocks"] == 2 * 64 + 4 >= sms, red
    assert red["smem_bytes"] >= p["splits"] * 256 * 4, (red, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [31, 33, 55, 57, 63, 65, 14688])
def test_fused_mlp_ln_bwd_reduce_c512_blocks(cuda, dtype, m):
    """K4's reduce alone at MixSTE's and D3DP's 512/1024 (its grid of 128
    equal blocks: four G rows, 4 H floats of dW1 and eight of db1 each, every
    split's share and the block's W2 rows by bulk copies, the dx partials of
    its four channels by cp.async) on seeded partials of the ragged M of the
    plain version's CPU checks (one row either side of a 32-row weight-pass
    tile, of a 56-row dx tile and of two splits of one tile) and the train
    step's 14,688: dgamma, dbeta, dw1, db1, dw2 and db2 bit for bit against
    the plain version, dls2 within K4's limit, a rerun bitwise equal; no
    spill, 128 blocks."""
    p = fused_mlp_ln_bwd_partition(m, 1024, 512)
    n = p["dx_tiles"] * 3 * 512 + p["splits"] * (2 * 1024 * 512 + 1024)  # no stage weights
    work = torch.randn(n, device="cuda", generator=cuda)
    w2 = torch.randn(512, 1024, device="cuda", generator=cuda).to(dtype)
    b2 = torch.randn(512, device="cuda", generator=cuda).to(dtype)
    ls2 = torch.rand(512, device="cuda", generator=cuda)
    got = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    want = fused_mlp_ln_bwd_reduce_reference(work, w2, b2, ls2, m)
    names = ("dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, a, w in zip(names, got, want):
        assert a.dtype == torch.float32 and torch.equal(a, w), name
    assert _sum_err(got[6], want[6]) <= TOL["fused_mlp_ln_bwd"][torch.float32]
    again = fused_mlp_ln_bwd_reduce(work, w2, b2, ls2, m)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    red = fused_mlp_ln_bwd_kernel_info(dtype, m, 1024, c=512)["reduce"]
    assert red["spill_bytes"] == 0 and red["registers"] > 0, red
    assert red["blocks"] == 128, red
    assert red["smem_bytes"] >= p["splits"] * 8 * 1024 * 4, (red, p)


def test_fused_mlp_ln_bwd_partition_matches_library_at_zoo_widths(cuda):
    """The Python mirror of K4's partition at C = 256 and 512 against the
    library's, and the workspace's size (the partials, then the stage
    launch's float32 weights); the dx pass runs clusters of two, at most as
    many as the card holds, each walking tiles; the weight pass clusters of
    two, a (hidden chunk, row split) each, at most one block a SM; no pass
    spills at either width."""
    for c in (256, 512):
        for m in (1, 300, 1377, 14688):
            for hidden in (64, 512, 1024, 2048):
                p = fused_mlp_ln_bwd_partition(m, hidden, c)
                info = fused_mlp_ln_bwd_kernel_info(torch.float32, m, hidden, c=c)
                assert (p["dx_rows"], p["w_rows"], p["splits"]) == (
                    info["dx_pass"]["rows"], info["weight_pass"]["rows"],
                    info["weight_pass"]["splits"]), (c, m, hidden)
                assert _bwd_workspace_size(m, hidden, c) == (
                    p["dx_tiles"] * 3 * c + p["splits"] * (2 * hidden * c + hidden)
                    + p["stage"])
                dx, wp = info["dx_pass"], info["weight_pass"]
                assert dx["cluster"] == 2 and dx["resident"] >= 1, dx
                assert dx["grid"] == 2 * min(p["dx_tiles"], dx["resident"]), dx
                assert wp["cluster"] == 2 and wp["resident"] >= 1, wp
                assert wp["grid"] == 2 * hidden // wp["chunk"] * p["splits"] <= 132, wp
        for dtype in (torch.float32, torch.bfloat16):
            for launch in fused_mlp_ln_bwd_kernel_info(dtype, 14688, 1024, c=c).values():
                assert launch["spill_bytes"] == 0 and launch["registers"] > 0, launch


def test_fused_mlp_ln_bwd_partition_matches_library_at_c64(cuda):
    """The Python mirror of K4's partition at C = 64 against the library's,
    and the workspace's size (the partials; no stage launch): one block a
    dx tile, one a (hidden chunk of 128, row split) in the weight pass, one
    wave; no launch spills in either dtype."""
    for m in (1, 56, 300, 1377, 14688):
        for hidden in (128, 256, 1024, 2048):
            p = fused_mlp_ln_bwd_partition(m, hidden, 64)
            info = fused_mlp_ln_bwd_kernel_info(torch.float32, m, hidden, c=64)
            assert (p["dx_rows"], p["w_rows"], p["splits"]) == (
                info["dx_pass"]["rows"], info["weight_pass"]["rows"],
                info["weight_pass"]["splits"]), (m, hidden)
            assert p["stage"] == 0 and _bwd_workspace_size(m, hidden, 64) == (
                p["dx_tiles"] * 3 * 64 + p["splits"] * (2 * hidden * 64 + hidden))
            dx, wp = info["dx_pass"], info["weight_pass"]
            assert dx["cluster"] == 1 and dx["grid"] == p["dx_tiles"], dx
            assert wp["cluster"] == 1 and wp["chunk"] == 128, wp
            assert wp["grid"] == hidden // 128 * p["splits"] <= 132, wp
    for dtype in (torch.float32, torch.bfloat16):
        for launch in fused_mlp_ln_bwd_kernel_info(dtype, 14688, 256, c=64).values():
            assert launch["spill_bytes"] == 0 and launch["registers"] > 0, launch


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 111, 112, 113, 1377, 14688])
def test_fused_mlp_ln_bwd_c64_warp_groups_match_plain(cuda, dtype, m):
    """K4 at MotionAGFormer's C/H = 64/256, whose dx pass runs two warp
    groups over hidden halves: one row, the dx pass's 112-row tile and one
    row either side, a ragged 1,377 and the train step's 14,688; all eight
    gradients against the plain version in float32, a rerun bitwise equal."""
    args = _mlp_args(cuda, m, dtype, 64, 256)
    g = torch.randn(m, 64, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden", [128, 2048])
def test_fused_mlp_ln_bwd_c64_warp_groups_hidden_widths(cuda, dtype, hidden):
    """The warp groups' halves at the least hidden width C = 64 takes (two
    chunks of 32 a group) and the most (32 a group), M = 1,377."""
    args = _mlp_args(cuda, 1377, dtype, 64, hidden)
    g = torch.randn(1377, 64, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


def test_fused_mlp_ln_bwd_c64_dx_pass_instantiation(cuda):
    """The C = 64 dx pass as the runtime reports it: 256 threads in two warp
    groups, 112-row tiles, one block a tile and a SM, no spills."""
    for dtype in (torch.float32, torch.bfloat16):
        dx = fused_mlp_ln_bwd_kernel_info(dtype, 14688, 256, c=64)["dx_pass"]
        assert (dx["threads"], dx["groups"], dx["rows"], dx["blocks_per_sm"]) == (
            256, 2, 112, 1), dx
        assert dx["spill_bytes"] == 0 and dx["grid"] == 132, dx


def test_fused_mlp_ln_bwd_c64_weight_pass_instantiation(cuda):
    """The C = 64 weight pass as the runtime reports it: 256 threads on the
    tensor cores (8 warps, one m16 tile of the chunk's 128 hidden columns
    each), 56-row tiles, one block a (chunk, split) and a SM, one wave of
    2 x 66 blocks at H = 256, no spills."""
    for dtype in (torch.float32, torch.bfloat16):
        wp = fused_mlp_ln_bwd_kernel_info(dtype, 14688, 256, c=64)["weight_pass"]
        assert (wp["threads"], wp["rows"], wp["chunk"], wp["blocks_per_sm"]) == (
            256, 56, 128, 1), wp
        assert wp["spill_bytes"] == 0 and wp["grid"] == 132, wp


def test_fused_mlp_ln_bwd_c128_bf16_instantiations(cuda):
    """bf16 at C = 128 as the runtime reports it: the tensor-core dx pass,
    224 threads (7 warps of 16 rows) on the 112-row tiles, one block a tile
    and a SM; the tensor-core weight pass, 256 threads a (chunk of 64, split)
    over the partition's 40-row tiles, one block a SM; no spills in either."""
    info = fused_mlp_ln_bwd_kernel_info(torch.bfloat16, 14688, 512)
    dx, wp = info["dx_pass"], info["weight_pass"]
    assert (dx["threads"], dx["rows"], dx["blocks_per_sm"], dx["grid"]) == (224, 112, 1, 132), dx
    assert (wp["threads"], wp["rows"], wp["chunk"], wp["splits"], wp["blocks_per_sm"]) == (
        256, 40, 64, 16, 1), wp
    assert dx["spill_bytes"] == 0 and wp["spill_bytes"] == 0, info


@pytest.mark.parametrize("m", [63, 65, 129, 680, 5121])
def test_fused_mlp_ln_bwd_c128_bf16_weight_steps(cuda, m):
    """The bf16 weight pass walks a split's rows in 64-row steps, the last
    ragged: one row either side of a step (63, 65), a step and one row
    (129), splits of 80 rows (680: 17 tiles of 40 over splits of two) and
    of 360 (5,121: 129 tiles over splits of nine, five steps and 40 rows)."""
    args = _mlp_args(cuda, m, torch.bfloat16)
    g = torch.randn(m, 128, device="cuda", generator=cuda).to(torch.bfloat16)
    _bwd_matches_plain(args, g, torch.bfloat16)


def test_fused_mlp_ln_bwd_zoo_digests_unchanged(cuda):
    """K4 at DSTFormer's 256/1024 and MixSTE's 512/1024 computes bit for bit
    what it computed before the C = 64 dx pass became two warp groups: SHA-1
    of the eight gradients on the seeded inputs of `scripts/torch_ab.sh
    digest` (an H100; the CUDA generator's stream), in both dtypes."""
    import hashlib

    want = {(256, torch.float32): "1bf4c3548f34 d170944d38a6 b57c5514f154 960840dd15d8 "
                                  "afe897b16613 db734215e7d2 c530f5618a7d 02ed10f17acb",
            (256, torch.bfloat16): "55d8e5ce63d8 096831a55dc5 1c48c9d59239 665657aba375 "
                                   "35a7f82c2d8c 8c25a5f4ea32 3a767d005889 dc605b901c14",
            (512, torch.float32): "970ed3af13d7 c6d7adc49751 d58a45cb3ca9 77758814a2aa "
                                  "34e8cba4eb00 98a3b1c5aaf2 c6426c40d1ae 0a9ffc010118",
            (512, torch.bfloat16): "5fdcfa21cfec 270ed6936690 4f3bc7777a33 56cb01677628 "
                                   "b8d88ef80c71 270d325c6e9e 2591141c9372 b438502dab92"}
    gen = torch.Generator(device="cuda").manual_seed(10)
    for c, h, eps in ((256, 1024, 1e-5), (512, 1024, 1e-6)):
        for dt in (torch.float32, torch.bfloat16):
            def randn(*shape, scale=1.0):
                return scale * torch.randn(*shape, device="cuda", generator=gen)
            x, g = randn(14688, c).to(dt), randn(14688, c).to(dt)
            args = (x, 1 + randn(c, scale=0.1), randn(c, scale=0.1),
                    randn(h, c, scale=c ** -0.5).to(dt), randn(h, scale=0.1).to(dt),
                    randn(c, h, scale=h ** -0.5).to(dt), randn(c, scale=0.1).to(dt),
                    torch.rand(c, device="cuda", generator=gen))
            out = fused_mlp_ln_bwd(*args, g, eps)
            got = " ".join(hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]
                           for t in out)
            assert got == want[(c, dt)], (c, dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("edge", ["one wave", "one tile more"])
def test_fused_mlp_ln_bwd_kernel_zoo_wave_edges(cuda, dtype, c, edge):
    """The cluster dx pass at exactly as many tiles as clusters the card
    holds at once (each cluster one tile), and one tile more (one cluster
    walks two, its weights streaming on across the tiles): all eight
    gradients against the plain version, a rerun bitwise equal."""
    info = fused_mlp_ln_bwd_kernel_info(dtype, 14688, 1024, c=c)["dx_pass"]
    tiles = info["resident"] + (edge == "one tile more")
    m = tiles * info["rows"]
    assert fused_mlp_ln_bwd_partition(m, 1024, c)["dx_tiles"] == tiles
    args = _mlp_args(cuda, m, dtype, c, 1024)
    g = torch.randn(m, c, device="cuda", generator=cuda).to(dtype)
    _bwd_matches_plain(args, g, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,eps", [(64, 1e-5), (256, 1e-5), (512, 1e-6)])
def test_fused_mlp_ln_bwd_zoo_reruns_bitwise_equal(cuda, dtype, c, eps):
    """K4 at the zoo's widths and the train step's M = 14,688, H = 1,024:
    three runs give all eight gradients bit for bit (the weight pass's
    clusters add the two blocks' partial sums in rank order, each split's
    partial has one writer, and the reduce sums them in index order)."""
    args = _mlp_args(cuda, 14688, dtype, c, 1024)
    g = torch.randn(14688, c, device="cuda", generator=cuda).to(dtype)
    first = fused_mlp_ln_bwd(*args, g, eps)
    for _ in range(2):
        again = fused_mlp_ln_bwd(*args, g, eps)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_fused_mlp_ln_bwd_c128_digests_unchanged(cuda):
    """The flagship's K4 (C = 128) computes bit for bit what it computed
    before its launches became templates on C (in bfloat16: since its two
    passes moved to the tensor cores, which round LN(x), the hidden, do and
    dz to bfloat16): SHA-1 of dx, dgamma, dbeta, dw1, db1, dw2 and db2 on
    the seeded inputs of `scripts/torch_ab.sh digest` (an H100; the CUDA
    generator's stream), in both dtypes."""
    import hashlib

    want = {torch.float32: "58156b444940 8096f000dc3e 79a2cd00ff2b c32c2aeb5932 "
                           "f5be679db688 1847d887a6fd 759b064cbe19",
            torch.bfloat16: "fc7c02ccc4c3 c2adb69612cc 8b806c6fcd31 475406a19829 "
                            "3ec28cd956f4 76cf961ed755 e03611052c51"}
    gen = torch.Generator(device="cuda").manual_seed(9)
    for dt in (torch.float32, torch.bfloat16):
        def randn(*shape, scale=1.0):
            return scale * torch.randn(*shape, device="cuda", generator=gen)
        x, g = randn(14688, 128).to(dt), randn(14688, 128).to(dt)
        args = (x, 1 + randn(128, scale=0.1), randn(128, scale=0.1),
                randn(512, 128, scale=128 ** -0.5).to(dt), randn(512, scale=0.1).to(dt),
                randn(128, 512, scale=512 ** -0.5).to(dt), randn(128, scale=0.1).to(dt),
                torch.rand(128, device="cuda", generator=gen))
        out = fused_mlp_ln_bwd(*args, g, 1e-5)
        got = " ".join(hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]
                       for t in out[:7])
        assert got == want[dt], dt


def test_widened_backward_kernels_reject_what_they_do_not_take(cuda):
    """K2 raises on heads of 128 and of 4 and on C = 1024 (heads of 64); K4
    on a width outside (64, 128, 256, 512) and at C = 64 on a hidden width
    that is not a multiple of 128; the reduce alone likewise."""
    q = torch.randn(2, 3, 17, 256, device="cuda", generator=cuda)
    with pytest.raises(ValueError, match="heads of width"):
        masked_sdpa_bwd(q, q, q, q, 0.25, 2)
    with pytest.raises(ValueError, match="heads of width"):
        masked_sdpa_bwd(q[..., :64], q[..., :64], q[..., :64], q[..., :64], 0.25, 16)
    w = torch.randn(2, 3, 17, 1024, device="cuda", generator=cuda)
    with pytest.raises(ValueError, match="C <= 512"):
        masked_sdpa_bwd(w, w, w, w, 0.25, 16)
    args = _mlp_args(cuda, 8, torch.float32, 64, 192)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_mlp_ln_bwd(*args, args[0], 1e-5)
    w2 = torch.zeros(64, 192, device="cuda")
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_mlp_ln_bwd_reduce(torch.zeros(10, device="cuda"), w2, w2[:, 0], w2[:, 0], 8)
    for c in (32, 1024):
        args = _mlp_args(cuda, 8, torch.float32, c, 256)
        with pytest.raises(ValueError, match="C in"):
            fused_mlp_ln_bwd(*args, args[0], 1e-5)
        w2 = torch.zeros(c, 256, device="cuda")
        with pytest.raises(ValueError, match="C in"):
            fused_mlp_ln_bwd_reduce(torch.zeros(10, device="cuda"), w2, w2[:, 0],
                                    w2[:, 0], 8)
