#!/usr/bin/env python3
"""Drive kasportsformer_torch on one NVIDIA GPU and check it, end to end.

Run from the repository root:  python3 chip_smoke.py [--out DIR] [--phases 0,1,2,3d]
(the short loops for kernel work: 0,1,2,3d for K1, 0,1,3,3b,3d for K3/K5,
0,1,7 for K4)

Phases (any failure exits non-zero and prints no result line):
  0. device: CUDA present; the card's name and power limit; TF32 off.
  1. build the five hand-written kernels from ops/csrc (K1-K5, one nvcc
     each, all started together).
  2. K1 masked_sdpa against its plain version at the serving shapes
     (spatial (128,27,17,128), temporal (128,17,27,128)), float32 and
     bfloat16, strided views of one qkv projection, and the x60 inter-head
     logit spread; kernel, plain and scaled_dot_product_attention times
     (kernel and SDPA in turns), each row's share of its bound and its time
     over SDPA's; K1's registers, shared memory and spills an instantiation
     to --out (also in 3d).
  3. K3 fused_mlp_ln against its plain version at M = 58,752 (serving),
     14,688 (the train step) and 1,377, each row with its tile (rows a tile,
     tiles, blocks, waves, L2 weight reads a launch) and share of the bound;
     K3's and K5's registers, shared memory and spills an instantiation to
     --out (also in 3d); a spill fails the phase.
     In phases 2 and 3 the plain version runs in float32 on the kernel's
     own inputs (bfloat16 ones included), so a bfloat16 kernel is held to
     the exact value and not to a second set of bfloat16 roundings.
  3b. K5 fused_mlp against its plain version at M = 58,752 (C/H 128/512 and
     512/1024) and 1,377.
  3c. K5's route: Mlp.forward(fused=True) at MixSTE's width, its launches
     counted around it.
  3d. K1 at the zoo's head widths and layouts (D = 8, 32, 64; flat streams,
     DSTFormer's grouped temporal view) and K3 at C/H 512/1024 (eps 1e-6),
     256/1024 and 64/256, with SDPA's time, share and ratio beside K1 as in
     phase 2 and the tile and share beside K3 as in phase 3; shapes outside the
     kernels' range (K1 at D = 128, K3 and K5 at C = 96) raise.
  4. the full-width 26-layer model with seeded, perturbed weights: the
     forward on the card through the kernels against the same weights on
     the CPU through the plain versions (B=4), 104 K1 and 156 K3 launches
     per forward; the bfloat16 forward no further from the float32 one than
     twice the CPU's bfloat16 forward is; 128-clip forward times (bfloat16
     also with the weights converted on every call, interleaved) and a
     profiler breakdown in both dtypes, K3's and K1's device time in it.
  5. serving, the main path: serve() on cuda at batch 128 answers /healthz
     and four /lift requests (40 frames, 405 frames, world space, 128 clips);
     then, with the model in bfloat16, the 40-frame and 128-clip requests;
     the launch counts are read around each dtype's serving alone.
  5b. the zoo at full width (MixSTE, DSTFormer, MotionAGFormer base,
     use_tcn, hierarchical and graph_only), each on the card through the
     kernels against the CPU through the plain versions (B=4, f32 within
     1e-3; a model whose CPU f32 forward lies further than 1e-4 from its
     float64 forward, graph_only, layer by layer within 1e-3 of each layer's
     largest entry instead; the
     bf16 forward held as in phase 4), its K1/K3 launches per forward, and
     128-clip forward times.
  5c. serving MixSTE, the zoo's main path: serve() on cuda answers /healthz
     and a 405-frame /lift, against the CPU; launches read around it.
  6. K2 masked_sdpa_bwd against its plain version at the train shapes
     (spatial (32,27,17,128), temporal (32,17,27,128) with the gradient a
     transposed view), float32 and bfloat16, and the x60 spread; kernel,
     plain and scaled_dot_product_attention-backward times.
  7. K4 fused_mlp_ln_bwd against its plain version at M = 14,688 and 1,377,
     all eight gradients, and a rerun bitwise equal; the whole call's time,
     and each of its three launches' device time (dx pass, weight pass,
     reduce; torch.profiler over the timed calls) with each launch's own
     bound and share; both passes' tiles, registers, shared memory and
     spills an instantiation to --out (a spill in either fails the phase).
     In phases 6 and 7 the plain version runs in float32 on the kernel's own
     inputs.
  8. full-model gradients: the train-mode loss and every parameter's
     gradient on the card (kernels) against the CPU (plain versions), same
     weights, B=4, the CPU's top-k adjacencies and ReLU gates replayed; the
     batch-norm running statistics; 104 K2 and 156 K4 launches per
     backward.
  9. the train step at the config's batch 32, float32 and bfloat16: median
     ms/step, clips/s, peak memory, device busy share and a profiler table
     (the profiles of phases 4 and 9 with the SM clock they ran at);
     then 50 steps on one batch, whose loss must fall.
 10. training, the second main path: `train` through the CLI's entry point
     on a seeded synthetic .npz clip store (256 train, 64 test clips) for 2
     epochs, each evaluated, then `evaluate` of the best checkpoint, which
     must give its epoch's MPJPE; the launch counts are read around `train`.
The last lines: the card, one JSON object per kernel table, and
{"ok": true, "device": {...}}; a run of a subset (--phases) ends with the
card and the phases' verdict instead. Long reports (the compiler's register report,
the profiler table) go to --out, by default chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import http.client
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

# published peaks of one H100 SXM (data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

FAILED: list[str] = []


def log(msg: str = "") -> None:
    print(msg, flush=True)


def phase(name: str):
    """Run a phase; record a failure and keep going so one run shows all."""
    def deco(fn):
        def run(*args, **kwargs):
            log(f"== {name}")
            t0 = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                log(f"   {name}: ok in {time.perf_counter() - t0:.1f} s")
                return out
            except Exception:  # a phase boundary: report and go on
                traceback.print_exc()
                log(f"   {name}: FAILED")
                FAILED.append(name)
                return None
        return run
    return deco


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi not available ({e})"


@contextlib.contextmanager
def sm_clock():
    """The card's SM clock, read by nvidia-smi about every 0.2 s on a thread
    while the body runs, so that a device time stands beside the clock it
    ran at. Yields a list that holds the readings (MHz) once the body ends;
    it stays empty where nvidia-smi cannot be run."""
    readings: list[float] = []
    stop = threading.Event()

    def poll() -> None:
        while not stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10)
                readings.append(float(out.stdout.splitlines()[0]))
            except (OSError, subprocess.SubprocessError, ValueError, IndexError):
                return
            stop.wait(0.2)

    thread = threading.Thread(target=poll, daemon=True)
    thread.start()
    try:
        yield readings
    finally:
        stop.set()
        thread.join(timeout=15)


def clock_text(readings: list[float]) -> str:
    if not readings:
        return "SM clock not measured"
    return (f"SM clock median {statistics.median(readings):.0f} MHz "
            f"({min(readings):.0f}-{max(readings):.0f}, {len(readings)} readings)")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device ms per call of fn. The device first spins for ~2 ms a call
    (`torch.cuda._sleep`), so the host has queued every call before the
    first one runs: the events then time the device, not how fast the host
    launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000 * iters)  # clock cycles, ~1.8 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(kernel, library, iters: int) -> tuple[float, float]:
    """Device ms per call of a kernel and of its library yardstick, timed in
    turns (kernel, library, library, kernel) so that a drift of the card's
    clock falls on both; each the mean of its two windows."""
    a1 = time_ms(kernel, iters)
    b1 = time_ms(library, iters)
    b2 = time_ms(library, iters)
    a2 = time_ms(kernel, iters)
    return (a1 + a2) / 2, (b1 + b2) / 2


def k1_row_line(ms: float, lib: float, bms: float) -> str:
    """A K1 row's share of its bound and its time over SDPA's."""
    return f"share of bound {bms / ms:.0%}  K1/SDPA {ms / lib:.2f}"


def write_k1_report(out_dir: str) -> None:
    """K1's compiler report (`-Xptxas -v`: registers, spills) and each
    instantiation's registers, shared memory, spills and blocks a SM as the
    runtime reports them, to --out/chip_smoke_k1_kernel.txt; one summary line
    an instantiation to the log."""
    import torch

    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.attention import masked_sdpa_kernel_info

    lines = []
    for dt in (torch.float32, torch.bfloat16):
        for d in (8, 16, 32, 64):
            info = masked_sdpa_kernel_info(dt, d)
            line = (f"K1 {str(dt).split('.')[1]:8s} D={d:2d}: " + ", ".join(
                f"{k} {v}" for k, v in info.items()))
            lines.append(line)
            log(f"   {line}")
    ptxas = _build.PTXAS.get("masked_sdpa", "(built before this process)")
    with open(os.path.join(out_dir, "chip_smoke_k1_kernel.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n== nvcc -Xptxas -v, masked_sdpa.cu\n"
                + ptxas + "\n")


def k3_tile_line(dt, m: int, c: int, h: int, ms: float, bms: float) -> str:
    """A K3 row's tiles (rows a tile), grid (blocks of the launch: a tile
    each, or a persistent block walking several), waves (tiles over the
    blocks the card holds at once), the weight bytes its tiles read from L2
    in a launch (every tile streams all of W1 and W2) and its share of the
    bound."""
    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp_ln_kernel_info

    try:
        info = fused_mlp_ln_kernel_info(dt, c, m)
    except TypeError:  # a library that reports no grid: a block a tile
        info = fused_mlp_ln_kernel_info(dt, c)
        info["grid"] = -(-m // info["rows"])
    rows = info["rows"]
    tiles = -(-m // rows)
    resident = (torch.cuda.get_device_properties(0).multi_processor_count
                * info["blocks_per_sm"])
    l2 = tiles * 2 * c * h * dt.itemsize
    return (f"tile {rows} rows: {tiles} tiles on {info['grid']} blocks, "
            f"{tiles / resident:.2f} waves, L2 weight reads {l2 / 1e6:.1f} MB; "
            f"share of bound {bms / ms:.1%}")


def write_k3_report(out_dir: str) -> None:
    """K3's and K5's compiler reports (`-Xptxas -v`: registers, spills) and
    each instantiation's tile, registers, shared memory, spills and blocks a
    SM as the runtime reports them, to --out/chip_smoke_k3_kernel.txt; one
    summary line an instantiation to the log. Raises if one spills."""
    import torch

    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import (fused_mlp_kernel_info,
                                              fused_mlp_ln_kernel_info)

    lines, spills = [], []
    for kname, info_fn in (("K3", fused_mlp_ln_kernel_info),
                           ("K5", fused_mlp_kernel_info)):
        for dt in (torch.float32, torch.bfloat16):
            for c in (64, 128, 256, 512):
                info = info_fn(dt, c)
                line = (f"{kname} {str(dt).split('.')[1]:8s} C={c:3d}: " + ", ".join(
                    f"{k} {v}" for k, v in info.items()))
                lines.append(line)
                if info["spill_bytes"] != 0:
                    spills.append(line)
                log(f"   {line}")
    log(f"   K3/K5 instantiations with local memory (spills): {spills or 'none'}")
    with open(os.path.join(out_dir, "chip_smoke_k3_kernel.txt"), "w") as f:
        f.write("\n".join(lines))
        for name in ("mlp_ln", "mlp"):
            ptxas = _build.PTXAS.get(name, "(built before this process)")
            f.write(f"\n\n== nvcc -Xptxas -v, {name}.cu\n{ptxas}\n")
    if spills:
        raise AssertionError(f"K3/K5 instantiations spill: {spills}")


def write_k4_report(out_dir: str) -> None:
    """The compiler's report of mlp_ln_bwd.cu (`-Xptxas -v`: registers and
    spills of K4's three kernels in both dtypes) and the dx pass's and the
    weight pass's instantiations (tile, the weight pass's chunk and row
    splits at M = 14,688, registers, shared memory, spills, blocks a SM) as
    the runtime reports them, to --out/chip_smoke_k4_kernel.txt; one summary
    line an instantiation to the log. Raises if either pass spills."""
    import torch

    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd_kernel_info

    lines, spills = [], []
    for dt in (torch.float32, torch.bfloat16):
        for label, info in fused_mlp_ln_bwd_kernel_info(dt, 14688, 512).items():
            line = (f"K4 {label.replace('_', ' '):11s} {str(dt).split('.')[1]:8s} "
                    "C=128 M=14688: " + ", ".join(f"{k} {v}" for k, v in info.items()))
            lines.append(line)
            if info["spill_bytes"] != 0:
                spills.append(line)
            log(f"   {line}")
    log(f"   K4 instantiations with local memory (spills): {spills or 'none'}")
    ptxas = _build.PTXAS.get("mlp_ln_bwd", "(built before this process)")
    with open(os.path.join(out_dir, "chip_smoke_k4_kernel.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n== nvcc -Xptxas -v, mlp_ln_bwd.cu\n"
                + ptxas + "\n")
    if spills:
        raise AssertionError(f"K4 instantiations spill: {spills}")


# K4's three launches, by the kernel names the profiler reports
K4_LAUNCHES = (("dx pass", "mlp_ln_bwd_dx_kernel"), ("weight pass", "mlp_ln_bwd_w_kernel"),
               ("reduce", "mlp_ln_bwd_reduce_kernel"))


def k4_launch_ms(call, iters: int) -> dict:
    """Device ms per launch of each of K4's three kernels over `iters`
    calls of `call` (torch.profiler; a kernel it does not see is absent)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    call()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    acc: dict = {}
    for e in device_events(prof):
        for label, name in K4_LAUNCHES:
            if name in e.key:
                t, n = acc.get(label, (0.0, 0))
                acc[label] = (t + e.self_device_time_total, n + e.count)
    return {label: t / 1e3 / n for label, (t, n) in acc.items()}


def bound_ms(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scaled_err(got, want) -> float:
    """max |got - want| / max(1, |want|): absolute below 1, relative above."""
    g, w = got.float(), want.float()
    return ((g - w).abs() / w.abs().clamp(min=1.0)).max().item()


# ------------------------------------------------------------ phases


@phase("phase 1: build kernels")
def build(out_dir: str) -> dict:
    from kasportsformer_torch.ops import _build

    t0 = time.perf_counter()
    report = _build.build_all()
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "chip_smoke_ptxas.txt"), "w") as f:
        for name, r in report.items():
            f.write(f"== {name}.cu ({r['seconds']:.2f} s)\n{r['ptxas']}\n")
    for name, r in report.items():
        regs = [ln.split(":", 1)[1].strip() for ln in r["ptxas"].splitlines()
                if "registers" in ln]
        log(f"   {name}.cu built in {r['seconds']:.2f} s; "
            f"per instantiation: {regs}")
    log(f"   build wall {wall:.2f} s (all nvcc started together)")
    return report


@phase("phase 2: K1 masked_sdpa vs plain")
def check_k1(dev, out_dir: str) -> dict:
    import torch
    import torch.nn.functional as F

    from kasportsformer_torch.ops.attention import (masked_sdpa,
                                                    masked_sdpa_reference)

    gen = torch.Generator(device=dev).manual_seed(1)
    heads, scale = 8, 16 ** -0.5
    # against the float32 plain version: float32 differs in summation order
    # only; bfloat16 by the rounding of the unnormalised probabilities (the
    # tensor cores' operand) and of the output, half a unit in the last place
    # each (2^-9 relative: <= 6e-3 in scaled_err on these inputs)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(128, 27, 17, 384, device=dev, generator=gen).to(dt)
        q, k, v = qkv.split(128, dim=-1)
        views = {"spatial": (q, k, v),
                 "temporal": tuple(z.transpose(1, 2) for z in (q, k, v))}
        for mode, (qq, kk, vv) in views.items():
            got = masked_sdpa(qq, kk, vv, scale, heads)
            want = masked_sdpa_reference(qq.float(), kk.float(), vv.float(),
                                         scale, heads)
            err = scaled_err(got, want)
            if not (torch.isfinite(got).all() and err <= tol[dt]):
                raise AssertionError(f"K1 {mode} {dt}: err {err} > {tol[dt]}")
            b, g, n, c = qq.shape
            # the library yardstick: one SDPA call on (B*G, H, N, D)
            qh, kh, vh = (z.reshape(b * g, n, heads, c // heads)
                          .transpose(1, 2).contiguous() for z in (qq, kk, vv))
            ms, lib = interleaved_ms(
                lambda: masked_sdpa(qq, kk, vv, scale, heads),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 50)
            plain = time_ms(
                lambda: masked_sdpa_reference(qq, kk, vv, scale, heads), 20)
            dname = str(dt).split(".")[1]
            nbytes = 4 * b * g * n * c * qq.element_size()
            flops = 4 * b * g * n * n * c
            bms, by = bound_ms(nbytes, flops, dname)
            rows[(mode, dname)] = dict(shape=[b, g, n, c], max_abs_err=(
                got.float() - want).abs().max().item(), ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            log(f"   K1 {mode:8s} {dname:8s} {tuple(qq.shape)} err {err:.2e} "
                f"(limit {tol[dt]:.0e}) kernel {ms:.4f} ms  plain "
                f"{plain:.4f}  sdpa {lib:.4f}  bound {bms:.4f} ({by})  "
                + k1_row_line(ms, lib, bms))
    # the x60 head-0 logit spread of tests/test_ops.py: exact per-head max
    q, k, v = (torch.randn(2, 4, 17, 128, device=dev, generator=gen)
               for _ in range(3))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    got = masked_sdpa(q, k, v, 0.25, heads)
    err = (got - masked_sdpa_reference(q, k, v, 0.25, heads)).abs().max().item()
    if not (torch.isfinite(got).all() and err <= 1e-4):
        raise AssertionError(f"K1 x60 spread f32: err {err}")
    qb, kb, vb = (z.bfloat16() for z in (q, k, v))
    gotb = masked_sdpa(qb, kb, vb, 0.25, heads)
    errb = scaled_err(gotb, masked_sdpa_reference(
        qb.float(), kb.float(), vb.float(), 0.25, heads))
    if not (torch.isfinite(gotb).all() and errb <= tol[torch.bfloat16]):
        raise AssertionError(f"K1 x60 spread bf16: err {errb}")
    log(f"   K1 x60 inter-head spread: f32 err {err:.2e}, bf16 err {errb:.2e}")
    write_k1_report(out_dir)
    return rows


def mlp_args(dev, gen, m: int, dt, c: int = 128, h: int = 512):
    import torch

    return (torch.randn(m, c, device=dev, generator=gen).to(dt),
            1 + 0.1 * torch.randn(c, device=dev, generator=gen),
            0.1 * torch.randn(c, device=dev, generator=gen),
            (torch.randn(h, c, device=dev, generator=gen) / c ** 0.5).to(dt),
            (0.1 * torch.randn(h, device=dev, generator=gen)).to(dt),
            (torch.randn(c, h, device=dev, generator=gen) / h ** 0.5).to(dt),
            (0.1 * torch.randn(c, device=dev, generator=gen)).to(dt),
            torch.rand(c, device=dev, generator=gen))


@phase("phase 3: K3 fused_mlp_ln vs plain")
def check_k3(dev, out_dir: str) -> dict:
    import torch

    from kasportsformer_torch.ops.mlp import (fused_mlp_ln,
                                              fused_mlp_ln_reference)

    gen = torch.Generator(device=dev).manual_seed(2)
    # against the float32 plain version: bfloat16 rounds the LayerNorm output
    # and the hidden activations (the tensor cores' operands) and the output
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for m in (58752, 14688, 1377):
            args = mlp_args(dev, gen, m, dt)
            got = fused_mlp_ln(*args, 1e-5)
            want = fused_mlp_ln_reference(*(a.float() for a in args), 1e-5)
            err = scaled_err(got, want)
            if not (torch.isfinite(got).all() and err <= tol[dt]):
                raise AssertionError(f"K3 M={m} {dt}: err {err} > {tol[dt]}")
            ms = time_ms(lambda: fused_mlp_ln(*args, 1e-5), 20)
            plain = time_ms(lambda: fused_mlp_ln_reference(*args, 1e-5), 20)
            dname = str(dt).split(".")[1]
            it = args[0].element_size()
            nbytes = 2 * m * 128 * it + 2 * 128 * 512 * it
            flops = 4 * m * 128 * 512
            bms, by = bound_ms(nbytes, flops, dname)
            rows[(m, dname)] = dict(shape=[m, 128], max_abs_err=(
                got.float() - want).abs().max().item(), ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by)
            log(f"   K3 M={m:6d} {dname:8s} err {err:.2e} (limit "
                f"{tol[dt]:.0e}) kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"bound {bms:.4f} ({by})  "
                + k3_tile_line(dt, m, 128, 512, ms, bms))
    write_k3_report(out_dir)
    return rows


@phase("phase 3b: K5 fused_mlp vs plain")
def check_k5(dev) -> dict:
    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp, fused_mlp_reference

    gen = torch.Generator(device=dev).manual_seed(12)
    # against the float32 plain version on the same inputs: bfloat16 rounds
    # the hidden activations (fc2's tensor-core operand) and the output
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for m, c, h in ((58752, 128, 512), (58752, 512, 1024), (1377, 128, 512)):
            x, _, _, w1, b1, w2, b2, _ = mlp_args(dev, gen, m, dt, c, h)
            args = (x, w1, b1, w2, b2)
            got = fused_mlp(*args)
            want = fused_mlp_reference(*(a.float() for a in args))
            err = scaled_err(got, want)
            if not (torch.isfinite(got).all() and err <= tol[dt]):
                raise AssertionError(f"K5 M={m} C/H={c}/{h} {dt}: err {err} > {tol[dt]}")
            ms = time_ms(lambda: fused_mlp(*args), 10)
            plain = time_ms(lambda: fused_mlp_reference(*args), 10)
            dname = str(dt).split(".")[1]
            it = x.element_size()
            bms, by = bound_ms(2 * m * c * it + 2 * c * h * it, 4 * m * c * h, dname)
            rows[(m, c, dname)] = dict(shape=[m, c, h], max_abs_err=(
                got.float() - want).abs().max().item(), ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by)
            log(f"   K5 M={m:6d} C/H={c}/{h} {dname:8s} err {err:.2e} (limit "
                f"{tol[dt]:.0e}) kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"bound {bms:.4f} ({by})")
    return rows


@phase("phase 3c: K5's route, Mlp.forward(fused=True), on the card")
def check_k5_route(dev) -> int:
    """K5's only route is the layer function (no model of either package
    passes fused=True): an Mlp of MixSTE's width on a 128-clip token stream,
    its launches counted around the fused forward alone, held against the
    same layer's unfused forward (cuBLAS linears)."""
    import torch

    from kasportsformer_torch.models.layers import Mlp
    from kasportsformer_torch.ops.mlp import fused_mlp

    gen = torch.Generator().manual_seed(14)
    mlp = Mlp(512, 1024)
    with torch.no_grad():
        for t in mlp.parameters():
            t.normal_(0.0, t.shape[-1] ** -0.5 if t.dim() == 2 else 0.1,
                      generator=gen)
    mlp = mlp.to(dev)
    x = torch.randn(128 * 27, 17, 512, generator=gen).to(dev)
    with torch.inference_mode():
        fused_mlp.launches = 0
        got = mlp(x, fused=True)
        launches = fused_mlp.launches
        err = scaled_err(got, mlp(x))
    log(f"   Mlp(512, 1024) on {tuple(x.shape)}: K5 launches {launches}, "
        f"fused vs unfused err {err:.2e} (limit 1e-4)")
    if launches != 1 or not (torch.isfinite(got).all() and err <= 1e-4):
        raise AssertionError(f"K5 route: launches {launches}, err {err}")
    return launches


def zoo_sdpa_views(dev, gen, dt):
    """K1's operands as the zoo passes them at B = 128, 27 frames: strided
    column slices of one qkv projection, in the layouts of MotionAGFormer
    hierarchical (C 64 over 8 heads, (B,T,J,C) and its temporal permutation),
    DSTFormer (C 256: a flat (B*F,J,C) stream and the grouped (B,J,F,C) view
    of its temporal attention) and MixSTE (C 512: flat spatial and temporal
    streams)."""
    import torch

    def split(shape, c):
        qkv = torch.randn(*shape, 3 * c, device=dev, generator=gen).to(dt)
        return qkv.split(c, dim=-1)

    mag = split((128, 27, 17), 64)
    dst = split((128 * 27, 17), 256)
    return {
        "MAG spatial D=8": (mag, 8),
        "MAG temporal D=8": (tuple(z.transpose(1, 2) for z in mag), 8),
        "DST spatial D=32": (dst, 8),
        "DST temporal D=32": (tuple(z.reshape(128, 27, 17, 256).transpose(1, 2)
                                    for z in dst), 8),
        "MixSTE spatial D=64": (split((128 * 27, 17), 512), 8),
        "MixSTE temporal D=64": (split((128 * 17, 27), 512), 8),
    }


@phase("phase 3d: K1 and K3 at the zoo's shapes vs plain")
def check_zoo_kernels(dev, out_dir: str) -> dict:
    import torch
    import torch.nn.functional as F

    from kasportsformer_torch.ops.attention import (masked_sdpa,
                                                    masked_sdpa_reference)
    from kasportsformer_torch.ops.mlp import (fused_mlp, fused_mlp_ln,
                                              fused_mlp_ln_reference)

    gen = torch.Generator(device=dev).manual_seed(13)
    tol1 = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    tol3 = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for name, ((qq, kk, vv), heads) in zoo_sdpa_views(dev, gen, dt).items():
            c = qq.shape[-1]
            scale = (c // heads) ** -0.5
            got = masked_sdpa(qq, kk, vv, scale, heads)
            want = masked_sdpa_reference(qq.float(), kk.float(), vv.float(),
                                         scale, heads)
            err = scaled_err(got, want)
            if not (torch.isfinite(got).all() and err <= tol1[dt]):
                raise AssertionError(f"K1 {name} {dt}: err {err} > {tol1[dt]}")
            lead, n = qq.shape[:-2].numel(), qq.shape[-2]
            qh, kh, vh = (z.reshape(lead, n, heads, c // heads)
                          .transpose(1, 2).contiguous() for z in (qq, kk, vv))
            ms, lib = interleaved_ms(
                lambda: masked_sdpa(qq, kk, vv, scale, heads),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 20)
            plain = time_ms(
                lambda: masked_sdpa_reference(qq, kk, vv, scale, heads), 10)
            bms, by = bound_ms(4 * lead * n * c * qq.element_size(),
                               4 * lead * n * n * c, dname)
            rows[("K1", name, dname)] = dict(shape=list(qq.shape), max_abs_err=(
                got.float() - want).abs().max().item(), ms=ms,
                plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            log(f"   K1 {name:21s} {dname:8s} {tuple(qq.shape)} err {err:.2e} "
                f"kernel {ms:.4f} ms  plain {plain:.4f}  sdpa {lib:.4f}  "
                f"bound {bms:.4f} ({by})  " + k1_row_line(ms, lib, bms))
        for c, h, eps in ((512, 1024, 1e-6), (256, 1024, 1e-5), (64, 256, 1e-5)):
            m = 58752
            args = mlp_args(dev, gen, m, dt, c, h)
            got = fused_mlp_ln(*args, eps)
            want = fused_mlp_ln_reference(*(a.float() for a in args), eps)
            err = scaled_err(got, want)
            if not (torch.isfinite(got).all() and err <= tol3[dt]):
                raise AssertionError(f"K3 C/H={c}/{h} {dt}: err {err} > {tol3[dt]}")
            ms = time_ms(lambda: fused_mlp_ln(*args, eps), 10)
            plain = time_ms(lambda: fused_mlp_ln_reference(*args, eps), 10)
            it = args[0].element_size()
            bms, by = bound_ms(2 * m * c * it + 2 * c * h * it, 4 * m * c * h, dname)
            rows[("K3", c, dname)] = dict(shape=[m, c, h], max_abs_err=(
                got.float() - want).abs().max().item(), ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by)
            log(f"   K3 M={m} C/H={c}/{h} eps {eps:.0e} {dname:8s} err {err:.2e} "
                f"kernel {ms:.4f} ms  plain {plain:.4f}  bound {bms:.4f} ({by})  "
                + k3_tile_line(dt, m, c, h, ms, bms))
    # shapes outside the kernels' range raise on the card, with no fallback
    q = torch.randn(2, 3, 17, 128, device=dev)
    x, w = torch.randn(8, 96, device=dev), torch.randn(256, 96, device=dev)
    refused = 0
    for call in (lambda: masked_sdpa(q, q, q, 0.1, 1),  # D = 128
                 lambda: fused_mlp_ln(x, x[0], x[0], w, w[:, 0], w.T, x[0], x[0]),
                 lambda: fused_mlp(x, w, w[:, 0], w.T, x[0])):  # C = 96
        try:
            call()
        except ValueError:
            refused += 1
    log(f"   K1 at D=128, K3 and K5 at C=96: {refused} of 3 refused")
    if refused != 3:
        raise AssertionError("a kernel took a shape outside its range")
    write_k1_report(out_dir)
    write_k3_report(out_dir)
    return rows


def perturbed(cfg, seed: int):
    """The model of `cfg` on the CPU, every weight and batch-norm statistic
    re-drawn at O(0.1-1) from a seeded generator (at init the layer scales
    are 1e-5, the fusion gates constant and DSTFormer's weights 0.02 wide)."""
    import torch

    from kasportsformer_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
            elif "layer_scale" in name:
                t.uniform_(0.1, 0.5, generator=gen)
            elif name.endswith("norm_adj") or name.endswith("limb_idx"):
                continue
            elif name.endswith("weight") and t.dim() == 1:  # LN / BN
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))
            elif name.endswith("weight") and t.dim() == 2:  # linear
                t.normal_(0.0, t.shape[1] ** -0.5, generator=gen)
            else:
                t.copy_(0.3 * torch.randn(t.shape, generator=gen))
    return model


@contextlib.contextmanager
def adjacency_tape(record: list | None = None, replay: list | None = None):
    """Within the block, the temporal GCNs' top-k adjacencies are appended to
    `record`, or replaced in call order by those of `replay`.

    The top-k is a threshold: where the k-th and (k+1)-th largest
    similarities of a frame lie closer than float32 rounding, two correct
    implementations (card and CPU, or JAX and the port) may link different
    neighbours and the outputs then differ far beyond rounding. Replaying
    the CPU's adjacencies on the card compares the arithmetic alone; the
    yielded list counts the entries the card would have chosen otherwise."""
    from kasportsformer_torch.models import layers as L

    orig = L.topk_adjacency
    tape = iter(replay) if replay is not None else None
    flips = [0, 0]  # differing entries, entries

    def taped(tokens, k):
        adj = orig(tokens, k)
        if record is not None:
            record.append(adj.cpu())
        if tape is not None:
            ref = next(tape)
            flips[0] += int((ref != adj.cpu()).sum())
            flips[1] += ref.numel()
            adj = ref.to(adj.device, adj.dtype)
        return adj

    L.topk_adjacency = taped
    try:
        yield flips
    finally:
        L.topk_adjacency = orig


@contextlib.contextmanager
def relu_gate_tape(record: list | None = None, replay: list | None = None):
    """Within the block, the gates of `torch.nn.functional.relu` (the GCNs'
    relu(x + BN(...))) are appended to `record`, or replaced in call order
    by those of `replay`.

    A gate is a threshold too: a pre-activation within float32 rounding of
    zero (one of the flagship's 12 million at B=4 is enough) may fall on the
    other side on the card, and its whole gradient with it: the GCN's
    batch-norm weight, whose gradient sums over that gate's channel, then
    moves far beyond rounding. Replayed, the comparison holds the arithmetic alone, as the
    adjacency tape does for the top-k; the yielded list counts the gates
    the card would have set otherwise."""
    import torch
    import torch.nn.functional as F

    orig = F.relu
    tape = iter(replay) if replay is not None else None
    flips = [0, 0]  # differing gates, gates

    def taped(x, inplace: bool = False):
        if record is not None:
            record.append((x > 0).cpu())
        if tape is None:
            return orig(x, inplace=inplace)
        ref = next(tape)
        flips[0] += int((ref != (x > 0).cpu()).sum())
        flips[1] += ref.numel()
        return torch.where(ref.to(x.device), x, torch.zeros_like(x))

    F.relu = taped
    try:
        yield flips
    finally:
        F.relu = orig


@contextlib.contextmanager
def casts_every_call():
    """Within the block, weights are converted to the activation dtype on
    every call instead of once (`layers.cast`): the yardstick for what
    keeping the converted copies saves."""
    from kasportsformer_torch.models import layers as L

    orig = L.cast
    L.cast = lambda t, dtype: t.to(dtype)
    try:
        yield
    finally:
        L.cast = orig


def clip_batch(gen, b: int):
    """Normalised keypoint clips: xy in [-1, 1], confidence in [0, 1]."""
    import torch

    x = torch.rand(b, 27, 17, 3, generator=gen)
    x[..., :2] = 2 * x[..., :2] - 1
    return x


@phase("phase 4: full model on the card vs the CPU")
def check_model(dev, out_dir: str) -> dict:
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa
    from kasportsformer_torch.ops.mlp import fused_mlp_ln

    from kasportsformer_torch.config import Config

    cpu_model = perturbed(Config(), seed=0)  # the flagship at full width
    model = copy.deepcopy(cpu_model).to(dev)
    log(f"   parameters: {model.parameter_count():,}")
    x = clip_batch(torch.Generator().manual_seed(3), 4)
    adjacencies: list = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        with adjacency_tape(record=adjacencies):
            want = cpu_model(x)
        cpu_s = time.perf_counter() - t0
        k1, k3 = masked_sdpa.launches, fused_mlp_ln.launches
        with adjacency_tape(replay=adjacencies) as flips:
            got = model(x.to(dev))
        torch.cuda.synchronize()
        d1, d3 = masked_sdpa.launches - k1, fused_mlp_ln.launches - k3
        if (d1, d3) != (104, 156):
            raise AssertionError(f"launches per forward {d1}, {d3} != 104, 156")
        dev32 = (got.cpu() - want).abs().max().item()
        if not (torch.isfinite(got).all() and dev32 <= 1e-3):
            raise AssertionError(f"f32 card vs CPU deviation {dev32}")
        free = (model(x.to(dev)).cpu() - want).abs().max().item()
        if free > 1e-3 and flips[0] == 0:
            raise AssertionError(f"free-running deviation {free} with no "
                                 "top-k adjacency flip to explain it")
        # bfloat16: the card's forward and the CPU's plain one, each against
        # the CPU's float32 forward, with the float32 adjacencies replayed
        # in both so that only the arithmetic differs
        for m in (model, cpu_model):
            m.compute_dtype = torch.bfloat16
        with adjacency_tape(replay=adjacencies):
            gotb = model(x.to(dev))
        with adjacency_tape(replay=adjacencies):
            cpub = cpu_model(x)
        free_b = model(x.to(dev))
        for m in (model, cpu_model):
            m.compute_dtype = torch.float32
        devb = (gotb.cpu() - want).abs().max().item()
        devb_cpu = (cpub - want).abs().max().item()
        devb_free = (free_b.cpu() - want).abs().max().item()
        if not (torch.isfinite(gotb).all() and devb <= 2 * devb_cpu):
            raise AssertionError(f"bf16 forward {devb} from f32, more than "
                                 f"twice the CPU's bf16 forward ({devb_cpu})")
    log(f"   B=4 forward: K1 launches {d1}, K3 launches {d3}; f32 max abs "
        f"deviation card vs CPU {dev32:.3e} with the CPU's top-k adjacencies "
        f"replayed (|y| max {want.abs().max().item():.3f}); free-running "
        f"{free:.3e}, top-k entries the card chose differently: {flips[0]} of "
        f"{flips[1]}; CPU forward {cpu_s:.2f} s")
    log(f"   B=4 bf16 forward vs CPU f32 (f32 adjacencies replayed): card "
        f"{devb:.3e}, CPU bf16 {devb_cpu:.3e} (limit 2x: {2 * devb_cpu:.3e}); "
        f"card free-running {devb_free:.3e}")

    xb = clip_batch(torch.Generator().manual_seed(4), 128).to(dev)
    times = {}
    with torch.inference_mode():
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            model.compute_dtype = dt
            times[dname] = time_ms(lambda: model(xb), 5, warmup=1)
        model.compute_dtype = torch.float32
    log(f"   128-clip forward: f32 {times['float32']:.2f} ms "
        f"({128e3 / times['float32']:.1f} clips/s), bf16 "
        f"{times['bfloat16']:.2f} ms ({128e3 / times['bfloat16']:.1f} clips/s)")
    # bf16 with the converted weights kept against converted on every call:
    # ten pairs in one process, alternating which side runs first
    ab = {"kept": [], "every call": []}

    def bf16_forward_ms(side: str) -> None:
        with contextlib.ExitStack() as stack:
            if side == "every call":
                stack.enter_context(casts_every_call())
            ab[side].append(time_ms(lambda: model(xb), 5, warmup=1))

    with torch.inference_mode():
        model.compute_dtype = torch.bfloat16
        for i in range(10):
            for side in (("kept", "every call") if i % 2 == 0
                         else ("every call", "kept")):
                bf16_forward_ms(side)
        model.compute_dtype = torch.float32
    wins = sum(a < b for a, b in zip(ab["kept"], ab["every call"]))
    log("   128-clip bf16 forward, weights converted once (kept) against "
        f"on every call, 10 pairs: kept wins {wins}; " + "; ".join(
            f"{k}: median {statistics.median(v):.2f} ms, runs "
            + ", ".join(f"{t:.2f}" for t in v) for k, v in ab.items()))
    for dt in (torch.float32, torch.bfloat16):
        profile(model, xb, dt, out_dir)
    return {"model": model, "deviation_f32": dev32, "deviation_bf16": devb,
            "forward_ms": times}


def device_events(prof) -> list:
    """The profile's kernels by name, with device time. A range annotated on
    the host (`Optimizer.step#AdamW.step`) is reported on the device as the
    span of the kernels inside it: it is left out, or they would count
    twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not ("#" in e.key and "(" not in e.key)]


def profile(model, xb, dtype, out_dir: str) -> None:
    """Device time by kernel over one 128-clip forward in `dtype`, and the
    device's busy share of the wall time (torch.profiler; reported, never
    fatal)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    dname = str(dtype).split(".")[1]
    try:
        with torch.inference_mode():
            model.compute_dtype = dtype
            model(xb)
            torch.cuda.synchronize()
            with sm_clock() as clock, tprofile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(xb)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        events = device_events(prof)
        busy = sum(e.self_device_time_total for e in events)
        events.sort(key=lambda e: -e.self_device_time_total)
        lines = [f"{e.self_device_time_total / 1e3:9.3f} ms {e.count:6d} x  "
                 f"{e.key}" for e in events]
        launches = sum(e.count for e in events)
        path = os.path.join(out_dir, f"chip_smoke_profile_{dname}.txt")
        with open(path, "w") as f:
            f.write(f"one 128-clip {dname} forward, wall {wall_us / 1e3:.3f} "
                    f"ms, device busy {busy / 1e3:.3f} ms, {launches} device "
                    f"kernels\n" + "\n".join(lines))
        log(f"   profile of one 128-clip {dname} forward: wall "
            f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({100 * busy / wall_us:.1f}%), {launches} device kernels; "
            + clock_text(clock))
        for group in ("K3", "K1"):
            mine = [e for e in events if kernel_group(e.key) == group]
            t = sum(e.self_device_time_total for e in mine)
            log(f"     of which {group}: {t / 1e3:.3f} ms in "
                f"{sum(e.count for e in mine)} launches "
                f"({100 * t / busy:.1f}% of device busy)")
        for line in lines[:10]:
            log(f"     {line[:110]}")
    except Exception as e:  # measurement only: report, do not fail the run
        log(f"   profile {dname}: not measured ({type(e).__name__}: {e})")
    finally:
        model.compute_dtype = torch.float32


def _request(port: int, method: str, path: str, payload=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps(payload) if payload is not None else None
        t0 = time.perf_counter()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        return resp.status, data, time.perf_counter() - t0
    finally:
        conn.close()


@phase("phase 5: serving on the card (main path)")
def check_serving(dev, model) -> dict:
    import numpy as np
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa
    from kasportsformer_torch.ops.mlp import fused_mlp_ln
    from kasportsformer_torch.serving import LiftService, serve

    rng = np.random.default_rng(5)
    requests = [
        ("40 frames", {"keypoints": rng.uniform(0, 1000, (40, 17, 2)).tolist(),
                       "width": 1280, "height": 720}),
        ("405 frames", {"keypoints": rng.uniform(0, 1000, (405, 17, 2)).tolist(),
                        "width": 1920, "height": 1080}),
        ("world", {"keypoints": rng.uniform(0, 1000, (60, 17, 3)).tolist(),
                   "width": 1280, "height": 720, "world": True}),
        ("128 clips", {"keypoints": rng.uniform(
            0, 1000, (128 * 27, 17, 2)).tolist(), "width": 1280,
            "height": 720}),
    ]

    def served(reqs) -> dict:
        """serve() on the card answers /healthz, reqs (one finite pose a
        frame), an unknown path (404) and a malformed request (400)."""
        srv = serve(model, host="127.0.0.1", port=0, batch_size=128, device=dev)
        port = srv.server_address[1]
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        answers = {}
        try:
            status, data, lat = _request(port, "GET", "/healthz")
            assert status == 200 and data["params"] == 29_365_668, data
            log(f"   /healthz {status} {data} in {lat * 1e3:.1f} ms")
            for name, req in reqs:
                status, data, lat = _request(port, "POST", "/lift", req)
                assert status == 200, (name, status, data)
                poses = np.asarray(data["poses"], np.float32)
                frames = len(req["keypoints"])
                assert poses.shape == (frames, 17, 3), (name, poses.shape)
                assert np.isfinite(poses).all(), name
                if req.get("world"):
                    np.testing.assert_allclose(poses[..., 2].min(-1), 0, atol=1e-5)
                    np.testing.assert_allclose(
                        poses.reshape(frames, -1).max(1), 1, atol=1e-5)
                else:
                    assert np.abs(poses[:, 0]).max() == 0.0, name  # root-zeroed
                clips = -(-frames // 27)
                log(f"   /lift {name:10s}: {status}, {clips:3d} clips, "
                    f"{lat * 1e3:8.1f} ms, {clips / lat:8.1f} clips/s")
                answers[name] = poses
            status, _, _ = _request(port, "GET", "/nope")
            assert status == 404
            status, _, _ = _request(port, "POST", "/lift", {"width": 1})
            assert status == 400
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        return answers

    # float32, then bfloat16 (the model as build_model gives it for a
    # config with compute_dtype: bfloat16); the counts are read around each
    launches = {}
    for dname, dt, reqs in (("float32", torch.float32, requests),
                            ("bfloat16", torch.bfloat16,
                             [requests[0], requests[3]])):
        masked_sdpa.launches = 0
        fused_mlp_ln.launches = 0
        model.compute_dtype = dt
        try:
            got = served(reqs)
        finally:
            model.compute_dtype = torch.float32
        launches[dname] = {"masked_sdpa": masked_sdpa.launches,
                           "fused_mlp_ln": fused_mlp_ln.launches}
        log(f"   kernel launches serving {dname}: {launches[dname]}")
        if min(launches[dname].values()) == 0:
            raise AssertionError(f"a kernel was not launched: {launches}")
        if dname == "float32":
            answers = got
        else:
            log("   bf16 served poses vs f32 served poses, max abs: " + ", ".join(
                f"{k} {float(np.abs(v - answers[k]).max()):.3e}"
                for k, v in got.items()))
    # the served poses: the same service called directly gives them back, and
    # agrees with the plain versions on the CPU (same weights, the CPU's top-k
    # adjacencies replayed; see adjacency_tape)
    req = requests[0][1]
    kpts = np.asarray(req["keypoints"], np.float32)
    card = LiftService(model, batch_size=128, device=dev)
    direct = card.lift_sequence(kpts, req["width"], req["height"])
    same = float(np.abs(answers["40 frames"] - direct).max())
    cpu = LiftService(copy.deepcopy(model).cpu(), batch_size=128, device="cpu")
    adjacencies: list = []
    with adjacency_tape(record=adjacencies):
        want = cpu.lift_sequence(kpts, req["width"], req["height"])
    with adjacency_tape(replay=adjacencies) as flips:
        got = card.lift_sequence(kpts, req["width"], req["height"])
    dev40 = float(np.abs(got - want).max())
    log(f"   40-frame poses: served vs direct call {same:.3e}; card vs CPU "
        f"plain versions {dev40:.3e} (top-k entries chosen differently: "
        f"{flips[0]} of {flips[1]})")
    if same > 1e-6 or dev40 > 1e-3:
        raise AssertionError(f"served poses: {same}, {dev40}")
    return launches


# ------------------------------------------------------------ the zoo

# full width: each family's published widths (the JAX configs' defaults)
# over the flagship's YAML, 27 frames, MotionAGFormer in all four variants
_MAG = dict(model_name="MotionAGFormer", dim_feat=128, n_layers=16,
            num_heads=8, mlp_ratio=4.0)
ZOO = {"MixSTE": dict(model_name="MixSTE", dim_in=2, dim_feat=512, n_layers=8,
                      num_heads=8, mlp_ratio=2.0),
       "DSTFormer": dict(model_name="DSTFormer", dim_feat=256, n_layers=5,
                         num_heads=8, mlp_ratio=4.0),
       "MotionAGFormer": _MAG,
       "MotionAGFormer use_tcn": dict(_MAG, use_tcn=True),
       "MotionAGFormer hierarchical": dict(_MAG, hierarchical=True),
       "MotionAGFormer graph_only": dict(_MAG, graph_only=True)}
# K1 and K3 launches per forward: a block's attention core and MLP tail
# (MixSTE 2 x 8 blocks; DSTFormer 4 half blocks x 5; MotionAGFormer 2
# attention and 4 former modules x 16 layers, graph_only 2 graph modules)
ZOO_LAUNCHES = {"MixSTE": (16, 16), "DSTFormer": (20, 20),
                "MotionAGFormer": (32, 64), "MotionAGFormer use_tcn": (32, 64),
                "MotionAGFormer hierarchical": (32, 64),
                "MotionAGFormer graph_only": (32, 32)}


def zoo_config(name: str):
    from kasportsformer_torch.config import load_config

    return load_config("configs/sportspose-gt-kasportsformer.yaml").replace(
        **ZOO[name])


def float64_copy(model):
    """A float64 copy of the CPU `model`: activations, parameters and
    statistics all float64, the yardstick of float32 rounding."""
    import torch

    m64 = copy.deepcopy(model).double()
    m64.compute_dtype = torch.float64
    return m64


def tensor_err(got, want) -> float:
    """max |got - want| / max(1, max |want|): the error against the tensor's
    scale, to which float32 rounding is relative where entries cancel."""
    g, w = got.double(), want.double()
    return ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()


def layerwise_deviation(model, cpu_model, x, adjacencies: list):
    """Each of `model.layers` on the card against the same layer on the CPU
    fed the card's input to it, the recorded top-k adjacencies replayed: the
    largest tensor_err over the layers, and beside it the same for the CPU's
    float32 layer against its float64 copy on that input (the rounding
    level). No error is carried from one layer to the next, so none is
    amplified."""
    ins, outs = [], []

    def keep(_, args, y):
        ins.append(args[0].cpu())
        outs.append(y.cpu())

    hooks = [layer.register_forward_hook(keep) for layer in model.layers]
    try:
        with adjacency_tape(replay=adjacencies):
            model(x.to(next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    with adjacency_tape(replay=adjacencies):
        cpu = [layer(a) for layer, a in zip(cpu_model.layers, ins)]
    with adjacency_tape(replay=adjacencies):
        f64 = [layer(a.double())
               for layer, a in zip(float64_copy(cpu_model).layers, ins)]
    return (max(tensor_err(y, w) for y, w in zip(outs, cpu)),
            max(tensor_err(c, w) for c, w in zip(cpu, f64)))


@phase("phase 5b: zoo models on the card vs the CPU")
def check_zoo_models(dev) -> dict:
    """Each model's card forward (kernels, f32) against its CPU forward
    (plain versions) on the same perturbed weights, within 1e-3, where
    rounding alone moves the output little: the CPU's own f32 forward within
    1e-4 of its float64 forward. graph_only's chain of 32 bare GCN layers,
    with perturbed weights, amplifies rounding so far (CPU f32 6e-4 from
    f64, bf16 O(1) from f32) that the end-to-end deviation says nothing of
    the port; such a model is held layer by layer instead, each layer on
    the card within 1e-3 of the CPU's on the same input, relative to the
    layer's largest entry (its entries grow to ~1e5 and cancel)."""
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa
    from kasportsformer_torch.ops.mlp import fused_mlp_ln

    res = {}
    for i, name in enumerate(ZOO):
        cpu_model = perturbed(zoo_config(name), seed=20 + i)
        model = copy.deepcopy(cpu_model).to(dev)
        x = clip_batch(torch.Generator().manual_seed(21 + i), 4)
        adjacencies: list = []
        with torch.inference_mode():
            with adjacency_tape(record=adjacencies):
                want = cpu_model(x)
            with adjacency_tape(replay=adjacencies):
                want64 = float64_copy(cpu_model)(x.double())
            k1, k3 = masked_sdpa.launches, fused_mlp_ln.launches
            with adjacency_tape(replay=adjacencies) as flips:
                got = model(x.to(dev))
            torch.cuda.synchronize()
            d = (masked_sdpa.launches - k1, fused_mlp_ln.launches - k3)
            dev32 = (got.cpu() - want).abs().max().item()
            cpu64 = (want - want64).abs().max().item()
            card64 = (got.cpu() - want64).abs().max().item()
            amplified = cpu64 > 1e-4
            layers = (layerwise_deviation(model, cpu_model, x, adjacencies)
                      if amplified else None)
            for m in (model, cpu_model):
                m.compute_dtype = torch.bfloat16
            with adjacency_tape(replay=adjacencies):
                gotb = model(x.to(dev))
            with adjacency_tape(replay=adjacencies):
                cpub = cpu_model(x)
            devb = (gotb.cpu() - want).abs().max().item()
            devb_cpu = (cpub - want).abs().max().item()
            xb = clip_batch(torch.Generator().manual_seed(4), 128).to(dev)
            times = {}
            for dname, dt in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
                model.compute_dtype = dt
                times[dname] = time_ms(lambda: model(xb), 3, warmup=1)
        log(f"   {name}: {model.parameter_count():,} parameters; K1/K3 launches "
            f"per forward {d} (expected {ZOO_LAUNCHES[name]}); B=4 f32 max abs "
            f"deviation card vs CPU {dev32:.3e} (|y| max "
            f"{want.abs().max().item():.3f}; top-k entries chosen differently: "
            f"{flips[0]} of {flips[1]}); vs the CPU's f64 forward: card f32 "
            f"{card64:.3e}, CPU f32 {cpu64:.3e}"
            + (f" (amplified: layer by layer card vs CPU {layers[0]:.3e} of "
               f"the layer's largest entry, limit 1e-3; CPU f32 vs f64 "
               f"{layers[1]:.3e})" if amplified else "")
            + f"; bf16 vs CPU f32: card {devb:.3e}, CPU "
            f"bf16 {devb_cpu:.3e} (limit 2x); 128-clip forward f32 "
            f"{times['float32']:.2f} ms, bf16 {times['bfloat16']:.2f} ms")
        if d != ZOO_LAUNCHES[name]:
            raise AssertionError(f"{name}: launches per forward {d}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite f32 forward on the card")
        if amplified and layers[0] > 1e-3:
            raise AssertionError(f"{name}: a layer on the card {layers[0]} "
                                 "from the CPU's on the same input")
        if not amplified and dev32 > 1e-3:
            raise AssertionError(f"{name}: f32 card vs CPU deviation {dev32}")
        if not (torch.isfinite(gotb).all() and devb <= 2 * devb_cpu):
            raise AssertionError(f"{name}: bf16 forward {devb} from f32, more "
                                 f"than twice the CPU's ({devb_cpu})")
        res[name] = {"deviation_f32": dev32, "deviation_f32_f64": card64,
                     "cpu_f32_f64": cpu64, "layerwise": layers,
                     "deviation_bf16": devb, "forward_ms": times}
        del model, cpu_model
    return res


@phase("phase 5c: serving MixSTE on the card (the zoo's main path)")
def check_zoo_serving(dev) -> dict:
    """serve() builds whatever model it is given: MixSTE at full width, f32,
    batch 128, answers /healthz and a 405-frame /lift, and the served poses
    agree with the plain versions on the CPU. The launch counts are read
    around this phase alone."""
    import numpy as np
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa
    from kasportsformer_torch.ops.mlp import fused_mlp_ln
    from kasportsformer_torch.serving import LiftService, serve

    cpu_model = perturbed(zoo_config("MixSTE"), seed=30)
    model = copy.deepcopy(cpu_model).to(dev)
    req = {"keypoints": np.random.default_rng(31).uniform(
        0, 1000, (405, 17, 2)).tolist(), "width": 1920, "height": 1080}
    masked_sdpa.launches = 0
    fused_mlp_ln.launches = 0
    srv = serve(model, host="127.0.0.1", port=0, batch_size=128,
                model_name="MixSTE", device=dev)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        status, data, lat = _request(srv.server_address[1], "GET", "/healthz")
        assert status == 200 and data["model"] == "MixSTE", data
        assert data["params"] == model.parameter_count(), data
        log(f"   /healthz {status} {data} in {lat * 1e3:.1f} ms")
        status, data, lat = _request(srv.server_address[1], "POST", "/lift", req)
        assert status == 200, (status, data)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    launches = {"masked_sdpa": masked_sdpa.launches,
                "fused_mlp_ln": fused_mlp_ln.launches}
    poses = np.asarray(data["poses"], np.float32)
    kpts = np.asarray(req["keypoints"], np.float32)
    want = LiftService(cpu_model, batch_size=128, device="cpu").lift_sequence(
        kpts, req["width"], req["height"])
    dev405 = float(np.abs(poses - want).max())
    log(f"   /lift 405 frames: {status}, 15 clips, {lat * 1e3:.1f} ms; served vs "
        f"CPU plain versions {dev405:.3e}; kernel launches in this phase: "
        f"{launches}")
    if not (poses.shape == (405, 17, 3) and np.isfinite(poses).all()
            and np.abs(poses[:, 0]).max() == 0.0 and dev405 <= 1e-3):
        raise AssertionError(f"served MixSTE poses: {poses.shape}, {dev405}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    return launches


# ------------------------------------------------------------ training path


def _errs(got, want) -> list[float]:
    return [scaled_err(a, b) for a, b in zip(got, want)]


def sum_err(got, want) -> float:
    """max |got - want| / max(1, max |want|): for a gradient summed over
    many rows, whose small entries are cancellations of large terms."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()


def time_backward_ms(out, inputs, grad, iters: int) -> float:
    """Device time of autograd's backward of `out` alone (the graph kept)."""
    import torch

    return time_ms(lambda: torch.autograd.grad(out, inputs, grad,
                                               retain_graph=True), iters)


@phase("phase 6: K2 masked_sdpa_bwd vs plain")
def check_k2(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from kasportsformer_torch.ops.attention import (masked_sdpa_bwd,
                                                    masked_sdpa_bwd_reference)

    gen = torch.Generator(device=dev).manual_seed(6)
    heads, scale = 8, 16 ** -0.5
    # against the plain version run in float32 on the same inputs: float32
    # differs in summation order only; bfloat16 rounds only dq, dk, dv
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(32, 27, 17, 384, device=dev, generator=gen).to(dt)
        gfull = torch.randn(32, 27, 17, 128, device=dev, generator=gen).to(dt)
        q, k, v = qkv.split(128, dim=-1)
        views = {"spatial": (q, k, v, gfull),
                 # temporal: the permuted views, the gradient a transposed view
                 "temporal": tuple(z.transpose(1, 2) for z in (q, k, v, gfull))}
        for mode, (qq, kk, vv, gg) in views.items():
            got = masked_sdpa_bwd(qq, kk, vv, gg, scale, heads)
            want = masked_sdpa_bwd_reference(*(z.float() for z in (qq, kk, vv, gg)),
                                             scale, heads)
            errs = _errs(got, want)
            if not (all(torch.isfinite(z).all() for z in got)
                    and max(errs) <= tol[dt]):
                raise AssertionError(f"K2 {mode} {dt}: errs {errs} > {tol[dt]}")
            b, g, n, c = qq.shape
            ms = time_ms(lambda: masked_sdpa_bwd(qq, kk, vv, gg, scale, heads), 50)
            plain = time_ms(lambda: masked_sdpa_bwd_reference(
                qq, kk, vv, gg, scale, heads), 20)
            # the library yardstick: the backward of one SDPA call on
            # (B*G, H, N, D)
            qh, kh, vh, gh = (z.reshape(b * g, n, heads, c // heads)
                              .transpose(1, 2).contiguous().requires_grad_(z is not gg)
                              for z in (qq, kk, vv, gg))
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            lib = time_backward_ms(sdpa_out, (qh, kh, vh), gh, 50)
            dname = str(dt).split(".")[1]
            nbytes = 7 * b * g * n * c * qq.element_size()
            flops = 10 * b * g * n * n * c
            bms, by = bound_ms(nbytes, flops, dname)
            rows[(mode, dname)] = dict(shape=[b, g, n, c], max_abs_err=max(
                (a.float() - w).abs().max().item() for a, w in zip(got, want)),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            log(f"   K2 {mode:8s} {dname:8s} {tuple(qq.shape)} err dq/dk/dv "
                + "/".join(f"{e:.2e}" for e in errs) + f" (limit {tol[dt]:.0e}) "
                f"kernel {ms:.4f} ms  plain {plain:.4f}  sdpa bwd {lib:.4f}  "
                f"bound {bms:.4f} ({by})")
    q, k, v, g = (torch.randn(2, 4, 17, 128, device=dev, generator=gen)
                  for _ in range(4))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    for dt in (torch.float32, torch.bfloat16):
        args = [z.to(dt) for z in (q, k, v, g)]
        got = masked_sdpa_bwd(*args, 0.25, heads)
        errs = _errs(got, masked_sdpa_bwd_reference(
            *(z.float() for z in args), 0.25, heads))
        if not (all(torch.isfinite(z).all() for z in got) and max(errs) <= tol[dt]):
            raise AssertionError(f"K2 x60 spread {dt}: errs {errs}")
        log(f"   K2 x60 inter-head spread {dt}: errs "
            + "/".join(f"{e:.2e}" for e in errs))
    return rows


_MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2", "dls2")


@phase("phase 7: K4 fused_mlp_ln_bwd vs plain")
def check_k4(dev, out_dir: str) -> dict:
    import torch

    from kasportsformer_torch.ops.mlp import (fused_mlp_ln_bwd,
                                              fused_mlp_ln_bwd_kernel_info,
                                              fused_mlp_ln_bwd_reference)

    gen = torch.Generator(device=dev).manual_seed(7)
    # against the plain version run in float32 on the same inputs: the
    # kernel computes in float32 from either dtype and rounds only dx (half
    # a unit in the last place, <= 3.9e-3 in bfloat16)
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    rows, per = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        for m in (14688, 1377):
            args = mlp_args(dev, gen, m, dt)
            g = torch.randn(m, 128, device=dev, generator=gen).to(dt)
            got = fused_mlp_ln_bwd(*args, g, 1e-5)
            again = fused_mlp_ln_bwd(*args, g, 1e-5)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K4 M={m} {dt}: a rerun is not bitwise equal")
            want = fused_mlp_ln_bwd_reference(*(a.float() for a in args),
                                              g.float(), 1e-5)
            # dx per element; the parameter gradients, sums over M rows,
            # against their largest entry
            errs = [scaled_err(got[0], want[0])] + [
                sum_err(a, b) for a, b in zip(got[1:], want[1:])]
            if not (all(torch.isfinite(z).all() for z in got)
                    and max(errs) <= tol[dt]):
                raise AssertionError(f"K4 M={m} {dt}: errs {dict(zip(_MLP_GRADS, errs))}")
            ms = time_ms(lambda: fused_mlp_ln_bwd(*args, g, 1e-5), 20)
            plain = time_ms(lambda: fused_mlp_ln_bwd_reference(*args, g, 1e-5), 20)
            dname = str(dt).split(".")[1]
            it = args[0].element_size()
            # x, g in and dx out; the weights and biases in; the parameter
            # gradients out in float32
            nbytes = (3 * m * 128 * it + 2 * 128 * 512 * it
                      + 4 * (2 * 128 * 512 + 512 + 5 * 128))
            # five products of 2*M*C*H: fc1 recomputed, dh = do W2,
            # da = dz W1, dW1 = dz^T a and G = g^T h (dW2 and dls2 follow
            # from G, so fc2 is not recomputed)
            flops = 10 * m * 128 * 512
            bms, by = bound_ms(nbytes, flops, dname)
            rows[(m, dname)] = dict(shape=[m, 128], max_abs_err=max(
                (a.float() - w).abs().max().item() for a, w in zip(got, want)),
                ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by)
            log(f"   K4 M={m:6d} {dname:8s} worst err "
                f"{max(errs):.2e} ({_MLP_GRADS[errs.index(max(errs))]}; limit "
                f"{tol[dt]:.0e}) kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"bound {bms:.4f} ({by}); rerun bitwise equal")
            per[(m, dname)] = k4_launch_ms(lambda: fused_mlp_ln_bwd(*args, g, 1e-5), 20)
            log("     by launch (profiler, ms a launch): " + "; ".join(
                f"{label} {per[(m, dname)].get(label, float('nan')):.4f}"
                for label, _ in K4_LAUNCHES))
    # each launch against the bound of its own work: the dx pass recomputes
    # fc1 and takes dh = do W2 and da = dz W1 (6*M*C*H) from x, g and the
    # weights, and writes dx; the weight pass recomputes fc1 and dh and takes
    # dW1 = dz^T a and G = g^T h (8*M*C*H) from the same inputs, and writes
    # one copy of dW1, G and db1 (its row-split partials are the design's, not
    # the function's, and count in the reduce's bound); the reduce reads both
    # passes' partials and W2 and writes the parameter gradients (bytes)
    for (m, dname), ms in per.items():
        info = fused_mlp_ln_bwd_kernel_info(torch.float32, m, 512)
        it = 4 if dname == "float32" else 2
        wts = 2 * 128 * 512 * it
        part_dx = -(-m // info["dx_pass"]["rows"]) * 3 * 128 * 4
        w_out = (2 * 512 * 128 + 512) * 4
        part_w = info["weight_pass"]["splits"] * w_out
        grads = 4 * (2 * 128 * 512 + 512 + 5 * 128)
        bounds = {"dx pass": bound_ms(3 * m * 128 * it + wts, 6 * m * 128 * 512, dname),
                  "weight pass": bound_ms(2 * m * 128 * it + wts + w_out,
                                          8 * m * 128 * 512, dname),
                  "reduce": bound_ms(part_dx + part_w + wts // 2 + grads, 0, dname)}
        log(f"   K4 M={m:6d} {dname:8s} by launch, bound (share): " + "; ".join(
            f"{label} {bounds[label][0]:.4f} ({bounds[label][1]}; "
            f"{bounds[label][0] / ms.get(label, float('nan')):.1%})"
            for label, _ in K4_LAUNCHES))
    write_k4_report(out_dir)
    return rows


def label_batch(gen, b: int):
    """Root-relative 3D targets of the scale the normalised inputs have."""
    import torch

    y = 0.3 * torch.randn(b, 27, 17, 3, generator=gen)
    return y - y[:, :, :1]


@phase("phase 8: full-model gradients on the card vs the CPU")
def check_grads(dev) -> dict:
    import torch

    from kasportsformer_torch.config import Config
    from kasportsformer_torch.ops.attention import masked_sdpa_bwd
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd
    from kasportsformer_torch.train.loop import make_grads_fn

    cfg = Config(grad_microbatch=0)
    cpu_model = perturbed(Config(), seed=0)
    model = copy.deepcopy(cpu_model).to(dev)
    x = clip_batch(torch.Generator().manual_seed(8), 4)
    y = label_batch(torch.Generator().manual_seed(9), 4)
    w = torch.ones(4)
    adjacencies: list = []
    gates: list = []
    t0 = time.perf_counter()
    with adjacency_tape(record=adjacencies), relu_gate_tape(record=gates):
        want = make_grads_fn(cpu_model, cfg)(x, y, w)
    cpu_s = time.perf_counter() - t0
    k2, k4 = masked_sdpa_bwd.launches, fused_mlp_ln_bwd.launches
    with adjacency_tape(replay=adjacencies) as flips, \
            relu_gate_tape(replay=gates) as gate_flips:
        got = make_grads_fn(model, cfg)(x.to(dev), y.to(dev), w.to(dev))
    torch.cuda.synchronize()
    d2, d4 = masked_sdpa_bwd.launches - k2, fused_mlp_ln_bwd.launches - k4
    if (d2, d4) != (104, 156):
        raise AssertionError(f"launches per backward {d2}, {d4} != 104, 156")
    loss_rel = abs(got["loss_total"].item() - want["loss_total"].item()) / abs(
        want["loss_total"].item())
    # the loss reaches no limb norm of an attention or graph module (as in
    # the reference): 2 parameters x 4 modules x 26 layers have no gradient,
    # on the CPU and on the card; any other missing one is a cut graph
    missing = {n for n, p in model.named_parameters() if p.grad is None}
    cpu_missing = {n for n, p in cpu_model.named_parameters() if p.grad is None}
    unreached = {n for n in cpu_missing if "norm1_limb" in n and ".bone_" not in n}
    if not (missing == cpu_missing == unreached and len(unreached) == 208):
        raise AssertionError(
            f"parameters without a gradient: {len(missing)} on the card "
            f"({sorted(missing - unreached)[:5]} beyond the limb norms), "
            f"{len(cpu_missing)} on the CPU, {len(unreached)} limb norms")
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()
                 if p.grad is not None}

    # per parameter: max |card - CPU| over the largest CPU gradient entry of
    # the module that holds it (a linear's weight and bias). A bias whose
    # gradient is a sum that cancels to near zero is so held to the size of
    # what flows through its module, which cancellation cannot shrink; its
    # error over its own largest entry is printed beside it.
    def owner(n: str) -> str:
        return n.rpartition(".")[0]

    module_max: dict[str, float] = {}
    for n, ref in cpu_grads.items():
        module_max[owner(n)] = max(module_max.get(owner(n), 0.0),
                                   ref.abs().max().item())
    rows = []
    for name, p in model.named_parameters():
        if name in missing:
            continue
        ref = cpu_grads[name]
        diff = (p.grad.cpu() - ref).abs().max().item()
        scale, own = module_max[owner(name)], ref.abs().max().item()
        rows.append((diff / scale if scale else (0.0 if diff == 0 else float("inf")),
                     diff / own if own else float("nan"), own, name))
    rows.sort(reverse=True)
    worst = rows[0][0]
    worst_own = max(rows, key=lambda r: r[1] if r[1] == r[1] else -1.0)
    cpu_bufs = dict(cpu_model.named_buffers())
    bn = max((b.cpu() - cpu_bufs[n]).abs().max().item()
             for n, b in model.named_buffers() if "running" in n)
    grad_tol, bn_tol = 1e-3, 1e-5
    log(f"   B=4 train-mode backward: K2 launches {d2}, K4 launches {d4}; loss "
        f"{got['loss_total'].item():.6f} (rel diff {loss_rel:.2e}); "
        f"{len(rows)} parameters with a gradient, {len(missing)} without on "
        f"both (the unreached limb norms); batch-norm running stats max abs "
        f"diff {bn:.3e} (limit {bn_tol:.0e}); top-k entries chosen "
        f"differently: {flips[0]} of {flips[1]}, ReLU gates set differently: "
        f"{gate_flips[0]} of {gate_flips[1]} (both replayed from the CPU); "
        f"CPU forward+backward {cpu_s:.2f} s")
    errs = sorted(r[0] for r in rows)
    log(f"   per-parameter error over its module's largest CPU gradient (limit "
        f"{grad_tol:.0e}): median {errs[len(errs) // 2]:.2e}, 99th percentile "
        f"{errs[int(0.99 * len(errs))]:.2e}, worst five: " + "; ".join(
            f"{n} {e:.2e} (over its own |g| max {s:.2e}: {o:.2e})"
            for e, o, s, n in rows[:5]))
    log(f"   over its own largest CPU gradient the worst is {worst_own[3]} "
        f"{worst_own[1]:.2e} (|g| max {worst_own[2]:.2e}, over its module's "
        f"{worst_own[0]:.2e})")
    if not (loss_rel <= 1e-5 and worst <= grad_tol and bn <= bn_tol):
        raise AssertionError("full-model gradients off the CPU's")
    return {"worst": worst, "worst_name": rows[0][3], "loss_rel": loss_rel}


def synthetic_clipsets(seed: int, n_train: int, n_test: int):
    """Seeded clip sets in the shape of a preprocessed SportsPose split:
    normalised 2D inputs with a confidence channel, root-relative train
    labels, and the test split's 2.5D-scaled labels, factors, (W, H)
    resolutions and actions."""
    import numpy as np

    from kasportsformer_torch.data.clips import ClipSet

    rng = np.random.default_rng(seed)

    def inputs(n):
        x = rng.uniform(-1, 1, (n, 27, 17, 3)).astype(np.float32)
        x[..., 2] = rng.uniform(0, 1, (n, 27, 17))
        return x

    def labels(n):
        y = (0.3 * rng.standard_normal((n, 27, 17, 3))).astype(np.float32)
        return y - y[:, :, :1]

    train = ClipSet("train", inputs(n_train), labels(n_train))
    lab = labels(n_test)
    test = ClipSet("test", inputs(n_test), lab,
                   labels_scaled=(lab * 1000).astype(np.float32),
                   factors=rng.uniform(2, 6, (n_test, 27)).astype(np.float32),
                   actions=np.array(["serve", "smash", "dive", "sprint"])[
                       np.arange(n_test) % 4],
                   res=np.tile(np.array([[1920, 1080]], np.float32), (n_test, 1)))
    return train, test


_GROUPS = (("K4", ("mlp_ln_bwd",)), ("K3", ("mlp_bf16_tc_kernel", "mlp_f32_")),
           ("K2", ("masked_sdpa_bwd",)),
           ("K1", ("masked_sdpa",)), ("GEMM", ("gemm", "nvjet", "splitK", "cutlass")),
           ("LayerNorm", ("layer_norm", "GammaBeta")), ("reduction", ("reduce_kernel",)),
           ("AdamW", ("multi_tensor", "adam", "Adam")), ("copy/cast", ("copy",)))


def kernel_group(key: str) -> str:
    """A profiler kernel name's group in the step breakdown."""
    for group, words in _GROUPS:
        if any(w in key for w in words):
            return group
    return "element-wise/other"


def profile_steps(step, n: int, name: str, out_dir: str) -> str:
    """Device time by kernel over n train steps and the device's busy share
    of their wall time (torch.profiler; reported, never fatal)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    try:
        step()
        torch.cuda.synchronize()
        with sm_clock() as clock, tprofile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = device_events(prof)
        busy = sum(e.self_device_time_total for e in events)
        events.sort(key=lambda e: -e.self_device_time_total)
        lines = [f"{e.self_device_time_total / 1e3 / n:9.3f} ms/step "
                 f"{e.count / n:7.1f} x  {e.key}" for e in events]
        with open(os.path.join(out_dir, f"chip_smoke_profile_{name}.txt"), "w") as f:
            f.write(f"{n} steps {name}: wall {wall_us / 1e3 / n:.3f} ms/step, "
                    f"device busy {busy / 1e3 / n:.3f} ms/step\n" + "\n".join(lines))
        groups: dict[str, list[float]] = {}
        for e in events:
            g = kernel_group(e.key)
            acc = groups.setdefault(g, [0.0, 0.0])
            acc[0] += e.self_device_time_total / 1e3 / n
            acc[1] += e.count / n
        log(f"   profile {name}: wall {wall_us / 1e3 / n:.2f} ms/step, device "
            f"busy {busy / 1e3 / n:.2f} ms/step ({100 * busy / wall_us:.1f}%), "
            f"{sum(e.count for e in events) / n:.0f} device kernels a step; "
            + clock_text(clock))
        log("     by group, ms/step (kernels a step): " + "; ".join(
            f"{g} {t:.1f} ({c:.0f})" for g, (t, c) in
            sorted(groups.items(), key=lambda kv: -kv[1][0])))
        k4 = {label: [e for e in events if name in e.key] for label, name in K4_LAUNCHES}
        log("     K4 by launch, ms/step (kernels a step): " + "; ".join(
            f"{label} {sum(e.self_device_time_total for e in es) / 1e3 / n:.2f} "
            f"({sum(e.count for e in es) / n:.0f})" for label, es in k4.items()))
        for line in lines[:8]:
            log(f"     {line[:110]}")
        return f"{100 * busy / wall_us:.1f}%"
    except Exception as e:  # measurement only: report, do not fail the run
        log(f"   profile {name}: not measured ({type(e).__name__}: {e})")
        return "not measured"


@phase("phase 9: train step at batch 32")
def check_train_step(dev, out_dir: str) -> dict:
    import numpy as np
    import torch

    from kasportsformer_torch.config import Config
    from kasportsformer_torch.data.pipeline import flip_generator
    from kasportsformer_torch.models import build_model
    from kasportsformer_torch.train.loop import make_optimizer, make_train_step

    train, _ = synthetic_clipsets(10, 320, 4)
    arrays = {"inputs": torch.as_tensor(train.inputs, device=dev),
              "labels": torch.as_tensor(train.labels, device=dev)}
    res = {}
    for dname in ("float32", "bfloat16"):
        cfg = Config(compute_dtype=dname)  # the public config: batch 32
        model = build_model(cfg, device=dev)
        opt = make_optimizer(model, cfg)
        step = make_train_step(model, cfg, opt)
        w = torch.ones(cfg.batch_size, device=dev)
        plans = np.arange(320).reshape(10, 32)
        times, i = [], 0

        def one() -> None:
            nonlocal i
            step(arrays, plans[i % 10], w, flip_generator(cfg.seed, 0, i))
            i += 1

        one()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(12):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        none = [n for n, p in model.named_parameters() if p.grad is None]
        if none:  # the step gives the unreached parameters zeros for AdamW
            raise AssertionError(f"no gradient after a step: {none[:5]}")
        med = statistics.median(times)
        busy = profile_steps(one, 3, f"train_{dname}", out_dir)
        res[dname] = {"ms": med, "peak_gib": peak, "busy": busy}
        log(f"   train step {dname}, batch 32: median {med:.1f} ms over 12 "
            f"steps (min {min(times):.1f}, max {max(times):.1f}), "
            f"{32e3 / med:.1f} clips/s, peak memory {peak:.2f} GiB")
        del model, opt, step
    # 50 steps on one fixed batch, float32, no flips: the loss must fall
    cfg = Config(flip=False, learning_rate=1e-3)
    model = build_model(cfg, device=dev)
    opt = make_optimizer(model, cfg)
    step = make_train_step(model, cfg, opt)
    w = torch.ones(32, device=dev)
    losses = [step(arrays, np.arange(32), w)["loss_total"].item()
              for _ in range(50)]
    log(f"   50 steps on one batch: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
        f"(min {min(losses):.5f})")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"fixed-batch losses did not fall: {losses}")
    res["losses"] = (losses[0], losses[-1])
    return res


@phase("phase 10: train and evaluate through the CLI (main path)")
def check_train_cli(dev, out_dir: str) -> dict:
    import dataclasses
    import io
    import re
    import tempfile

    from kasportsformer_torch import cli
    from kasportsformer_torch.config import load_config
    from kasportsformer_torch.data.clips import save_clipstore
    from kasportsformer_torch.ops.attention import masked_sdpa, masked_sdpa_bwd
    from kasportsformer_torch.ops.mlp import fused_mlp_ln, fused_mlp_ln_bwd

    counters = (masked_sdpa, masked_sdpa_bwd, fused_mlp_ln, fused_mlp_ln_bwd)
    with tempfile.TemporaryDirectory() as tmp:
        train, test = synthetic_clipsets(11, 256, 64)
        for cs in (train, test):
            save_clipstore(os.path.join(tmp, "clips", "SYN-27", f"{cs.split}.npz"), cs)
        raw = dataclasses.asdict(
            load_config("configs/sportspose-gt-kasportsformer.yaml"))
        raw.update(epochs=2, warmup_epoches=1, data_root=os.path.join(tmp, "clips"),
                   clip_set_name="SYN-27", new_checkpoint_dir=os.path.join(tmp, "ckpt"),
                   new_checkpoint_name="syn", logger_dir_path=os.path.join(tmp, "log"),
                   logger_file_name="train.log", use_wandb=False, checkpoint=False,
                   resume=False, eval_only=False)
        cfg_path = os.path.join(tmp, "syn.yaml")  # JSON is YAML
        with open(cfg_path, "w") as f:
            json.dump(raw, f)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(["train", "--config-path", cfg_path])
        train_s = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
        if rc != 0:
            raise AssertionError(f"train exited {rc}")
        logs = "".join(open(os.path.join(tmp, "log", n)).read()
                       for n in os.listdir(os.path.join(tmp, "log")))
        mpjpes = [float(v) for v in re.findall(r"epoch \d+: MPJPE ([0-9.eE+-]+) mm", logs)]
        best = os.path.join(tmp, "ckpt", "syn_best")
        if len(mpjpes) != 2 or not os.path.isdir(best):
            raise AssertionError(f"expected 2 evaluated epochs and a best "
                                 f"checkpoint, got {mpjpes}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["evaluate", "--config-path", cfg_path,
                           "--checkpoint", best])
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        diff = abs(result["mpjpe"] - min(mpjpes))
        log(f"   train: 2 epochs of 8 steps in {train_s:.1f} s, eval MPJPE per "
            f"epoch {mpjpes}; evaluate on the best checkpoint: "
            f"{result['mpjpe']} mm (diff {diff:.2e}); launches {launches}")
        if rc != 0 or diff > 1e-3 or min(launches.values()) == 0:
            raise AssertionError(f"evaluate rc {rc}, MPJPE diff {diff}, "
                                 f"launches {launches}")
    return launches


PHASES = ("0", "1", "2", "3", "3b", "3c", "3d", "4", "5", "5b", "5c", "6",
          "7", "8", "9", "10")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chip_smoke_out",
                        help="directory for the long reports")
    parser.add_argument(
        "--phases", default=None,
        help="comma-separated subset of the phases to run, e.g. 0,1,2,3d "
             "(phase 0 always runs; 5 brings 4, whose model it serves). A "
             "subset prints its tables and exits 0 or 1, never the result "
             "line, which belongs to the whole run. Default: every phase")
    args = parser.parse_args()
    want = set(PHASES)
    if args.phases is not None:
        want = {p.strip() for p in args.phases.split(",") if p.strip()}
        unknown = want - set(PHASES)
        if unknown:
            parser.error(f"unknown phases {sorted(unknown)}; known: {PHASES}")
        want |= {"0"} | ({"4"} if "5" in want else set())
    try:
        import torch
    except ImportError:
        log("chip_smoke: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this check "
            "needs an NVIDIA GPU")
        return 1
    try:
        import kasportsformer_torch  # noqa: F401
    except ImportError:
        log("chip_smoke: kasportsformer_torch not found; run from the "
            "repository root")
        return 1
    os.makedirs(args.out, exist_ok=True)
    t_start = time.perf_counter()
    log("== phase 0: device")
    card = card_line()
    log(f"   {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def run(name: str, fn, *fargs):
        return fn(*fargs) if name in want else None

    run("1", build, args.out)
    k1 = run("2", check_k1, dev, args.out)
    k3 = run("3", check_k3, dev, args.out)
    k5 = run("3b", check_k5, dev)
    k5_launches = run("3c", check_k5_route, dev)
    zoo_k = run("3d", check_zoo_kernels, dev, args.out)
    res = run("4", check_model, dev, args.out)
    launches = None
    if res is not None:
        launches = run("5", check_serving, dev, res["model"])
        del res
    zoo = run("5b", check_zoo_models, dev)
    zoo_launches = run("5c", check_zoo_serving, dev)
    k2 = run("6", check_k2, dev)
    k4 = run("7", check_k4, dev, args.out)
    run("8", check_grads, dev)
    run("9", check_train_step, dev, args.out)
    train_launches = run("10", check_train_cli, dev, args.out)
    log(f"== total {time.perf_counter() - t_start:.1f} s")
    if args.phases is not None:
        log(card)
        log(f"chip_smoke: phases {sorted(want, key=PHASES.index)} "
            + (f"FAILED: {FAILED}" if FAILED else "ok"))
        return 1 if FAILED else 0
    if FAILED or not (k1 and k3 and k5 and k5_launches and zoo_k and launches
                      and zoo and zoo_launches and k2 and k4 and train_launches):
        log(f"chip_smoke: FAILED phases: {FAILED}")
        return 1

    # rows at the main paths' shapes, f32 (and K3's bf16 flagship row): the
    # flagship's serving (K1, K3; the bf16 row's launches from its bf16
    # serving), the train step (K2, K4), MixSTE's serving (K1, K3 at the
    # zoo's widest shapes) and K5's layer route; launches from those runs
    kernels = [
        dict(name="masked_sdpa", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa.cu",
             replaces="kasportsformer_tpu/ops/attention.py:227",
             launches=launches["float32"]["masked_sdpa"],
             **k1[("spatial", "float32")]),
        dict(name="masked_sdpa_bwd", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa_bwd.cu",
             replaces="kasportsformer_tpu/ops/attention.py:365",
             launches=train_launches["masked_sdpa_bwd"],
             **k2[("spatial", "float32")]),
        dict(name="fused_mlp_ln", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:202",
             launches=launches["float32"]["fused_mlp_ln"],
             **k3[(58752, "float32")]),
        dict(name="fused_mlp_ln", route="cuda", dtype="bfloat16",
             source="kasportsformer_torch/ops/csrc/mlp_ln.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:202",
             launches=launches["bfloat16"]["fused_mlp_ln"],
             **k3[(58752, "bfloat16")]),
        dict(name="fused_mlp_ln_bwd", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln_bwd.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:284",
             launches=train_launches["fused_mlp_ln_bwd"],
             **k4[(14688, "float32")]),
        dict(name="fused_mlp", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:137",
             launches=k5_launches, **k5[(58752, 512, "float32")]),
        dict(name="masked_sdpa[zoo]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa.cu",
             replaces="kasportsformer_tpu/ops/attention.py:227",
             launches=zoo_launches["masked_sdpa"],
             **zoo_k[("K1", "MixSTE spatial D=64", "float32")]),
        dict(name="fused_mlp_ln[zoo]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:202",
             launches=zoo_launches["fused_mlp_ln"],
             **zoo_k[("K3", 512, "float32")]),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
