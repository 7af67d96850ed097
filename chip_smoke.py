#!/usr/bin/env python3
"""Drive kasportsformer_torch on one NVIDIA GPU and check it, end to end.

Run from the repository root:  python3 chip_smoke.py [--out DIR] [--phases 0,1,2,3d]
(the short loops for kernel work: 0,1,2,3d for K1, 0,1,3,3b,3d for K3/K5,
0,1,6 for K2, 0,1,7 for K4, 0,1,6,7,9b for the zoo's training)

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
     blocks a tile, tiles, blocks, waves, registers, shared memory, L2
     weight reads a launch) and share of the bound;
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
     DSTFormer's grouped temporal view; D = 8 also at the served batch 256,
     128 clips and their flips, and at the train step's batch 32), K1 at
     D = 16, 32 and 64 and at D = 8 in bfloat16 bit for bit against the
     outputs before f32 at heads of 8 got a kernel of its own
     (`K1_DIGESTS`), and K3
     at C/H 512/1024 (eps 1e-6),
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
     use_tcn, hierarchical, graph_only and XS, STCFormer, KTPFormer and
     D3DP's default sampler), each on the card through the
     kernels against the CPU through the plain versions (B=4, f32 within
     1e-3; a model whose CPU f32 forward lies further than 1e-4 from its
     float64 forward, graph_only, layer by layer within 1e-3 of each layer's
     largest entry instead; the
     bf16 forward held as in phase 4), its K1/K3 launches per forward, and
     128-clip forward times; a profiler breakdown of the f32 128-clip
     forward of MixSTE, DSTFormer, STCFormer, KTPFormer, D3DP,
     MotionAGFormer-XS and hierarchical (device time and busy share, K3's
     and K1's group).
     D3DP's sampler also at 2 DDIM steps over 2 proposals, card against CPU
     on one generator (B=4), and at the paper's 10 steps over 20 proposals,
     timed on the card alone (B=4, ms per input clip).
  5c. serving MixSTE, STCFormer, KTPFormer and D3DP (whose eval forward,
     DDIM sampling, replaces the flip-TTA), the zoo's main path: serve() on
     cuda answers /healthz and a 405-frame /lift, against the CPU; launches
     read around it, a model at a time.
  6. K2 masked_sdpa_bwd against its plain version at the train shapes
     (spatial (32,27,17,128), temporal (32,17,27,128) with the gradient a
     transposed view), float32 and bfloat16, and the x60 spread; kernel,
     plain and scaled_dot_product_attention-backward times (kernel and SDPA
     in turns), each row's tiles, waves, share of its bound and its time
     over SDPA's; then the zoo's train shapes at batch 32, MotionAGFormer's
     heads of 8 (C = 64: (B,T,J,C) and its temporal permutation with a
     transposed gradient), DSTFormer's of 32 (flat spatial stream, grouped
     temporal view with a transposed gradient) and MixSTE's of 64 (flat
     spatial and temporal streams), both dtypes, a rerun bitwise equal, with
     the same times and shares; heads of 128 and 4 and C = 1024 raise; K2's
     registers, shared memory, spills, tile and grid an instantiation (D = 8,
     16, 32, 64) to --out/chip_smoke_k2_kernel.txt (a spill fails the phase).
     bfloat16 at heads of 16 (masked_sdpa_bwd_mma_kernel) also at N = 1,
     17, 27 and 32 in both views, each time beside a control that rounds
     neither P nor dS (K2 in float32 on the same values), which must lie
     over a K2_BF16_LIMITS limit from N = 2 on; and K2 at heads of 16, 32
     and 64 gives bit for bit the dq, dk and dv of `K2_DIGESTS`.
  7. K4 fused_mlp_ln_bwd against its plain version at M = 14,688 and 1,377,
     all eight gradients, and a rerun bitwise equal; the whole call's time,
     and each of its three launches' device time (dx pass, weight pass,
     reduce; torch.profiler over the timed calls) with each launch's own
     bound and share; the three launches' tiles, grids, registers, shared
     memory and spills an instantiation to --out (a spill in any fails the
     phase). Then the reduce alone on seeded partials of the same shapes,
     bit for bit against its plain version on the card (dls2 within the
     limit), its time, bound and share beside torch.sum over the weight
     partials (a yardstick of that part only), and its device time after
     other kernels (warm, a rewritten workspace, matmuls, a flushed L2).
     Then K4 at the zoo's widths (C/H 64/256, 256/1024, and 512/1024 at eps
     1e-6) at M = 14,688 and 1,377, both dtypes, all eight gradients, a
     rerun bitwise equal, the call's and each launch's time against its
     bound (at 256 and 512 a stage launch writes the dx pass's f32 weights
     first, and the dx pass and the weight pass run clusters of two blocks;
     at 64 the dx pass runs two warp groups a block, each over half the
     hidden width, and the weight pass one block on the tensor cores in
     3xTF32, its time also against its FFMA bound and its route's 3xTF32
     bound: each pass's cluster size,
     clusters resident, tiles and waves beside, the dx pass's warp groups
     and blocks a SM, the weight pass's chunk and row splits too); C = 32
     and 1024, and H = 192 at C = 64, raise. Last, K4 at C/H 128/512,
     256/1024 and 512/1024 on seeded inputs in both dtypes gives bit for bit
     the eight gradients it gave before the C = 64 dx pass became two warp
     groups (SHA-1 digests, `K4_DIGESTS`; bf16 at C = 128 since its passes
     moved to the tensor cores). In phases 6 and 7 the plain version runs
     in float32 on the kernel's own inputs, but for K2 in bf16 at heads of
     16 and K4 in bf16 at C = 128: there the tensor-core kernels round P and
     dS (K2), LN(x), the hidden, do and dz (K4) to bf16 as the TPU kernels
     do, and are held to the plain version run in bf16 (per element 1e-2;
     K2's results each also by their mean error, K2_BF16_LIMITS), K4's
     distance from the float32 plain version at most twice that plain
     version's own; each launch's kernel name, registers and spills are
     logged.
  8. full-model gradients: the train-mode loss and every parameter's
     gradient on the card (kernels) against the CPU (plain versions), same
     weights, B=4, the CPU's top-k adjacencies and ReLU gates replayed; the
     batch-norm running statistics; 104 K2 and 156 K4 launches per
     backward.
  9. the train step at the config's batch 32, float32 and bfloat16: median
     ms/step, clips/s, peak memory, device busy share and a profiler table
     (the profiles of phases 4 and 9 with the SM clock they ran at; K2's
     and K4's launches by kernel name), the K4 calls of the 12 timed steps
     and their K2 calls, which must be 104 a step (in bfloat16 through
     masked_sdpa_bwd_mma_kernel); then 50 steps on one batch in each dtype,
     whose loss must fall.
  9b. the zoo trains on the card (MixSTE, DSTFormer and MotionAGFormer base,
     use_tcn, hierarchical, graph_only and XS at full width, drop_path 0 as
     the config sets it, and D3DP's diffusion objective at -cs 512 -dep 8,
     its timesteps and noise drawn on each side from one seed): the B=4
     train-mode loss and every parameter's
     gradient on the card against the CPU, the CPU's top-k adjacencies and
     ReLU gates replayed (each within 1e-3 of its module's largest CPU
     entry, the loss within 1e-5), the expected K2 and K4 launches a backward;
     the float32 step at batch 32 of MixSTE, DSTFormer, MotionAGFormer-XS
     and hierarchical (median ms over 12 steps, clips/s, peak memory,
     profiler table by kernel group, K1, K2 and K4 launches read around the
     12 steps); one epoch of MixSTE through the CLI's
     `train` on phase 10's synthetic store, then `evaluate`, the launches
     read around `train`.
 10. training, the second main path: `train` through the CLI's entry point
     on a seeded synthetic .npz clip store (256 train, 64 test clips) for 2
     epochs, each evaluated, then `evaluate` of the best checkpoint, which
     must give its epoch's MPJPE; the launch counts are read around `train`.
The last lines: the card, one JSON object per kernel table, and
{"ok": true, "device": {...}}; a run of a subset (--phases) ends with the
card and the phases' verdict instead. A run in which a phase failed ends,
on stdout and last on stderr, with each failed phase and the last line of
its exception, and exits 1. Long reports (the compiler's register report,
the profiler table) go to --out, by default chip_smoke_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import http.client
import itertools
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
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}

FAILED: list[str] = []
# each failed phase's exception, the last line of its traceback
FAILURES: dict[str, str] = {}


def log(msg: str = "") -> None:
    print(msg, flush=True)


def report_failures(what: str) -> None:
    """Name the failed phases and their exceptions on stdout and, last of
    all, on stderr, whose end is what a caller that shows only the tail of
    the error stream (after the CLI's own logging) reads."""
    lines = [f"chip_smoke: FAILED: {what}"] + [
        f"  {name}: {FAILURES[name]}" for name in FAILED]
    for line in lines:
        log(line)
    print("\n".join(lines), file=sys.stderr, flush=True)


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
                FAILURES[name] = traceback.format_exc().strip().splitlines()[-1]
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
    runtime reports them, and its stage (rows a stage holds of q, k or v,
    the ring's stages and a stage's bytes; at heads of 8 in float32 one
    instantiation a block of four rows N is padded to), to
    --out/chip_smoke_k1_kernel.txt; one summary line an instantiation to the
    log. Raises if one spills."""
    import inspect

    import torch

    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.attention import masked_sdpa_kernel_info

    # an older tree's report (kept for A/B runs) takes no N and gives no stage
    by_rows = "n" in inspect.signature(masked_sdpa_kernel_info).parameters
    lines, spills = [], []
    for dt in (torch.float32, torch.bfloat16):
        for d in (8, 16, 32, 64):
            rows = d == 8 and dt == torch.float32 and by_rows
            for n in (range(4, 33, 4) if rows else (32,)):
                info = (masked_sdpa_kernel_info(dt, d, n=n) if by_rows else
                        masked_sdpa_kernel_info(dt, d))
                if "stages" in info and info["stages"] > 0:
                    info["stage_bytes"] = info["smem_bytes"] // info["stages"]
                line = (f"K1 {str(dt).split('.')[1]:8s} D={d:2d}"
                        + (f" N<={n:2d}" if rows else "") + ": " + ", ".join(
                            f"{k} {v}" for k, v in info.items()))
                lines.append(line)
                if info["spill_bytes"] != 0:
                    spills.append(line)
                log(f"   {line}")
    log(f"   K1 instantiations with local memory (spills): {spills or 'none'}")
    ptxas = _build.PTXAS.get("masked_sdpa", "(built before this process)")
    with open(os.path.join(out_dir, "chip_smoke_k1_kernel.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n== nvcc -Xptxas -v, masked_sdpa.cu\n"
                + ptxas + "\n")
    if spills:
        raise AssertionError(f"K1 instantiations spill: {spills}")


def k2_row_line(dt, seqs: int, n: int, heads: int, ms: float, lib: float,
                bms: float, d: int = 16) -> str:
    """A K2 row's tiles ((sequence, head group) pairs), the persistent grid,
    waves (tiles over the grid), its share of its bound and its time over
    the backward of one SDPA call (the tile fields only where the library
    reports them: an older tree's, kept for A/B runs, does not)."""
    from kasportsformer_torch.ops import attention

    share = f"share of bound {bms / ms:.1%}  K2/SDPA bwd {ms / lib:.3f}"
    if not hasattr(attention, "masked_sdpa_bwd_kernel_info"):
        return share
    info = (attention.masked_sdpa_bwd_kernel_info(dt, n) if d == 16 else
            attention.masked_sdpa_bwd_kernel_info(dt, n, d=d))
    grid = info["grid"]
    tiles = seqs * -(-heads // info["tile_heads"])
    return f"{tiles} tiles on {min(tiles, grid)} blocks, {tiles / grid:.2f} waves; " + share


def write_k2_report(out_dir: str) -> None:
    """K2's compiler report (`-Xptxas -v`: registers, spills) and each
    instantiation's threads, registers, shared memory, spills, blocks a SM,
    tile and grid as the runtime reports them, to
    --out/chip_smoke_k2_kernel.txt; one summary line an instantiation to the
    log. Raises if one spills."""
    import torch

    from kasportsformer_torch.ops import _build, attention

    if not hasattr(attention, "masked_sdpa_bwd_kernel_info"):  # an older tree
        log("   K2 reports no instantiations in this tree")
        return
    lines, spills = [], []
    # one instantiation a head width and block of four rows (an older tree's
    # library, kept for A/B runs, has the flagship's D = 16 only)
    widths = attention.LIMITS["masked_sdpa_bwd"][0]
    for dt in (torch.float32, torch.bfloat16):
        for d in widths:
            for n in range(4, 33, 4):
                info = (attention.masked_sdpa_bwd_kernel_info(dt, n) if d == 16 else
                        attention.masked_sdpa_bwd_kernel_info(dt, n, d=d))
                line = (f"K2 {str(dt).split('.')[1]:8s} D={d} N<={n:2d}: " + ", ".join(
                    f"{k} {v}" for k, v in info.items()))
                lines.append(line)
                if info["spill_bytes"] != 0:
                    spills.append(line)
                log(f"   {line}")
    log(f"   K2 instantiations with local memory (spills): {spills or 'none'}")
    ptxas = _build.PTXAS.get("masked_sdpa_bwd", "(built before this process)")
    with open(os.path.join(out_dir, "chip_smoke_k2_kernel.txt"), "w") as f:
        f.write("\n".join(lines) + "\n\n== nvcc -Xptxas -v, masked_sdpa_bwd.cu\n"
                + ptxas + "\n")
    if spills:
        raise AssertionError(f"K2 instantiations spill: {spills}")


def k3_tile_line(dt, m: int, c: int, h: int, ms: float, bms: float) -> str:
    """A K3 row's tile (rows a tile, blocks a tile: a cluster of two in
    float32 at C >= 256), tiles, grid (blocks of the launch: a tile a block,
    or persistent blocks or clusters walking several), waves (tiles over the
    tiles the card takes at once), registers, shared memory a block, the
    weight bytes its tiles read from L2 in a launch (every tile streams all
    of W1 and W2) and its share of the bound."""
    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp_ln_kernel_info

    info = fused_mlp_ln_kernel_info(dt, c, m)
    rows, cluster = info["rows"], info.get("cluster", 1)
    tiles = -(-m // rows)
    resident = info.get("resident", -1)
    if resident < 0:  # a library that reports no clusters: blocks a SM
        resident = (torch.cuda.get_device_properties(0).multi_processor_count
                    * info["blocks_per_sm"])
    l2 = tiles * 2 * c * h * dt.itemsize
    return (f"tile {rows} rows, cluster {cluster}: {tiles} tiles on "
            f"{info['grid']} blocks, {tiles / (resident // cluster):.2f} waves, "
            f"{info['registers']} registers, {info['smem_bytes']} B shared, "
            f"L2 weight reads {l2 / 1e6:.1f} MB; share of bound {bms / ms:.1%}")


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
    spills of K4's three kernels in both dtypes) and the three launches'
    instantiations (tile, the weight pass's chunk and row splits at
    M = 14,688, the reduce's grid, registers, shared memory, spills, blocks
    a SM) as the runtime reports them, to --out/chip_smoke_k4_kernel.txt;
    one summary line an instantiation to the log. Raises if any spills."""
    import torch

    from kasportsformer_torch.ops import _build
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd_kernel_info

    lines, spills = [], []
    for dt in (torch.float32, torch.bfloat16):
        for c, h in k4_widths():
            info_c = (fused_mlp_ln_bwd_kernel_info(dt, 14688, h) if c == 128 else
                      fused_mlp_ln_bwd_kernel_info(dt, 14688, h, c=c))
            for label, info in info_c.items():
                line = (f"K4 {label.replace('_', ' '):11s} {str(dt).split('.')[1]:8s} "
                        f"C/H={c}/{h} M=14688: " + ", ".join(
                            f"{k} {v}" for k, v in info.items()))
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


def k4_widths() -> tuple:
    """K4's (C, H): the flagship's, then the zoo's (MotionAGFormer-XS and
    hierarchical, DSTFormer, MixSTE) where the tree's K4 takes them (an
    older tree's, kept for A/B runs, does not)."""
    from kasportsformer_torch.ops.mlp import _WIDTHS

    return ((128, 512),) + tuple((c, h) for c, h in ((64, 256), (256, 1024), (512, 1024))
                                 if c in _WIDTHS["mlp_ln_bwd"])


# K4's launches, by the kernel names the profiler reports: at C = 256 and
# 512 a stage launch (both passes' f32 weights) first; each pass is one
# block a tile (a hidden chunk and row split) at C = 128 and a cluster of two
# at 256 and 512 (and one block at every width in a tree from before its
# cluster, kept for A/B runs), the dx pass at C = 64 one block of two
# warp groups, the weight pass at C = 64 one block on the tensor cores and
# the reduce at C = 64 its segment kernel and at 512 its kernel of equal
# blocks (each of C = 128's kind in an older tree), so each goes by all its
# kernels' names
K4_LAUNCHES = (("stage", ("mlp_ln_bwd_stage_kernel",)),
               ("dx pass", ("mlp_ln_bwd_dx_kernel", "mlp_ln_bwd_dx_cluster_kernel",
                            "mlp_ln_bwd_dx_wg_kernel", "mlp_ln_bwd_dx_mma_kernel")),
               ("weight pass", ("mlp_ln_bwd_w_kernel", "mlp_ln_bwd_w_cluster_kernel",
                                "mlp_ln_bwd_w_tc_kernel", "mlp_ln_bwd_w_mma_kernel")),
               ("reduce", ("mlp_ln_bwd_reduce_kernel", "mlp_ln_bwd_reduce_seg_kernel",
                           "mlp_ln_bwd_reduce_wide_kernel")))


def k4_launch_ms(call, iters: int, seen: dict | None = None) -> dict:
    """Device ms per launch of each of K4's kernels over `iters` calls of
    `call` (torch.profiler; a kernel it does not see is absent). Where
    `seen` is given, it gets each launch's kernel names as the profiler
    reports them."""
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
        for label, names in K4_LAUNCHES:
            if any(name in e.key for name in names):
                t, n = acc.get(label, (0.0, 0))
                acc[label] = (t + e.self_device_time_total, n + e.count)
                if seen is not None:
                    seen.setdefault(label, set()).add(kernel_name(e.key))
    return {label: t / 1e3 / n for label, (t, n) in acc.items()}


def kernel_name(key: str) -> str:
    """A profiler event's kernel name without its namespace, template
    arguments and parameters."""
    import re

    found = re.search(r"(\w+_kernel)\b", key)
    return found.group(1) if found else key[:60]


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


def mag_sdpa_views(dev, gen, dt, b: int, suffix: str) -> dict:
    """MotionAGFormer hierarchical's and XS's K1 operands at B = b: strided
    column slices of one (b, 27, 17, 192) qkv projection over 8 heads of 8,
    (B,T,J,C) and its temporal permutation; `suffix` ends each name."""
    import torch

    mag = torch.randn(b, 27, 17, 192, device=dev, generator=gen).to(dt).split(64, dim=-1)
    return {f"MAG spatial D=8{suffix}": (mag, 8),
            f"MAG temporal D=8{suffix}": (tuple(z.transpose(1, 2) for z in mag), 8)}


def zoo_sdpa_views(dev, gen, dt, b: int = 128):
    """K1's (and K2's) operands as the zoo passes them at B = b, 27 frames:
    strided column slices of one qkv projection, in the layouts of
    MotionAGFormer hierarchical (C 64 over 8 heads, (B,T,J,C) and its
    temporal permutation), DSTFormer (C 256: a flat (B*F,J,C) stream and the
    grouped (B,J,F,C) view of its temporal attention) and MixSTE (C 512: flat
    spatial and temporal streams)."""
    import torch

    def split(shape, c):
        qkv = torch.randn(*shape, 3 * c, device=dev, generator=gen).to(dt)
        return qkv.split(c, dim=-1)

    dst = split((b * 27, 17), 256)
    return {
        **mag_sdpa_views(dev, gen, dt, b, ""),
        "DST spatial D=32": (dst, 8),
        "DST temporal D=32": (tuple(z.reshape(b, 27, 17, 256).transpose(1, 2)
                                    for z in dst), 8),
        "MixSTE spatial D=64": (split((b * 27, 17), 512), 8),
        "MixSTE temporal D=64": (split((b * 17, 27), 512), 8),
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
        # the zoo's views at batch 128, then MotionAGFormer's at the served
        # batch (128 clips and their flips) and at the train step's batch 32
        views = {**zoo_sdpa_views(dev, gen, dt),
                 **mag_sdpa_views(dev, gen, dt, 256, " B=256"),
                 **mag_sdpa_views(dev, gen, dt, 32, " B=32")}
        for name, ((qq, kk, vv), heads) in views.items():
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
            log(f"   K1 {name:27s} {dname:8s} {tuple(qq.shape)} err {err:.2e} "
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
    check_k1_digests(dev)
    write_k1_report(out_dir)
    write_k3_report(out_dir)
    return rows


# k1_digests on an H100 before K1 at heads of 8 in float32 got a kernel of
# its own: the outputs at the other head widths and at heads of 8 in
# bfloat16, whose code that change left alone
K1_DIGESTS = {
    ("flagship spatial D=16", "float32"): "2e1e3053373e",
    ("flagship temporal D=16", "float32"): "f3118ddbac96",
    ("DST spatial D=32", "float32"): "e5e6bc69c8ec",
    ("DST temporal D=32", "float32"): "4904fcbfc476",
    ("MixSTE spatial D=64", "float32"): "2ced306b9e01",
    ("MixSTE temporal D=64", "float32"): "ec40dd7af3c9",
    ("flagship spatial D=16", "bfloat16"): "930a12e921a5",
    ("flagship temporal D=16", "bfloat16"): "9f9a01bcb7b7",
    ("MAG spatial D=8", "bfloat16"): "0b1e6b09283b",
    ("MAG temporal D=8", "bfloat16"): "8b9cfe312e75",
    ("DST spatial D=32", "bfloat16"): "7ae3aa0cd882",
    ("DST temporal D=32", "bfloat16"): "676b309bc098",
    ("MixSTE spatial D=64", "bfloat16"): "539258f58c8a",
    ("MixSTE temporal D=64", "bfloat16"): "8ecb6f660322"}


def check_k1_digests(dev) -> None:
    """K1 at heads of 16, 32 and 64 in both dtypes, and at heads of 8 in
    bfloat16, gives bit for bit the outputs of `K1_DIGESTS`; raises where
    one differs."""
    got = k1_digests(dev)
    changed = [key for key, want in K1_DIGESTS.items() if got[key] != want]
    log(f"   K1 at heads of 16, 32 and 64 (the flagship's and phase 3d's views, f32 and bf16) "
        f"and of 8 in bf16: "
        f"the outputs' SHA-1 digests {'equal' if not changed else 'NOT equal'} to those before "
        f"f32 at heads of 8 got a kernel of its own"
        + (f": changed at {changed}" if changed else ""))
    if changed:
        raise AssertionError(f"K1's outputs changed at (view, dtype) {changed}")


def k1_digests(dev) -> dict:
    """SHA-1 (12 hex digits) of K1's output on the seeded inputs of
    `scripts/torch_ab.sh digest` (generator seed 17), each dtype in turn:
    the flagship's (128, 27, 17, 128) over 8 heads of 16 and its temporal
    view, then phase 3d's views at batch 128, DSTFormer's (heads of 32),
    MixSTE's (heads of 64) and, in bfloat16 only, MotionAGFormer's (heads
    of 8); {(view name, dtype name): digest}."""
    import hashlib

    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa

    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = torch.randn(128, 27, 17, 384, device=dev, generator=gen).to(dt).split(128, -1)
        views = {"flagship spatial D=16": ((q, k, v), 8),
                 "flagship temporal D=16": (tuple(z.transpose(1, 2) for z in (q, k, v)), 8),
                 **zoo_sdpa_views(dev, gen, dt)}
        for name, ((qq, kk, vv), heads) in views.items():
            if "D=8" in name and dt == torch.float32:  # f32 at heads of 8 was redesigned
                continue
            y = masked_sdpa(qq, kk, vv, (qq.shape[-1] // heads) ** -0.5, heads)
            out[(name, str(dt).split(".")[1])] = hashlib.sha1(
                y.float().cpu().numpy().tobytes()).hexdigest()[:12]
    return out


def perturbed(cfg, seed: int):
    """The model of `cfg` on the CPU, every weight and batch-norm statistic
    re-drawn at O(0.1-1) from a seeded generator (at init the layer scales
    are 1e-5, the fusion gates constant and DSTFormer's weights 0.02 wide)."""
    import torch

    from kasportsformer_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(cfg, device="cpu", generator=gen)
    constants = ("norm_adj", "limb_idx", "base_adj", "freqs", "zero_b1", "zero_b2")
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.uniform_(0.5, 1.5, generator=gen)
            elif "layer_scale" in name:
                t.uniform_(0.1, 0.5, generator=gen)
            elif name.endswith(constants):
                continue
            elif name.endswith("gconv.W"):  # KTPFormer's (2, in, out)
                t.normal_(0.0, t.shape[1] ** -0.5, generator=gen)
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


def profile(model, xb, dtype, out_dir: str, label: str = "") -> None:
    """Device time by kernel over one 128-clip forward in `dtype`, and the
    device's busy share of the wall time (torch.profiler; reported, never
    fatal). `label` names a model other than the flagship."""
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
        what = f"{label} {dname}" if label else dname
        path = os.path.join(out_dir, f"chip_smoke_profile_{what.replace(' ', '_')}.txt")
        with open(path, "w") as f:
            f.write(f"one 128-clip {what} forward, wall {wall_us / 1e3:.3f} "
                    f"ms, device busy {busy / 1e3:.3f} ms, {launches} device "
                    f"kernels\n" + "\n".join(lines))
        log(f"   profile of one 128-clip {what} forward: wall "
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
        log(f"   profile {label} {dname}: not measured ({type(e).__name__}: {e})")
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
# and as MotionAGFormer-XS (Mehraban et al., WACV 2024, Table 1: 12 layers of
# 64 channels, 8 heads of 8, MLP ratio 4)
_MAG = dict(model_name="MotionAGFormer", dim_feat=128, n_layers=16,
            num_heads=8, mlp_ratio=4.0)
ZOO = {"MixSTE": dict(model_name="MixSTE", dim_in=2, dim_feat=512, n_layers=8,
                      num_heads=8, mlp_ratio=2.0),
       "DSTFormer": dict(model_name="DSTFormer", dim_feat=256, n_layers=5,
                         num_heads=8, mlp_ratio=4.0),
       "MotionAGFormer": _MAG,
       "MotionAGFormer use_tcn": dict(_MAG, use_tcn=True),
       "MotionAGFormer hierarchical": dict(_MAG, hierarchical=True),
       "MotionAGFormer graph_only": dict(_MAG, graph_only=True),
       "MotionAGFormer-XS": dict(_MAG, dim_feat=64, n_layers=12),
       # STCFormer's published 6 blocks of 256 (the JAX config's defaults);
       # KTPFormer keeps MixSTE's trunk (arXiv:2404.00658); D3DP's -cs 512
       # -dep 8, served as the registry builds it: 1 proposal, 1 DDIM step,
       # the flip inside the sampler
       "STCFormer": dict(model_name="STCFormer", dim_feat=256, n_layers=6,
                         num_heads=8),
       "KTPFormer": dict(model_name="KTPFormer", dim_feat=512, n_layers=8,
                         num_heads=8, mlp_ratio=2.0),
       "D3DP": dict(model_name="D3DP", dim_feat=512, n_layers=8, num_heads=8,
                    mlp_ratio=2.0)}
# K1 and K3 launches per forward, and K2 and K4 per backward: a block's
# attention core and MLP tail (MixSTE 2 x 8 blocks; DSTFormer 4 half blocks
# x 5; MotionAGFormer 2 attention and 4 former modules x 16 layers (12 in
# XS), graph_only 2 graph modules; STCFormer's split attention is plain
# torch, its 6 MLP tails K3; KTPFormer KPA, TPA and 2 x 8 blocks; D3DP one
# denoiser call of 2 x 8 blocks: forward on the 8 stacked clips of B=4 and
# its flip, and in training on the B=4 noised targets, no flip)
ZOO_LAUNCHES = {"MixSTE": (16, 16), "DSTFormer": (20, 20),
                "MotionAGFormer": (32, 64), "MotionAGFormer use_tcn": (32, 64),
                "MotionAGFormer hierarchical": (32, 64),
                "MotionAGFormer graph_only": (32, 32),
                "MotionAGFormer-XS": (24, 48), "STCFormer": (0, 6),
                "KTPFormer": (18, 18), "D3DP": (16, 16)}
# the zoo models phase 5c serves, whose K1/K3 launches the kernels line counts
ZOO_SERVED = ("MixSTE", "STCFormer", "KTPFormer", "D3DP")
# the MotionAGFormer configurations phase 9b trains, and those it times at
# batch 32 beside MixSTE and DSTFormer (the 64-channel ones, K2 at heads of
# 8 and K4 at C = 64)
MAG_ZOO = tuple(n for n in ZOO if n.startswith("MotionAGFormer"))
ZOO_STEPS = ("MixSTE", "DSTFormer", "MotionAGFormer-XS", "MotionAGFormer hierarchical")


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
def check_zoo_models(dev, out_dir: str) -> dict:
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
            if amplified and not hasattr(model, "layers"):
                raise AssertionError(f"{name}: CPU f32 {cpu64} from its f64 "
                                     "forward, and no layers to hold one by one")
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
        if name in ("MixSTE", "DSTFormer", "STCFormer", "KTPFormer", "D3DP",
                    "MotionAGFormer-XS", "MotionAGFormer hierarchical"):
            profile(model, xb, torch.float32, out_dir, label=name)
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
        if name == "D3DP":
            res[name]["samplers"] = check_d3dp_samplers(model, cpu_model, dev)
        del model, cpu_model
    return res


def check_d3dp_samplers(model, cpu_model, dev) -> dict:
    """D3DP's sampler at 2 DDIM steps over 2 proposals, f32, card against
    CPU on one generator (B=4: 16 stacked clips a denoiser call, 2 calls);
    then the paper's eval sampler, 10 steps over 20 proposals (one call of
    160 clips a step at B=4), timed on the card alone: its CPU reference
    would take minutes."""
    import dataclasses

    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa
    from kasportsformer_torch.ops.mlp import fused_mlp_ln

    cfg = model.cfg
    x = clip_batch(torch.Generator().manual_seed(40), 4)
    try:
        for m in (model, cpu_model):
            m.compute_dtype = torch.float32
            m.cfg = dataclasses.replace(cfg, sampling_timesteps=2, num_proposals=2)
        with torch.inference_mode():
            want = cpu_model.sample(x, torch.Generator().manual_seed(41))
            k1, k3 = masked_sdpa.launches, fused_mlp_ln.launches
            got = model.sample(x.to(dev), torch.Generator().manual_seed(41))
            torch.cuda.synchronize()
            d = (masked_sdpa.launches - k1, fused_mlp_ln.launches - k3)
            dev_s = (got.cpu() - want).abs().max().item()
            model.cfg = dataclasses.replace(cfg, sampling_timesteps=10,
                                            num_proposals=20)
            xd = x.to(dev)
            paper = time_ms(lambda: model.sample(xd), 2, warmup=1)
    finally:
        model.cfg = cpu_model.cfg = cfg
    log(f"   D3DP sampler, 2 DDIM steps x 2 proposals, B=4: output "
        f"{tuple(got.shape)}, K1/K3 launches {d} (expected (32, 32)); f32 max "
        f"abs deviation card vs CPU on one generator {dev_s:.3e}; the paper's "
        f"eval sampler, 10 steps x 20 proposals, B=4: {paper:.2f} ms, "
        f"{paper / 4:.2f} ms per input clip ({4e3 / paper:.2f} clips/s)")
    if d != (32, 32):
        raise AssertionError(f"D3DP sampler: launches {d}")
    if not (torch.isfinite(got).all() and dev_s <= 1e-3):
        raise AssertionError(f"D3DP sampler: card vs CPU deviation {dev_s}")
    return {"deviation_f32": dev_s, "paper_ms": paper,
            "paper_ms_per_clip": paper / 4}


@phase("phase 5c: serving the zoo on the card (the zoo's main path)")
def check_zoo_serving(dev) -> dict:
    """serve() builds whatever model it is given: each of ZOO_SERVED (D3DP's
    eval forward, DDIM sampling with the flip inside, replaces the service's
    flip-TTA) at full width, f32, batch 128, answers /healthz and a
    405-frame /lift, and the served poses agree with the plain versions on
    the CPU. The counts are set to 0 as this phase starts; it returns each
    model's K1/K3 launches, and fails if a kernel its forward runs was not
    launched serving it."""
    import numpy as np
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa
    from kasportsformer_torch.ops.mlp import fused_mlp_ln
    from kasportsformer_torch.serving import LiftService, serve

    req = {"keypoints": np.random.default_rng(31).uniform(
        0, 1000, (405, 17, 2)).tolist(), "width": 1920, "height": 1080}
    kpts = np.asarray(req["keypoints"], np.float32)
    masked_sdpa.launches = 0
    fused_mlp_ln.launches = 0
    launches = {}
    for i, name in enumerate(ZOO_SERVED):
        cpu_model = perturbed(zoo_config(name), seed=30 + 2 * i)
        model = copy.deepcopy(cpu_model).to(dev)
        before = (masked_sdpa.launches, fused_mlp_ln.launches)
        srv = serve(model, host="127.0.0.1", port=0, batch_size=128,
                    model_name=name, device=dev)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            status, data, lat = _request(srv.server_address[1], "GET", "/healthz")
            assert status == 200 and data["model"] == name, data
            assert data["params"] == model.parameter_count(), data
            log(f"   {name} /healthz {status} {data} in {lat * 1e3:.1f} ms")
            status, data, lat = _request(srv.server_address[1], "POST", "/lift",
                                         req)
            assert status == 200, (name, status, data)
        finally:
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=60)
        d = (masked_sdpa.launches - before[0], fused_mlp_ln.launches - before[1])
        poses = np.asarray(data["poses"], np.float32)
        want = LiftService(cpu_model, batch_size=128, device="cpu").lift_sequence(
            kpts, req["width"], req["height"])
        dev405 = float(np.abs(poses - want).max())
        log(f"   {name} /lift 405 frames: {status}, 15 clips, {lat * 1e3:.1f} ms; "
            f"served vs CPU plain versions {dev405:.3e}; K1/K3 launches "
            f"serving it (warm-up included) {d}")
        if not (poses.shape == (405, 17, 3) and np.isfinite(poses).all()
                and np.abs(poses[:, 0]).max() == 0.0 and dev405 <= 1e-3):
            raise AssertionError(f"served {name} poses: {poses.shape}, {dev405}")
        if any(want_k and not got_k
               for want_k, got_k in zip(ZOO_LAUNCHES[name], d)):
            raise AssertionError(f"{name}: a kernel was not launched: {d}")
        launches[name] = d
        del model, cpu_model
    log(f"   K1/K3 launches in this phase, by model: {launches}")
    return launches


# ------------------------------------------------------------ training path


def _errs(got, want) -> list[float]:
    return [scaled_err(a, b) for a, b in zip(got, want)]


def sum_err(got, want) -> float:
    """max |got - want| / max(1, max |want|): for a gradient summed over
    many rows, whose small entries are cancellations of large terms."""
    g, w = got.float(), want.float()
    return ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()


# K2 in bfloat16 at heads of 16 (masked_sdpa_bwd_mma_kernel) against the
# plain version run in bfloat16 on the same inputs. Both round P (for dV),
# dS and dq, dk, dv where _attn_bwd_kernel rounds them, so they differ only
# where a sum order moves a value across a rounding edge. A per-element
# limit cannot tell that from a kernel that rounds only its results (both
# lie within an ulp of each entry), so each result is also held, as a
# whole, to mean |a - b| / mean |b| (mean_err) within its limit here, where
# K2 in float32 on the same values (the CUDA-core kernel's numerics, only
# the results rounded) lies over one from N = 2 on. Read over 4 seeds at
# N = 1, 17, 27 and 32, both views (NVIDIA H100 80GB HBM3, 700 W,
# scripts/k2_bf16_limits.py): the kernel <= 5.9e-7 on each result (2.1e-6
# at phase 6's x60 spread), the control >= 1.59e-3 from N = 17 on; both 0 at
# N = 1, where P is 1 and dS 0
K2_BF16_LIMITS = {"dq": 1e-4, "dk": 1e-4, "dv": 1e-4}
_K2_GRADS = ("dq", "dk", "dv")


def mean_err(got, want) -> float:
    """mean |got - want| / mean |want| (the absolute mean where want is 0)."""
    g, w = got.float(), want.float()
    return ((g - w).abs().mean() / w.abs().mean().clamp(min=1e-30)).item()


def k2_kernel(dt, n: int, d: int = 16) -> str:
    """The kernel of K2's instantiation for (dt, N = n, heads of d):
    masked_sdpa_bwd_mma_kernel (bfloat16 at heads of 16: P and dS rounded to
    bfloat16 on the tensor cores) or masked_sdpa_bwd_kernel (exact float32);
    "unknown" in an older tree, kept for A/B runs, whose library does not
    say."""
    from kasportsformer_torch.ops import attention

    if not hasattr(attention, "masked_sdpa_bwd_kernel_info"):
        return "unknown"
    mma = attention.masked_sdpa_bwd_kernel_info(dt, n, d=d).get("mma")
    return {1: "masked_sdpa_bwd_mma_kernel", 0: "masked_sdpa_bwd_kernel"}.get(mma, "unknown")


def k2_rounds(dt, n: int, d: int = 16) -> bool:
    """Whether K2's instantiation for (dt, N = n, heads of d) rounds P and
    dS to bfloat16."""
    return k2_kernel(dt, n, d) == "masked_sdpa_bwd_mma_kernel"


def k2_against_plain(got, args, scale: float, heads: int, tol: float):
    """K2's (dq, dk, dv) on args against its plain version: where its
    instantiation rounds P and dS (bfloat16 at heads of 16), the plain
    version run in bfloat16, each result per element within 1e-2 (scaled by
    max(1, |y|)) and within its K2_BF16_LIMITS mean error; else the plain
    version run in float32, per element within tol. Returns (want, the
    per-element errors, the mean errors or None, whether all hold)."""
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa_bwd_reference

    q = args[0]
    rounds = k2_rounds(q.dtype, q.shape[-2], q.shape[-1] // heads)
    want = masked_sdpa_bwd_reference(*(args if rounds else (z.float() for z in args)),
                                     scale, heads)
    errs = _errs(got, want)
    means = [mean_err(a, w) for a, w in zip(got, want)] if rounds else None
    ok = (all(torch.isfinite(z).all() for z in got) and max(errs) <= (1e-2 if rounds else tol)
          and (means is None or all(m <= K2_BF16_LIMITS[nm] for nm, m in zip(_K2_GRADS, means))))
    return want, errs, means, ok


def k2_means_text(means) -> str:
    return "" if means is None else " mean err " + ", ".join(
        f"{nm} {m:.2e} ({K2_BF16_LIMITS[nm]:.0e})" for nm, m in zip(_K2_GRADS, means))


@phase("phase 6: K2 masked_sdpa_bwd vs plain")
def check_k2(dev, out_dir: str) -> dict:
    import torch
    import torch.nn.functional as F

    from kasportsformer_torch.ops.attention import (masked_sdpa_bwd,
                                                    masked_sdpa_bwd_reference)

    gen = torch.Generator(device=dev).manual_seed(6)
    heads, scale = 8, 16 ** -0.5
    # per element against the plain version in float32 on the same inputs
    # (float32: summation order only), but bfloat16 at heads of 16: see
    # k2_against_plain
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
            want, errs, means, ok = k2_against_plain(got, (qq, kk, vv, gg), scale, heads,
                                                     tol[dt])
            if not ok:
                raise AssertionError(f"K2 {mode} {dt}: errs {errs} > {tol[dt]}"
                                     + k2_means_text(means))
            b, g, n, c = qq.shape
            # the library yardstick: the backward of one SDPA call on
            # (B*G, H, N, D), timed in turns with the kernel
            qh, kh, vh, gh = (z.reshape(b * g, n, heads, c // heads)
                              .transpose(1, 2).contiguous().requires_grad_(z is not gg)
                              for z in (qq, kk, vv, gg))
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            ms, lib = interleaved_ms(
                lambda: masked_sdpa_bwd(qq, kk, vv, gg, scale, heads),
                lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), gh,
                                            retain_graph=True), 50)
            plain = time_ms(lambda: masked_sdpa_bwd_reference(
                qq, kk, vv, gg, scale, heads), 20)
            dname = str(dt).split(".")[1]
            nbytes = 7 * b * g * n * c * qq.element_size()
            flops = 10 * b * g * n * n * c
            bms, by = bound_ms(nbytes, flops, dname)
            rows[(mode, dname)] = dict(shape=[b, g, n, c], max_abs_err=max(
                (a.float() - w).abs().max().item() for a, w in zip(got, want)),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            log(f"   K2 {mode:8s} {dname:8s} {tuple(qq.shape)} err dq/dk/dv "
                + "/".join(f"{e:.2e}" for e in errs)
                + f" (limit {1e-2 if means is not None else tol[dt]:.0e}"
                + (", from the plain version in bfloat16)" if means is not None else ")")
                + k2_means_text(means) + f" kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"sdpa bwd {lib:.4f}  bound {bms:.4f} ({by})  "
                + k2_row_line(dt, b * g, n, heads, ms, lib, bms))
    q, k, v, g = (torch.randn(2, 4, 17, 128, device=dev, generator=gen)
                  for _ in range(4))
    q[..., :16] *= 60.0
    k[..., :16] *= 60.0
    for dt in (torch.float32, torch.bfloat16):
        args = [z.to(dt) for z in (q, k, v, g)]
        got = masked_sdpa_bwd(*args, 0.25, heads)
        _, errs, means, ok = k2_against_plain(got, args, 0.25, heads, tol[dt])
        if not ok:
            raise AssertionError(f"K2 x60 spread {dt}: errs {errs}" + k2_means_text(means))
        log(f"   K2 x60 inter-head spread {dt}: errs "
            + "/".join(f"{e:.2e}" for e in errs) + k2_means_text(means))
    check_k2_bf16_rounding(dev, gen)
    from kasportsformer_torch.ops import attention
    if 64 in attention.LIMITS["masked_sdpa_bwd"][0]:  # an older tree has D = 16 only
        rows.update(check_k2_zoo(dev, gen, tol))
        check_k2_digests(dev)
    write_k2_report(out_dir)
    return rows


def k2_bf16_case(dev, gen, n: int, view: str, b: int = 8, g: int = 27):
    """bfloat16 q, k, v and g at heads of 16, C = 128: column slices of one
    qkv projection of (b, g, n) rows ("spatial"), or of (b, n, g) rows
    permuted to (b, g, n) with a transposed gradient ("temporal")."""
    import torch

    lead = (b, g, n) if view == "spatial" else (b, n, g)
    qkv = torch.randn(*lead, 384, device=dev, generator=gen).to(torch.bfloat16)
    gr = torch.randn(*lead, 128, device=dev, generator=gen).to(torch.bfloat16)
    args = (*qkv.split(128, dim=-1), gr)
    return args if view == "spatial" else tuple(z.transpose(1, 2) for z in args)


def k2_bf16_control(args, scale: float, heads: int):
    """K2 in float32 on the values of bfloat16 args, its results rounded to
    bfloat16: what a kernel that rounds neither P nor dS gives."""
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa_bwd

    return tuple(z.to(torch.bfloat16) for z in masked_sdpa_bwd(
        *(z.float() for z in args), scale, heads))


def check_k2_bf16_rounding(dev, gen) -> None:
    """K2 in bfloat16 at heads of 16 at N = 1, 17, 27 and 32, spatial and
    temporal views: within its limits of the plain version run in bfloat16
    (k2_against_plain) and a rerun bitwise equal, and the control
    (k2_bf16_control) over a mean limit from N = 2 on: the checks tell a
    kernel that rounds P and dS from one that does not. Raises otherwise."""
    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa_bwd

    if not k2_rounds(torch.bfloat16, 17):  # an older tree's K2
        log("   K2 bfloat16 at heads of 16: this tree's kernel rounds only its results")
        return
    heads, scale = 8, 16 ** -0.5
    for n in (1, 17, 27, 32):
        for view in ("spatial", "temporal"):
            args = k2_bf16_case(dev, gen, n, view)
            got = masked_sdpa_bwd(*args, scale, heads)
            again = masked_sdpa_bwd(*args, scale, heads)
            want, errs, means, ok = k2_against_plain(got, args, scale, heads, 1e-2)
            ctl = k2_bf16_control(args, scale, heads)
            ctl_means = [mean_err(a, w) for a, w in zip(ctl, want)]
            ctl_over = any(m > K2_BF16_LIMITS[nm] for nm, m in zip(_K2_GRADS, ctl_means))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            log(f"   K2 bfloat16 N={n:2d} {view:8s} {tuple(args[0].shape)}: kernel err "
                + "/".join(f"{e:.2e}" for e in errs) + k2_means_text(means)
                + "; control mean err " + "/".join(f"{m:.2e}" for m in ctl_means)
                + f" ({'over' if ctl_over else 'WITHIN'} a limit); rerun bitwise equal {same}")
            if not (ok and same and (ctl_over or n == 1)):
                raise AssertionError(f"K2 bfloat16 N={n} {view}: kernel within its limits "
                                     f"{ok}, rerun equal {same}, control over a limit {ctl_over}")


# k2_digests on an H100 before K2's tile at heads of 8 took eight heads: the
# outputs at the other head widths, whose instantiations that change left
# alone. bfloat16 at heads of 16 taken anew when it moved to the tensor cores
# (masked_sdpa_bwd_mma_kernel), which round P and dS to bfloat16 where the TPU
# kernel does: its outputs are meant to differ from the exact float32 ones
K2_DIGESTS = {
    (16, "float32"): "e71fbeea5386 06b6bd4608f3 1a8ab6c33868",
    (16, "bfloat16"): "fd9ee027fd3a 2c4e058ddf3e 0da2bedad691",
    (32, "float32"): "6f58124588bb 71721f088f17 a63594cb7fb5",
    (32, "bfloat16"): "a53e72a2057a bff9f178506f 6c47a390d624",
    (64, "float32"): "3f0f91e1518e 544eccee4af0 17376d4cc065",
    (64, "bfloat16"): "9e59b20a793a f53921278821 f6974a2ec060"}


def check_k2_digests(dev) -> None:
    """K2 at heads of 16, 32 and 64 in both dtypes gives bit for bit the dq,
    dk and dv of `K2_DIGESTS`; raises where one differs."""
    got = k2_digests(dev)
    changed = [key for key, want in K2_DIGESTS.items() if got[key] != want]
    log(f"   K2 at heads of 16, 32 and 64 (8 heads, batch 32, temporal views, f32 and bf16): "
        f"dq, dk and dv's SHA-1 digests {'equal' if not changed else 'NOT equal'} to "
        f"K2_DIGESTS" + (f": changed at {changed}, now "
                         + "; ".join(f"{key} {got[key]}" for key in changed) if changed else ""))
    if changed:
        raise AssertionError(f"K2's outputs changed at (D, dtype) {changed}")


def k2_digests(dev) -> dict:
    """SHA-1 (12 hex digits) of K2's dq, dk and dv on the seeded inputs of
    `scripts/torch_ab.sh digest` (generator seed 11): at heads of 16, 32 and
    64, each in float32 and bfloat16, 8 heads on the temporal views of a
    (32, 27, 17, 24 D) qkv projection with a transposed gradient;
    {(d, dtype name): "dq dk dv"}."""
    import hashlib

    import torch

    from kasportsformer_torch.ops.attention import masked_sdpa_bwd

    gen = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for d in (16, 32, 64):
        for dt in (torch.float32, torch.bfloat16):
            qkv = torch.randn(32, 27, 17, 24 * d, device=dev, generator=gen).to(dt)
            g = torch.randn(32, 27, 17, 8 * d, device=dev, generator=gen).to(dt)
            q, k, v = (z.transpose(1, 2) for z in qkv.split(8 * d, dim=-1))
            grads = masked_sdpa_bwd(q, k, v, g.transpose(1, 2), d ** -0.5, 8)
            out[(d, str(dt).split(".")[1])] = " ".join(
                hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12] for t in grads)
    return out


def check_k2_zoo(dev, gen, tol: dict) -> dict:
    """K2 at the zoo's train shapes (batch 32, 27 frames): MotionAGFormer-XS's
    and hierarchical's heads of 8 (C = 64: (B, T, J, C) spatially and its
    (B, J, T, C) permutation temporally, the gradient a transposed view),
    DSTFormer's heads of 32 (C = 256: the flat spatial stream and the
    grouped temporal view, its gradient a transposed view) and MixSTE's of
    64 (C = 512: flat spatial and temporal streams), both dtypes, against
    the plain version in float32 and a rerun bitwise equal, with the
    kernel's, the plain version's and SDPA's backward times; then shapes
    outside K2's range (heads of 128 and of 4, C = 1024) raise."""
    import torch
    import torch.nn.functional as F

    from kasportsformer_torch.ops.attention import (masked_sdpa_bwd,
                                                    masked_sdpa_bwd_reference)

    from kasportsformer_torch.ops import attention

    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for name, ((qq, kk, vv), heads) in zoo_sdpa_views(dev, gen, dt, 32).items():
            c = qq.shape[-1]
            d = c // heads
            if d not in attention.LIMITS["masked_sdpa_bwd"][0]:  # an older tree's
                continue
            scale = d ** -0.5
            if qq.dim() == 3:  # a flat stream enters as the view (1, M, N, C)
                qq, kk, vv = (z[None] for z in (qq, kk, vv))
            if "temporal D=" in name and qq.shape[0] == 32:  # a permuted view
                gg = torch.randn(32, 27, 17, c, device=dev, generator=gen).to(dt).transpose(1, 2)
            else:
                gg = torch.randn(qq.shape, device=dev, generator=gen).to(dt)
            got = masked_sdpa_bwd(qq, kk, vv, gg, scale, heads)
            again = masked_sdpa_bwd(qq, kk, vv, gg, scale, heads)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            want = masked_sdpa_bwd_reference(*(z.float() for z in (qq, kk, vv, gg)),
                                             scale, heads)
            errs = _errs(got, want)
            if not (same and all(torch.isfinite(z).all() for z in got)
                    and max(errs) <= tol[dt]):
                raise AssertionError(f"K2 {name} {dt}: errs {errs} > {tol[dt]}, "
                                     f"rerun bitwise equal {same}")
            lead, n = qq.shape[:-2].numel(), qq.shape[-2]
            qh, kh, vh, gh = (z.reshape(lead, n, heads, d).transpose(1, 2).contiguous()
                              .requires_grad_(z is not gg) for z in (qq, kk, vv, gg))
            sdpa_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
            ms, lib = interleaved_ms(
                lambda: masked_sdpa_bwd(qq, kk, vv, gg, scale, heads),
                lambda: torch.autograd.grad(sdpa_out, (qh, kh, vh), gh,
                                            retain_graph=True), 20)
            plain = time_ms(lambda: masked_sdpa_bwd_reference(
                qq, kk, vv, gg, scale, heads), 10)
            bms, by = bound_ms(7 * lead * n * c * qq.element_size(),
                               10 * lead * n * n * c, dname)
            rows[(name, dname)] = dict(shape=list(qq.shape), max_abs_err=max(
                (a.float() - w).abs().max().item() for a, w in zip(got, want)),
                ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
            log(f"   K2 {name:20s} {dname:8s} {tuple(qq.shape)} err dq/dk/dv "
                + "/".join(f"{e:.2e}" for e in errs) + f" (limit {tol[dt]:.0e}), "
                f"rerun bitwise equal; kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"sdpa bwd {lib:.4f}  bound {bms:.4f} ({by})  "
                + k2_row_line(dt, lead, n, heads, ms, lib, bms, d))
    q = torch.randn(2, 3, 17, 256, device=dev)
    w = torch.randn(2, 3, 17, 1024, device=dev)
    refused = 0
    for call in (lambda: masked_sdpa_bwd(q, q, q, q, 0.1, 2),   # heads of 128
                 lambda: masked_sdpa_bwd(*(q[..., :64],) * 4, 0.1, 16),  # of 4
                 lambda: masked_sdpa_bwd(w, w, w, w, 0.1, 16)):  # C = 1024
        try:
            call()
        except ValueError:
            refused += 1
    log(f"   K2 at D=128, at D=4 and at C=1024: {refused} of 3 refused")
    if refused != 3:
        raise AssertionError("K2 took a shape outside its range")
    return rows


_MLP_GRADS = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2", "dls2")


# K4 in bfloat16 at C = 128 (the tensor-core passes) against the plain
# version run in bfloat16, a gradient at a time (dx per element scaled by
# max(1, |y|), the parameter gradients against their largest entry). Both
# round LN(x), the hidden, do and dz, so they differ where a sum order moves
# a value across a rounding edge: dx by at most an ulp of its bfloat16
# (2^-7 relative); dgamma, dbeta, db1 and dls2 by at most 2e-4 and dW1 by
# 1.4e-3 (M = 1 and 5; 6.3e-4 from M = 39 up), where a kernel that does not
# round lands at 2.0e-3 or more on each of the five, dW1 at 3.0e-3 or more
# (NVIDIA H100 80GB HBM3, 700 W, scripts/k4_bf16_limits.py); dW2 = ls2 G and
# db2 = ls2 sum g from g itself, where the plain version rounds do = g ls2
# first, so within that rounding and a flip of h's (2^-8; read up to 3.4e-3)
K4_BF16_LIMITS = {"dx": 1e-2, "dgamma": 1e-3, "dbeta": 1e-3, "dw1": 2e-3, "db1": 1e-3,
                  "dw2": 2 ** -8, "db2": 2 ** -8, "dls2": 1e-3}


# k4_digests on an H100 before K4's dx pass at C = 64 became two warp groups:
# the outputs at the other widths, whose launches that change left alone;
# bfloat16 at C = 128 after its two passes moved to the tensor cores, which
# round LN(x), the hidden, do and dz to bfloat16 as the TPU kernel does (the
# CUDA-core passes before them computed in float32 throughout)
K4_DIGESTS = {
    (128, "float32"): "58156b444940 8096f000dc3e 79a2cd00ff2b c32c2aeb5932 f5be679db688 "
                      "1847d887a6fd 759b064cbe19 98ad32e8c589",
    (128, "bfloat16"): "fc7c02ccc4c3 c2adb69612cc 8b806c6fcd31 475406a19829 3ec28cd956f4 "
                       "76cf961ed755 e03611052c51 58172c025a27",
    (256, "float32"): "1bf4c3548f34 d170944d38a6 b57c5514f154 960840dd15d8 afe897b16613 "
                      "db734215e7d2 c530f5618a7d 02ed10f17acb",
    (256, "bfloat16"): "55d8e5ce63d8 096831a55dc5 1c48c9d59239 665657aba375 35a7f82c2d8c "
                       "8c25a5f4ea32 3a767d005889 dc605b901c14",
    (512, "float32"): "970ed3af13d7 c6d7adc49751 d58a45cb3ca9 77758814a2aa 34e8cba4eb00 "
                      "98a3b1c5aaf2 c6426c40d1ae 0a9ffc010118",
    (512, "bfloat16"): "5fdcfa21cfec 270ed6936690 4f3bc7777a33 56cb01677628 b8d88ef80c71 "
                       "270d325c6e9e 2591141c9372 b438502dab92"}


def check_k4_digests(dev) -> None:
    """K4 at C/H 128/512, 256/1024 and 512/1024 in both dtypes gives bit for
    bit the eight gradients of `K4_DIGESTS`; raises where one differs."""
    got = k4_digests(dev)
    changed = [key for key, want in K4_DIGESTS.items() if got[key] != want]
    log(f"   K4 at C/H 128/512, 256/1024 and 512/1024 (M = 14,688, f32 and bf16): the eight "
        f"gradients' SHA-1 digests {'equal' if not changed else 'NOT equal'} to those before "
        f"the C = 64 dx pass became two warp groups (bf16 at C = 128: since its passes "
        f"moved to the tensor cores)" + (f": changed at {changed}" if changed else ""))
    if changed:
        raise AssertionError(f"K4's outputs changed at (C, dtype) {changed}")


def k4_digests(dev) -> dict:
    """SHA-1 (12 hex digits) of each of K4's eight gradients at M = 14,688
    on the seeded inputs of `scripts/torch_ab.sh digest`: C/H 128/512 (eps
    1e-5, generator seed 9), then 256/1024 (1e-5) and 512/1024 (1e-6) from
    a generator of their own (seed 10), each in float32 and bfloat16;
    {(c, dtype name): "dx dgamma ... dls2"}."""
    import hashlib

    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd

    out = {}
    for seed, widths in ((9, ((128, 512, 1e-5),)), (10, ((256, 1024, 1e-5), (512, 1024, 1e-6)))):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def randn(*shape, scale=1.0):
            return scale * torch.randn(*shape, device=dev, generator=gen)
        # torch_ab.sh's order: at 128 the dtypes outermost, at 256 and 512 the widths
        cases = ([(c, h, eps, dt) for dt in (torch.float32, torch.bfloat16)
                  for c, h, eps in widths] if seed == 9 else
                 [(c, h, eps, dt) for c, h, eps in widths
                  for dt in (torch.float32, torch.bfloat16)])
        for c, h, eps, dt in cases:
            x, g = randn(14688, c).to(dt), randn(14688, c).to(dt)
            args = (x, 1 + randn(c, scale=0.1), randn(c, scale=0.1),
                    randn(h, c, scale=c ** -0.5).to(dt), randn(h, scale=0.1).to(dt),
                    randn(c, h, scale=h ** -0.5).to(dt), randn(c, scale=0.1).to(dt),
                    torch.rand(c, device=dev, generator=gen))
            grads = fused_mlp_ln_bwd(*args, g, eps)
            out[(c, str(dt).split(".")[1])] = " ".join(
                hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12] for t in grads)
    return out


@phase("phase 7: K4 fused_mlp_ln_bwd vs plain")
def check_k4(dev, out_dir: str) -> dict:
    import torch

    from kasportsformer_torch.ops import mlp as mlp_ops
    from kasportsformer_torch.ops.mlp import (fused_mlp_ln_bwd,
                                              fused_mlp_ln_bwd_kernel_info,
                                              fused_mlp_ln_bwd_reference)

    gen = torch.Generator(device=dev).manual_seed(7)
    # float32: against the plain version in float32 on the same inputs
    # (summation order). bfloat16 (the tensor-core passes): against the
    # plain version run in bfloat16 on the same inputs, which rounds LN(x),
    # the hidden, do and dz where the kernel (and the TPU kernel) rounds
    # them, each gradient at its own limit (K4_BF16_LIMITS); beside it the
    # kernel's distance from the float32 plain version, at most twice the
    # bfloat16 plain version's own
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
            exact = fused_mlp_ln_bwd_reference(*(a.float() for a in args),
                                               g.float(), 1e-5)
            want = exact if dt is torch.float32 else fused_mlp_ln_bwd_reference(*args, g, 1e-5)
            # dx per element; the parameter gradients, sums over M rows,
            # against their largest entry
            errs = grad_errs(got, want)
            limits = ([tol[dt]] * 8 if dt is torch.float32 else
                      [K4_BF16_LIMITS[name] for name in _MLP_GRADS])
            if not (all(torch.isfinite(z).all() for z in got)
                    and all(e <= lim for e, lim in zip(errs, limits))):
                raise AssertionError(f"K4 M={m} {dt}: errs {dict(zip(_MLP_GRADS, errs))}")
            if dt is torch.bfloat16:
                log(f"   K4 M={m:6d} bfloat16 from the bfloat16 plain version (limit): "
                    + ", ".join(f"{n} {e:.2e} ({lim:.1e})"
                                for n, e, lim in zip(_MLP_GRADS, errs, limits)))
                far, plain_far = max(grad_errs(got, exact)), max(grad_errs(want, exact))
                log(f"   K4 M={m:6d} bfloat16 from the float32 plain version: kernel "
                    f"{far:.2e}, bfloat16 plain version {plain_far:.2e} (limit twice "
                    f"that, {2 * plain_far:.2e})")
                if far > 2 * plain_far:
                    raise AssertionError(f"K4 M={m} bf16: {far:.2e} from the f32 plain "
                                         f"version, over twice the bf16 plain's {plain_far:.2e}")
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
            worst = max(range(8), key=lambda i: errs[i] / limits[i])
            log(f"   K4 M={m:6d} {dname:8s} worst err "
                f"{errs[worst]:.2e} ({_MLP_GRADS[worst]}; limit "
                f"{limits[worst]:.1e}) kernel {ms:.4f} ms  plain {plain:.4f}  "
                f"bound {bms:.4f} ({by}); rerun bitwise equal")
            seen: dict = {}
            per[(m, dname)] = k4_launch_ms(lambda: fused_mlp_ln_bwd(*args, g, 1e-5), 20, seen)
            log("     by launch (profiler, ms a launch): " + "; ".join(
                f"{label} {t:.4f}" for label, t in per[(m, dname)].items()))
            info = fused_mlp_ln_bwd_kernel_info(dt, m, 512)
            log("     kernels: " + "; ".join(
                f"{label} {'/'.join(sorted(seen.get(label, ())))}" + (
                    f" ({info[key]['registers']} registers, {info[key]['spill_bytes']} B "
                    f"spilled)" if key else "")
                for label, key in (("dx pass", "dx_pass"), ("weight pass", "weight_pass"),
                                   ("reduce", "reduce"))))
    # each launch against the bound of its own work: the dx pass recomputes
    # fc1 and takes dh = do W2 and da = dz W1 (6*M*C*H) from x, g and the
    # weights, and writes dx; the weight pass recomputes fc1 and dh and takes
    # dW1 = dz^T a and G = g^T h (8*M*C*H) from the same inputs, and writes
    # one copy of dW1, G and db1 (its row-split partials are the design's, not
    # the function's, and count in the reduce's bound); the reduce reads both
    # passes' partials and W2 and writes the parameter gradients (bytes)
    for (m, dname), ms in per.items():
        log(f"   K4 M={m:6d} {dname:8s} by launch, bound (share): "
            + k4_launch_bounds(m, 128, 512, dname, ms) + "; "
            + k4_dx_tiling(dname, m, 128, 512) + "; " + k4_w_tiling(dname, m, 128, 512))
    if hasattr(mlp_ops, "fused_mlp_ln_bwd_reduce"):
        check_k4_reduce(dev, gen, per)
    else:  # the parent tree of an A/B, from before the reduce had an entry
        log("   K4 reduce alone: this tree has no entry for it")
    if len(k4_widths()) > 1:  # an older tree's K4 has C = 128 only
        rows.update(check_k4_zoo(dev, gen, tol))
        check_k4_digests(dev)
    write_k4_report(out_dir)
    return rows


def grad_errs(got, want) -> list[float]:
    """K4's eight gradients against `want`: dx per element (scaled by
    max(1, |y|)), the parameter gradients against their largest entry."""
    return [scaled_err(got[0], want[0])] + [sum_err(a, b) for a, b in zip(got[1:], want[1:])]


def k4_launch_bounds(m: int, c: int, h: int, dname: str, ms: dict) -> str:
    """Each of K4's launches against the bound of its own work: the dx pass
    recomputes fc1 and takes dh = do W2 and da = dz W1 (6*M*C*H) from x, g
    and the weights, and writes dx; the weight pass recomputes fc1 and dh and
    takes dW1 = dz^T a and G = g^T h (8*M*C*H) from the same inputs, and
    writes one copy of dW1, G and db1 (its row-split partials are the
    design's, not the function's, and count in the reduce's bound); the
    reduce reads both passes' partials and W2 and writes the parameter
    gradients (bytes). `ms` holds each launch's device ms."""
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd_partition

    p = (fused_mlp_ln_bwd_partition(m, h) if c == 128 else
         fused_mlp_ln_bwd_partition(m, h, c))
    it = 4 if dname == "float32" else 2
    wts = 2 * c * h * it
    part_dx = p["dx_tiles"] * 3 * c * 4
    w_out = (2 * h * c + h) * 4
    part_w = p["splits"] * w_out
    grads = 4 * (2 * c * h + h + 5 * c)
    # the stage launch reads W1 and W2 (in bf16 also b1) and writes the f32
    # copies the dx pass reads
    staged = 2 * c * h + (h if it == 2 else 0)
    bounds = {"stage": bound_ms((it + 4) * staged, 0, dname),
              "dx pass": bound_ms(3 * m * c * it + wts, 6 * m * c * h, dname),
              "weight pass": bound_ms(2 * m * c * it + wts + w_out, 8 * m * c * h, dname),
              "reduce": bound_ms(part_dx + part_w + wts // 2 + grads, 0, dname)}
    return "; ".join(
        f"{label} {bounds[label][0]:.4f} ({bounds[label][1]}; "
        f"{bounds[label][0] / ms[label]:.1%})" for label, _ in K4_LAUNCHES if label in ms)


def k4_w_tc_bounds(m: int, c: int, h: int, ms: float) -> str:
    """The C = 64 weight pass's device ms against two bounds of its work in
    either dtype (it computes in float32): the f32 FFMA bound of its 8*M*C*H
    FLOP at 67 TFLOP/s, and its route's own, 3xTF32 on the tensor cores: 3 x
    8*M*C*H FLOP at the dense TF32 rate of 495 TFLOP/s (`PEAK_FLOPS`)."""
    ffma = 8 * m * c * h / PEAK_FLOPS["float32"] * 1e3
    tf32 = 3 * 8 * m * c * h / PEAK_FLOPS["tf32"] * 1e3
    return (f"weight pass {ms:.4f} ms: FFMA bound (8*M*C*H at 67 TFLOP/s) {ffma:.4f} "
            f"({ffma / ms:.1%}); 3xTF32 bound (24*M*C*H at 495 TFLOP/s) {tf32:.4f} "
            f"({tf32 / ms:.1%})")


def k4_dx_tiling(dname: str, m: int, c: int, h: int) -> str:
    """The dx pass's instantiation at this shape, as the library reports it:
    blocks a cluster (a tile), clusters (at C <= 128 blocks) the card holds
    at once, the tiles of m rows and the waves they make on those; at C = 64
    also its warp groups (each over a hidden share, with its own ring) and
    blocks a SM."""
    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd_kernel_info

    dt = getattr(torch, dname)
    info = (fused_mlp_ln_bwd_kernel_info(dt, m, h) if c == 128 else
            fused_mlp_ln_bwd_kernel_info(dt, m, h, c=c))["dx_pass"]
    tiles = -(-m // info["rows"])
    if "resident" not in info:  # a tree from before the report had the key
        return f"dx pass {info['rows']}-row tiles: {tiles}"
    text = (f"dx pass cluster {info['cluster']}, clusters resident {info['resident']}, "
            f"{info['rows']}-row tiles {tiles}, waves {tiles / info['resident']:.2f}")
    if info.get("groups", 1) > 1:  # C = 64: warp groups over hidden shares
        text += (f", warp groups {info['groups']} a block of {info['threads']} threads (each "
                 f"{h // info['groups']} hidden columns in chunks of 32 through its own "
                 f"two-stage ring), blocks a SM {info['blocks_per_sm']}")
    return text


def k4_w_tiling(dname: str, m: int, c: int, h: int) -> str:
    """The weight pass's instantiation at this shape, as the library reports
    it: blocks a cluster (a hidden chunk and row split), its row tile, hidden
    chunk and splits, the clusters (at C = 128 blocks) the card holds at once
    and the waves its launch makes on those."""
    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd_kernel_info

    dt = getattr(torch, dname)
    info = (fused_mlp_ln_bwd_kernel_info(dt, m, h) if c == 128 else
            fused_mlp_ln_bwd_kernel_info(dt, m, h, c=c))["weight_pass"]
    text = (f"weight pass {info['rows']}-row tiles, chunk {info['chunk']}, "
            f"splits {info['splits']}")
    if "resident" not in info:  # a tree from before the report had the key
        return text
    clusters = info["grid"] // info["cluster"]
    return (f"{text}, cluster {info['cluster']}, clusters resident {info['resident']}, "
            f"grid {clusters} clusters, waves {clusters / info['resident']:.2f}")


def check_k4_zoo(dev, gen, tol: dict) -> dict:
    """K4 at the zoo's widths (C/H 64/256 for MotionAGFormer-XS and
    hierarchical, 256/1024 for DSTFormer, 512/1024 with MixSTE's LayerNorm
    eps of 1e-6) at the train step's M = 14,688 and a ragged 1,377, both
    dtypes: all eight gradients against the plain version in float32, a
    rerun bitwise equal, the whole call's time, the plain version's, the
    bound, and each launch's device time against its own bound; then shapes
    outside K4's range (C = 32 and 1024, and H = 192 at C = 64) raise."""
    import torch

    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd, fused_mlp_ln_bwd_reference

    eps_of = {64: 1e-5, 256: 1e-5, 512: 1e-6}
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        for c, h in k4_widths()[1:]:
            eps = eps_of[c]
            for m in (14688, 1377):
                args = mlp_args(dev, gen, m, dt, c, h)
                g = torch.randn(m, c, device=dev, generator=gen).to(dt)
                got = fused_mlp_ln_bwd(*args, g, eps)
                again = fused_mlp_ln_bwd(*args, g, eps)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                want = fused_mlp_ln_bwd_reference(*(a.float() for a in args), g.float(), eps)
                errs = grad_errs(got, want)
                if not (same and all(torch.isfinite(z).all() for z in got)
                        and max(errs) <= tol[dt]):
                    raise AssertionError(f"K4 C/H={c}/{h} M={m} {dt}: errs "
                                         f"{dict(zip(_MLP_GRADS, errs))}, rerun "
                                         f"bitwise equal {same}")
                ms = time_ms(lambda: fused_mlp_ln_bwd(*args, g, eps), 10)
                plain = time_ms(lambda: fused_mlp_ln_bwd_reference(*args, g, eps), 10)
                it = args[0].element_size()
                nbytes = 3 * m * c * it + 2 * c * h * it + 4 * (2 * c * h + h + 5 * c)
                bms, by = bound_ms(nbytes, 10 * m * c * h, dname)
                per = k4_launch_ms(lambda: fused_mlp_ln_bwd(*args, g, eps), 10)
                rows[(m, dname, c)] = dict(shape=[m, c, h], max_abs_err=max(
                    (a.float() - w).abs().max().item() for a, w in zip(got, want)),
                    ms=ms, plain_ms=plain, library_ms=None, bound_ms=bms, bound_by=by)
                log(f"   K4 C/H={c}/{h} eps {eps:.0e} M={m:6d} {dname:8s} worst err "
                    f"{max(errs):.2e} ({_MLP_GRADS[errs.index(max(errs))]}; limit "
                    f"{tol[dt]:.0e}), rerun bitwise equal; kernel {ms:.4f} ms  "
                    f"plain {plain:.4f}  bound {bms:.4f} ({by}; {bms / ms:.1%})")
                log("     by launch (profiler, ms a launch): " + "; ".join(
                    f"{label} {t:.4f}" for label, t in per.items())
                    + "; bound (share): " + k4_launch_bounds(m, c, h, dname, per))
                log("     " + k4_dx_tiling(dname, m, c, h) + "; " + k4_w_tiling(dname, m, c, h))
                if c == 64 and "weight pass" in per:
                    log("     " + k4_w_tc_bounds(m, c, h, per["weight pass"]))
    refused = 0
    for c, h in ((32, 256), (1024, 256), (64, 192)):
        args = mlp_args(dev, gen, 8, torch.float32, c, h)
        try:
            fused_mlp_ln_bwd(*args, args[0], 1e-5)
        except ValueError:
            refused += 1
    log(f"   K4 at C=32, at C=1024 and at C/H=64/192: {refused} of 3 refused")
    if refused != 3:
        raise AssertionError("K4 took a shape outside its range")
    return rows


def check_k4_reduce(dev, gen, per: dict) -> None:
    """K4's reduce alone (`fused_mlp_ln_bwd_reduce`) on seeded partials of
    the step's shapes, the flagship's C/H 128/512 and, where the tree's K4
    takes them, MotionAGFormer-XS's and hierarchical's 64/256 (its segment
    grid) and MixSTE's and D3DP's 512/1024 (its grid of equal blocks), held
    bit for bit against its plain version on the
    card (dls2, grouped otherwise, within K4's limit); its time (events, and
    the profiler's device time a launch), bound, share, grid (and the SMs
    it covers), registers and
    spills (a spill fails the phase), beside `torch.sum` over the weight
    partials' split axis, a library yardstick of that part only. Then the
    reduce's device time alone on a warm workspace, after a copy that
    rewrites the workspace, after f32 matmuls that touch none of it (and
    leave it in L2), after those and the copy, and on a workspace flushed
    from L2, beside its time inside K4 (after the weight pass): the state
    of its data in L2 told apart from the card's after heavy compute."""
    import torch

    from kasportsformer_torch.ops.mlp import (_bwd_workspace_size,
                                              fused_mlp_ln_bwd_kernel_info,
                                              fused_mlp_ln_bwd_partition,
                                              fused_mlp_ln_bwd_reduce,
                                              fused_mlp_ln_bwd_reduce_reference)

    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widths = [(128, 512)] + [(c, h) for c, h in k4_widths() if c in (64, 512)]
    for (c, hidden), dt, m in itertools.product(widths, (torch.float32, torch.bfloat16),
                                                (14688, 1377)):
        dname = str(dt).split(".")[1]
        grads = 4 * (2 * c * hidden + hidden + 5 * c)
        p = (fused_mlp_ln_bwd_partition(m, hidden) if c == 128 else
             fused_mlp_ln_bwd_partition(m, hidden, c))
        n_dx = p["dx_tiles"] * 3 * c
        # the two passes' partials (at C = 512 without the stage launch's weights)
        work = torch.randn(n_dx + p["splits"] * (2 * c * hidden + hidden), device=dev,
                           generator=gen)
        w2 = torch.randn(c, hidden, device=dev, generator=gen).mul(
            hidden ** -0.5).to(dt)
        b2 = torch.randn(c, device=dev, generator=gen).mul(0.1).to(dt)
        ls2 = torch.rand(c, device=dev, generator=gen)
        args = (work, w2, b2, ls2, m)
        got = fused_mlp_ln_bwd_reduce(*args)
        want = fused_mlp_ln_bwd_reduce_reference(*args)
        same = [torch.equal(a, b) for a, b in zip(got[:6], want[:6])]
        err = sum_err(got[6], want[6])
        if not all(same) or err > tol[dt]:
            raise AssertionError(
                f"K4 reduce alone M={m} {dname}: bitwise equal "
                f"{dict(zip(_MLP_GRADS[1:7], same))}, dls2 err {err:.2e}")
        ms = time_ms(lambda: fused_mlp_ln_bwd_reduce(*args), 50)
        launch = k4_launch_ms(lambda: fused_mlp_ln_bwd_reduce(*args), 20).get(
            "reduce", float("nan"))  # nan: the profiler saw no launch
        plain = time_ms(lambda: fused_mlp_ln_bwd_reduce_reference(*args), 5)
        part_w = work[n_dx:].view(p["splits"], -1)
        lib = time_ms(lambda: torch.sum(part_w, 0), 50)
        bms, by = bound_ms(4 * work.numel() + w2.numel() * w2.element_size()
                           + grads, 0, dname)
        info = (fused_mlp_ln_bwd_kernel_info(dt, m, hidden) if c == 128 else
                fused_mlp_ln_bwd_kernel_info(dt, m, hidden, c=c))["reduce"]
        log(f"   K4 reduce alone C/H={c}/{hidden} M={m:6d} {dname:8s} six gradients "
            f"bitwise equal to plain, dls2 err {err:.2e} (limit {tol[dt]:.0e}); kernel "
            f"{ms:.4f} ms (events), {launch:.4f} ms a launch (profiler)  "
            f"plain {plain:.4f}  bound {bms:.4f} ({by}; {bms / launch:.1%} "
            f"of a launch)  torch.sum over the weight partials' splits "
            f"(yardstick of that part only) {lib:.4f}; grid {info['blocks']} "
            f"x {info['threads']} on {sms} SMs ({info['blocks'] / sms:.2f} a SM), "
            f"registers {info['registers']}, shared memory {info['smem_bytes']} B, "
            f"spills {info['spill_bytes']} B, {info['blocks_per_sm']} blocks a SM")
        if info["spill_bytes"] != 0:
            raise AssertionError(f"K4 reduce C={c} {dname} spills: {info}")
    hidden = 512
    # the reduce's device time a launch (f32, M = 14,688) after each prefix
    work = torch.randn(_bwd_workspace_size(14688, hidden), device=dev, generator=gen)
    src = work.clone()
    w2 = torch.randn(128, hidden, device=dev, generator=gen)
    ls2 = torch.rand(128, device=dev, generator=gen)
    a = torch.randn(1024, 1024, device=dev, generator=gen)  # 12 MB with b, mm's output
    b = torch.randn(1024, 1024, device=dev, generator=gen)
    flush = torch.empty(32 << 20, device=dev)  # 128 MB, over the 50 MB L2

    def after(prefix):
        def call():
            prefix()
            fused_mlp_ln_bwd_reduce(work, w2, w2[:, 0], ls2, 14688)
        return k4_launch_ms(call, 20).get("reduce", float("nan"))

    times = {"inside K4 (after the weight pass)": per[(14688, "float32")].get(
                 "reduce", float("nan")),
             "alone, back to back": after(lambda: None),
             "after a copy rewriting the workspace": after(lambda: work.copy_(src)),
             "after four 1024^3 f32 matmuls (12 MB)": after(
                 lambda: [torch.mm(a, b) for _ in range(4)]),
             "after them and then the copy": after(
                 lambda: ([torch.mm(a, b) for _ in range(4)], work.copy_(src))),
             "on a workspace flushed from L2": after(lambda: flush.zero_())}
    log("   K4 reduce f32 M=14688, device ms a launch (profiler): " + "; ".join(
        f"{k} {v:.4f}" for k, v in times.items()))


def label_batch(gen, b: int):
    """Root-relative 3D targets of the scale the normalised inputs have."""
    import torch

    y = 0.3 * torch.randn(b, 27, 17, 3, generator=gen)
    return y - y[:, :, :1]


def grad_rows(model, cpu_model) -> list:
    """Per parameter with a gradient, the worst first: (max |card - CPU|
    over the largest CPU gradient entry of the module that holds it (a
    linear's weight and bias), the same over its own largest entry, that
    entry, its name). A bias whose gradient is a sum that cancels to near
    zero is so held to the size of what flows through its module, which
    cancellation cannot shrink; its error over its own largest entry is
    printed beside it."""
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()
                 if p.grad is not None}

    def owner(n: str) -> str:
        return n.rpartition(".")[0]

    module_max: dict[str, float] = {}
    for n, ref in cpu_grads.items():
        module_max[owner(n)] = max(module_max.get(owner(n), 0.0),
                                   ref.abs().max().item())
    rows = []
    for name, p in model.named_parameters():
        if p.grad is None:
            continue
        ref = cpu_grads[name]
        diff = (p.grad.cpu() - ref).abs().max().item()
        scale, own = module_max[owner(name)], ref.abs().max().item()
        rows.append((diff / scale if scale else (0.0 if diff == 0 else float("inf")),
                     diff / own if own else float("nan"), own, name))
    rows.sort(reverse=True)
    return rows


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
    rows = grad_rows(model, cpu_model)
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


@phase("phase 9b: zoo train step on the card")
def check_zoo_train(dev, out_dir: str) -> dict:
    """The zoo trained on the card at full width, drop_path 0 as the config
    sets it (so every MLP tail takes K3 and K4): (1) MixSTE's, DSTFormer's,
    the five MotionAGFormer configurations' (base, use_tcn, hierarchical,
    graph_only, XS) and D3DP's (its diffusion objective: the target noised
    at drawn timesteps, then denoised, the draws from one seeded generator
    on each side) train-mode loss and every parameter's
    gradient at B = 4 on the card (kernels) against the CPU (plain
    versions), same perturbed weights, the CPU's top-k adjacencies and ReLU
    gates replayed, each gradient within 1e-3 of its module's largest CPU
    entry and the loss within 1e-5 relative, K2 and K4 launches counted per
    backward (graph_only too: its chain of GCN layers amplifies the forward's
    rounding to 6e-4 of the output, phase 5b, but not its replayed
    gradients past this limit); (2) the
    float32 train step at the config's batch 32 of MixSTE, DSTFormer,
    MotionAGFormer-XS and hierarchical: median ms over 12 steps, clips/s,
    peak memory and a profiler table by kernel group, the launches read
    around the 12 steps; (3) one epoch of MixSTE through the CLI's `train` on
    phase 10's synthetic store, then `evaluate`, the launches read around
    `train`."""
    import numpy as np
    import torch

    from kasportsformer_torch.data.pipeline import flip_generator
    from kasportsformer_torch.models import build_model
    from kasportsformer_torch.ops.attention import masked_sdpa, masked_sdpa_bwd
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd
    from kasportsformer_torch.train.loop import (make_grads_fn, make_optimizer,
                                                 make_train_step)

    res = {}
    for i, name in enumerate(("MixSTE", "DSTFormer") + MAG_ZOO + ("D3DP",)):
        cfg = zoo_config(name)
        if cfg.drop_path != 0.0:
            raise AssertionError(f"{name}: the config's drop_path is {cfg.drop_path}")
        gcfg = cfg.replace(grad_microbatch=0)
        cpu_model = perturbed(cfg, seed=40 + i)
        model = copy.deepcopy(cpu_model).to(dev)
        x = clip_batch(torch.Generator().manual_seed(41 + i), 4)
        y = label_batch(torch.Generator().manual_seed(43 + i), 4)
        w = torch.ones(4)
        adjacencies: list = []
        gates: list = []
        t0 = time.perf_counter()
        # a model's draws (D3DP's timesteps and noise) from a generator of
        # the same seed on each side, on the CPU, so the card's are the CPU's
        with adjacency_tape(record=adjacencies), relu_gate_tape(record=gates):
            want = make_grads_fn(cpu_model, gcfg)(
                x, y, w, torch.Generator().manual_seed(47 + i))
        cpu_s = time.perf_counter() - t0
        k2, k4 = masked_sdpa_bwd.launches, fused_mlp_ln_bwd.launches
        with adjacency_tape(replay=adjacencies) as flips, \
                relu_gate_tape(replay=gates) as gate_flips:
            got = make_grads_fn(model, gcfg)(x.to(dev), y.to(dev), w.to(dev),
                                             torch.Generator().manual_seed(47 + i))
        torch.cuda.synchronize()
        d = (masked_sdpa_bwd.launches - k2, fused_mlp_ln_bwd.launches - k4)
        loss_rel = abs(got["loss_total"].item() - want["loss_total"].item()) / abs(
            want["loss_total"].item())
        missing = {n for n, p in model.named_parameters() if p.grad is None}
        cpu_missing = {n for n, p in cpu_model.named_parameters() if p.grad is None}
        rows = grad_rows(model, cpu_model)
        errs = sorted(r[0] for r in rows)
        log(f"   {name} B=4 train-mode backward: K2/K4 launches {d} (expected "
            f"{ZOO_LAUNCHES[name]}); loss {got['loss_total'].item():.6f} (rel diff "
            f"{loss_rel:.2e}, limit 1e-5); {len(rows)} parameters with a gradient, "
            f"{len(missing)} without; per-parameter error over its module's largest "
            f"CPU gradient (limit 1e-3): median {errs[len(errs) // 2]:.2e}, worst "
            f"five: " + "; ".join(f"{n} {e:.2e} (over its own |g| max {s:.2e}: {o:.2e})"
                                  for e, o, s, n in rows[:5])
            + f"; top-k entries chosen differently: {flips[0]} of {flips[1]}, ReLU "
            f"gates set differently: {gate_flips[0]} of {gate_flips[1]} (both "
            f"replayed from the CPU); CPU forward+backward {cpu_s:.2f} s")
        if not (d == ZOO_LAUNCHES[name] and missing == cpu_missing
                and loss_rel <= 1e-5 and rows[0][0] <= 1e-3):
            raise AssertionError(f"{name}: gradients off the CPU's")
        res[name] = {"worst": rows[0][0], "worst_name": rows[0][3], "loss_rel": loss_rel}
        del model, cpu_model

    train, _ = synthetic_clipsets(12, 320, 4)
    arrays = {"inputs": torch.as_tensor(train.inputs, device=dev),
              "labels": torch.as_tensor(train.labels, device=dev)}
    plans = np.arange(320).reshape(10, 32)
    for name in ZOO_STEPS:
        cfg = zoo_config(name)  # the public config: batch 32, float32
        model = build_model(cfg, device=dev)
        opt = make_optimizer(model, cfg)
        step = make_train_step(model, cfg, opt)
        w = torch.ones(cfg.batch_size, device=dev)
        times, losses, i = [], [], 0

        def one() -> None:
            nonlocal i
            losses.append(step(arrays, plans[i % 10], w,
                               flip_generator(cfg.seed, 0, i))["loss_total"])
            i += 1

        one()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        masked_sdpa.launches = masked_sdpa_bwd.launches = fused_mlp_ln_bwd.launches = 0
        for _ in range(12):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launches = {"masked_sdpa": masked_sdpa.launches,
                    "masked_sdpa_bwd": masked_sdpa_bwd.launches,
                    "fused_mlp_ln_bwd": fused_mlp_ln_bwd.launches}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        med = statistics.median(times)
        busy = profile_steps(one, 3, f"train_{name.replace(' ', '_')}", out_dir)
        finite = all(bool(torch.isfinite(v)) for v in losses)
        log(f"   {name} train step float32, batch 32: median {med:.1f} ms over 12 "
            f"steps (min {min(times):.1f}, max {max(times):.1f}), {32e3 / med:.1f} "
            f"clips/s, peak memory {peak:.2f} GiB; launches over the 12 steps "
            f"{launches}; losses finite {finite}")
        if not finite or min(launches.values()) == 0:
            raise AssertionError(f"{name} train step: losses finite {finite}, "
                                 f"launches {launches}")
        res[name].update(step_ms=med, peak_gib=peak, busy=busy, launches=launches)
        del model, opt, step
    del arrays
    res["MixSTE"]["cli_launches"] = train_and_evaluate_cli(ZOO["MixSTE"], 1)
    return res


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
        k2 = [e for e in events if kernel_group(e.key) == "K2"]
        if k2:
            log(f"     K2, ms/step (kernels a step) [kernel]: "
                f"{sum(e.self_device_time_total for e in k2) / 1e3 / n:.2f} "
                f"({sum(e.count for e in k2) / n:.0f}) "
                f"[{'/'.join(sorted({kernel_name(e.key) for e in k2}))}]")
        k4 = {label: [e for e in events if any(name in e.key for name in names)]
              for label, names in K4_LAUNCHES}
        log("     K4 by launch, ms/step (kernels a step) [kernel]: " + "; ".join(
            f"{label} {sum(e.self_device_time_total for e in es) / 1e3 / n:.2f} "
            f"({sum(e.count for e in es) / n:.0f}) "
            f"[{'/'.join(sorted({kernel_name(e.key) for e in es}))}]"
            for label, es in k4.items() if es))
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
    from kasportsformer_torch.ops.attention import masked_sdpa_bwd
    from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd
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
        fused_mlp_ln_bwd.launches = masked_sdpa_bwd.launches = 0
        for _ in range(12):
            t0 = time.perf_counter()
            one()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        k4_calls, k2_calls = fused_mlp_ln_bwd.launches, masked_sdpa_bwd.launches
        if k4_calls == 0:
            raise AssertionError(f"the {dname} train step launched no K4")
        # 104 K2 a step (52 blocks' two attention cores); in bfloat16 through
        # the tensor-core kernel at both of the flagship's lengths (N = 17, 27)
        k2_kernels = sorted({k2_kernel(getattr(torch, dname), n) for n in (17, 27)})
        if k2_calls != 104 * 12 or (dname == "bfloat16"
                                    and "masked_sdpa_bwd_kernel" in k2_kernels):
            raise AssertionError(f"the {dname} train step: {k2_calls} K2 launches in 12 "
                                 f"steps, kernels at N = 17, 27: {k2_kernels}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        none = [n for n, p in model.named_parameters() if p.grad is None]
        if none:  # the step gives the unreached parameters zeros for AdamW
            raise AssertionError(f"no gradient after a step: {none[:5]}")
        med = statistics.median(times)
        busy = profile_steps(one, 3, f"train_{dname}", out_dir)
        res[dname] = {"ms": med, "peak_gib": peak, "busy": busy, "k4_launches": k4_calls,
                      "k2_launches": k2_calls}
        log(f"   train step {dname}, batch 32: median {med:.1f} ms over 12 "
            f"steps (min {min(times):.1f}, max {max(times):.1f}), "
            f"{32e3 / med:.1f} clips/s, peak memory {peak:.2f} GiB; K4 calls "
            f"{k4_calls} in the 12 steps ({k4_calls / 12:.0f} a step), K2 calls "
            f"{k2_calls} ({k2_calls / 12:.0f} a step, {'/'.join(k2_kernels)})")
        del model, opt, step
    # 50 steps on one fixed batch in each dtype, no flips: the loss must fall
    for dname in ("float32", "bfloat16"):
        cfg = Config(flip=False, learning_rate=1e-3, compute_dtype=dname)
        model = build_model(cfg, device=dev)
        opt = make_optimizer(model, cfg)
        step = make_train_step(model, cfg, opt)
        w = torch.ones(32, device=dev)
        losses = [step(arrays, np.arange(32), w)["loss_total"].item()
                  for _ in range(50)]
        log(f"   50 steps on one batch, {dname}: loss {losses[0]:.5f} -> {losses[-1]:.5f} "
            f"(min {min(losses):.5f})")
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"{dname} fixed-batch losses did not fall: {losses}")
        res[f"losses_{dname}"] = (losses[0], losses[-1])
        del model, opt, step
    return res


def train_and_evaluate_cli(overrides: dict, epochs: int) -> dict:
    """`train` through the CLI's entry point on a seeded synthetic .npz clip
    store (256 train, 64 test clips) in a temp dir, the flagship's YAML with
    `overrides`, for `epochs` epochs, each evaluated; then `evaluate` of the
    best checkpoint, which must give its epoch's MPJPE. The launch counts of
    K1-K4 are set to 0 just before `train` and read just after."""
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
        raw.update(overrides)
        raw.update(epochs=epochs, warmup_epoches=1, data_root=os.path.join(tmp, "clips"),
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
        if len(mpjpes) != epochs or not os.path.isdir(best):
            raise AssertionError(f"expected {epochs} evaluated epochs and a best "
                                 f"checkpoint, got {mpjpes}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["evaluate", "--config-path", cfg_path,
                           "--checkpoint", best])
        result = json.loads(buf.getvalue().strip().splitlines()[-1])
        diff = abs(result["mpjpe"] - min(mpjpes))
        log(f"   train: {epochs} epochs of 8 steps in {train_s:.1f} s, eval MPJPE per "
            f"epoch {mpjpes}; evaluate on the best checkpoint: "
            f"{result['mpjpe']} mm (diff {diff:.2e}); launches {launches}")
        if rc != 0 or diff > 1e-3 or min(launches.values()) == 0:
            raise AssertionError(f"evaluate rc {rc}, MPJPE diff {diff}, "
                                 f"launches {launches}")
    return launches


@phase("phase 10: train and evaluate through the CLI (main path)")
def check_train_cli(dev, out_dir: str) -> dict:
    return train_and_evaluate_cli({}, 2)


PHASES = ("0", "1", "2", "3", "3b", "3c", "3d", "4", "5", "5b", "5c", "6",
          "7", "8", "9", "9b", "10")


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
    zoo = run("5b", check_zoo_models, dev, args.out)
    zoo_launches = run("5c", check_zoo_serving, dev)
    k2 = run("6", check_k2, dev, args.out)
    k4 = run("7", check_k4, dev, args.out)
    run("8", check_grads, dev)
    step9 = run("9", check_train_step, dev, args.out)
    zoo_train = run("9b", check_zoo_train, dev, args.out)
    train_launches = run("10", check_train_cli, dev, args.out)
    log(f"== total {time.perf_counter() - t_start:.1f} s")
    if args.phases is not None:
        log(card)
        if FAILED:
            report_failures(f"phases {FAILED} of {sorted(want, key=PHASES.index)}")
            return 1
        log(f"chip_smoke: phases {sorted(want, key=PHASES.index)} ok")
        return 0
    results = {"2": k1, "3": k3, "3b": k5, "3c": k5_launches, "3d": zoo_k,
               "5": launches, "5b": zoo, "5c": zoo_launches, "6": k2, "7": k4,
               "9": step9, "9b": zoo_train, "10": train_launches}
    empty = [f"phase {p}" for p, r in results.items() if not r]
    if FAILED or empty:
        report_failures(f"phases {FAILED}; phases without a result {empty}")
        return 1

    # rows at the main paths' shapes, f32 (and K3's bf16 flagship row): the
    # flagship's serving (K1, K3; the bf16 row's launches from its bf16
    # serving), the train step (K2, K4), the zoo's serving in 5c (K1 at
    # D = 64, K3 at 512/1024 and, STCFormer's, 256/1024) and K5's layer
    # route; launches from those runs
    zoo_k1 = sum(d[0] for d in zoo_launches.values())
    zoo_k3 = {c: sum(d[1] for n, d in zoo_launches.items()
                     if ZOO[n]["dim_feat"] == c) for c in (512, 256)}
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
        # the bf16 train step's (phase 9): K2 at heads of 16 on the tensor
        # cores (masked_sdpa_bwd_mma_kernel), K4's tensor-core passes at C = 128
        dict(name="masked_sdpa_bwd", route="cuda", dtype="bfloat16",
             source="kasportsformer_torch/ops/csrc/masked_sdpa_bwd.cu",
             replaces="kasportsformer_tpu/ops/attention.py:365",
             launches=step9["bfloat16"]["k2_launches"],
             **k2[("spatial", "bfloat16")]),
        dict(name="fused_mlp_ln_bwd", route="cuda", dtype="bfloat16",
             source="kasportsformer_torch/ops/csrc/mlp_ln_bwd.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:284",
             launches=step9["bfloat16"]["k4_launches"],
             **k4[(14688, "bfloat16")]),
        dict(name="fused_mlp", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:137",
             launches=k5_launches, **k5[(58752, 512, "float32")]),
        dict(name="masked_sdpa[zoo]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa.cu",
             replaces="kasportsformer_tpu/ops/attention.py:227",
             launches=zoo_k1,
             **zoo_k[("K1", "MixSTE spatial D=64", "float32")]),
        dict(name="fused_mlp_ln[zoo]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:202",
             launches=zoo_k3[512], **zoo_k[("K3", 512, "float32")]),
        dict(name="fused_mlp_ln[zoo C=256]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:202",
             launches=zoo_k3[256], **zoo_k[("K3", 256, "float32")]),
        # the zoo's training (phase 9b): DSTFormer's widths from its batch-32
        # steps, MixSTE's from its epoch through the CLI
        dict(name="masked_sdpa_bwd[zoo D=32]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa_bwd.cu",
             replaces="kasportsformer_tpu/ops/attention.py:365",
             launches=zoo_train["DSTFormer"]["launches"]["masked_sdpa_bwd"],
             **k2[("DST spatial D=32", "float32")]),
        dict(name="masked_sdpa_bwd[zoo D=64]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa_bwd.cu",
             replaces="kasportsformer_tpu/ops/attention.py:365",
             launches=zoo_train["MixSTE"]["cli_launches"]["masked_sdpa_bwd"],
             **k2[("MixSTE spatial D=64", "float32")]),
        dict(name="fused_mlp_ln_bwd[zoo C=256]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln_bwd.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:284",
             launches=zoo_train["DSTFormer"]["launches"]["fused_mlp_ln_bwd"],
             **k4[(14688, "float32", 256)]),
        dict(name="fused_mlp_ln_bwd[zoo C=512]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln_bwd.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:284",
             launches=zoo_train["MixSTE"]["cli_launches"]["fused_mlp_ln_bwd"],
             **k4[(14688, "float32", 512)]),
        # MotionAGFormer-XS's batch-32 steps (phase 9b): K1 and K2 at heads of
        # 8 (K1's row at phase 3d's (32, 27, 17, 64)), K4 at C/H 64/256
        dict(name="masked_sdpa[zoo D=8]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa.cu",
             replaces="kasportsformer_tpu/ops/attention.py:227",
             launches=zoo_train["MotionAGFormer-XS"]["launches"]["masked_sdpa"],
             **zoo_k[("K1", "MAG spatial D=8 B=32", "float32")]),
        dict(name="masked_sdpa_bwd[zoo D=8]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/masked_sdpa_bwd.cu",
             replaces="kasportsformer_tpu/ops/attention.py:365",
             launches=zoo_train["MotionAGFormer-XS"]["launches"]["masked_sdpa_bwd"],
             **k2[("MAG spatial D=8", "float32")]),
        dict(name="fused_mlp_ln_bwd[zoo C=64]", route="cuda", dtype="float32",
             source="kasportsformer_torch/ops/csrc/mlp_ln_bwd.cu",
             replaces="kasportsformer_tpu/ops/mlp.py:284",
             launches=zoo_train["MotionAGFormer-XS"]["launches"]["fused_mlp_ln_bwd"],
             **k4[(14688, "float32", 64)]),
    ]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
