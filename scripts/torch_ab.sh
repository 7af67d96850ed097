#!/bin/bash
# A/B of kasportsformer_torch on one card: chip_smoke.py phases on a
# baseline tree (P) and on this tree (N), in turns P N N P, so that both are
# measured on the same card in one command.
#
#   scripts/torch_ab.sh prepare <commit>   unpack <commit> into build/ab/P and
#                                          give it this tree's chip_smoke.py
#   scripts/torch_ab.sh run <phases> [dir] on the card: P N N P; each run's
#                                          log and reports under dir/<n><side>
#                                          (default chiprun_out/ab)
#   scripts/torch_ab.sh digest             on the card: K4 on seeded inputs at
#                                          M = 14,688 in P and in N, at C/H
#                                          128/512, 256/1024 and 512/1024 (eps
#                                          1e-6), and the SHA-1 of each of its
#                                          eight gradients, so a launch left
#                                          unchanged shows as equal digests of
#                                          what it alone feeds; then K2 at
#                                          heads of 16, 32 and 64 (8 heads,
#                                          batch 32, 27 x 17) and the SHA-1 of
#                                          dq, dk and dv; a width the tree's
#                                          kernels do not take is skipped
# A run that fails is reported and the turns go on; the exit code is the
# number of runs that failed.
set -uo pipefail
cd "$(dirname "$0")/.."
case "${1:-}" in
  prepare)
    rm -rf build/ab/P && mkdir -p build/ab/P
    git archive "$2" | tar -x -C build/ab/P
    cp chip_smoke.py build/ab/P/
    ;;
  run)
    out="$(pwd)/${3:-chiprun_out/ab}"
    failed=0
    n=0
    for side in P N N P; do
      n=$((n + 1))
      tree=.
      [ "$side" = P ] && tree=build/ab/P
      mkdir -p "$out/$n$side"
      echo "=== run $n: $side ($tree)"
      (cd "$tree" && python3 chip_smoke.py --phases "$2" --out "$out/$n$side") \
        > "$out/$n$side/log.txt" 2>&1 || { echo "run $n ($side) failed"; failed=$((failed + 1)); }
      grep -E "K2 (spatial|temporal)|by launch|K4 M=|K4 C/H|dx pass cluster|K4 reduce|K3 M|K5 M|128-clip forward|profile|of which|by group|train step|SM clock|phases" \
        "$out/$n$side/log.txt" || true
    done
    exit "$failed"
    ;;
  digest)
    for tree in build/ab/P .; do
      echo "=== $tree"
      (cd "$tree" && python3 - <<'PY'
import hashlib

import torch

from kasportsformer_torch.ops.mlp import fused_mlp_ln_bwd

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
    names = ("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2", "dls2")
    print(str(dt), " ".join(
        f"{n} {hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]}"
        for n, t in zip(names, out)))
# the zoo's widths from a generator of their own, so the flagship's inputs
# above stay those of its digests in tests/test_torch_cuda.py
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
        print(f"C/H {c}/{h}", str(dt), " ".join(
            f"{n} {hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]}"
            for n, t in zip(names, out)))
# K2 at the head widths of the flagship and the zoo, the temporal view of a
# (B, T, J, C) qkv projection with a transposed gradient
from kasportsformer_torch.ops import attention

gen = torch.Generator(device="cuda").manual_seed(11)
for d in (16, 32, 64):
    if d not in attention.LIMITS["masked_sdpa_bwd"][0]:
        continue
    for dt in (torch.float32, torch.bfloat16):
        qkv = torch.randn(32, 27, 17, 24 * d, device="cuda", generator=gen).to(dt)
        g = torch.randn(32, 27, 17, 8 * d, device="cuda", generator=gen).to(dt)
        q, k, v = (z.transpose(1, 2) for z in qkv.split(8 * d, dim=-1))
        out = attention.masked_sdpa_bwd(q, k, v, g.transpose(1, 2), d ** -0.5, 8)
        print(f"K2 D={d}", str(dt), " ".join(
            f"{n} {hashlib.sha1(t.float().cpu().numpy().tobytes()).hexdigest()[:12]}"
            for n, t in zip(("dq", "dk", "dv"), out)))
PY
      ) || failed=1
    done
    exit "${failed:-0}"
    ;;
  *)
    echo "usage: $0 prepare <commit> | run <phases> [dir] | digest" >&2
    exit 2
    ;;
esac
