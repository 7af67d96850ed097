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
#                                          M = 14,688 in P and in N, and the
#                                          SHA-1 of each of its eight gradients,
#                                          so a launch left unchanged shows as
#                                          equal digests of what it alone feeds
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
      grep -E "by launch|K4 M=|K3 M|K5 M|128-clip forward|profile|of which|by group|train step|SM clock|phases" \
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
