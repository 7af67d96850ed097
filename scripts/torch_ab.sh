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
#                                          128/512, 256/1024 and 512/1024, and
#                                          the SHA-1 of each of its eight
#                                          gradients, so a launch left
#                                          unchanged shows as equal digests of
#                                          what it alone feeds; then K2 at
#                                          heads of 16, 32 and 64 (8 heads,
#                                          batch 32, 27 x 17) and the SHA-1 of
#                                          dq, dk and dv; then K1's output at
#                                          heads of 16, 32 and 64 and its SHA-1
#                                          (chip_smoke.k4_digests, k2_digests
#                                          and k1_digests)
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
      grep -E "K1 |K2 (spatial|temporal)|by launch|K4 M=|K4 C/H|dx pass cluster|K4 reduce|K3 M|K5 M|128-clip forward|profile|of which|by group|train step|SM clock|phases" \
        "$out/$n$side/log.txt" || true
    done
    exit "$failed"
    ;;
  digest)
    for tree in build/ab/P .; do
      echo "=== $tree"
      (cd "$tree" && python3 - <<'PY'
import chip_smoke

# chip_smoke.py is this tree's in both (prepare copies it): the same seeded
# inputs on each side
for label, digests in (("K4 C", chip_smoke.k4_digests("cuda")),
                      ("K2 D", chip_smoke.k2_digests("cuda")),
                      ("K1", chip_smoke.k1_digests("cuda"))):
    for (width, dtype), digest in digests.items():
        print(f"{label}={width} {dtype} {digest}")
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
