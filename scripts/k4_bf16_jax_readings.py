#!/usr/bin/env python3
"""How far K4's bf16 parameter gradients at C/H = 128/512 lie from the JAX
package's bf16 backward kernel, and why: the readings behind
`tests/test_torch_train_ops.py::test_fused_mlp_ln_bwd_reduce_reference_bf16_tensor_core_partials`.

Runs on the CPU, like the tests (it imports both packages):

    JAX_PLATFORMS=cpu python3 scripts/k4_bf16_jax_readings.py [--f32-outputs]

For the test's inputs (M = 300, 1,377, 39, 41) it prints, for each of the
seven parameter gradients, the distance from `fused_mlp_ln_bwd_pallas` in
bfloat16 (interpret mode), per element (scaled by max(1, |y|)) and against
the largest entry, of three things: the reduce's plain version on partials
built as the tensor-core passes build them (erf GELU), the same partials in
the TPU kernel's tanh GELU, and the port's plain version run in bfloat16.
The JAX wrapper casts dW1, db1, dW2 and db2 to the parameters' dtype;
`--f32-outputs` hands it the same bfloat16 values in float32 arrays, so
that its sums stay float32.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--f32-outputs", action="store_true")
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_train_ops as T
    from kasportsformer_tpu.ops.mlp import fused_mlp_ln_bwd_pallas
    from kasportsformer_torch.ops.mlp import (fused_mlp_ln_bwd_reduce_reference,
                                              fused_mlp_ln_bwd_reference)

    for m in (300, 1377, 39, 41):  # the test's inputs
        rng = np.random.default_rng(1000 + m)
        a = T._mlp_inputs(m, 128, 512, rng)
        g = rng.standard_normal((m, 128)).astype(np.float32)
        targs = [t.to(torch.bfloat16) if i in (0, 3, 4, 5, 6) else t
                 for i, t in enumerate(T._torch_mlp_args(a))]
        gb = T._t(g).to(torch.bfloat16)
        erf, tanh = (fused_mlp_ln_bwd_reduce_reference(
            T._k4_workspace(targs, gb.float(), bf16=True, tanh=t), *targs[5:], m)
            for t in (False, True))
        plain = fused_mlp_ln_bwd_reference(*targs, gb)
        pad = -m % 64
        jargs = [jnp.asarray(a[k]) for k in T._ORDER]
        jargs[0] = jnp.pad(jargs[0], ((0, pad), (0, 0)))
        for i in (0, 3, 4, 5, 6):
            jargs[i] = jargs[i].astype(jnp.bfloat16)
            if args.f32_outputs and i:
                jargs[i] = jargs[i].astype(jnp.float32)
        kernel = [np.asarray(z, np.float32) for z in fused_mlp_ln_bwd_pallas(
            *jargs, jnp.pad(jnp.asarray(g, jnp.bfloat16), ((0, pad), (0, 0))), interpret=True)]
        kernel[3], kernel[5] = kernel[3].T, kernel[5].T
        print(f"M={m}: from JAX's bf16 kernel, per element / against the largest entry")
        for name, w, *ours in zip(T._ORDER[1:], kernel[1:], erf, tanh, plain[1:]):
            cells = []
            for label, y in zip(("erf partials", "tanh partials", "plain bf16"), ours):
                d = np.abs(y.numpy() - w)
                cells.append(f"{label} {float((d / np.maximum(1.0, np.abs(w))).max()):.3e} / "
                             f"{float(d.max() / np.abs(w).max()):.3e}")
            print(f"   {name:5s} " + "; ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
