#!/usr/bin/env python3
"""Probe: can jax.grad differentiate the JAX package's Pallas attention?

    JAX_PLATFORMS=cpu python3 scripts/pallas_grad_probe.py

Runs jax.grad of sum(attention(q, k, v) * w) through the Pallas kernels of
videovanish_tpu/ops/attention.py in interpret mode on the CPU, and through
the XLA routes beside them:

  _flash_attention(interpret=True)             (:171, _flash_kernel_inline)
  _packed_small_attention_tpu(interpret=True)  (:291, _packed_kernel)
  _xla_attention                               (:30)
  _packed_small_attention                      (:460)

and prints, per function, either the gradient's max |value| or the
exception it raises (type and first line). None of the four Pallas kernels
defines a VJP (no custom_vjp in the module), so on the TPU, where
`_use_pallas()` sends attention to them, the JAX trainer could not
differentiate attention; on the CPU its tests take the XLA routes. The
port's backward kernels (flash_attn_bwd, small_seq_attn_bwd) compute what
jax.vjp of the two XLA routes computes. Changes nothing in the JAX
package; imports it only.
"""
from __future__ import annotations

import importlib
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    jax.config.update("jax_platforms", "cpu")
    # ops/__init__.py exports a function named `attention` over the module
    J = importlib.import_module("videovanish_tpu.ops.attention")
    print(f"jax {jax.__version__}, backend {jax.default_backend()}")

    rng = np.random.default_rng(0)

    def inputs(B, H, Sq, Sk, D):
        return tuple(jnp.asarray(rng.standard_normal(s).astype(np.float32))
                     for s in ((B, H, Sq, D), (B, H, Sk, D), (B, H, Sk, D),
                               (B, H, Sq, D)))

    flash = inputs(1, 2, 256, 256, 40)  # a flash-routed shape (D = 40)
    small = inputs(16, 2, 22, 22, 40)   # a packed shape (S = 22)
    cases = [
        ("_flash_attention (Pallas, interpret)", flash,
         lambda q, k, v: J._flash_attention(q, k, v, 40 ** -0.5,
                                            interpret=True)),
        ("_packed_small_attention_tpu (Pallas, interpret)", small,
         lambda q, k, v: J._packed_small_attention_tpu(q, k, v, 40 ** -0.5,
                                                       interpret=True)),
        ("_xla_attention", flash,
         lambda q, k, v: J._xla_attention(q, k, v, 40 ** -0.5)),
        ("_packed_small_attention", small,
         lambda q, k, v: J._packed_small_attention(q, k, v, 40 ** -0.5)),
    ]
    failed = 0
    for name, (q, k, v, w), fn in cases:
        try:
            g = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * w),
                         argnums=(0, 1, 2))(q, k, v)
            print(f"{name}: grad ok, max |dq|, |dk|, |dv| = "
                  + ", ".join(f"{float(jnp.abs(x).max()):.4g}" for x in g))
        except Exception as e:  # the probe reports what jax.grad raises
            failed += 1
            first = (str(e).strip().splitlines() or [""])[0]
            print(f"{name}: {type(e).__name__}: {first[:200]}")
    print(f"{failed} of {len(cases)} functions cannot be differentiated")
    return 0


if __name__ == "__main__":
    sys.exit(main())
