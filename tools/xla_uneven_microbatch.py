"""What the reference's compiled train step does with a microbatch whose
rows the data devices do not divide: pad them, or run them whole on
every data device.

The reference (``src/repro``, JAX on the CPU) compiles its smoke-config
train step on a (2, 4) ``(data, model)`` mesh of 8 forced host devices
(its own ``launch.mesh.make_test_mesh``), the batch split over ``data``
by ``batch_pspecs(dp_total=2)``, at 4, 6, 8 and 12 rows of 16 tokens,
with ``accum_steps`` 1 and 2.  It prints each compile's per-device FLOPs
and bytes from ``compiled.cost_analysis()`` (XLA counts a scan body
once) and the HLO's all-gather, all-to-all and pad ops.  At 2
microbatches, 4, 8 and 12 rows put 1, 2 and 3 rows a device in each;
6 rows (3 a microbatch, uneven over 2) costs the 2-row count if XLA pads
the microbatch to 4, the 3-row count if it runs it whole on each device.
The port's ``distributed.sharding.split_rows`` follows what this shows.

This reads the reference only and never the port; it is not a test.

Run:  PYTHONPATH=src python tools/xla_uneven_microbatch.py [ARCH ...]
(default: qwen2-72b qwen2-moe-a2.7b; about a minute each on a CPU).
"""

import os
import sys

# before the first use of JAX: 8 host devices, on the CPU
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from repro import configs as cfgs  # noqa: E402
from repro.distributed.compat import enter_mesh  # noqa: E402
from repro.distributed.specs import batch_pspecs, opt_pspecs  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import LM  # noqa: E402
from repro.models.params import (param_pspecs,  # noqa: E402
                                 param_shape_structs)
from repro.optim import adamw  # noqa: E402
from repro.train import make_train_step  # noqa: E402

AXES = ("data", "model")
ROWS = (4, 6, 8, 12)
SEQ = 16


def compile_counts(arch: str) -> list[dict]:
    """Per-device FLOPs, bytes and HLO op counts of ``arch``'s smoke train
    step at each of ``ROWS`` rows and 1 or 2 microbatches."""
    cfg = cfgs.get_smoke_config(arch)
    mesh = make_test_mesh((2, 4), AXES)
    enter_mesh(mesh)
    p_ps = param_pspecs(cfg, fsdp_size=0, tp_size=4)
    p_sds = param_shape_structs(cfg)
    opt = adamw(1e-3)
    opt_sds = jax.eval_shape(opt.init, p_sds)
    o_ps = opt_pspecs(opt_sds, p_ps)

    def named(tree):
        return jax.tree_util.tree_map(lambda ps: NamedSharding(mesh, ps),
                                      tree, is_leaf=lambda x: isinstance(x, P))

    out = []
    for rows in ROWS:
        for accum in (1, 2):
            batch = {k: jax.ShapeDtypeStruct((rows, SEQ), jnp.int32)
                     for k in ("tokens", "labels")}
            b_ps = batch_pspecs(batch, AXES, dp_total=2)
            step = make_train_step(LM(cfg), opt, accum_steps=accum)
            with mesh:
                compiled = jax.jit(
                    step, in_shardings=(named(p_ps), named(o_ps),
                                        named(b_ps),
                                        NamedSharding(mesh, P())),
                    out_shardings=(named(p_ps), named(o_ps), None)
                ).lower(p_sds, opt_sds, batch,
                        jax.ShapeDtypeStruct((), jnp.int32)).compile()
            cost = compiled.cost_analysis()
            cost = cost[0] if isinstance(cost, (list, tuple)) else cost
            hlo = compiled.as_text()
            out.append({"rows": rows, "accum": accum,
                        "flops": cost["flops"],
                        "bytes": cost["bytes accessed"],
                        "all_gather": hlo.count(" all-gather("),
                        "all_to_all": hlo.count(" all-to-all("),
                        "pad": hlo.count(" pad(")})
    return out


def main(argv: list[str]) -> None:
    for arch in argv or ["qwen2-72b", "qwen2-moe-a2.7b"]:
        for r in compile_counts(arch):
            print(f"{arch} rows {r['rows']:2d} accum {r['accum']} "
                  f"(rows a microbatch {r['rows'] // r['accum']}): "
                  f"flops/device {r['flops']:.6e} bytes/device "
                  f"{r['bytes']:.6e} all-gather {r['all_gather']} "
                  f"all-to-all {r['all_to_all']} pad {r['pad']}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
