"""XLA's per-device FLOP share of the JAX package's recurrent cells under its
sharding rules: each cell function (``mamba2_forward``, ``mlstm_forward``,
``slstm_forward``) jitted with ``in_shardings`` from
``repro.parallel.sharding.param_specs`` on a (data 1, model N) mesh of forced
host devices, its ``cost_analysis`` FLOPs a device over those of the
one-device compile, forward and gradient. A count of the CPU compiler, not a
timing; the port's share of the same cell is the dry run's trace
(``tests/test_torch_mesh_ssm.py`` holds the two at model 4).

    PYTHONPATH=src python scripts/xla_cell_share.py --arch xlstm-125m --model 16 --seq 256

The cells take the config's widths, batch 2 and ``--seq`` steps.
"""
import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--model", type=int, default=16, help="the model axis's size")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={args.model}"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    real = jax.__version__
    jax.__version__ = "0.4.37"       # jax_compat refuses newer releases at import
    from repro.common import jax_compat as jc
    jax.__version__ = real
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.models import ssm
    from repro.parallel import sharding as shd

    cfg = get_config(args.arch).model
    cells = {}
    if cfg.ssm is not None:
        cells["mamba2"] = (ssm.init_mamba2, ssm.mamba2_forward)
    kinds = set(cfg.block_pattern or ())
    if "mlstm" in kinds:
        cells["mlstm"] = (ssm.init_mlstm, ssm.mlstm_forward)
    if "slstm" in kinds:
        cells["slstm"] = (ssm.init_slstm, ssm.slstm_forward)
    auto = (jc.AxisType.Auto,) * 2
    one = jc.make_mesh((1, 1), ("data", "model"), axis_types=auto, devices=jax.devices()[:1])
    many = jc.make_mesh((1, args.model), ("data", "model"), axis_types=auto)
    for name, (init, fwd) in cells.items():
        p = {"cell": init(jax.random.key(1), cfg)}
        x = jax.random.normal(jax.random.key(2), (args.batch, args.seq, cfg.d_model), jnp.float32)
        fns = {"forward": lambda p, x: fwd(p["cell"], cfg, x)[0],
               "gradient": jax.grad(lambda p, x: jnp.sum(fwd(p["cell"], cfg, x)[0] ** 2),
                                    argnums=(0, 1))}
        for kind, fn in fns.items():
            flops = []
            for mesh in (one, many):
                with jc.set_mesh(mesh):
                    psh = shd.to_shardings(shd.param_specs(p, mesh), mesh)
                    xsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
                    cost = jax.jit(fn, in_shardings=(psh, xsh)).lower(p, x).compile() \
                        .cost_analysis()
                    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
                    flops.append(float(cost["flops"]))
            print(f"{args.arch} {name} {kind}: model {args.model}, seq {args.seq}, batch "
                  f"{args.batch}: {flops[1]:.4e} FLOPs a device of {flops[0]:.4e} on one, "
                  f"share {flops[1] / flops[0]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "src"))
    sys.exit(main())
