"""Command-line interface.

The reference's CLI is `if abspath(PROGRAM_FILE) == @__FILE__ main() end` per
example file with constants edited in `main()`
(`/root/reference/src/spira-metal-optimized.jl:1493-1518`); here it is one
real entry point:

    python -m spira_tpu.cli render --scene cornell --spectral -o out.png
    python -m spira_tpu.cli inverse --steps 200 -o recovered.png
    python -m spira_tpu.cli info
"""

from __future__ import annotations

import argparse
import sys


def _cmd_render(args) -> int:
    from .pipeline import run_config
    from .utils.config import config_from_args
    from .utils.metrics import Timer, logger

    cfg = config_from_args(args)
    with Timer("render") as t:
        run_config(cfg)
    rays = cfg.width * cfg.height * cfg.spp * cfg.max_depth
    logger.info(
        "%.2f Mrays/s (%d rays in %.2fs)", rays / t.elapsed / 1e6, rays,
        t.elapsed,
    )
    return 0


def _cmd_inverse(args) -> int:
    import jax.numpy as jnp
    import numpy as np

    from .diff.inverse import make_inverse_step
    from .io import image as img_io
    from .render import render_flat
    from .utils import checkpoint as ckpt
    from .utils.config import build_scene, config_from_args
    from .utils.metrics import logger

    cfg = config_from_args(args)
    scene, camera = build_scene(cfg)

    if args.target:
        # EXRs are stored top-down; the optimizer compares bottom-up flat
        # buffers (undo the assemble flip).
        target_img = img_io.load_exr(args.target)
        target = jnp.asarray(
            np.asarray(target_img, np.float32)[::-1].reshape(-1, 3)
        )
    else:
        logger.info("no --target: synthesizing one from the true scene")
        target = render_flat(
            scene, camera, width=cfg.width, height=cfg.height, spp=cfg.spp,
            max_depth=cfg.max_depth, seed=cfg.seed + 1,
            spectral=cfg.spectral,
        )

    step, init = make_inverse_step(
        width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_depth=cfg.max_depth, spectral=cfg.spectral,
        learning_rate=args.lr,
    )
    key = "albedo_spd" if cfg.spectral else "albedo"
    table = getattr(scene.materials, key)
    params = {key: jnp.full_like(table, 0.5), "emission": scene.materials.emission * 0.0 + 1.0}
    opt_state = init(params)
    start = 0
    if cfg.checkpoint_dir:
        restored = ckpt.load_train_state(cfg.checkpoint_dir, params, opt_state)
        if restored is not None:
            params, opt_state, start = restored
            logger.info("resumed inverse loop at step %d", start)

    for it in range(start, args.steps):
        params, opt_state, loss = step(
            params, opt_state, scene, camera, target, it
        )
        if it % max(1, args.steps // 20) == 0:
            logger.info("step %d  loss %.6f", it, float(loss))
        if cfg.checkpoint_dir and cfg.checkpoint_every and (
            (it + 1) % cfg.checkpoint_every == 0
        ):
            ckpt.save_train_state(
                cfg.checkpoint_dir, params=params, opt_state=opt_state,
                step=it + 1,
            )
    loss = float(loss)
    logger.info("final loss %.6f", loss)
    if not np.isfinite(loss):
        logger.error("non-finite loss; the optimisation diverged")
        return 1
    if cfg.output:
        from .core.types import replace

        materials = scene.materials
        for name, value in params.items():
            materials = replace(materials, **{name: value})
        recovered = replace(scene, materials=materials)
        flat = render_flat(
            recovered, camera, width=cfg.width, height=cfg.height,
            spp=max(cfg.spp, 16), max_depth=cfg.max_depth,
            spectral=cfg.spectral,
        )
        hdr = img_io.assemble_image(flat, cfg.width, cfg.height)
        img_io.save_png(cfg.output, img_io.to_uint8(img_io.tonemap_gamma(hdr)))
        logger.info("wrote %s", cfg.output)
    return 0


def _cmd_info(args) -> int:
    import jax

    print("spira_tpu — differentiable spectral path tracer in JAX")
    print(f"jax {jax.__version__}")
    print(f"backend: {jax.default_backend()}")
    for d in jax.devices():
        print(f"  {d}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="spira_tpu")
    sub = p.add_subparsers(dest="command", required=True)

    from .utils.config import add_render_args

    pr = sub.add_parser("render", help="render a scene")
    add_render_args(pr)
    pr.set_defaults(fn=_cmd_render)

    pi = sub.add_parser("inverse", help="inverse-rendering Adam loop")
    add_render_args(pi)
    pi.add_argument("--steps", type=int, default=100)
    pi.add_argument("--lr", type=float, default=2e-2)
    pi.add_argument("--target", default=None,
                    help="EXR target image (default: self-synthesized)")
    pi.set_defaults(fn=_cmd_inverse)

    pn = sub.add_parser("info", help="show backend/devices")
    pn.set_defaults(fn=_cmd_info)

    args = p.parse_args(argv)
    from .utils.cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
