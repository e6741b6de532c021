"""Render configuration: a real dataclass + CLI flags.

The reference has no config system — kwargs with defaults and constants
edited inside `main()` (SURVEY.md §5 "Config / flag system"; the comment
"Parse command line arguments here if needed" at
`/root/reference/examples/julia-raytracer.jl:827` was never implemented).
This module is that missing subsystem.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass
class RenderConfig:
    # scene
    scene: str = "default"  # default | cornell | mesh | <path/to.obj>
    # camera
    lookfrom: Tuple[float, float, float] = (0.0, 1.0, 3.0)
    lookat: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    vfov: float = 60.0
    aperture: float = 0.0
    focus_dist: Optional[float] = None
    # film — defaults are the reference demo config
    # (/root/reference/src/spira-metal-optimized.jl:1494-1497)
    width: int = 640
    height: int = 360
    spp: int = 32
    max_depth: int = 4
    # estimator
    semantics: str = "physical"  # physical | reference
    spectral: bool = False
    engine: str = "auto"  # one of ENGINE_CHOICES (module-level canonical list)
    shading: str = "full"  # full | preview | normal (single-bounce quick looks)
    seed: int = 0
    tonemap: str = "gamma"  # gamma | aces | none
    # execution
    n_tile: Optional[int] = None  # None = single device
    n_spp_axis: int = 1
    # adaptive sampling: rows stop once their pixels' relative luminance
    # half-CI95 falls below this (None = uniform spp everywhere)
    adaptive_tol: Optional[float] = None
    adaptive_min_spp: int = 8
    # retirement unit: "block" (128-px segments, block-mean CI — the knob
    # with a real operating range) or "row" (whole rows, quantile CI)
    adaptive_granularity: str = "block"
    # io
    output: str = "render.png"
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # samples between checkpoints; 0 = off
    progress: bool = True

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RenderConfig":
        d = json.loads(text)
        for k in ("lookfrom", "lookat"):
            if k in d and d[k] is not None:
                d[k] = tuple(d[k])
        return cls(**d)


#: Engines the CLI and RenderConfig accept: ``auto`` plus every engine of
#: `render.ENGINES` (`render.select_engine` resolves ``auto`` through the
#: platform's row of `render.ENGINE_TABLE`).
ENGINE_CHOICES = ("auto", "pallas", "fused", "wavefront")


#: Quality tiers mirroring the reference's config ladder: `quick` is its
#: smoke-test size (/root/reference/tests/test-metal-optimized.jl:10-13),
#: `demo` the package main() (/root/reference/src/spira-metal-optimized.jl:
#: 1494-1497), `quality` the "GPU detected" auto tier
#: (/root/reference/examples/julia-raytracer-optimized-metal.jl:2348-2353).
PRESETS = {
    "quick": dict(width=320, height=180, spp=4, max_depth=2),
    "demo": dict(width=640, height=360, spp=32, max_depth=4),
    "quality": dict(width=1280, height=720, spp=100, max_depth=10),
}


def add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="default",
                   help="default | cornell | mesh | bunny | path/to/model.obj")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS),
                   help="quality tier setting width/height/spp/max-depth "
                        "(explicit flags still override)")
    # None sentinels so config_from_args can tell "user typed it" (wins
    # over a preset, in any spelling: --width 800, --width=800, --wid 800)
    # from "defaulted" — membership tests on sys.argv get '=' forms wrong
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--semantics", default="physical",
                   choices=["physical", "reference"])
    p.add_argument("--spectral", action="store_true")
    p.add_argument("--shading", default="full",
                   choices=["full", "preview", "normal"],
                   help="full path tracing, or single-bounce quick looks")
    p.add_argument("--engine", default="auto", choices=list(ENGINE_CHOICES),
                   help="execution engine (auto picks per scene and "
                        "platform)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tonemap", default="gamma",
                   choices=["gamma", "aces", "none"])
    p.add_argument("--lookfrom", type=float, nargs=3, default=[0.0, 1.0, 3.0])
    p.add_argument("--lookat", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--vfov", type=float, default=60.0)
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--focus-dist", type=float, default=None)
    p.add_argument("--n-tile", type=int, default=None,
                   help="tile-axis device count (default: single device)")
    p.add_argument("--n-spp-axis", type=int, default=1)
    p.add_argument("--adaptive-tol", type=float, default=None,
                   help="adaptive sampling: stop rows whose pixels' relative"
                        " luminance CI95 falls below this (--spp = cap)")
    p.add_argument("--adaptive-min-spp", type=int, default=8)
    p.add_argument("--adaptive-granularity", default="block",
                   choices=["block", "row"],
                   help="adaptive retirement unit: 128-px blocks "
                        "(block-mean CI) or whole rows (quantile CI)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--no-progress", dest="progress", action="store_false")


def config_from_args(args: argparse.Namespace) -> RenderConfig:
    # fill the film fields the user left unset: preset values if --preset,
    # else the demo defaults (a typed flag always wins — argparse leaves
    # it non-None regardless of spelling or argv source)
    film = dict(PRESETS["demo"])
    if getattr(args, "preset", None):
        film.update(PRESETS[args.preset])
    for field, value in film.items():
        if getattr(args, field, None) is None:
            setattr(args, field, value)
    return RenderConfig(
        scene=args.scene,
        lookfrom=tuple(args.lookfrom),
        lookat=tuple(args.lookat),
        vfov=args.vfov,
        aperture=args.aperture,
        focus_dist=args.focus_dist,
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_depth=args.max_depth,
        semantics=args.semantics,
        spectral=args.spectral,
        engine=args.engine,
        shading=args.shading,
        seed=args.seed,
        tonemap=args.tonemap,
        n_tile=args.n_tile,
        n_spp_axis=args.n_spp_axis,
        adaptive_tol=args.adaptive_tol,
        adaptive_min_spp=args.adaptive_min_spp,
        adaptive_granularity=args.adaptive_granularity,
        output=args.output,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        progress=args.progress,
    )


def build_scene(cfg: RenderConfig):
    """Resolve cfg.scene to (Scene, Camera)."""
    from ..scene.camera import make_camera
    from ..scene.scene import (
        cornell_camera,
        create_cornell_box,
        create_mesh_scene,
        create_scene,
    )

    aspect = cfg.width / cfg.height
    if cfg.scene == "default":
        scene = create_scene()
    elif cfg.scene == "cornell":
        return create_cornell_box(), cornell_camera(aspect)
    elif cfg.scene == "mesh":
        scene = create_mesh_scene()
    elif cfg.scene == "bunny":
        from ..scene.bunny import bunny_camera, create_bunny_scene

        scene, _ = create_bunny_scene()
        return scene, bunny_camera(aspect)
    elif cfg.scene.endswith(".obj"):
        scene = create_mesh_scene(obj_path=cfg.scene)
    else:
        raise ValueError(f"unknown scene {cfg.scene!r}")
    camera = make_camera(
        lookfrom=cfg.lookfrom,
        lookat=cfg.lookat,
        vfov=cfg.vfov,
        aspect_ratio=aspect,
        aperture=cfg.aperture,
        focus_dist=cfg.focus_dist,
    )
    return scene, camera
