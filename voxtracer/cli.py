"""CLI entry — render / play / bench / info.

The headless replacement of the reference's GLFW app shell + frame loop
(template.cpp:126-329): no window, no GL — render frames to PNG, run the
game headless, or benchmark.  `python -m voxtracer.cli --help`."""

from __future__ import annotations

import argparse
import sys
import time


PRESETS = {
    "teapot": "teapot_primary",
    "room": "room_whitted",
    "roomglass": None,  # handled specially
    "monu": "monu_path",
    "city": "city_path",
    "cityxl": "city_xl_path",
    "glassbox": "glass_sphere_box",
}


def cmd_render(args):
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np

    from voxtracer.io.image import write_png
    from voxtracer.render.accumulate import ProgressiveState
    from voxtracer.render.integrator import render
    from voxtracer.render.tonemap import to_rgb8
    from voxtracer.scene import presets
    from voxtracer.utils.profiling import FrameReport

    if args.preset == "roomglass":
        scene, cfg = presets.room_whitted(glass=True)
    else:
        scene, cfg = getattr(presets, PRESETS[args.preset])()
    if args.width:
        cfg = dataclasses.replace(cfg, width=args.width,
                                  height=args.height or args.width)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.bounces:
        cfg = dataclasses.replace(cfg, max_bounces=args.bounces)
    if args.dof:
        cfg = dataclasses.replace(cfg, use_dof=True)
    scene = jax.tree.map(jnp.asarray, scene)

    if args.dof:
        # autofocus: trace the center pixel, clamp(t, -1, 1e4)
        # (reference Tick, renderer.cpp:1987-1991)
        from voxtracer.render.camera import primary_rays
        from voxtracer.render.integrator import find_nearest_world

        cx = jnp.asarray([cfg.width / 2.0], jnp.float32)
        cy = jnp.asarray([cfg.height / 2.0], jnp.float32)
        o, d = primary_rays(scene.camera, cfg.width, cfg.height, cx, cy, None, jnp)
        rec = find_nearest_world(scene, o, d, jnp.ones(1, bool))
        focal = float(np.clip(np.asarray(rec["t"])[0], -1.0, 1e4))
        scene = scene.replace(camera=scene.camera.replace(
            focal_distance=jnp.float32(focal),
            defocus_jitter=jnp.float32(args.defocus)))
        print(f"autofocus: focal distance {focal:.3f}")

    key = jax.random.PRNGKey(args.seed)
    if cfg.mode == "reproject":
        # static-camera temporal reuse (renderer.cpp:1997-2101): each frame
        # reprojects against the previous frame's illumination history;
        # output is already tonemapped by the resolve pass
        from voxtracer.render.reproject import render_reproject_frame_jit

        history = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
        prev_cam = scene.camera
        report = FrameReport(cfg.width, cfg.height)
        for frame in range(args.frames):
            t0 = time.time()
            img, history, _ = render_reproject_frame_jit(
                scene, cfg, prev_cam, history, jax.random.fold_in(key, frame))
            np.asarray(history)
            report.frame(time.time() - t0)
        rgb = (np.clip(np.asarray(img), 0.0, 1.0) * 255).astype(np.uint8)
        write_png(args.output, rgb)
        print(f"wrote {args.output} ({cfg.width}x{cfg.height}, "
              f"{args.frames} reprojected frames)")
        return

    prog = ProgressiveState(cfg.height, cfg.width)
    report = FrameReport(cfg.width, cfg.height)
    for frame in range(args.frames):
        t0 = time.time()
        img = render(scene, cfg, jax.random.fold_in(key, frame), args.spp)
        acc = np.asarray(prog.add(img))
        report.frame(time.time() - t0)
    rgb = np.asarray(to_rgb8(jnp.asarray(acc)))
    write_png(args.output, rgb)
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, "
          f"{args.frames} frames x {args.spp} spp, mode={cfg.mode})")


def cmd_play(args):
    """Headless game loop: scripted or random inputs, renders periodically."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from voxtracer.config import RenderConfig
    from voxtracer.game.level import Game
    from voxtracer.io.image import write_png
    from voxtracer.render.integrator import (find_nearest_world, render,
                                             render_game_frame)
    from voxtracer.render.tonemap import to_rgb8

    game = Game(seed=args.seed)
    cfg = RenderConfig(width=args.width or 128, height=args.height or 106,
                       mode="path", max_bounces=6,
                       detect_light_kill=args.light_kill)
    scene = None

    def probe(o, d, dist):
        nonlocal scene
        if scene is None or game.dirty:
            scene = jax.tree.map(jnp.asarray, game.build_scene(cfg.width, cfg.height))
        rec = find_nearest_world(
            scene, jnp.asarray(o)[None], jnp.asarray(d)[None],
            jnp.ones(1, bool), skip_lo=9, skip_hi=14, skip_first=True)
        t = float(rec["t"][0])
        vol = int(rec["vol"][0])
        point = np.asarray(o) + min(t, dist) * np.asarray(d)
        normal = np.asarray(rec["normal"][0])
        return vol, t, point, normal

    moves = list(args.moves) if args.moves else ["w"] * args.steps
    history = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    for i, mv in enumerate(moves[:args.steps]):
        in_light = None
        if args.light_kill:
            # render this frame and observe the kill flag
            # (renderer.cpp:2112-2118: render happens before game logic)
            if scene is None or game.dirty:
                scene = jax.tree.map(jnp.asarray,
                                     game.build_scene(cfg.width, cfg.height))
            if game.state.static_camera:
                # post-revert temporal-reuse mode (renderer.cpp:1997-2101,
                # entered by the staticCamera trigger at :2112-2118)
                from voxtracer.render.reproject import \
                    render_reproject_frame_jit

                _, history, _ = render_reproject_frame_jit(
                    scene, cfg, scene.camera, history,
                    jax.random.fold_in(jax.random.PRNGKey(1), i))
            else:
                _, lit = render_game_frame(scene, cfg,
                                           jax.random.fold_in(
                                               jax.random.PRNGKey(1), i), 1)
                in_light = bool(lit)
        game.tick(0.1, mv, probe, in_light=in_light)
        if game.state.won:
            print("WIN")
            break
    scene = jax.tree.map(jnp.asarray, game.build_scene(cfg.width, cfg.height))
    img = render(scene, cfg, jax.random.PRNGKey(0), args.spp)
    write_png(args.output, np.asarray(to_rgb8(img)))
    print(f"game state: chunk={game.state.current_chunk} "
          f"volumes={len(game.volumes)} -> {args.output}")


def cmd_live(args):
    """Interactive viewer: live progressive render in the terminal with a
    fly camera (reference window + input loop, template.cpp:296-329)."""
    import dataclasses

    from voxtracer.scene import presets
    from voxtracer.viewer import run_live

    if args.preset == "roomglass":
        scene, cfg = presets.room_whitted(glass=True)
    else:
        scene, cfg = getattr(presets, PRESETS[args.preset])()
    cfg = dataclasses.replace(cfg, width=args.width, height=args.height)
    if args.mode:
        cfg = dataclasses.replace(cfg, mode=args.mode)
    if args.bounces:
        cfg = dataclasses.replace(cfg, max_bounces=args.bounces)

    script = None
    if args.script:
        # one character per frame; '.' = idle frame (accumulate only)
        script = [set() if c == "." else {c} for c in args.script]
    frames, _ = run_live(scene, cfg, max_frames=args.frames, script=script,
                         display=not args.no_display, spp=args.spp,
                         seed=args.seed)
    print(f"live: {frames} frames rendered", file=sys.stderr)


def cmd_info(args):
    import jax

    print("devices:", jax.devices())
    print("backend:", jax.default_backend())


def main(argv=None):
    p = argparse.ArgumentParser(prog="voxtracer")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a preset scene to PNG")
    r.add_argument("--preset", choices=PRESETS, default="teapot")
    r.add_argument("--width", type=int, default=0)
    r.add_argument("--height", type=int, default=0)
    r.add_argument("--mode",
                   choices=["primary", "whitted", "path", "reproject"],
                   default=None)
    r.add_argument("--bounces", type=int, default=0)
    r.add_argument("--dof", action="store_true",
                   help="thin-lens DOF with autofocus")
    r.add_argument("--defocus", type=float, default=2.0,
                   help="defocusJitter (camera.h:191)")
    r.add_argument("--frames", type=int, default=1)
    r.add_argument("--spp", type=int, default=1)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--output", default="out.png")
    r.set_defaults(fn=cmd_render)

    g = sub.add_parser("play", help="run the game headless")
    g.add_argument("--steps", type=int, default=8)
    g.add_argument("--moves", default="")
    g.add_argument("--width", type=int, default=0)
    g.add_argument("--height", type=int, default=0)
    g.add_argument("--spp", type=int, default=1)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--light-kill", action="store_true",
                   help="render each step and detect the light-kill revert")
    g.add_argument("--output", default="game.png")
    g.set_defaults(fn=cmd_play)

    v = sub.add_parser("live", help="interactive terminal viewer (fly cam)")
    v.add_argument("--preset", choices=PRESETS, default="monu")
    v.add_argument("--width", type=int, default=256)
    v.add_argument("--height", type=int, default=212)
    v.add_argument("--mode",
                   choices=["primary", "whitted", "path"], default=None)
    v.add_argument("--bounces", type=int, default=0)
    v.add_argument("--frames", type=int, default=0,
                   help="stop after N frames (0 = until quit)")
    v.add_argument("--script", default="",
                   help="headless key script, one char per frame ('.'=idle)")
    v.add_argument("--no-display", action="store_true")
    v.add_argument("--spp", type=int, default=1)
    v.add_argument("--seed", type=int, default=0)
    v.set_defaults(fn=cmd_live)

    i = sub.add_parser("info", help="device info")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    from voxtracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
