"""Interactive live viewer — the headless-terminal analogue of the reference's
GLFW window + fly camera + ImGui edit loop (template.cpp:296-329,
camera.h:113-181, renderer.cpp:2348-2971).

No GL and no window system in this environment, so the "surface" is the
terminal: frames draw as ANSI truecolor half-blocks (one character cell =
two stacked pixels), giving a live progressive image in any modern
terminal.  Input is raw non-blocking keyboard reads (termios + select) —
WASD/QE fly, arrow keys look, exactly the reference key map.  Any camera
move or live material edit resets the progressive accumulator, the same
rule as every ImGui callback in the reference (renderer.cpp:343).

A scripted mode (`keys` iterable + display off) drives the identical loop
headlessly so the viewer is testable without a TTY.
"""

from __future__ import annotations

import sys
import time

import numpy as np


# ---------------------------------------------------------------- terminal IO

class KeyReader:
    """Non-blocking raw keyboard input.  Terminals deliver key *presses*
    (no key-up), so each frame consumes all pending bytes and treats them
    as that frame's held-key set."""

    ARROWS = {"A": "up", "B": "down", "C": "right", "D": "left"}

    def __init__(self):
        import termios
        import tty

        self.fd = sys.stdin.fileno()
        self.saved = termios.tcgetattr(self.fd)
        tty.setcbreak(self.fd)

    def close(self):
        import termios

        termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def poll(self) -> set:
        import select

        keys = set()
        while select.select([sys.stdin], [], [], 0)[0]:
            ch = sys.stdin.read(1)
            if ch == "\x1b":  # escape sequence (arrow) or bare ESC
                if select.select([sys.stdin], [], [], 0)[0]:
                    seq = sys.stdin.read(1)
                    if seq == "[" and select.select([sys.stdin], [], [], 0)[0]:
                        keys.add(self.ARROWS.get(sys.stdin.read(1), "esc"))
                else:
                    keys.add("esc")
            elif ch:
                keys.add(ch.lower())
        return keys


class TermDisplay:
    """ANSI truecolor half-block framebuffer (2 pixels per text row)."""

    def __init__(self):
        self.out = sys.stdout
        self.out.write("\x1b[?1049h\x1b[?25l")  # alt screen, hide cursor

    def close(self):
        self.out.write("\x1b[?25h\x1b[?1049l")
        self.out.flush()

    # 3-digit ASCII LUT: byte value -> b"000".."255" (leading zeros are
    # valid ANSI parameter syntax, making every cell a FIXED 41 bytes)
    _DIG = np.frombuffer(b"".join(b"%03d" % i for i in range(256)),
                         np.uint8).reshape(256, 3)
    _CELL = np.frombuffer(b"\x1b[38;2;000;000;000m"
                          b"\x1b[48;2;000;000;000m\xe2\x96\x80", np.uint8)
    _SLOTS = (7, 11, 15, 26, 30, 34)  # RRR GGG BBB (fg), RRR GGG BBB (bg)

    def show(self, rgb8: np.ndarray, status: str):
        # fixed-width byte-template assembly: with every cell a constant
        # 41 bytes the whole frame is ONE numpy fancy-index fill instead
        # of a per-pixel Python loop
        h, w, _ = rgb8.shape
        hh = h // 2
        tmpl_key = (hh, w)
        if getattr(self, "_tmpl_key", None) != tmpl_key:
            suffix = np.frombuffer(b"\x1b[0m\x1b[K\n", np.uint8)
            row_len = w * len(self._CELL) + len(suffix)
            buf = np.empty((hh, row_len), np.uint8)
            buf[:, :w * len(self._CELL)] = np.tile(self._CELL, (1, w))
            buf[:, w * len(self._CELL):] = suffix
            self._buf = buf
            self._tmpl_key = tmpl_key
        cells = self._buf[:, :w * len(self._CELL)].reshape(
            hh, w, len(self._CELL))
        comp = np.concatenate([rgb8[0:2 * hh:2], rgb8[1:2 * hh:2]],
                              axis=-1)  # [hh, w, 6]
        for slot, ch in zip(self._SLOTS, range(6)):
            cells[:, :, slot:slot + 3] = self._DIG[comp[..., ch]]
        self.out.write("\x1b[H"
                       + self._buf.tobytes().decode("utf-8")
                       + "\x1b[0m" + status + "\x1b[K")
        self.out.flush()


# ----------------------------------------------------------------- live edits

class EditState:
    """Live edit cursor — the ImGui panel analogue (renderer.cpp:2348-2971
    spirit: every scene parameter tweakable at runtime, each edit resetting
    the accumulator) as a terminal keymap instead of a widget tree:

      0-9          pick material slot directly; [ / ] step slot -/+
      m / n        albedo of the slot  x1.25 / x0.8
      r / f        roughness           +0.1 / -0.1   (clamped 0..1)
      g / h        emissive strength   +0.5 / -0.5   (clamped >= 0)
      i / k        IOR                 +0.05 / -0.05 (clamped >= 1)
      l            cycle the selected light (point -> area -> spot -> dir)
      u / j        selected light's color x1.25 / x0.8
    """

    def __init__(self, material: int = 6, light: int = 0):
        self.material = material
        self.light = light

    def status(self, scene) -> str:
        m = scene.materials
        i = self.material
        alb = np.asarray(m.albedo[i])
        return (f"mat {i}: alb=({alb[0]:.2f},{alb[1]:.2f},{alb[2]:.2f}) "
                f"rough={float(m.roughness[i]):.2f} "
                f"emis={float(m.emissive[i]):.2f} "
                f"ior={float(m.ior[i]):.2f} light#{self.light}")


def apply_edits(scene, keys, edit: EditState):
    """Apply this frame's edit keys -> (scene, edited?).  Pure function of
    the pressed-key set; shared by the live loop and the headless tests."""
    import jax.numpy as jnp

    edited = False
    for ch in keys & set("0123456789"):
        edit.material = int(ch)
    if "[" in keys:
        edit.material = (edit.material - 1) % 256
    if "]" in keys:
        edit.material = (edit.material + 1) % 256
    i = edit.material
    m = scene.materials

    def upd(**kw):
        nonlocal m, edited
        m = m.replace(**kw)
        edited = True

    if "m" in keys:
        upd(albedo=m.albedo.at[i].mul(1.25))
    if "n" in keys:
        upd(albedo=m.albedo.at[i].mul(0.8))
    if "r" in keys:
        upd(roughness=m.roughness.at[i].set(
            jnp.clip(m.roughness[i] + 0.1, 0.0, 1.0)))
    if "f" in keys:
        upd(roughness=m.roughness.at[i].set(
            jnp.clip(m.roughness[i] - 0.1, 0.0, 1.0)))
    if "g" in keys:
        upd(emissive=m.emissive.at[i].add(0.5))
    if "h" in keys:
        upd(emissive=m.emissive.at[i].set(
            jnp.maximum(m.emissive[i] - 0.5, 0.0)))
    if "i" in keys:
        upd(ior=m.ior.at[i].add(0.05))
    if "k" in keys:
        upd(ior=m.ior.at[i].set(jnp.maximum(m.ior[i] - 0.05, 1.0)))
    if edited:
        scene = scene.replace(materials=m)

    L = scene.lights
    n_lights = L.count
    if "l" in keys:
        edit.light = (edit.light + 1) % max(n_lights, 1)
    if "u" in keys or "j" in keys:
        s = 1.25 if "u" in keys else 0.8
        li = edit.light
        if li < L.n_point:
            L = L.replace(point_color=L.point_color.at[li].mul(s))
        elif li < L.n_point + L.n_area:
            L = L.replace(area_color=L.area_color.at[li - L.n_point].mul(s))
        elif li < L.n_point + L.n_area + L.n_spot:
            L = L.replace(spot_color=L.spot_color.at[
                li - L.n_point - L.n_area].mul(s))
        else:
            L = L.replace(dir_color=jnp.asarray(L.dir_color) * s)
        scene = scene.replace(lights=L)
        edited = True
    return scene, edited


# ------------------------------------------------------------------ live loop

def _make_live_step():
    """ONE fused jitted dispatch per frame: render sample -> progressive
    lerp -> Reinhard-Jodie -> uint8.  Every separate eager op is its own
    dispatch, so the frame loop ships exactly one program and pulls
    exactly one small uint8 image."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from voxtracer.render.integrator import render
    from voxtracer.render.tonemap import to_rgb8

    @partial(jax.jit, static_argnames=("cfg", "spp"))
    def step(scene, cfg, acc, n_frames, key, spp):
        img = render(scene, cfg, key, spp)
        w = 1.0 / (n_frames.astype(jnp.float32) + 1.0)
        acc = acc * (1.0 - w) + img * w
        return acc, to_rgb8(acc)

    return step


def run_live(scene, cfg, *, max_frames: int = 0, script=None,
             display: bool = True, spp: int = 1, seed: int = 0,
             edit_material: int = 6):
    """The frame loop (template.cpp:296-329 analogue).

    script: optional iterable of per-frame key sets (headless driving);
    when given and display is False, no TTY is needed.
    Returns (frames_rendered, report) for the caller/tests.
    """
    import jax
    import jax.numpy as jnp

    from voxtracer.render.flycam import FlyState, handle_input, to_camera
    from voxtracer.utils.profiling import FrameReport

    scene = jax.tree.map(jnp.asarray, scene)
    fly = FlyState.from_camera(scene.camera)
    edit = EditState(material=edit_material)
    aspect = cfg.width / cfg.height
    live_step = _make_live_step()
    acc = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    n_acc = 0
    # per-frame stats go to the HUD line, not stderr, when displaying
    import io

    report = FrameReport(cfg.width, cfg.height,
                         stream=io.StringIO() if display else sys.stderr)
    key = jax.random.PRNGKey(seed)

    reader = disp = None
    if display:
        disp = TermDisplay()
        if script is None:
            reader = KeyReader()
    script_it = iter(script) if script is not None else None

    frame = 0
    dt_ms = 33.0
    try:
        while True:
            if max_frames and frame >= max_frames:
                break
            t0 = time.time()
            if script_it is not None:
                try:
                    keys = set(next(script_it))
                except StopIteration:
                    break
            elif reader is not None:
                keys = reader.poll()
            else:
                keys = set()
            if "esc" in keys or "x" in keys:
                break

            scene, edited = apply_edits(scene, keys, edit)

            moved = handle_input(fly, keys, dt_ms, slow="shift" in keys)
            if moved:
                scene = scene.replace(camera=jax.tree.map(
                    jnp.asarray, to_camera(fly, aspect, scene.camera)))
            if moved or edited:
                n_acc = 0  # ResetAccumulator (renderer.cpp:343); weight
                # 1/(0+1)=1 overwrites acc, no device-side zeroing needed

            acc, rgb_dev = live_step(scene, cfg, acc,
                                     jnp.int32(n_acc),
                                     jax.random.fold_in(key, frame), spp)
            rgb = np.asarray(rgb_dev)
            n_acc += 1
            dt = time.time() - t0
            dt_ms = dt * 1000.0
            if not display:
                print(f"raw {dt_ms:.1f} ms keys={sorted(keys)}",
                      file=sys.stderr, flush=True)
            stats = report.frame(dt)
            if disp is not None:
                disp.show(rgb, f"{stats['ms']:.1f}ms ({stats['fps']:.1f}fps) "
                               f"{stats['mrays_s']:.2f}Mrays/s  "
                               f"spp={n_acc} "
                               f"pos=({fly.pos[0]:.1f},{fly.pos[1]:.1f},"
                               f"{fly.pos[2]:.1f})  {edit.status(scene)}  "
                               f"[wasd/qe/arrows move, 0-9/[/] slot, "
                               f"m/n r/f g/h i/k edit, l u/j lights, "
                               f"x quit]")
            frame += 1
    finally:
        if reader is not None:
            reader.close()
        if disp is not None:
            disp.close()
    return frame, report
