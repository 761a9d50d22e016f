"""Fly camera (camera.h:113-181) + scripted live-viewer loop."""

import numpy as np
import pytest

from voxtracer.render.camera import make_camera
from voxtracer.render.flycam import (STOP_ANGLE, FlyState, handle_input,

                                     to_camera)

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow



def _mk():
    cam = make_camera(pos=(0, 0, -3), target=(0, 0, 0), aspect=1.0)
    return cam, FlyState.from_camera(cam)


def test_forward_moves_along_ahead():
    cam, fly = _mk()
    changed = handle_input(fly, {"w"}, dt_ms=100.0)
    assert changed
    np.testing.assert_allclose(fly.pos, [0, 0, -3 + 0.75], atol=1e-6)


def test_idle_frame_no_change():
    cam, fly = _mk()
    assert not handle_input(fly, set(), dt_ms=100.0)
    np.testing.assert_allclose(fly.pos, [0, 0, -3])


def test_yaw_rotates_without_translating():
    cam, fly = _mk()
    handle_input(fly, {"right"}, dt_ms=100.0)
    np.testing.assert_allclose(fly.pos, [0, 0, -3])
    new = to_camera(fly, 1.0, cam)
    ahead = np.asarray(new.ahead)
    assert abs(np.linalg.norm(ahead) - 1.0) < 1e-5
    assert ahead[0] != 0.0  # turned toward +x (right = up x ahead)


def test_pitch_clamps_at_stop_angle():
    cam, fly = _mk()
    for _ in range(2000):
        handle_input(fly, {"up"}, dt_ms=10.0)
    ahead = (fly.target - fly.pos)
    ahead = ahead / np.linalg.norm(ahead)
    # one-step overshoot allowed (reference clamp only stops further adds,
    # camera.h:126-140)
    assert ahead[1] <= STOP_ANGLE + 0.1
    before = fly.target.copy()
    handle_input(fly, {"up"}, dt_ms=10.0)
    np.testing.assert_allclose(fly.target, before)  # saturated: no-op


def test_to_camera_matches_make_camera_basis():
    """Rebuilt frustum corners equal make_camera's for a level pose
    (both implement camera.h:172-178)."""
    cam = make_camera(pos=(1, 2, -5), target=(1, 2, 0), aspect=256 / 212)
    fly = FlyState.from_camera(cam)
    rebuilt = to_camera(fly, 256 / 212, cam)
    for f in ("pos", "top_left", "top_right", "bottom_left", "ahead"):
        np.testing.assert_allclose(np.asarray(getattr(rebuilt, f)),
                                   np.asarray(getattr(cam, f)), atol=1e-5)


def test_scripted_live_loop_moves_and_resets():
    """Headless live loop: a move key resets the accumulator; idle frames
    accumulate; the loop completes without a TTY."""
    from voxtracer.scene.presets import glass_sphere_box
    from voxtracer.viewer import run_live

    scene, cfg = glass_sphere_box(32, 32)
    script = [set(), set(), {"w"}, set()]
    frames, report = run_live(scene, cfg, script=script, display=False,
                              max_frames=4)
    assert frames == 4


def test_scripted_live_material_edit():
    from voxtracer.scene.presets import glass_sphere_box
    from voxtracer.viewer import run_live

    scene, cfg = glass_sphere_box(32, 32)
    frames, _ = run_live(scene, cfg, script=[{"m"}, set()], display=False)
    assert frames == 2


def test_cli_live_scripted(tmp_path):
    from voxtracer import cli

    cli.main(["live", "--preset", "glassbox", "--width", "32", "--height",
              "32", "--script", "..w.", "--no-display"])


def test_apply_edits_keymap():
    """The widened live-edit keymap (EditState): slot picking, material
    property nudges with clamping, and light color scaling — each returns
    edited=True so the loop resets the accumulator (renderer.cpp:343)."""
    import jax
    import jax.numpy as jnp

    from voxtracer.scene.presets import glass_sphere_box
    from voxtracer.viewer import EditState, apply_edits

    scene, cfg = glass_sphere_box(32, 32)
    scene = jax.tree.map(jnp.asarray, scene)
    edit = EditState(material=6)

    # digit picks the slot; no scene change
    s2, edited = apply_edits(scene, {"3"}, edit)
    assert edit.material == 3 and not edited

    # slot stepping wraps
    apply_edits(scene, {"["}, edit)
    assert edit.material == 2
    apply_edits(scene, {"]"}, edit)
    assert edit.material == 3

    # albedo brighten
    before = np.asarray(scene.materials.albedo[3])
    s2, edited = apply_edits(scene, {"m"}, edit)
    assert edited
    assert np.allclose(np.asarray(s2.materials.albedo[3]), before * 1.25)

    # roughness clamps at 1.0
    s3 = scene
    for _ in range(15):
        s3, _ = apply_edits(s3, {"r"}, edit)
    assert float(s3.materials.roughness[3]) == 1.0

    # ior clamps at 1.0 going down
    s4 = scene
    for _ in range(40):
        s4, _ = apply_edits(s4, {"k"}, edit)
    assert float(s4.materials.ior[3]) == 1.0

    # light scaling: light 0 is the first point light
    lb = np.asarray(scene.lights.point_color[0])
    s5, edited = apply_edits(scene, {"u"}, edit)
    assert edited
    assert np.allclose(np.asarray(s5.lights.point_color[0]), lb * 1.25)

    # cycling past the typed banks reaches the directional light
    for _ in range(scene.lights.count - 1):
        apply_edits(scene, {"l"}, edit)
    db = np.asarray(scene.lights.dir_color)
    s6, _ = apply_edits(scene, {"j"}, edit)
    assert np.allclose(np.asarray(s6.lights.dir_color), db * 0.8)
