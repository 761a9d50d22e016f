"""Game layer tests: rolling-cube player, props, level progression
(SURVEY.md §2 #19)."""

import numpy as np
import pytest

from voxtracer.game.player import PlayerCharacter, _model_offset
from voxtracer.game.props import ModifyingProp

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow


def test_player_probe_ray_direction():
    p = PlayerCharacter()
    assert p.update_input("w")
    o, d, dist = p.probe_ray()
    # direction - up normalized: (-z - y) diagonal
    assert dist == 3.0
    assert d[2] < 0 and d[1] < 0
    np.testing.assert_allclose(np.linalg.norm(d), 1.0, atol=1e-6)


def test_player_move_on_floor_keeps_position():
    p = PlayerCharacter()
    pos, rot = p.move((1.0, 2.0, 3.0), (0.0, 1.0, 0.0))
    # up-facing floor: offset = -model_offset(up)*.375 = (-.375, 0, -.375)
    # (PlayerCharacter.cpp:136-152: the up branch zeroes notUpsideOffset,
    # GetModelOffset spreads y onto x/z)
    assert rot.shape == (4, 4)
    np.testing.assert_allclose(pos, [1.0 - 0.375, 2.0, 3.0 - 0.375], atol=1e-6)


def test_player_revert_roundtrip():
    p = PlayerCharacter()
    pos0, rot0 = p.move((0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    p.snapshot(pos0)
    p.move((5.0, 0.0, -3.0), (1.0, 0.0, 0.0))
    pos1, rot1 = p.revert()
    np.testing.assert_allclose(pos1, pos0)
    np.testing.assert_allclose(rot1, rot0, atol=1e-6)


def test_model_offset_quirk():
    # face +y: offset spreads y onto x,z
    np.testing.assert_allclose(_model_offset(np.array([0.0, 1.0, 0.0])),
                               [1.0, 0.0, 1.0])
    # face -x: sign-flipped
    np.testing.assert_allclose(_model_offset(np.array([-1.0, 0.0, 0.0])),
                               [0.0, 1.0, 1.0])


def test_modifying_prop_slides_window(assets_dir):
    prop = ModifyingProp(str(assets_dir / "monu2.vox"), 64, period=0.5,
                         starting_index=16, increase_rate=16)
    assert prop.update(0.1) is None
    g1 = prop.update(0.5)
    assert g1 is not None and g1.shape == (64, 64, 64)
    g2 = prop.update(0.6)
    assert g2 is not None
    assert not np.array_equal(g1, g2)  # window moved
    # wraps after passing 64
    for _ in range(4):
        prop.update(1.0)
    assert prop.index <= 64 + 16


def test_game_builds_and_progresses(assets_dir):
    from voxtracer.game.level import Game

    game = Game(seed=3)
    scene = game.build_scene()
    assert scene.volumes.n == 1 + 6 + 6 + 8  # player+env+bridge+bridgeblind...
    n0 = scene.volumes.n
    assert n0 > 10

    # scripted probe: always hit volume 1 just past the trigger point
    def fake_probe(o, d, dist):
        point = np.array([0.0, 0.0, game.state.trigger_checkpoint - 1.0], np.float32)
        return 1, 1.0, point, np.array([0.0, 1.0, 0.0], np.float32)

    game.tick(0.016, "w", fake_probe)
    assert game.state.current_chunk == 1
    scene2 = game.build_scene()
    assert game.state.trigger_checkpoint == -52.0
    assert scene2.lights.n_area == 1  # second zone adds the area light
    game.tick(0.016, "w", fake_probe)
    assert game.state.current_chunk == 2
    assert any(p is not None for p in game.props)
    game.tick(0.016, "w", fake_probe)
    assert game.state.current_chunk == 3  # win text added
    scene4 = game.build_scene()
    assert scene4.volumes.n >= 3


def test_game_light_kill_reverts(assets_dir):
    from voxtracer.game.level import Game

    game = Game(seed=4)
    start_pos = tuple(game.volumes[0].position)

    def fake_probe(o, d, dist):
        return 1, 1.0, np.array([1.0, 0.0, -2.0], np.float32), \
            np.array([0.0, 1.0, 0.0], np.float32)

    game.tick(0.016, "w", fake_probe)
    moved_pos = tuple(game.volumes[0].position)
    assert moved_pos != start_pos
    game.state.in_light = True
    game.tick(0.016, None, fake_probe)
    assert game.state.static_camera
    # player returned to checkpoint (the initial snapshot)
    np.testing.assert_allclose(game.volumes[0].position, start_pos, atol=1e-5)


def test_light_kill_from_render(assets_dir):
    """Rendering a brightly lit player-smoke volume flips the in_light aux
    (renderer.cpp:1437-1450); a dark scene doesn't.  The flag then drives
    the checkpoint revert through Game.tick (renderer.cpp:2112-2118)."""
    import jax
    import jax.numpy as jnp

    from voxtracer.config import RenderConfig
    from voxtracer.core.types import SMOKE_PLAYER
    from voxtracer.render.integrator import render_game_frame
    from voxtracer.scene.instances import VolumeSpec, build_volumes
    from voxtracer.scene.lights import make_lights
    from voxtracer.scene.materials import default_materials
    from voxtracer.scene.presets import _assemble
    from voxtracer.scene.volume import solid_grid

    vols = build_volumes([VolumeSpec(position=(0, 0, 0), gridsize=4,
                                     grid=solid_grid(4, SMOKE_PLAYER))])
    cfg = RenderConfig(width=16, height=16, mode="path", max_bounces=2,
                       detect_light_kill=True, activate_sky=False,
                       compact_chunks=1)
    key = jax.random.PRNGKey(0)
    # player smoke gets a nonzero albedo in the game via the .vox palette
    # mutation rule (scene.cpp:516-520) — replicate it here; the default
    # SMOKE_PLAYER albedo is black (smoke5, renderer.cpp MaterialSetUp)
    mats = default_materials()
    alb = np.array(mats.albedo)
    alb[SMOKE_PLAYER] = (1.0, 0.7, 1.0)
    mats = mats.replace(albedo=alb)

    def run(color):
        lights = make_lights(point=((0.0, 0.0, -1.2) + color,))
        scene = jax.tree.map(jnp.asarray,
                             _assemble(vols, mats, lights=lights))
        _, lit = render_game_frame(scene, cfg, key, 1)
        return bool(lit)

    assert run((500.0, 500.0, 500.0))       # lit player -> kill flag
    assert not run((1e-4, 1e-4, 1e-4))      # dark -> no flag


def test_light_kill_reverts_via_tick(assets_dir):
    """The rendered in_light observation plumbs through Game.tick and
    reverts the player to its checkpoint."""
    from voxtracer.game.level import Game

    game = Game(seed=11)
    start_pos = tuple(game.volumes[0].position)

    def fake_probe(o, d, dist):
        return 1, 1.0, np.array([1.0, 0.0, -2.0], np.float32), \
            np.array([0.0, 1.0, 0.0], np.float32)

    game.tick(0.016, "w", fake_probe)
    assert tuple(game.volumes[0].position) != start_pos
    game.tick(0.016, None, fake_probe, in_light=True)
    assert game.state.static_camera
    np.testing.assert_allclose(game.volumes[0].position, start_pos,
                               atol=1e-5)
