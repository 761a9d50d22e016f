"""One-bounce path-replay adjoint tests (VERDICT r2 next-round #4): FD vs
autodiff through NEE shadow visibility and the first secondary segment, and
inverse-rendering convergence when the target differs ONLY in a shadowed /
reflected region (invisible to the primary-only diff mode)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from voxtracer.config import RenderConfig
from voxtracer.diff.path_replay import mse_loss_replay, render_diff_replay
from voxtracer.diff.volumetric import params_from_scene
from voxtracer.render.camera import make_camera
from voxtracer.render.integrator import find_nearest_world, _pixel_grid
from voxtracer.render.camera import primary_rays
from voxtracer.scene.instances import VolumeSpec, build_volumes
from voxtracer.scene.lights import make_lights
from voxtracer.scene.materials import default_materials
from voxtracer.scene.presets import _assemble
from voxtracer.scene.volume import solid_grid

# minutes-scale on a 2-vCPU box (golden renders, multi-second jit
# compiles): long-lane only, the fast CI gate runs `-m 'not slow'`
# (pyproject.toml marker)
pytestmark = pytest.mark.slow


def _shadow_scene(w=24, h=24):
    """White floor + a blocker ABOVE the view frustum casting a shadow into
    it: volume 1 (the blocker) is never hit by a primary ray — the only
    gradient path to its density runs through the relaxed NEE shadow march."""
    # world box of a spec = [2*position+0.5 - scale/2, 2*position+0.5 + scale/2]
    # (the position-doubling transform quirk, core/transforms.py:73-92)
    mats = default_materials()
    specs = [
        # floor: y in [-0.85, -0.55], spans x/z [-1.6, 2.6]
        VolumeSpec(position=(0.0, -0.6, 0.0), gridsize=1, grid=solid_grid(1, 0),
                   scale=(4.0, 0.3, 4.0)),
        # blocker: center (0.5, 0.8, 0.556) — on the light->floor(0.5,-0.55,0.6)
        # line, above the camera frustum; thick enough (0.3) that the
        # seg_steps march can't step over it
        VolumeSpec(position=(0.0, 0.15, 0.028), gridsize=8,
                   grid=solid_grid(8, 0), scale=(0.3, 0.3, 0.3)),
    ]
    vols = build_volumes(specs)
    # light close above the blocker -> large umbra (many shadow pixels)
    lights = make_lights(point=((0.5, 1.7, 0.52, 3.0, 3.0, 3.0),))
    cam = make_camera(pos=(0.5, 0.05, -1.3), target=(0.5, -0.4, 0.55),
                      aspect=w / h)
    scene = _assemble(vols, mats, lights=lights, camera=cam)
    cfg = RenderConfig(width=w, height=h, mode="path", max_bounces=2,
                       activate_sky=False, deterministic_lights=True)
    return scene, cfg


def _mirror_scene(w=24, h=24):
    """Metal wall + a red box BEHIND the camera: volume 1 (the box) is only
    visible reflected — the gradient to its albedo/density runs through the
    replayed mirror bounce (V01 · alb1 · E1)."""
    # world box = [2*position+0.5 +- scale/2] (transform quirk, see above)
    mats = default_materials()
    specs = [
        # mirror wall: z in [2.2, 2.4], spans x/y [-1, 2]
        VolumeSpec(position=(0.0, 0.0, 0.9), gridsize=1, grid=solid_grid(1, 6),
                   scale=(3.0, 3.0, 0.2)),
        # red box: center (1.2, 1.2, -4.7) — behind the camera, seen only
        # reflected (mirror point ~(0.74, 0.74, 2.3), in frustum)
        VolumeSpec(position=(0.35, 0.35, -2.6), gridsize=8,
                   grid=solid_grid(8, 1), scale=(0.5, 0.5, 0.3)),
    ]
    vols = build_volumes(specs)
    lights = make_lights(point=((0.5, 1.2, -1.6, 4.0, 4.0, 4.0),))
    cam = make_camera(pos=(0.5, 0.5, -1.25), target=(0.5, 0.5, 2.3),
                      aspect=w / h)
    scene = _assemble(vols, mats, lights=lights, camera=cam)
    cfg = RenderConfig(width=w, height=h, mode="path", max_bounces=2,
                       activate_sky=False, deterministic_lights=True)
    return scene, cfg


def _assert_volume_primary_invisible(scene, cfg, vol_idx):
    px, py = _pixel_grid(cfg)
    o, d = primary_rays(scene.camera, cfg.width, cfg.height, px, py, None,
                        jnp)
    rec = find_nearest_world(scene, o, d, jnp.ones(o.shape[0], bool))
    seen = np.asarray(rec["vol"])[np.asarray(rec["hit"])]
    assert not (seen == vol_idx).any(), "scene invalid: volume directly visible"


KW = dict(n_steps=32, seg_steps=32)


def test_replay_density_fd_through_shadow():
    """FD vs autodiff for density logits of the shadow-only blocker."""
    scene, cfg = _shadow_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    _assert_volume_primary_invisible(scene, cfg, 1)
    params = params_from_scene(scene, occupied_logit=0.5, empty_logit=-6.0)
    key = jax.random.PRNGKey(0)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    # SUM loss for FD headroom (mean-loss deltas sit below f32 resolution)
    def loss(p):
        img = render_diff_replay(p, scene, cfg, key, **KW)
        return jnp.sum((img - target) ** 2)

    g = jax.grad(loss)(params)
    gd = np.asarray(g.density_logits)
    assert np.isfinite(gd).all()
    # the blocker's cells must receive gradient through the shadow march
    assert np.abs(gd[1]).max() > 0.0

    # FD-checkable cells only: the loss is ~4e2, so entries whose
    # |grad|*2eps falls near the f32 ulp (~3e-5) cannot be measured by FD
    flat = np.abs(gd[1]).reshape(-1)
    cand = [fi for fi in np.argsort(flat)[-3:] if flat[fi] > 0.2 * flat.max()]
    assert cand, "no FD-measurable blocker cells"
    eps = 2e-2
    for fi in cand:
        xi, yi, zi = np.unravel_index(fi, gd[1].shape)
        vals = []
        for s in (+1.0, -1.0):
            dl = np.asarray(params.density_logits).copy()
            dl[1, xi, yi, zi] += s * eps
            vals.append(float(loss(dataclasses.replace(
                params, density_logits=jnp.asarray(dl)))))
        fd = (vals[0] - vals[1]) / (2 * eps)
        ad = gd[1, xi, yi, zi]
        assert abs(fd - ad) < 0.2 * max(abs(fd), abs(ad)) + 1e-5, (fd, ad)


def test_replay_albedo_fd_through_reflection():
    """FD vs autodiff for the albedo of a box seen ONLY in a mirror."""
    scene, cfg = _mirror_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    _assert_volume_primary_invisible(scene, cfg, 1)
    params = params_from_scene(scene, occupied_logit=6.0, empty_logit=-6.0)
    key = jax.random.PRNGKey(1)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    # SUM loss for FD headroom: the reflection covers a handful of the 576
    # pixels, so the MEAN-loss FD delta sits below float32 resolution
    def loss(p):
        img = render_diff_replay(p, scene, cfg, key, **KW)
        return jnp.sum((img - target) ** 2)

    g = jax.grad(loss)(params)
    ga = np.asarray(g.albedo_table)
    assert np.isfinite(ga).all()
    # material 1 exists only on the mirrored-only box
    assert np.abs(ga[1]).max() > 0.0

    eps = 5e-2
    ci = int(np.abs(ga[1]).argmax())
    vals = []
    for s in (+1.0, -1.0):
        at = np.asarray(params.albedo_table).copy()
        at[1, ci] += s * eps
        vals.append(float(loss(
            dataclasses.replace(params, albedo_table=jnp.asarray(at)))))
    fd = (vals[0] - vals[1]) / (2 * eps)  # central: exact for quadratics
    ad = ga[1, ci]
    assert abs(fd - ad) < 0.15 * max(abs(fd), abs(ad)) + 1e-6, (fd, ad)


def test_replay_shadow_region_convergence():
    """Inverse rendering where target and init differ ONLY in a shadowed
    region: recovering the blocker's density must reduce the loss (the
    primary-only mode has exactly zero gradient here)."""
    import optax

    scene, cfg = _shadow_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    key = jax.random.PRNGKey(2)
    # gentler density scale keeps softplus out of saturation across the
    # optimization trajectory (interesting logit range ~[-3, 3])
    kw = dict(KW, density_scale=8.0)

    p_target = params_from_scene(scene, occupied_logit=3.0, empty_logit=-3.0)
    target = render_diff_replay(p_target, scene, cfg, key, **kw)

    # init: blocker transparent (same logits elsewhere)
    dl = np.asarray(p_target.density_logits).copy()
    dl[1] = -3.0
    params = dataclasses.replace(p_target,
                                 density_logits=jnp.asarray(dl))
    loss0 = float(mse_loss_replay(params, scene, cfg, target, key, **kw))
    assert loss0 > 1e-6, "target must differ in the shadowed region"

    grad_jit = jax.jit(jax.grad(mse_loss_replay),
                       static_argnames=("cfg", "n_steps", "seg_steps"))
    opt = optax.adam(0.3)
    state = opt.init(params.density_logits)
    for _ in range(40):
        g = grad_jit(params, scene, cfg, target, key, **kw)
        upd, state = opt.update(g.density_logits, state)
        params = dataclasses.replace(
            params, density_logits=params.density_logits + upd)
    loss1 = float(mse_loss_replay(params, scene, cfg, target, key, **kw))
    assert loss1 < loss0 * 0.2, (loss0, loss1)


def test_replay_reflected_region_convergence():
    """Target differs only in a REFLECTED region (red vs white box albedo
    behind the camera): albedo recovery through the replayed bounce."""
    scene, cfg = _mirror_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    key = jax.random.PRNGKey(3)
    p_target = params_from_scene(scene)
    target = render_diff_replay(p_target, scene, cfg, key, **KW)

    at = np.asarray(p_target.albedo_table).copy()
    at[1] = (0.9, 0.9, 0.9)  # init: white box; target: red (palette row 1)
    params = dataclasses.replace(p_target, albedo_table=jnp.asarray(at))
    loss0 = float(mse_loss_replay(params, scene, cfg, target, key, **KW))
    assert loss0 > 1e-7

    import optax

    # adam: the raw-SGD stable lr differs by orders of magnitude between
    # albedo rows (row coverage ~ pixel count) — normalized steps converge
    grad_jit = jax.jit(jax.grad(mse_loss_replay),
                       static_argnames=("cfg", "n_steps", "seg_steps"))
    opt = optax.adam(0.03)
    state = opt.init(params.albedo_table)
    for _ in range(90):
        g = grad_jit(params, scene, cfg, target, key, **KW)
        upd, state = opt.update(g.albedo_table, state)
        params = dataclasses.replace(
            params, albedo_table=params.albedo_table + upd)
    loss1 = float(mse_loss_replay(params, scene, cfg, target, key, **KW))
    assert loss1 < loss0 * 0.05, (loss0, loss1)  # adam endpoint oscillates ~1e-8
    # METAL_MID's albedo is cyan (0,1,1): the reflection carries NO red —
    # only the observable g/b channels of the box can be recovered
    rec = np.asarray(params.albedo_table)[1]
    tgt = np.asarray(p_target.albedo_table)[1]
    assert np.abs(rec[1:] - tgt[1:]).max() < 0.15, (rec, tgt)


def _glass_scene(w=24, h=24):
    """Glass slab covering the whole frustum in front of a blue wall: the
    wall (volume 1) is never the primary hit — every gradient path to its
    albedo runs through the replayed dielectric chain (entry refraction ->
    frozen medium march -> exit refraction -> relaxed segment -> NEE),
    the renderer.cpp:1146-1209 transport (VERDICT r3 item 4)."""
    mats = default_materials()
    specs = [
        # glass slab: z in [0.5, 0.7], spans x/y [-1, 2] (covers frustum)
        VolumeSpec(position=(0.0, 0.0, 0.05), gridsize=1,
                   grid=solid_grid(1, 8), scale=(3.0, 3.0, 0.2)),
        # wall: z in [2.0, 2.2], only visible THROUGH the glass
        VolumeSpec(position=(0.0, 0.0, 0.8), gridsize=1,
                   grid=solid_grid(1, 2), scale=(3.0, 3.0, 0.2)),
    ]
    vols = build_volumes(specs)
    # light between the glass exit (z=0.7) and the wall (z=2.0)
    lights = make_lights(point=((0.5, 0.5, 1.4, 4.0, 4.0, 4.0),))
    cam = make_camera(pos=(0.5, 0.5, -1.2), target=(0.5, 0.5, 2.1),
                      aspect=w / h)
    scene = _assemble(vols, mats, lights=lights, camera=cam)
    cfg = RenderConfig(width=w, height=h, mode="path", max_bounces=3,
                       activate_sky=False, deterministic_lights=True)
    return scene, cfg


def _smoke_scene(w=24, h=24):
    """Smoke block filling the view in front of a blue wall with the light
    between them: the wall is seen only THROUGH the medium, and the smoke
    voxels' density reaches the image through the replayed smoke chain's
    absorption exponent (renderer.cpp:1210-1314, Absorption :1596-1608)
    — the transport that had NO gradient path before round 5."""
    from voxtracer.core.types import SMOKE_MID_DENSITY

    mats = default_materials()
    specs = [
        # smoke slab: z in [0.4, 0.8], covers the frustum in x/y
        VolumeSpec(position=(0.0, 0.0, 0.1), gridsize=8,
                   grid=solid_grid(8, SMOKE_MID_DENSITY),
                   scale=(3.0, 3.0, 0.4)),
        # wall: z in [2.0, 2.2], only visible through the smoke
        VolumeSpec(position=(0.0, 0.0, 0.8), gridsize=1,
                   grid=solid_grid(1, 2), scale=(3.0, 3.0, 0.2)),
    ]
    vols = build_volumes(specs)
    lights = make_lights(point=((0.5, 0.5, 1.4, 4.0, 4.0, 4.0),))
    cam = make_camera(pos=(0.5, 0.5, -1.2), target=(0.5, 0.5, 2.1),
                      aspect=w / h)
    scene = _assemble(vols, mats, lights=lights, camera=cam)
    cfg = RenderConfig(width=w, height=h, mode="path", max_bounces=3,
                       activate_sky=False, deterministic_lights=True)
    return scene, cfg


def test_replay_smoke_density_fd():
    """FD vs autodiff for the smoke voxels' density through the replayed
    absorption exponent (target differs only inside/behind the medium)."""
    scene, cfg = _smoke_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    params = params_from_scene(scene, occupied_logit=0.3, empty_logit=-6.0)
    key = jax.random.PRNGKey(4)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss(p):
        img = render_diff_replay(p, scene, cfg, key, **KW)
        return jnp.sum((img - target) ** 2)

    g = jax.grad(loss)(params)
    gd = np.asarray(g.density_logits)
    assert np.isfinite(gd).all()
    # the smoke volume's cells must receive gradient through the chain
    assert np.abs(gd[0]).max() > 0.0

    flat = np.abs(gd[0]).reshape(-1)
    cand = [fi for fi in np.argsort(flat)[-3:] if flat[fi] > 0.2 * flat.max()]
    assert cand, "no FD-measurable smoke cells"
    eps = 2e-2
    for fi in cand:
        xi, yi, zi = np.unravel_index(fi, gd[0].shape)
        vals = []
        for s in (+1.0, -1.0):
            dl = np.asarray(params.density_logits).copy()
            dl[0, xi, yi, zi] += s * eps
            vals.append(float(loss(dataclasses.replace(
                params, density_logits=jnp.asarray(dl)))))
        fd = (vals[0] - vals[1]) / (2 * eps)
        ad = gd[0, xi, yi, zi]
        assert abs(fd - ad) < 0.2 * max(abs(fd), abs(ad)) + 1e-5, (fd, ad)


def test_replay_smoke_density_recovery():
    """Inverse rendering: recover the smoke volume's density from images
    whose target differs ONLY in how much the medium absorbs (the wall
    behind is identical) — exercises the density -> soft-length ->
    absorption gradient chain end to end."""
    import optax

    scene, cfg = _smoke_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    key = jax.random.PRNGKey(5)
    kw = dict(KW, density_scale=8.0)

    p_target = params_from_scene(scene, occupied_logit=2.0, empty_logit=-3.0)
    target = render_diff_replay(p_target, scene, cfg, key, **kw)

    dl = np.asarray(p_target.density_logits).copy()
    dl[0] = -2.0  # init: thin smoke; target: dense
    params = dataclasses.replace(p_target, density_logits=jnp.asarray(dl))
    loss0 = float(mse_loss_replay(params, scene, cfg, target, key, **kw))
    assert loss0 > 1e-7, "target must differ through the medium"

    grad_jit = jax.jit(jax.grad(mse_loss_replay),
                       static_argnames=("cfg", "n_steps", "seg_steps"))
    opt = optax.adam(0.25)
    state = opt.init(params.density_logits)
    for _ in range(40):
        g = grad_jit(params, scene, cfg, target, key, **kw)
        upd, state = opt.update(g.density_logits, state)
        params = dataclasses.replace(
            params, density_logits=params.density_logits + upd)
    loss1 = float(mse_loss_replay(params, scene, cfg, target, key, **kw))
    assert loss1 < loss0 * 0.2, (loss0, loss1)


def test_replay_glass_chain_fd_and_convergence():
    """Gradients THROUGH a dielectric chain of depth >= 3: FD vs autodiff
    for the behind-glass wall albedo, and inverse-rendering convergence
    when the target differs only behind the glass."""
    scene, cfg = _glass_scene()
    scene = jax.tree.map(jnp.asarray, scene)
    _assert_volume_primary_invisible(scene, cfg, 1)
    params = params_from_scene(scene)
    key = jax.random.PRNGKey(0)

    true_alb = params.albedo_table.at[2].set(
        jnp.asarray([0.9, 0.2, 0.1], jnp.float32))
    target = render_diff_replay(params.replace(albedo_table=true_alb),
                                scene, cfg, key, **KW)

    def loss(p):
        img = render_diff_replay(p, scene, cfg, key, **KW)
        return jnp.sum((img - target) ** 2)

    g = jax.grad(loss)(params)
    ga = np.asarray(g.albedo_table)
    assert np.isfinite(ga).all()
    # the wall's albedo row is reached only through the glass chain
    assert np.abs(ga[2]).max() > 1e-4

    # FD check on the wall's red channel
    eps = 1e-2
    base = float(params.albedo_table[2, 0])

    def at(v):
        p = params.replace(
            albedo_table=params.albedo_table.at[2, 0].set(v))
        return float(loss(p))

    fd = (at(base + eps) - at(base - eps)) / (2 * eps)
    rel = abs(fd - ga[2, 0]) / max(abs(fd), 1e-6)
    assert rel < 0.1, (fd, ga[2, 0])

    # convergence: gradient descent on the albedo table recovers the wall
    # color to a fraction of the initial loss
    p = params
    l0 = float(loss(p))
    lr = 0.5 / max(l0, 1e-6)

    for _ in range(25):
        gi = jax.grad(loss)(p)
        p = p.replace(albedo_table=jnp.clip(
            p.albedo_table - lr * l0 * gi.albedo_table /
            (jnp.linalg.norm(gi.albedo_table) + 1e-12), 0.0, 1.0))
    l1 = float(loss(p))
    assert l1 < 0.35 * l0, (l0, l1)
