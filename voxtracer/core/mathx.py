"""Numerics shared by the JAX renderer and the NumPy oracle.

Every function here is written against the generic array API (`jnp` or
`np` passed as ``xp``) so the golden CPU oracle (ref/cpu_renderer.py) and the
jitted path use literally the same formulas — this is what makes the
allclose golden tests meaningful.

Replicates the reference's fast approximations and self-intersection offset
(reference: tmpl8math.cpp:405-487) so converged images match its behavior.
"""

from __future__ import annotations

import numpy as np

TWO_PI = 2.0 * np.pi
INV_PI = 1.0 / np.pi
INV_2PI = 1.0 / (2.0 * np.pi)

# Reference: MaterialType::NONE (scene.h:56)
MAT_NONE = 255


def dot3(a, b):
    return (a * b).sum(axis=-1)


def normalize(v, xp):
    n = xp.sqrt((v * v).sum(axis=-1, keepdims=True))
    return v / n


def reflect(d, n):
    """Mirror reflection (reference: renderer.cpp:913-916)."""
    return d - 2.0 * n * dot3(d, n)[..., None]


def refract(d, n, ior_ratio, xp):
    """Snell refraction, 'Ray Tracing in One Weekend' form
    (reference: renderer.cpp:919-925)."""
    cos_theta = xp.minimum(dot3(-d, n), 1.0)[..., None]
    ratio = xp.asarray(ior_ratio)[..., None]
    r_perp = ratio * (d + cos_theta * n)
    r_par = -xp.sqrt(xp.abs(1.0 - (r_perp * r_perp).sum(axis=-1, keepdims=True))) * n
    return r_perp + r_par


def schlick(cosine, ior, xp):
    """Fresnel Schlick for dielectrics (reference: renderer.cpp:1588-1594)."""
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def schlick_nonmetal(cosine):
    """Fixed r0=0.04 Schlick used for diffuse spec split
    (reference: renderer.cpp:1611-1616)."""
    r0 = 0.04
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def absorption(color, intensity, distance, xp):
    """Beer–Lambert with combined density term
    (reference: renderer.cpp:1596-1608).  NOTE: the reference *replaces* the
    color with the transmittance — so does this."""
    return xp.exp(-distance[..., None] * intensity[..., None] * (1.0 - color))


def atan2_fast(y, x, xp):
    """Polynomial atan2 approximation (reference: tmpl8math.cpp:405-426)."""
    one_qtr_pi = np.pi / 4.0
    thr_qtr_pi = 3.0 * np.pi / 4.0
    abs_y = xp.abs(y) + 1e-10
    neg_x = x < 0.0
    r = xp.where(neg_x, (x + abs_y) / (abs_y - x), (x - abs_y) / (x + abs_y))
    angle = xp.where(neg_x, thr_qtr_pi, one_qtr_pi)
    angle = angle + (0.1963 * r * r - 0.9817) * r
    return xp.where(y < 0.0, -angle, angle)


def acos_fast(x, xp):
    """Polynomial acos approximation (reference: tmpl8math.cpp:429-443)."""
    negate = (x < 0.0).astype(x.dtype) if hasattr(x, "astype") else xp.where(x < 0.0, 1.0, 0.0)
    xa = xp.abs(x)
    ret = -0.0187293
    ret = ret * xa + 0.0742610
    ret = ret * xa - 0.2121144
    ret = ret * xa + 1.5707288
    ret = ret * xp.sqrt(xp.maximum(1.0 - xa, 0.0))
    ret = ret - 2.0 * negate * ret
    return negate * 3.14159265358979 + ret


def offset_ray(p, n, xp):
    """Self-intersection-safe ray origin via integer ULP nudge
    ('Ray Tracing Gems' ch.6; reference: tmpl8math.cpp:445-487).

    Exact bit-level replication: works on float32 arrays for both NumPy and
    JAX backends (int32 view arithmetic)."""
    p = p.astype(xp.float32) if hasattr(p, "astype") else p
    int_scale = 256.0
    float_scale = 1.0 / 65536.0
    origin = 1.0 / 32.0

    of_i = (int_scale * n).astype(xp.int32)
    p_bits = _float_as_int(p, xp)
    p_i = _int_as_float(p_bits + xp.where(p < 0.0, -of_i, of_i), xp)
    return xp.where(xp.abs(p) < origin, p + float_scale * n, p_i)


def _float_as_int(f, xp):
    if xp is np:
        return f.astype(np.float32).view(np.int32)
    import jax

    return jax.lax.bitcast_convert_type(f.astype(xp.float32), xp.int32)


def _int_as_float(i, xp):
    if xp is np:
        return i.astype(np.int32).view(np.float32)
    import jax

    return jax.lax.bitcast_convert_type(i.astype(xp.int32), xp.float32)


def luminance(color):
    """Rec.709 luma (reference: renderer.cpp:2237-2240)."""
    return color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722


def reinhard_jodie(color, xp):
    """Luminance-lerped Reinhard tonemap (reference: renderer.cpp:2222-2234)."""
    lum = luminance(color)[..., None]
    tc = color / (1.0 + color)
    tl = color / (1.0 + lum)
    return tl + tc * (tc - tl)


def rgb_to_ycocg(rgb, xp):
    """Reference: renderer.cpp:833-839."""
    y = dot3(rgb, xp.asarray([1.0, 2.0, 1.0], dtype=rgb.dtype)) * 0.25
    co = dot3(rgb, xp.asarray([2.0, 0.0, -2.0], dtype=rgb.dtype)) * 0.25 + (0.5 * 256.0 / 255.0)
    cg = dot3(rgb, xp.asarray([-1.0, 2.0, -1.0], dtype=rgb.dtype)) * 0.25 + (0.5 * 256.0 / 255.0)
    return xp.stack([y, co, cg], axis=-1)


def ycocg_to_rgb(ycocg, xp):
    """Reference: renderer.cpp:841-851."""
    y = ycocg[..., 0]
    co = ycocg[..., 1] - (0.5 * 256.0 / 255.0)
    cg = ycocg[..., 2] - (0.5 * 256.0 / 255.0)
    return xp.stack([y + co - cg, y + cg, y - co - cg], axis=-1)
