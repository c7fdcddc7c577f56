"""Irawan–Marschner woven cloth BRDF.

Wavefront port of the reference's `irawan` plugin (ref:
src/bsdfs/irawan.{h,cpp} — based on Piti Irawan's thesis "The Appearance
of Woven Cloth", 2008). The reference evaluates one uv-located yarn
segment per shading point via a virtual call; here the weave patterns are
compiled into a pool of padded arrays (grids / yarn tables / scalar meta)
bound at scene compile — the eval is a pair of gathers plus closed-form
elementwise math over the whole wavefront.

Semantics mirrored from the reference:
  * the weave tile is addressed by (u·repeatU, (1-v)·repeatV);
  * specular term = filament (psi == 0) or staple (psi != 0) integrand
    (irawan.cpp:390,482) with von Mises phase, Seeliger attenuation and
    the radius-of-curvature spine model (irawan.cpp:551);
  * correlated per-segment noise perturbs umax via TEA-seeded Perlin
    noise when `period > 0` (irawan.cpp:256-275);
  * per-fiber intensity variation = min(-log ξ, 10) with ξ a TEA hash of
    the fineness-scaled position (irawan.cpp:295-303);
  * the specular normalization is estimated by cosine-hemisphere Monte
    Carlo at registration, matching the reference's `configure()`
    bootstrap (irawan.cpp:139-169: norm = N / (max·π));
  * sampling is cosine-hemisphere, pdf = cosθ/π (irawan.cpp:336-370).

Weave patterns come from `parse_weave` (the reference's text DSL, with
$var substitution) or the built-in `plain_weave`/`twill_weave`/
`denim_weave` constructors.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..core.noise import perlin
from ..core.warp import (INV_PI, square_to_cosine_hemisphere,
                         square_to_cosine_hemisphere_pdf)

_EPS = 1e-6


# ---------------------------------------------------------------------------
# pattern description + DSL parser
# ---------------------------------------------------------------------------

@dataclass
class Yarn:
    """One yarn segment class (ref: irawan.h:49 `struct Yarn`). Angles in
    radians (the DSL specifies them in degrees)."""
    type: int = 0              # 0 = warp, 1 = weft
    psi: float = 0.0           # fiber twist angle (0 ⇒ filament)
    umax: float = 0.0          # max inclination angle
    kappa: float = 0.0         # spine curvature
    width: float = 0.0
    length: float = 0.0
    center_u: float = 0.0
    center_v: float = 0.0
    kd: Sequence[float] = (0.0, 0.0, 0.0)
    ks: Sequence[float] = (0.0, 0.0, 0.0)


@dataclass
class WeavePattern:
    """ref: irawan.h:150 `struct WeavePattern`."""
    name: str = ""
    tile_width: int = 1
    tile_height: int = 1
    alpha: float = 0.0         # uniform scattering
    beta: float = 0.0          # forward scattering (von Mises concentration)
    ss: float = 0.0            # filament smoothing
    h_width: float = 0.0       # highlight width
    warp_area: float = 0.0
    weft_area: float = 0.0
    d_warp_umax_over_d_warp: float = 0.0   # radians
    d_warp_umax_over_d_weft: float = 0.0
    d_weft_umax_over_d_warp: float = 0.0
    d_weft_umax_over_d_weft: float = 0.0
    fineness: float = 0.0
    period: float = 0.0
    pattern: np.ndarray = field(
        default_factory=lambda: np.ones((1, 1), np.int32))  # [H, W] 1-based
    yarns: List[Yarn] = field(default_factory=list)


_DEG_KEYS = {"psi", "umax", "dWarpUmaxOverDWarp", "dWarpUmaxOverDWeft",
             "dWeftUmaxOverDWarp", "dWeftUmaxOverDWeft"}
_SNAKE = {
    "tileWidth": "tile_width", "tileHeight": "tile_height",
    "hWidth": "h_width", "warpArea": "warp_area", "weftArea": "weft_area",
    "dWarpUmaxOverDWarp": "d_warp_umax_over_d_warp",
    "dWarpUmaxOverDWeft": "d_warp_umax_over_d_weft",
    "dWeftUmaxOverDWarp": "d_weft_umax_over_d_warp",
    "dWeftUmaxOverDWeft": "d_weft_umax_over_d_weft",
    "centerU": "center_u", "centerV": "center_v",
}


def parse_weave(text: str, params: dict | None = None) -> WeavePattern:
    """Parse the reference's weave-pattern DSL (ref: irawan.h:344
    `WeavePatternGrammar`): `weave { key = value, ..., pattern {..},
    yarn {..}, ... }` with /* */ comments and $var substitution from
    `params`."""
    params = params or {}
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)

    def subst(tok: str):
        tok = tok.strip()
        if tok.startswith("$"):
            return params[tok[1:]]
        return tok

    m = re.search(r"weave\s*\{(.*)\}\s*$", text, flags=re.S)
    if not m:
        raise ValueError("not a weave pattern file")
    body = m.group(1)

    wp = WeavePattern()
    # extract pattern {...} and yarn {...} blocks first
    def grab_blocks(kind, s):
        out = []
        # one nesting level: yarn blocks contain {r, g, b} spectra
        pat = re.compile(kind + r"\s*\{((?:[^{}]|\{[^{}]*\})*)\}",
                         flags=re.S)
        while True:
            mm = pat.search(s)
            if not mm:
                return out, s
            out.append(mm.group(1))
            s = s[:mm.start()] + s[mm.end():]

    pat_blocks, body = grab_blocks("pattern", body)
    yarn_blocks, body = grab_blocks("yarn", body)

    for kv in re.finditer(r"(\w+)\s*=\s*(\"[^\"]*\"|[^,\s]+)", body):
        key, val = kv.group(1), subst(kv.group(2))
        if key == "name":
            wp.name = str(val).strip('"')
            continue
        attr = _SNAKE.get(key, key)
        v = float(val)
        if key in _DEG_KEYS:
            v *= math.pi / 180.0
        if key in ("tileWidth", "tileHeight"):
            setattr(wp, attr, int(v))
        else:
            setattr(wp, attr, v)

    if pat_blocks:
        ids = [int(subst(t)) for t in pat_blocks[0].replace(",", " ").split()]
        if len(ids) != wp.tile_width * wp.tile_height:
            raise ValueError("pattern size != tileWidth*tileHeight")
        wp.pattern = np.asarray(ids, np.int32).reshape(
            wp.tile_height, wp.tile_width)

    for yb in yarn_blocks:
        y = Yarn()
        for kv in re.finditer(
                r"(\w+)\s*=\s*(\{[^}]*\}|\"[^\"]*\"|[^,\s]+)", yb):
            key, raw = kv.group(1), kv.group(2)
            if key == "type":
                y.type = 0 if raw.strip() == "warp" else 1
                continue
            if raw.startswith("{"):
                vals = [float(subst(t)) for t in
                        raw.strip("{}").replace(",", " ").split()]
                setattr(y, key, tuple(vals))
                continue
            v = float(subst(raw))
            if key in _DEG_KEYS:
                v *= math.pi / 180.0
            setattr(y, _SNAKE.get(key, key), v)
        wp.yarns.append(y)

    if not wp.yarns:
        raise ValueError("weave pattern has no yarns")
    if wp.pattern.min() < 1 or wp.pattern.max() > len(wp.yarns):
        raise ValueError("pattern references undefined yarns")
    return wp


# -- built-in patterns (plain/twill from the Irawan thesis parameter
#    families; values chosen to exercise both integrand types) -------------

def plain_weave(kd=(0.3, 0.3, 0.3), ks=(0.4, 0.4, 0.4)) -> WeavePattern:
    """1/1 plain weave, filament yarns (psi = 0 → filament integrand)."""
    d = math.pi / 180.0
    common = dict(psi=0.0, umax=25 * d, kappa=0.0, width=2.0, length=2.0,
                  kd=kd, ks=ks)
    return WeavePattern(
        name="plain", tile_width=2, tile_height=2,
        alpha=0.1, beta=6.0, ss=0.3, h_width=0.5,
        warp_area=0.5, weft_area=0.5,
        pattern=np.array([[1, 2], [2, 1]], np.int32),
        yarns=[Yarn(type=0, center_u=0.5, center_v=0.5, **common),
               Yarn(type=1, center_u=0.5, center_v=0.5, **common)])


def twill_weave(kd=(0.25, 0.2, 0.1), ks=(0.5, 0.5, 0.5)) -> WeavePattern:
    """2/2 twill, staple yarns (psi != 0 → staple integrand)."""
    d = math.pi / 180.0
    common = dict(psi=30 * d, umax=30 * d, kappa=0.1, kd=kd, ks=ks)
    return WeavePattern(
        name="twill", tile_width=4, tile_height=4,
        alpha=0.05, beta=4.0, ss=0.0, h_width=0.5,
        warp_area=0.6, weft_area=0.4,
        pattern=np.array([[1, 1, 2, 2], [2, 1, 1, 2],
                          [2, 2, 1, 1], [1, 2, 2, 1]], np.int32),
        yarns=[Yarn(type=0, width=2.0, length=4.0, center_u=0.5,
                    center_v=0.5, **common),
               Yarn(type=1, width=2.0, length=4.0, center_u=0.5,
                    center_v=0.5, **common)])


def denim_weave() -> WeavePattern:
    """3/1 warp-faced twill with indigo warp / white weft (denim-like)."""
    d = math.pi / 180.0
    return WeavePattern(
        name="denim", tile_width=3, tile_height=6,
        alpha=0.12, beta=12.0, ss=0.0, h_width=0.95,
        warp_area=0.7, weft_area=0.3,
        d_warp_umax_over_d_warp=12 * d, d_warp_umax_over_d_weft=12 * d,
        d_weft_umax_over_d_warp=6 * d, d_weft_umax_over_d_weft=6 * d,
        fineness=8.0, period=50.0,
        pattern=np.array([[1, 3, 8], [1, 3, 5], [1, 7, 5],
                          [1, 4, 5], [6, 4, 5], [2, 4, 5]], np.int32),
        yarns=(
            [Yarn(type=0, psi=38 * d, umax=46 * d, kappa=1.1, width=2.0,
                  length=3.0, center_u=cu, center_v=cv,
                  kd=(0.02, 0.03, 0.14), ks=(0.06, 0.09, 0.24))
             for cu, cv in [(0.1667, 0.75), (0.1667, -0.25), (0.5, 1.0833),
                            (0.5, 0.0833), (0.8333, 0.4167)]]
            + [Yarn(type=1, psi=38 * d, umax=46 * d, kappa=1.1, width=2.0,
                    length=3.0, center_u=cu, center_v=cv,
                    kd=(0.55, 0.55, 0.56), ks=(0.2, 0.2, 0.2))
               for cu, cv in [(0.1667, 0.25), (0.5, 0.5833),
                              (0.8333, 0.9167)]]))


# ---------------------------------------------------------------------------
# compile-time pool (like bsdf/tabulated_pool.py)
# ---------------------------------------------------------------------------

N_META = 16
N_YARN = 14

_POOL = {"grids": None, "yarns": None, "meta": None}


def register_patterns(patterns: Sequence[WeavePattern] | None) -> None:
    """Bind all weave patterns used by the scene. Pads grids/yarn tables
    to the max dims so a single gather addresses any pattern."""
    if not patterns:
        _POOL["grids"] = _POOL["yarns"] = _POOL["meta"] = None
        return
    k = len(patterns)
    hw = max(p.tile_width * p.tile_height for p in patterns)
    ny = max(len(p.yarns) for p in patterns)
    grids = np.zeros((k, hw), np.int32)
    yarns = np.zeros((k, ny, N_YARN), np.float32)
    meta = np.zeros((k, N_META), np.float32)
    for i, p in enumerate(patterns):
        flat = p.pattern.reshape(-1) - 1          # 0-based yarn ids
        grids[i, :flat.size] = flat
        for j, y in enumerate(p.yarns):
            yarns[i, j] = ([y.type, y.psi, y.umax, y.kappa, y.width,
                            y.length, y.center_u, y.center_v]
                           + list(y.kd) + list(y.ks))
        meta[i] = [p.alpha, p.beta, p.ss, p.h_width, p.warp_area,
                   p.weft_area, p.tile_width, p.tile_height,
                   p.d_warp_umax_over_d_warp, p.d_warp_umax_over_d_weft,
                   p.d_weft_umax_over_d_warp, p.d_weft_umax_over_d_weft,
                   p.fineness, p.period, 0.0, 0.0]
        meta[i, 14] = _estimate_normalization(grids[i], yarns[i], meta[i])
    _POOL["grids"] = jnp.asarray(grids)
    _POOL["yarns"] = jnp.asarray(yarns)
    _POOL["meta"] = jnp.asarray(meta)


def get_pool():
    return _POOL["grids"], _POOL["yarns"], _POOL["meta"]


def _estimate_normalization(grid_row, yarn_rows, meta_row,
                            n_samples: int = 10000) -> float:
    """The reference's configure() bootstrap (irawan.cpp:139-169):
    cosine-hemisphere MC of the raw specular integrand; normalization
    = N / (sum·π) so the normalized specular term integrates to ≲1."""
    rs = np.random.RandomState(0xC0FFEE)
    u_wi = rs.rand(n_samples, 2).astype(np.float32)
    u_wo = rs.rand(n_samples, 2).astype(np.float32)
    uv = rs.rand(n_samples, 2).astype(np.float32)
    wi = np.asarray(square_to_cosine_hemisphere(jnp.asarray(u_wi)))
    wo = np.asarray(square_to_cosine_hemisphere(jnp.asarray(u_wo)))
    raw = _eval_arrays(
        jnp.asarray(grid_row)[None], jnp.asarray(yarn_rows)[None],
        jnp.asarray(meta_row)[None],
        jnp.zeros(n_samples, jnp.int32), jnp.ones(n_samples),
        jnp.ones(n_samples), jnp.asarray(uv), jnp.asarray(wi),
        jnp.asarray(wo), initialization=True)
    total = float(np.asarray(raw).sum())
    if total <= 0:
        return 0.0
    return n_samples / (total * math.pi)


# ---------------------------------------------------------------------------
# eval core (vectorized port of irawan.cpp:189-650)
# ---------------------------------------------------------------------------

def _sample_tea_f32(v0, v1, rounds: int = 8):
    """TEA-hashed float in [0,1) (ref: include/mitsuba/core/qmc.h:146)."""
    v0 = v0.astype(jnp.uint32)
    v1 = v1.astype(jnp.uint32)
    s = jnp.uint32(0)
    for _ in range(rounds):
        s = s + jnp.uint32(0x9E3779B9)
        v0 = v0 + (((v1 << 4) + jnp.uint32(0xA341316C))
                   ^ (v1 + s) ^ ((v1 >> 5) + jnp.uint32(0xC8013EA4)))
        v1 = v1 + (((v0 << 4) + jnp.uint32(0xAD90777D))
                   ^ (v0 + s) ^ ((v0 >> 5) + jnp.uint32(0x7E95761E)))
    bits = (v0 >> 9) | jnp.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0


def _von_mises(cos_x, b):
    """Normalized von Mises pdf on the circle (irawan.cpp:587-605)."""
    absb = jnp.abs(b)
    t_small = (absb / 3.75) ** 2
    i0_small = 1.0 + t_small * (3.5156229 + t_small * (
        3.0899424 + t_small * (1.2067492 + t_small * (
            0.2659732 + t_small * (0.0360768 + t_small * 0.0045813)))))
    t_big = 3.75 / jnp.maximum(absb, _EPS)
    i0_big = jnp.exp(absb) / jnp.sqrt(jnp.maximum(absb, _EPS)) * (
        0.39894228 + t_big * (0.01328592 + t_big * (
            0.00225319 + t_big * (-0.00157565 + t_big * (
                0.00916281 + t_big * (-0.02057706 + t_big * (
                    0.02635537 + t_big * (-0.01647633
                                          + t_big * 0.00392377))))))))
    i0 = jnp.where(absb <= 3.75, i0_small, i0_big)
    return jnp.exp(b * cos_x) / (2.0 * jnp.pi * i0)


def _seeliger(c1, c2):
    """Lommel-Seeliger attenuation, albedo 1 (irawan.cpp:608-615)."""
    c1 = jnp.maximum(c1, 0.0)
    c2 = jnp.maximum(c2, 0.0)
    den = c1 + c2
    return jnp.where(den > 0, c1 * c2 / (4.0 * jnp.pi
                                         * jnp.maximum(den, _EPS)), 0.0)


def _radius_of_curvature(u, umax, kappa, w, l):
    """Spine radius of curvature (irawan.cpp:551-581): ellipse /
    parabola / hyperbola / circle by rhat."""
    tan_umax = jnp.tan(jnp.clip(umax, _EPS, jnp.pi / 2 - _EPS))
    rhat = 1.0 + kappa * (1.0 + 1.0 / tan_umax)
    a = 0.5 * w
    sin_umax = jnp.sin(umax)

    # circle (rhat == 1)
    r_circ = (0.5 * l - a * sin_umax) / jnp.maximum(sin_umax, _EPS)

    # ellipse (rhat > 0)
    rh_pos = jnp.maximum(rhat, _EPS)
    tmax_e = jnp.arctan(rh_pos * tan_umax)
    bhat_e = (0.5 * l - a * sin_umax) / jnp.maximum(jnp.sin(tmax_e), _EPS)
    ahat_e = bhat_e / rh_pos
    t_e = jnp.arctan(rh_pos * jnp.tan(u))
    r_ell = (bhat_e ** 2 * jnp.cos(t_e) ** 2
             + ahat_e ** 2 * jnp.sin(t_e) ** 2) ** 1.5 \
        / jnp.maximum(jnp.abs(ahat_e * bhat_e), _EPS)

    # hyperbola (rhat < 0)
    def atanh(x):
        x = jnp.clip(x, -1.0 + _EPS, 1.0 - _EPS)
        return 0.5 * jnp.log((1.0 + x) / (1.0 - x))
    rh_neg = jnp.minimum(rhat, -_EPS)
    tmax_h = -atanh(rh_neg * tan_umax)
    bhat_h = (0.5 * l - a * sin_umax) / jnp.maximum(jnp.sinh(tmax_h), _EPS)
    ahat_h = bhat_h / rh_neg
    t_h = -atanh(rh_neg * jnp.tan(u))
    r_hyp = -(bhat_h ** 2 * jnp.cosh(t_h) ** 2
              + ahat_h ** 2 * jnp.sinh(t_h) ** 2) ** 1.5 \
        / jnp.minimum(ahat_h * bhat_h, -_EPS ** 2)

    # parabola (rhat == 0)
    tmax_p = tan_umax
    ahat_p = (0.5 * l - a * sin_umax) / jnp.maximum(2.0 * tmax_p, _EPS)
    t_p = jnp.tan(u)
    r_par = 2.0 * ahat_p * (1.0 + t_p * t_p) ** 1.5

    r = jnp.where(jnp.abs(rhat - 1.0) < 1e-5, r_circ,
                  jnp.where(rhat > 1e-5, r_ell,
                            jnp.where(rhat < -1e-5, r_hyp, r_par)))
    return r


def _filament_integrand(u, v, om_i, om_r, alpha, beta, ss, umax, kappa,
                        w, l, h_width):
    """irawan.cpp:390-466 (psi == 0)."""
    h = om_i + om_r
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), _EPS)
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    # reference uses atan(h.y/h.z): range (-pi/2, pi/2)
    u_of_v = jnp.arctan(hy / jnp.where(jnp.abs(hz) < _EPS, _EPS, hz))

    n = jnp.stack([jnp.sin(v), jnp.sin(u_of_v) * jnp.cos(v),
                   jnp.cos(u_of_v) * jnp.cos(v)], axis=-1)
    r = _radius_of_curvature(jnp.minimum(jnp.abs(u_of_v), (1 - ss) * umax),
                             (1 - ss) * umax, kappa, w, l)
    a = 0.5 * w
    ipr = om_i + om_r
    ipr_len = jnp.linalg.norm(ipr, axis=-1)
    t = jnp.stack([jnp.zeros_like(u_of_v), jnp.cos(u_of_v),
                   -jnp.sin(u_of_v)], axis=-1)
    txh_x = t[..., 1] * hz - t[..., 2] * hy      # cross(t, h).x
    gu = a * (r + a * jnp.cos(v)) \
        / jnp.maximum(ipr_len * jnp.abs(txh_x), _EPS)
    fc = alpha + _von_mises(-jnp.sum(om_i * om_r, axis=-1), beta)
    att = _seeliger(jnp.sum(n * om_i, axis=-1), jnp.sum(n * om_r, axis=-1))
    smooth = jnp.clip((jnp.abs(u_of_v) - (1 - ss) * umax)
                      / jnp.maximum(ss * umax, _EPS), 0.0, 1.0)
    smooth = smooth * smooth * (3.0 - 2.0 * smooth)
    a_s = jnp.where(ss > _EPS, att * (1.0 - smooth), att)
    fs = gu * fc * a_s * jnp.pi * l

    delta_y = l * h_width
    y_of_v = jnp.clip(u_of_v * 0.5 * l / jnp.maximum(umax, _EPS),
                      0.5 * (delta_y - l), 0.5 * (l - delta_y))
    in_hl = jnp.abs(y_of_v - u * 0.5 * l / jnp.maximum(umax, _EPS)) \
        < 0.5 * delta_y
    valid = ((jnp.abs(u_of_v) < umax) & in_hl & (ss >= 0.0) & (ss < 1.0)
             & (w * jnp.sin(umax) < l) & (kappa >= -1.0))
    return jnp.where(valid, fs / jnp.maximum(delta_y, _EPS), 0.0)


def _staple_integrand(u, v, om_i, om_r, alpha, beta, psi, umax, kappa,
                      w, l, h_width):
    """irawan.cpp:482-549 (psi != 0)."""
    h = om_i + om_r
    h = h / jnp.maximum(jnp.linalg.norm(h, axis=-1, keepdims=True), _EPS)
    hx, hy, hz = h[..., 0], h[..., 1], h[..., 2]
    sin_u, cos_u = jnp.sin(u), jnp.cos(u)
    tan_psi = jnp.tan(jnp.where(jnp.abs(psi) < _EPS, _EPS, psi))
    denom = jnp.sqrt(hx * hx + (hy * sin_u + hz * cos_u) ** 2) * tan_psi
    d = (hy * cos_u - hz * sin_u) / jnp.where(jnp.abs(denom) < _EPS,
                                              _EPS, denom)
    v_of_u = jnp.arctan2(-hy * sin_u - hz * cos_u, hx) \
        + jnp.arccos(jnp.clip(d, -1.0, 1.0))

    n = jnp.stack([jnp.sin(v_of_u), sin_u * jnp.cos(v_of_u),
                   cos_u * jnp.cos(v_of_u)], axis=-1)
    r = _radius_of_curvature(jnp.abs(u), umax, kappa, w, l)
    a = 0.5 * w
    ipr_len = jnp.linalg.norm(om_i + om_r, axis=-1)
    n_dot_h = jnp.abs(jnp.sum(n * h, axis=-1))
    gv = a * (r + a * jnp.cos(v_of_u)) \
        / jnp.maximum(ipr_len * n_dot_h * jnp.abs(jnp.sin(psi)), _EPS)
    fc = alpha + _von_mises(-jnp.sum(om_i * om_r, axis=-1), beta)
    att = _seeliger(jnp.sum(n * om_i, axis=-1), jnp.sum(n * om_r, axis=-1))
    fs = gv * fc * att * 2.0 * w * umax

    delta_x = w * h_width
    x_of_u = jnp.clip(v_of_u * w / jnp.pi,
                      0.5 * (delta_x - w), 0.5 * (w - delta_x))
    in_hl = jnp.abs(x_of_u - v * w / jnp.pi) < 0.5 * delta_x
    valid = ((jnp.abs(d) < 1.0) & (jnp.abs(v_of_u) < jnp.pi / 2) & in_hl
             & (w * jnp.sin(umax) < l) & (kappa >= -1.0))
    return jnp.where(valid, fs / jnp.maximum(delta_x, _EPS), 0.0)


def _eval_arrays(grids, yarns, meta, idx, rep_u, rep_v, uv, wi, wo,
                 initialization: bool = False):
    """Specular+diffuse eval over a wavefront. Returns f·cosθo [N, 3]
    (or the raw unnormalized integrand [N] when initialization=True)."""
    mrow = meta[idx]                                   # [N, 16]
    alpha, beta, ss, h_width = (mrow[..., 0], mrow[..., 1],
                                mrow[..., 2], mrow[..., 3])
    warp_area, weft_area = mrow[..., 4], mrow[..., 5]
    tw, th = mrow[..., 6], mrow[..., 7]
    fineness, period = mrow[..., 12], mrow[..., 13]
    spec_norm = mrow[..., 14]

    u_t = uv[..., 0] * rep_u
    v_t = (1.0 - uv[..., 1]) * rep_v
    xy_x = u_t * tw
    xy_y = v_t * th
    lx = jnp.mod(jnp.floor(xy_x), jnp.maximum(tw, 1.0)).astype(jnp.int32)
    ly = jnp.mod(jnp.floor(xy_y), jnp.maximum(th, 1.0)).astype(jnp.int32)
    cell = lx + ly * tw.astype(jnp.int32)
    yid = grids[idx, jnp.clip(cell, 0, grids.shape[1] - 1)]
    yr = yarns[idx, yid]                               # [N, 14]
    ytype = yr[..., 0]
    psi, umax0, kappa = yr[..., 1], yr[..., 2], yr[..., 3]
    w_, l_ = yr[..., 4], yr[..., 5]
    center_u, center_v = yr[..., 6], yr[..., 7]
    kd, ks = yr[..., 8:11], yr[..., 11:14]

    center_x = jnp.floor(xy_x / jnp.maximum(tw, 1.0)) * tw + center_u * tw
    center_y = jnp.floor(xy_y / jnp.maximum(th, 1.0)) * th \
        + (1.0 - center_v) * th
    x = xy_x - center_x
    y = -(xy_y - center_y)

    is_weft = ytype > 0.5
    # weft: rotate local frame and directions by pi/2 about z
    xr = jnp.where(is_weft, -y, x)
    yr_ = jnp.where(is_weft, x, y)

    def rot(v):
        vx = jnp.where(is_weft, -v[..., 1], v[..., 0])
        vy = jnp.where(is_weft, v[..., 0], v[..., 1])
        return jnp.stack([vx, vy, v[..., 2]], axis=-1)

    om_i = rot(wi)
    om_r = rot(wo)

    d_umax_d_warp = jnp.where(is_weft, mrow[..., 10], mrow[..., 8])
    d_umax_d_weft = jnp.where(is_weft, mrow[..., 11], mrow[..., 9])

    # correlated per-segment noise (irawan.cpp:256-275)
    pos_x = center_x.astype(jnp.uint32)
    pos_y = center_y.astype(jnp.uint32)
    t1 = _sample_tea_f32(pos_x, 2 * pos_y)
    t2 = _sample_tea_f32(pos_x, 2 * pos_y + jnp.uint32(1))
    n1 = perlin(jnp.stack(
        [(center_x * (th * rep_v + t1) + center_y)
         / jnp.maximum(period, _EPS),
         jnp.zeros_like(center_x), jnp.zeros_like(center_x)], axis=-1))
    n2 = perlin(jnp.stack(
        [(center_y * (tw * rep_u + t2) + center_x)
         / jnp.maximum(period, _EPS),
         jnp.zeros_like(center_x), jnp.zeros_like(center_x)], axis=-1))
    umax = jnp.where(period > 0,
                     umax0 + n1 * d_umax_d_warp + n2 * d_umax_d_weft,
                     umax0)

    u = yr_ / jnp.maximum(l_ / 2.0, _EPS) * umax
    v = xr * jnp.pi / jnp.maximum(w_, _EPS)

    f_fil = _filament_integrand(u, v, om_i, om_r, alpha, beta, ss, umax,
                                kappa, w_, l_, h_width)
    f_sta = _staple_integrand(u, v, om_i, om_r, alpha, beta, psi, umax,
                              kappa, w_, l_, h_width)
    integrand = jnp.where(jnp.abs(psi) > _EPS, f_sta, f_fil)

    # per-fiber intensity variation (irawan.cpp:295-303)
    i1 = ((center_x + xr) * fineness).astype(jnp.uint32)
    i2 = ((center_y + yr_) * fineness).astype(jnp.uint32)
    xi = _sample_tea_f32(i1, i2)
    iv = jnp.where(fineness > 0,
                   jnp.minimum(-jnp.log(jnp.maximum(xi, 1e-7)), 10.0), 1.0)

    area_scale = jnp.where(
        is_weft,
        (warp_area + weft_area) / jnp.maximum(weft_area, _EPS),
        (warp_area + weft_area) / jnp.maximum(warp_area, _EPS))

    cos_i = wi[..., 2]
    cos_o = wo[..., 2]
    front = (cos_i > 0) & (cos_o > 0)

    if initialization:
        # the bootstrap sums eval/cosθo (irawan.cpp:162) → no cosine here
        return jnp.where(front, iv * integrand, 0.0)

    spec = ks * (iv * integrand * spec_norm * area_scale)[..., None]
    f = (spec + kd * INV_PI) * cos_o[..., None]
    return jnp.where(front[..., None], f, 0.0)


# ---------------------------------------------------------------------------
# BSDF family entry points (wired into bsdf.py dispatch tables)
# params: [0] pool index, [1] repeatU, [2] repeatV, [22:24] uv
# ---------------------------------------------------------------------------

def irawan_eval(p, wi, wo):
    grids, yarns, meta = get_pool()
    if grids is None:
        return jnp.zeros(wi.shape[:-1] + (3,))
    idx = jnp.clip(p[..., 0].astype(jnp.int32), 0, grids.shape[0] - 1)
    return _eval_arrays(grids, yarns, meta, idx, p[..., 1], p[..., 2],
                        p[..., 22:24], wi, wo)


def irawan_pdf(p, wi, wo):
    front = (wi[..., 2] > 0) & (wo[..., 2] > 0)
    return jnp.where(front, jnp.abs(wo[..., 2]) * INV_PI, 0.0)


def irawan_sample(p, wi, u2, u1):
    wo = square_to_cosine_hemisphere(u2)
    pdf = irawan_pdf(p, wi, wo)
    f = irawan_eval(p, wi, wo)
    w = jnp.where(pdf[..., None] > 1e-9,
                  f / jnp.maximum(pdf, 1e-9)[..., None], 0.0)
    return (wo, w, pdf, jnp.zeros(wi.shape[:-1], bool),
            jnp.ones(wi.shape[:-1]))
