"""Compiled scene representation: flat, device-resident structure-of-arrays.

This is the wavefront inversion of the reference's ref-counted object graph
rooted at Scene (ref: include/mitsuba/render/scene.h:49): scene compilation
(builder.py) bakes every shape into a world-space triangle soup, every BSDF
into a row of a parameter table, every emitter into a row of emitter tables,
and precomputes the Woop affine transforms that make ray-triangle
intersection a pair of matmuls (or the fused trace kernel, accel/pallas_trace.py) (accel/dense.py). The whole scene is a
pytree — it flows through jit/pjit/shard_map and is replicated (or sharded)
with jax.sharding like any other array data (SURVEY.md §2.5 "read-only
shared state").
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..core.distribution import Discrete1D

# Material type codes (bsdf dispatch table, ref: EBSDFType bsdf.h:233)
MAT_DIFFUSE = 0
MAT_CONDUCTOR = 1
MAT_ROUGH_CONDUCTOR = 2
MAT_DIELECTRIC = 3
MAT_PLASTIC = 4
MAT_ROUGH_DIELECTRIC = 5
MAT_ROUGH_PLASTIC = 6
MAT_PHONG = 7
MAT_WARD = 8
MAT_ROUGH_DIFFUSE = 9
MAT_NULL = 10
MAT_THIN_DIELECTRIC = 11
MAT_DIFFTRANS = 12        # diffuse transmitter (ref: src/bsdfs/difftrans.cpp)
MAT_MIXTURE = 13          # mixture/blend/mask adapter (mixturebsdf.cpp,
#                           blendbsdf.cpp, mask.cpp — compiled to one code)
MAT_COATING = 14          # smooth dielectric coat over a nested BSDF
MAT_HK = 15               # Hanrahan-Krueger thin slab (src/bsdfs/hk.cpp)
MAT_TABULATED = 16        # winmad tabulated BSDF (tabulated_bsdf.cpp:16)
#                           (ref: src/bsdfs/coating.cpp)
MAT_ROUGH_COATING = 17    # microfacet-rough dielectric layer over a nested
                          # BSDF (ref: src/bsdfs/roughcoating.cpp)
MAT_IRAWAN = 18           # Irawan-Marschner woven cloth
                          # (ref: src/bsdfs/irawan.{h,cpp})
MAT_ANISO_ROUGHDIFFUSE = 19   # LEADR anisotropic rough diffuse from slope
                          # moments (ref: src/bsdfs/aniso_roughdiffuse.cpp)
N_MAT_TYPES = 20

# Emitter type codes (ref: EEmitterType emitter.h:76)
EM_AREA = 0
EM_POINT = 1
EM_CONSTANT = 2
EM_ENVMAP = 3
EM_DIRECTIONAL = 4
EM_SPOT = 5

# Material parameter-table layout: mat_params[M, 16]
# diffuse:          [0:3] albedo rgb
# conductor:        [0:3] eta, [3:6] k, [6:9] specular reflectance
# rough_conductor:  as conductor + [9] alpha_u [10] alpha_v [11] dist_type
# dielectric:       [0] int_ior/ext_ior ratio eta, [1:4] spec refl, [4:7] spec trans
# plastic:          [0] eta, [1:4] diffuse refl, [4:7] spec refl, [7] nonlinear
# rough_dielectric: [0] eta, [1:4] spec refl, [4:7] spec trans, [9] alpha_u
#                   [10] alpha_v [11] dist_type
# rough_plastic:    like plastic + [9] alpha [11] dist_type
# phong:            [0:3] diffuse refl, [3:6] spec refl, [6] exponent
# ward:             [0:3] diffuse refl, [3:6] spec refl, [9] alpha_u [10] alpha_v
# rough_diffuse:    [0:3] albedo, [9] alpha
# difftrans:        [0:3] transmittance
# mixture:          [18] child-A row id, [19] child-B row id, [20] weight
#                   of child A, [21] weight-texture id (-1 const; mask =
#                   mixture(child, null) with opacity as the weight;
#                   blend = texture-driven weight)
# coating:          [0] eta ratio, [1:4] sigmaA·thickness, [4] coat
#                   specular-reflectance scale, [18] nested child row id
# rough_coating:    as coating + [9] alpha, [11] dist type
# irawan:           [0] weave-pattern pool index (bsdf/irawan_pool.py),
#                   [1] repeatU, [2] repeatV, [22:24] uv (written per-lane
#                   by resolve_material — the weave eval is uv-driven)
# all:              [12] type code, [13] albedo-tex id, [14] roughness-tex id
#                   [15] two-sided flag, [16] normal/bump-map tex id,
#                   [17] bump scale (0 ⇒ slot 16 is a tangent-space normal
#                   map; >0 ⇒ height bump map with that scale)
#                   (packed so one row gather fetches the whole material)
N_MAT_PARAMS = 24

# mat_tex[M, 2]: texture slot per textured parameter (-1 = constant)
# slot 0: albedo / diffuse reflectance texture id
# slot 1: roughness texture id
N_MAT_TEX = 2


class Intersection(NamedTuple):
    """Wavefront hit record — SoA analog of the reference's Intersection
    (ref: include/mitsuba/render/shape.h:36). All fields [N, ...]."""
    valid: jnp.ndarray      # [N] bool
    t: jnp.ndarray          # [N] hit distance
    p: jnp.ndarray          # [N, 3] hit position (world)
    ng: jnp.ndarray         # [N, 3] geometric normal
    ns: jnp.ndarray         # [N, 3] interpolated shading normal
    uv: jnp.ndarray         # [N, 2]
    tri_id: jnp.ndarray     # [N] int32
    mat_id: jnp.ndarray     # [N] int32
    em_id: jnp.ndarray      # [N] int32 (-1 = not an emitter)


class SceneData(NamedTuple):
    """The compiled scene. T triangles, M materials, E emitters, ET emissive
    triangles. Triangle soup is padded to a multiple of the intersection
    cluster size with degenerate far-away triangles."""
    # -- geometry --------------------------------------------------------
    p0: jnp.ndarray         # [T, 3]
    e1: jnp.ndarray         # [T, 3] p1 - p0
    e2: jnp.ndarray         # [T, 3] p2 - p0
    ng: jnp.ndarray         # [T, 3] unit geometric normal
    vn: jnp.ndarray         # [T, 3, 3] per-corner shading normals
    vuv: jnp.ndarray        # [T, 3, 2] per-corner uvs
    tri_mat: jnp.ndarray    # [T] int32 material id
    tri_em: jnp.ndarray     # [T] int32 emitter id (-1 none)
    tri_area: jnp.ndarray   # [T]
    # -- Woop-packed intersection transforms (accel/dense.py) ------------
    woop_o: jnp.ndarray     # [4, 3T] origin transform (affine, homogeneous)
    woop_d: jnp.ndarray     # [3, 3T] direction transform (linear)
    # trace-kernel layout of the real triangles (accel/pallas_trace.py
    # build_trace_tables): Woop rows [12, C·TC] and cluster AABBs [8, C]
    trace_woop: jnp.ndarray
    trace_box: jnp.ndarray
    # packed per-triangle attribute rows for single-gather hit records:
    # [T, 24] = ng(0:3) vn(3:12) vuv(12:18) mat(18) em(19) pad(20:24)
    tri_attr: jnp.ndarray
    # -- materials -------------------------------------------------------
    mat_type: jnp.ndarray   # [M] int32
    mat_params: jnp.ndarray  # [M, N_MAT_PARAMS]
    mat_tex: jnp.ndarray    # [M, N_MAT_TEX] int32
    # -- emitters --------------------------------------------------------
    em_type: jnp.ndarray     # [E] int32
    em_radiance: jnp.ndarray  # [E, 3] radiance (area/env) or intensity (point)
    em_pos: jnp.ndarray      # [E, 3] position (point) / direction (directional)
    em_area: jnp.ndarray     # [E] total surface area of area emitters
    em_pmf: Discrete1D       # emitter-selection distribution (scene.cpp:378)
    em_tri_offset: jnp.ndarray  # [E+1] int32 segment offsets into em_tris
    em_tris: jnp.ndarray     # [ET] int32 global triangle ids
    em_tri_cdfg: jnp.ndarray  # [ET] "globalized" cdf: emitter_index + within-cdf
    em_tri_data: jnp.ndarray  # [max(ET,1), 12] packed p0|e1|e2|ng rows
    em_aux: jnp.ndarray      # [E, 8] per-type extras (spot: dir,cosCut,cosBeam)
    # -- textures (atlas of mip pyramids; texture/texture.py) -------------
    tex_data: jnp.ndarray    # [TEXELS, 3] flattened texel pool (all mips)
    tex_meta: jnp.ndarray    # [NTEX, 8] int32: offset,w,h,n_mips,wrap,filter,...
    # -- environment -----------------------------------------------------
    env_id: jnp.ndarray      # scalar int32: emitter id of env light (-1 none)
    env_img: jnp.ndarray     # [H, W, 3] lat-long radiance (1x1 dummy if none)
    env_row_cdf: jnp.ndarray  # [H+1] marginal row CDF (envmap.cpp:99-106)
    env_col_cdf: jnp.ndarray  # [H, W+1] per-row column CDFs
    env_density: jnp.ndarray  # [H, W] pdf over the unit square
    # -- media (homogeneous; media/homogeneous.py) -----------------------
    med_sigma_t: jnp.ndarray  # [1, 3] extinction of the (single) global medium
    med_albedo: jnp.ndarray   # [1, 3] single-scattering albedo
    med_g: jnp.ndarray        # [1] HG asymmetry
    med_bound: jnp.ndarray    # [1] medium extent along rays (vacuum beyond)
    has_medium: jnp.ndarray   # scalar bool
    # heterogeneous density grid (media/heterogeneous.py); 1³ dummy if none
    med_grid: jnp.ndarray       # [Z, Y, X] density
    med_grid_min: jnp.ndarray   # [3] world bbox min
    med_grid_extent: jnp.ndarray  # [3] world bbox extent
    med_majorant: jnp.ndarray   # scalar: max density · σ_scale
    # SGGX microflake medium (winmad heterogeneous2/3): packed S matrix
    # [Sxx,Syy,Szz,Sxy,Sxz,Syz]; zeros ⇒ isotropic medium (disabled)
    med_sggx: jnp.ndarray = None
    # Gaussian-fiber microflake orientation [3] (ref: src/phase/
    # microflake.cpp); zeros ⇒ no fiber medium
    med_fiber: jnp.ndarray = None
    # envmap Walker alias table over the H·W texel distribution
    # (emitter/envmap.py): O(1) texel pick — 1 packed row gather —
    # replacing the O(W) per-lane column-CDF scan. None ⇒ CDF path.
    env_alias: jnp.ndarray = None      # [H*W, 2]: accept prob, alias id

    @property
    def n_tris(self):
        return self.p0.shape[0]

    @property
    def n_emitters(self):
        return self.em_type.shape[0]
