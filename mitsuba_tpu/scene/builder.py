"""Scene builder: declarative Python scene description → compiled SceneData.

This is the analog of the reference's XML→Properties→PluginManager pipeline
(ref: src/librender/scenehandler.cpp:712-770 + Scene::initialize): users
describe shapes/materials/emitters with small dataclasses, and `compile_scene`
bakes everything into the flat arrays of SceneData — world-space triangle
soup, Woop transforms, material/emitter tables, CDFs. All transform work is
host-side float64; device arrays are float32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..accel.dense import build_woop
from ..core import transform as tf
from ..core.distribution import Discrete1D
from . import scene as S
from .shapes import Mesh

# ---------------------------------------------------------------------------
# Declarative description (the "Properties" layer, ref: properties.h:46)
# ---------------------------------------------------------------------------


@dataclass
class Material:
    """BSDF description. `kind` selects the lobe family (ref plugin names,
    src/bsdfs/); parameters mirror each plugin's Properties defaults."""
    kind: str = "diffuse"
    albedo: Sequence[float] = (0.5, 0.5, 0.5)       # diffuse/roughdiffuse
    eta: Sequence[float] | float = (0.2004, 0.9240, 1.1022)  # conductor (Cu) / ior
    k: Sequence[float] = (3.9129, 2.4528, 2.1421)
    specular_reflectance: Sequence[float] = (1.0, 1.0, 1.0)
    specular_transmittance: Sequence[float] = (1.0, 1.0, 1.0)
    diffuse_reflectance: Sequence[float] = (0.5, 0.5, 0.5)
    alpha: float = 0.1
    alpha_v: Optional[float] = None
    distribution: str = "ggx"                         # "beckmann"|"ggx"
    int_ior: float = 1.5046                           # dielectric (BK7)
    ext_ior: float = 1.000277                         # air
    exponent: float = 30.0                            # phong
    nonlinear: bool = False                           # plastic
    albedo_texture: int = -1                          # texture slot id
    roughness_texture: int = -1
    two_sided: bool = False                           # twosided adapter
    normal_texture: int = -1                          # normalmap/bumpmap
    bump_scale: float = 0.0                           # >0 ⇒ bumpmap mode
    # composite adapters (mixture/blend/mask/coating):
    child_a: int = -1            # material index of nested child A
    child_b: int = -1            # material index of nested child B
    weight: float = 0.5          # mixture weight of child A / mask opacity
    weight_texture: int = -1     # blendbsdf weight / mask opacity texture
    transmittance: Sequence[float] = (0.5, 0.5, 0.5)  # difftrans
    sigma_a: Sequence[float] = (0.0, 0.0, 0.0)        # coating / hk absorption
    thickness: float = 1.0                            # coating / hk slab depth
    sigma_s: Sequence[float] = (1.0, 1.0, 1.0)        # hk scattering
    g: float = 0.0                                    # hk phase asymmetry
    table_id: int = 0                                 # tabulated BSDF index
    table_scale: float = 1.0
    repeat_u: float = 1.0                             # irawan weave tiling
    repeat_v: float = 1.0
    moments0: Sequence[float] = (0.0, 0.0)   # aniso_roughdiffuse: mean
    #   slope (E[x], E[y]) of the LEADR Gaussian slope distribution
    moments1: Sequence[float] = (0.5, 0.5, 0.0)  # (E[x²], E[y²], E[xy])
    sample_visibility: bool = True           # Smith G2 shadowing on/off

    _KINDS = {
        "diffuse": S.MAT_DIFFUSE, "conductor": S.MAT_CONDUCTOR,
        "roughconductor": S.MAT_ROUGH_CONDUCTOR,
        "dielectric": S.MAT_DIELECTRIC, "plastic": S.MAT_PLASTIC,
        "roughdielectric": S.MAT_ROUGH_DIELECTRIC,
        "roughplastic": S.MAT_ROUGH_PLASTIC, "phong": S.MAT_PHONG,
        "ward": S.MAT_WARD, "roughdiffuse": S.MAT_ROUGH_DIFFUSE,
        "null": S.MAT_NULL, "thindielectric": S.MAT_THIN_DIELECTRIC,
        "difftrans": S.MAT_DIFFTRANS,
        "mixturebsdf": S.MAT_MIXTURE, "blendbsdf": S.MAT_MIXTURE,
        "mask": S.MAT_MIXTURE, "coating": S.MAT_COATING,
        "hk": S.MAT_HK, "tabulated": S.MAT_TABULATED,
        "roughcoating": S.MAT_ROUGH_COATING,
        "irawan": S.MAT_IRAWAN,
        "aniso_roughdiffuse": S.MAT_ANISO_ROUGHDIFFUSE,
    }

    def compile(self):
        code = self._KINDS[self.kind]
        p = np.zeros(S.N_MAT_PARAMS, np.float32)
        dist = 1.0 if self.distribution == "ggx" else 0.0
        av = self.alpha if self.alpha_v is None else self.alpha_v
        if code in (S.MAT_DIFFUSE, S.MAT_ROUGH_DIFFUSE):
            p[0:3] = self.albedo
            p[9] = self.alpha
        elif code in (S.MAT_CONDUCTOR, S.MAT_ROUGH_CONDUCTOR):
            eta = self.eta if not np.isscalar(self.eta) else [self.eta] * 3
            p[0:3] = eta
            p[3:6] = self.k
            p[6:9] = self.specular_reflectance
            p[9], p[10], p[11] = self.alpha, av, dist
        elif code in (S.MAT_DIELECTRIC, S.MAT_ROUGH_DIELECTRIC,
                      S.MAT_THIN_DIELECTRIC):
            p[0] = self.int_ior / self.ext_ior
            p[1:4] = self.specular_reflectance
            p[4:7] = self.specular_transmittance
            p[9], p[10], p[11] = self.alpha, av, dist
        elif code in (S.MAT_PLASTIC, S.MAT_ROUGH_PLASTIC):
            p[0] = self.int_ior / self.ext_ior
            p[1:4] = self.diffuse_reflectance
            p[4:7] = self.specular_reflectance
            p[7] = float(self.nonlinear)
            p[9], p[10], p[11] = self.alpha, av, dist
        elif code == S.MAT_PHONG:
            p[0:3] = self.diffuse_reflectance
            p[3:6] = self.specular_reflectance
            p[6] = self.exponent
        elif code == S.MAT_WARD:
            p[0:3] = self.diffuse_reflectance
            p[3:6] = self.specular_reflectance
            p[9], p[10] = self.alpha, av
        elif code == S.MAT_DIFFTRANS:
            p[0:3] = self.transmittance
        elif code == S.MAT_MIXTURE:
            if self.kind == "mask":
                # mask = mixture(child, null) with opacity weight
                # (ref: src/bsdfs/mask.cpp); the null child row id is
                # patched in by compile_scene
                p[18], p[19] = float(self.child_a), -2.0
                p[20] = self.weight          # opacity
            else:
                p[18], p[19] = float(self.child_a), float(self.child_b)
                p[20] = self.weight
            p[21] = float(self.weight_texture)
        elif code in (S.MAT_COATING, S.MAT_ROUGH_COATING):
            p[0] = self.int_ior / self.ext_ior
            p[1:4] = np.asarray(self.sigma_a, np.float64) * self.thickness
            p[4] = 1.0
            p[9], p[11] = self.alpha, dist
            p[18] = float(self.child_a)
        elif code == S.MAT_IRAWAN:
            p[0] = float(self.table_id)      # weave-pattern pool index
            p[1] = self.repeat_u
            p[2] = self.repeat_v
        elif code == S.MAT_HK:
            p[0:3] = self.sigma_s
            p[3:6] = self.sigma_a
            p[6] = self.g
            p[7] = self.thickness
        elif code == S.MAT_TABULATED:
            p[0] = float(self.table_id)
            p[1] = self.table_scale
        elif code == S.MAT_ANISO_ROUGHDIFFUSE:
            p[0:3] = self.albedo
            p[3:5] = self.moments0
            p[5:8] = self.moments1
            p[11] = float(self.sample_visibility)
        tex = np.array([self.albedo_texture, self.roughness_texture],
                       np.int32)
        # dispatch metadata packed into the row (scene.py layout)
        p[12] = float(code)
        p[13], p[14] = float(tex[0]), float(tex[1])
        p[15] = float(self.two_sided)
        p[16] = float(self.normal_texture)
        p[17] = float(self.bump_scale)
        return code, p, tex


@dataclass
class ShapeInstance:
    """A mesh placed in the world with a material and optional emission —
    subsumes the reference's shape + (bsdf, area-emitter) children."""
    mesh: Mesh
    to_world: np.ndarray = field(default_factory=tf.identity)
    material: int = 0                      # index into scene materials list
    radiance: Optional[Sequence[float]] = None  # area emitter if set
    sampling_weight: float = 1.0
    flip_normals: bool = False


@dataclass
class PointLight:
    position: Sequence[float]
    intensity: Sequence[float]
    sampling_weight: float = 1.0


@dataclass
class SpotLight:
    """Spot emitter (ref: src/emitters/spot.cpp): linear angular falloff
    between beam_width and cutoff_angle (degrees)."""
    position: Sequence[float]
    direction: Sequence[float]
    intensity: Sequence[float]
    cutoff_angle: float = 20.0
    beam_width: float = 15.0      # defaults: cutoff*3/4 in the reference
    sampling_weight: float = 1.0


@dataclass
class CollimatedLight:
    """Collimated beam emitter (ref: src/emitters/collimated.cpp — a
    zero-radius parallel beam carrying `power` watts). Compiled as a
    sub-degree spot from the beam origin (half-angle 0.25°): the
    delta-delta beam only matters inside participating media, where the
    narrow cone is an accurate, samplable stand-in."""
    position: Sequence[float]
    direction: Sequence[float]
    power: Sequence[float] = (1.0, 1.0, 1.0)
    sampling_weight: float = 1.0


@dataclass
class DirectionalLight:
    """Delta directional emitter (ref: src/emitters/directional.cpp).
    direction = direction light TRAVELS; irradiance in W/m²."""
    direction: Sequence[float]
    irradiance: Sequence[float]
    sampling_weight: float = 1.0


@dataclass
class ConstantLight:
    """Constant environment emitter (ref: src/emitters/constant.cpp)."""
    radiance: Sequence[float]
    sampling_weight: float = 1.0


@dataclass
class EnvmapLight:
    """Image-based lat-long environment emitter (ref: src/emitters/
    envmap.cpp). image: [H, W, 3] HDR numpy array."""
    image: np.ndarray = None
    scale: float = 1.0
    sampling_weight: float = 1.0


@dataclass
class Medium:
    """Single global homogeneous medium (ref: src/medium/homogeneous.cpp).
    `bound` = medium extent along any ray (vacuum beyond); stands in for
    the reference's shape-attached medium boundaries."""
    sigma_t: Sequence[float] = (1.0, 1.0, 1.0)
    albedo: Sequence[float] = (0.5, 0.5, 0.5)
    g: float = 0.0
    bound: float = 1e30
    # heterogeneous: density grid [Z, Y, X] scaling sigma_t, with world bbox
    density_grid: np.ndarray = None
    grid_min: Sequence[float] = (0.0, 0.0, 0.0)
    grid_max: Sequence[float] = (1.0, 1.0, 1.0)
    # SGGX microflake S-matrix [Sxx,Syy,Szz,Sxy,Sxz,Syz] (winmad
    # anisotropic media, heterogeneous2/3 + SGGX phase); None = isotropic
    sggx_s: Sequence[float] = None
    # Gaussian-fiber microflake orientation (src/phase/microflake.cpp);
    # None = no fiber phase. Use HeteroVolPathTracer(fiber=True,
    # fiber_stddev=...) to enable.
    fiber_orientation: Sequence[float] = None


@dataclass
class SceneDesc:
    materials: list = field(default_factory=list)
    shapes: list = field(default_factory=list)
    point_lights: list = field(default_factory=list)
    spot_lights: list = field(default_factory=list)
    collimated_lights: list = field(default_factory=list)
    directional_lights: list = field(default_factory=list)
    constant_light: Optional[ConstantLight] = None
    envmap: Optional[EnvmapLight] = None
    medium: Optional[Medium] = None
    textures: list = field(default_factory=list)   # numpy [H, W, 3] images
    bsdf_tables: list = field(default_factory=list)  # [n_ti,n_to,n_phi,3]
    weave_patterns: list = field(default_factory=list)  # irawan WeavePattern

    def add_weave_pattern(self, pattern) -> int:
        """Register an irawan weave pattern; returns its pool index for
        Material(kind='irawan', table_id=...)."""
        self.weave_patterns.append(pattern)
        return len(self.weave_patterns) - 1

    def add_material(self, **kw) -> int:
        self.materials.append(Material(**kw))
        return len(self.materials) - 1

    def add_texture(self, image) -> int:
        """Register a bitmap texture; returns its id for Material
        albedo_texture/roughness_texture slots."""
        self.textures.append(np.asarray(image, np.float32))
        return len(self.textures) - 1

    def add_shape(self, mesh, to_world=None, material=0, radiance=None,
                  sampling_weight=1.0, flip_normals=False):
        self.shapes.append(ShapeInstance(
            mesh, tf.identity() if to_world is None else to_world,
            material, radiance, sampling_weight, flip_normals))
        return len(self.shapes) - 1


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def _spread3(x):
    """Spread the low 10 bits of x to every 3rd bit (Morton interleave)."""
    x = x.astype(np.uint64)
    x = (x | (x << 16)) & np.uint64(0x030000FF)
    x = (x | (x << 8)) & np.uint64(0x0300F00F)
    x = (x | (x << 4)) & np.uint64(0x030C30C3)
    x = (x | (x << 2)) & np.uint64(0x09249249)
    return x


def morton_order(p0, e1, e2) -> np.ndarray:
    """Stable permutation sorting triangles along a 30-bit Morton curve
    of their centroids. Consecutive tc-sized trace clusters then cover
    spatially compact regions, which is what makes the trace kernel's
    per-cluster AABB culling (accel/pallas_trace.py) effective — the
    LBVH-style leaf ordering of SURVEY §7, without interior pointer
    nodes."""
    c = np.asarray(p0, np.float64) + (np.asarray(e1, np.float64)
                                      + np.asarray(e2, np.float64)) / 3.0
    lo = c.min(0)
    ext = np.maximum(c.max(0) - lo, 1e-30)
    q = np.minimum(((c - lo) / ext * 1023.0), 1023.0).astype(np.uint64)
    code = (_spread3(q[:, 0]) | (_spread3(q[:, 1]) << np.uint64(1))
            | (_spread3(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def compile_scene(desc: SceneDesc, cluster_size: int = 512) -> S.SceneData:
    """Bake the description into SceneData. Triangle count is padded to a
    multiple of `cluster_size` (degenerate tris never hit)."""
    if not desc.materials:
        desc.materials.append(Material())

    p0s, e1s, e2s, ngs, vns, vuvs = [], [], [], [], [], []
    tri_mats, tri_ems, tri_areas = [], [], []
    emitters = []   # list of dicts
    em_tri_lists = []

    for shape in desc.shapes:
        mesh = shape.mesh
        v = tf.apply_point(shape.to_world, mesh.vertices)
        f = mesh.faces
        p0 = v[f[:, 0]]
        p1 = v[f[:, 1]]
        p2 = v[f[:, 2]]
        e1 = p1 - p0
        e2 = p2 - p0
        ng = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(ng, axis=-1)
        ngn = ng / np.maximum(np.linalg.norm(ng, axis=-1, keepdims=True),
                              1e-20)
        if shape.flip_normals:
            ngn = -ngn
        if mesh.normals is not None:
            n_w = tf.apply_normal(shape.to_world, mesh.normals)
            n_w = n_w / np.maximum(
                np.linalg.norm(n_w, axis=-1, keepdims=True), 1e-20)
            if shape.flip_normals:
                n_w = -n_w
            vn = np.stack([n_w[f[:, k]] for k in range(3)], axis=1)
        else:
            vn = np.repeat(ngn[:, None, :], 3, axis=1)
        if mesh.uvs is not None:
            vuv = np.stack([mesh.uvs[f[:, k]] for k in range(3)], axis=1)
        else:
            vuv = np.zeros((len(f), 3, 2))

        base = sum(len(x) for x in p0s)
        tri_idx = np.arange(base, base + len(f))

        em_id = -1
        if shape.radiance is not None:
            em_id = len(emitters)
            emitters.append({
                "type": S.EM_AREA,
                "radiance": np.asarray(shape.radiance, np.float64),
                "pos": np.zeros(3),
                "area": float(area.sum()),
                "weight": shape.sampling_weight,
            })
            em_tri_lists.append((tri_idx, area))

        p0s.append(p0); e1s.append(e1); e2s.append(e2); ngs.append(ngn)
        vns.append(vn); vuvs.append(vuv)
        tri_mats.append(np.full(len(f), shape.material, np.int32))
        tri_ems.append(np.full(len(f), em_id, np.int32))
        tri_areas.append(area)

    if p0s:
        p0 = np.concatenate(p0s)
        e1 = np.concatenate(e1s)
        e2 = np.concatenate(e2s)
        ng = np.concatenate(ngs)
        vn = np.concatenate(vns)
        vuv = np.concatenate(vuvs)
        tri_mat = np.concatenate(tri_mats)
        tri_em = np.concatenate(tri_ems)
        tri_area = np.concatenate(tri_areas)
    else:
        p0 = np.zeros((0, 3)); e1 = np.zeros((0, 3)); e2 = np.zeros((0, 3))
        ng = np.zeros((0, 3)); vn = np.zeros((0, 3, 3))
        vuv = np.zeros((0, 3, 2))
        tri_mat = np.zeros(0, np.int32); tri_em = np.zeros(0, np.int32)
        tri_area = np.zeros(0)

    # Spatial (Morton) triangle order so trace clusters are compact —
    # small scenes keep author order (fixture stability; culling is
    # irrelevant at that size anyway)
    if len(p0) > 256:
        order = morton_order(p0, e1, e2)
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        p0, e1, e2, ng = p0[order], e1[order], e2[order], ng[order]
        vn, vuv = vn[order], vuv[order]
        tri_mat, tri_em = tri_mat[order], tri_em[order]
        tri_area = tri_area[order]
        em_tri_lists = [(inv[t], a) for t, a in em_tri_lists]

    # Pad triangle soup to cluster multiple with degenerate triangles
    n_tris = len(p0)
    padded = max(cluster_size, -(-max(n_tris, 1) // cluster_size)
                 * cluster_size)
    pad = padded - n_tris
    if pad:
        p0 = np.concatenate([p0, np.full((pad, 3), 1e30)])
        e1 = np.concatenate([e1, np.zeros((pad, 3))])
        e2 = np.concatenate([e2, np.zeros((pad, 3))])
        ng = np.concatenate([ng, np.tile([0.0, 0.0, 1.0], (pad, 1))])
        vn = np.concatenate([vn, np.tile([0.0, 0.0, 1.0], (pad, 3, 1))])
        vuv = np.concatenate([vuv, np.zeros((pad, 3, 2))])
        tri_mat = np.concatenate([tri_mat, np.zeros(pad, np.int32)])
        tri_em = np.concatenate([tri_em, np.full(pad, -1, np.int32)])
        tri_area = np.concatenate([tri_area, np.zeros(pad)])

    woop_o, woop_d = build_woop(p0, e1, e2)
    # kernel layout over REAL triangles only (the far-away pads would
    # inflate the last cluster's bound into uselessness)
    from ..accel.pallas_trace import build_trace_tables
    trace_woop, trace_box = build_trace_tables(woop_o, p0, e1, e2, n_tris)

    # packed attribute rows: one gather fetches the whole hit record
    n_tp = len(p0)
    tri_attr = np.zeros((n_tp, 24), np.float32)
    tri_attr[:, 0:3] = ng
    tri_attr[:, 3:12] = vn.reshape(n_tp, 9)
    tri_attr[:, 12:18] = vuv.reshape(n_tp, 6)
    tri_attr[:, 18] = tri_mat.astype(np.float32)
    tri_attr[:, 19] = tri_em.astype(np.float32)

    # Non-area emitters
    env_id = -1
    for pl in desc.point_lights:
        emitters.append({
            "type": S.EM_POINT,
            "radiance": np.asarray(pl.intensity, np.float64),
            "pos": np.asarray(pl.position, np.float64),
            "area": 0.0, "weight": pl.sampling_weight})
        em_tri_lists.append((np.zeros(0, np.int64), np.zeros(0)))
    for sl in desc.spot_lights:
        dirn = np.asarray(sl.direction, np.float64)
        dirn = dirn / np.linalg.norm(dirn)
        emitters.append({
            "type": S.EM_SPOT,
            "radiance": np.asarray(sl.intensity, np.float64),
            "pos": np.asarray(sl.position, np.float64),
            "area": 0.0, "weight": sl.sampling_weight,
            "aux": np.concatenate([
                dirn, [np.cos(np.radians(sl.cutoff_angle)),
                       np.cos(np.radians(sl.beam_width))],
                np.zeros(3)])})
        em_tri_lists.append((np.zeros(0, np.int64), np.zeros(0)))
    for cl in getattr(desc, "collimated_lights", []):
        dirn = np.asarray(cl.direction, np.float64)
        dirn = dirn / np.linalg.norm(dirn)
        half = np.radians(0.25)
        solid = 2.0 * np.pi * (1.0 - np.cos(half))
        intensity = np.asarray(cl.power, np.float64) / solid
        emitters.append({
            "type": S.EM_SPOT,
            "radiance": intensity,
            "pos": np.asarray(cl.position, np.float64),
            "area": 0.0, "weight": cl.sampling_weight,
            "aux": np.concatenate([
                dirn, [np.cos(half), np.cos(half * 0.9)], np.zeros(3)])})
        em_tri_lists.append((np.zeros(0, np.int64), np.zeros(0)))
    for dl in desc.directional_lights:
        dirn = np.asarray(dl.direction, np.float64)
        dirn = dirn / np.linalg.norm(dirn)
        emitters.append({
            "type": S.EM_DIRECTIONAL,
            "radiance": np.asarray(dl.irradiance, np.float64),
            "pos": dirn,
            "area": 0.0, "weight": dl.sampling_weight})
        em_tri_lists.append((np.zeros(0, np.int64), np.zeros(0)))
    if desc.constant_light is not None:
        env_id = len(emitters)
        emitters.append({
            "type": S.EM_CONSTANT,
            "radiance": np.asarray(desc.constant_light.radiance, np.float64),
            "pos": np.zeros(3), "area": 0.0,
            "weight": desc.constant_light.sampling_weight})
        em_tri_lists.append((np.zeros(0, np.int64), np.zeros(0)))
    env_tables = None
    if desc.envmap is not None:
        from ..emitter.envmap import build_env_tables
        env_id = len(emitters)
        emitters.append({
            "type": S.EM_ENVMAP,
            "radiance": np.full(3, desc.envmap.scale, np.float64),
            "pos": np.zeros(3), "area": 0.0,
            "weight": desc.envmap.sampling_weight})
        em_tri_lists.append((np.zeros(0, np.int64), np.zeros(0)))
        env_tables = build_env_tables(
            np.asarray(desc.envmap.image, np.float32) * desc.envmap.scale)

    n_em = len(emitters)
    if n_em:
        em_type = np.array([e["type"] for e in emitters], np.int32)
        em_rad = np.stack([e["radiance"] for e in emitters])
        em_pos = np.stack([e["pos"] for e in emitters])
        em_area = np.array([e["area"] for e in emitters])
        em_pmf = Discrete1D.build(np.array([e["weight"] for e in emitters]))
        em_aux = np.stack([e.get("aux", np.zeros(8)) for e in emitters])
        offs = [0]
        tris_flat, cdfg_flat = [], []
        for ei, (tris, areas) in enumerate(em_tri_lists):
            if len(tris):
                cdf = np.cumsum(areas) / areas.sum()
                cdf[-1] = 1.0
                tris_flat.append(tris)
                cdfg_flat.append(ei + cdf)
            offs.append(offs[-1] + len(tris))
        em_tri_offset = np.array(offs, np.int32)
        em_tris = (np.concatenate(tris_flat).astype(np.int32)
                   if tris_flat else np.zeros(0, np.int32))
        em_tri_cdfg = (np.concatenate(cdfg_flat).astype(np.float32)
                       if cdfg_flat else np.zeros(0, np.float32))
        if len(em_tris):
            em_tri_data = np.concatenate(
                [p0[em_tris], e1[em_tris], e2[em_tris], ng[em_tris]],
                axis=1).astype(np.float32)
        else:
            em_tri_data = np.zeros((1, 12), np.float32)
    else:
        em_type = np.zeros(0, np.int32)
        em_rad = np.zeros((0, 3))
        em_pos = np.zeros((0, 3))
        em_area = np.zeros(0)
        em_pmf = Discrete1D.build(np.ones(1))
        em_aux = np.zeros((0, 8))
        em_tri_offset = np.zeros(1, np.int32)
        em_tris = np.zeros(0, np.int32)
        em_tri_cdfg = np.zeros(0, np.float32)
        em_tri_data = np.zeros((1, 12), np.float32)

    # Materials — type/texture codes packed into param slots 12-14 so the
    # wavefront fetches one row per lane (bsdf.resolve_params)
    mat_type, mat_params, mat_tex = [], [], []
    for m in desc.materials:
        c, p, t = m.compile()
        mat_type.append(c); mat_params.append(p); mat_tex.append(t)
    # mask adapters reference an implicit null child (sentinel -2):
    # append one shared null row and patch the references
    if any(p[12] == S.MAT_MIXTURE and p[19] == -2.0 for p in mat_params):
        null_id = len(mat_params)
        c, p, t = Material(kind="null").compile()
        mat_type.append(c); mat_params.append(p); mat_tex.append(t)
        for row in mat_params[:null_id]:
            if row[12] == S.MAT_MIXTURE and row[19] == -2.0:
                row[19] = float(null_id)

    # Textures
    from ..texture.texture import pack_textures
    tex_data, tex_meta = pack_textures(desc.textures)

    # Medium
    med_grid = np.zeros((1, 1, 1), np.float32)
    med_grid_min = np.zeros(3, np.float32)
    med_grid_extent = np.ones(3, np.float32)
    med_majorant = np.float32(0.0)
    if desc.medium is not None:
        med_sigma_t = np.asarray(desc.medium.sigma_t, np.float32)[None]
        med_albedo = np.asarray(desc.medium.albedo, np.float32)[None]
        med_g = np.array([desc.medium.g], np.float32)
        med_bound = np.array([desc.medium.bound], np.float32)
        has_medium = np.array(True)
        if desc.medium.density_grid is not None:
            g3 = np.asarray(desc.medium.density_grid, np.float32)
            if g3.ndim == 4:
                g3 = g3[..., 0]
            med_grid = g3
            med_grid_min = np.asarray(desc.medium.grid_min, np.float32)
            med_grid_extent = (np.asarray(desc.medium.grid_max, np.float32)
                               - med_grid_min)
            sigma_scale = float(np.mean(desc.medium.sigma_t))
            med_majorant = np.float32(g3.max() * sigma_scale)
    else:
        med_sigma_t = np.zeros((1, 3), np.float32)
        med_albedo = np.zeros((1, 3), np.float32)
        med_g = np.zeros(1, np.float32)
        med_bound = np.full(1, 1e30, np.float32)
        has_medium = np.array(False)

    f32 = lambda x: jnp.asarray(x, jnp.float32)
    i32 = lambda x: jnp.asarray(x, jnp.int32)
    # bind tabulated-BSDF tables (compile-time constants; see
    # bsdf/tabulated_pool.py)
    from ..bsdf import irawan as irawan_mod
    irawan_mod.register_patterns(desc.weave_patterns or None)
    if desc.bsdf_tables:
        from ..bsdf import tabulated_pool
        tabulated_pool.register_tables(np.stack(
            [np.asarray(t, np.float32) for t in desc.bsdf_tables]))

    return S.SceneData(
        p0=f32(p0), e1=f32(e1), e2=f32(e2), ng=f32(ng), vn=f32(vn),
        vuv=f32(vuv), tri_mat=i32(tri_mat), tri_em=i32(tri_em),
        tri_area=f32(tri_area),
        woop_o=jnp.asarray(woop_o), woop_d=jnp.asarray(woop_d),
        trace_woop=jnp.asarray(trace_woop), trace_box=jnp.asarray(trace_box),
        tri_attr=jnp.asarray(tri_attr),
        mat_type=i32(np.array(mat_type)),
        mat_params=f32(np.stack(mat_params)),
        mat_tex=i32(np.stack(mat_tex)),
        em_type=em_type if isinstance(em_type, jnp.ndarray) else i32(em_type),
        em_radiance=f32(em_rad), em_pos=f32(em_pos), em_area=f32(em_area),
        em_pmf=em_pmf, em_tri_offset=i32(em_tri_offset),
        em_tris=i32(em_tris), em_tri_cdfg=f32(em_tri_cdfg),
        em_tri_data=f32(em_tri_data), em_aux=f32(em_aux),
        tex_data=f32(tex_data), tex_meta=i32(tex_meta),
        env_id=i32(env_id),
        env_img=f32(env_tables["env_img"] if env_tables
                    else np.zeros((1, 1, 3))),
        env_row_cdf=f32(env_tables["env_row_cdf"] if env_tables
                        else np.array([0.0, 1.0])),
        env_col_cdf=f32(env_tables["env_col_cdf"] if env_tables
                        else np.array([[0.0, 1.0]])),
        env_density=f32(env_tables["env_density"] if env_tables
                        else np.ones((1, 1))),
        env_alias=(f32(env_tables["env_alias"]) if env_tables
                   else None),
        med_sigma_t=f32(med_sigma_t), med_albedo=f32(med_albedo),
        med_g=f32(med_g), med_bound=f32(med_bound),
        has_medium=jnp.asarray(has_medium),
        med_grid=f32(med_grid), med_grid_min=f32(med_grid_min),
        med_grid_extent=f32(med_grid_extent),
        med_majorant=jnp.asarray(med_majorant),
        med_sggx=jnp.asarray(
            np.zeros(6, np.float32) if (desc.medium is None
                                        or desc.medium.sggx_s is None)
            else np.asarray(desc.medium.sggx_s, np.float32)),
        med_fiber=jnp.asarray(
            np.zeros(3, np.float32)
            if (desc.medium is None
                or desc.medium.fiber_orientation is None)
            else np.asarray(desc.medium.fiber_orientation, np.float32)),
    )
