"""Host-side analytic shape → triangle mesh generators.

Counterparts of the reference's shape plugins (ref: src/shapes/{rectangle,
cube,sphere,disk,cylinder}.cpp). Every shape is compiled to triangles
at scene-build time: analytic per-ray intersections (sphere quadratics etc.)
would fragment the wavefront; a tessellated sphere with interpolated shading
normals feeds the same triangle intersector as everything else.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Mesh:
    """Indexed triangle mesh, object space."""
    vertices: np.ndarray            # [V, 3] float64
    faces: np.ndarray               # [F, 3] int64
    normals: np.ndarray | None = None   # [V, 3] shading normals
    uvs: np.ndarray | None = None       # [V, 2]
    colors: np.ndarray | None = None    # [V, 3] linear vertex colors
    #   (consumed by texture/geomtex.py bake_vertex_colors — the
    #   vertexcolors texture analog; ref: src/textures/vertexcolors.cpp)


def rectangle() -> Mesh:
    """Unit rectangle in the xy-plane spanning [-1,1]², normal +z
    (ref: src/shapes/rectangle.cpp)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], float)
    f = np.array([[0, 1, 2], [2, 3, 0]])
    n = np.tile([0.0, 0.0, 1.0], (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], float)
    return Mesh(v, f, n, uv)


def cube() -> Mesh:
    """Axis-aligned cube spanning [-1,1]³, outward normals
    (ref: src/shapes/cube.cpp)."""
    verts, faces, normals, uvs = [], [], [], []
    axes = [(0, 1, 2), (1, 2, 0), (2, 0, 1)]
    idx = 0
    for ax, (a, b, c) in enumerate(axes):
        for s in (-1.0, 1.0):
            corners = []
            for (ua, ub) in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
                p = np.zeros(3)
                p[c] = s
                p[a] = ua * s  # flip winding with side for outward normals
                p[b] = ub
                corners.append(p)
            n = np.zeros(3)
            n[c] = s
            verts.extend(corners)
            normals.extend([n] * 4)
            uvs.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
            faces.append([idx, idx + 1, idx + 2])
            faces.append([idx + 2, idx + 3, idx])
            idx += 4
    return Mesh(np.array(verts), np.array(faces), np.array(normals),
                np.array(uvs, float))


def sphere(subdiv_theta: int = 32, subdiv_phi: int = 64) -> Mesh:
    """UV sphere of radius 1 at origin (ref: src/shapes/sphere.cpp —
    analytic there; tessellated here with exact shading normals so the
    shading-normal interpolation recovers the smooth appearance)."""
    th = np.linspace(0.0, np.pi, subdiv_theta + 1)
    ph = np.linspace(0.0, 2 * np.pi, subdiv_phi + 1)
    tg, pg = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(tg) * np.cos(pg)
    y = np.sin(tg) * np.sin(pg)
    z = np.cos(tg)
    v = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    uv = np.stack([pg / (2 * np.pi), 1.0 - tg / np.pi], -1).reshape(-1, 2)
    faces = []
    w = subdiv_phi + 1
    for i in range(subdiv_theta):
        for j in range(subdiv_phi):
            a, b = i * w + j, i * w + j + 1
            c, d = (i + 1) * w + j, (i + 1) * w + j + 1
            if i > 0:
                faces.append([a, c, b])
            if i < subdiv_theta - 1:
                faces.append([b, c, d])
    return Mesh(v, np.array(faces), v.copy(), uv)


def disk(subdiv: int = 64) -> Mesh:
    """Unit disk in the xy-plane, normal +z (ref: src/shapes/disk.cpp)."""
    ang = np.linspace(0, 2 * np.pi, subdiv, endpoint=False)
    rim = np.stack([np.cos(ang), np.sin(ang), np.zeros(subdiv)], -1)
    v = np.concatenate([[[0.0, 0.0, 0.0]], rim])
    f = [[0, 1 + i, 1 + (i + 1) % subdiv] for i in range(subdiv)]
    n = np.tile([0.0, 0.0, 1.0], (subdiv + 1, 1))
    uv = 0.5 * (v[:, :2] + 1.0)
    return Mesh(v, np.array(f), n, uv)


def cylinder(subdiv: int = 64) -> Mesh:
    """Open cylinder along z from 0 to 1, radius 1
    (ref: src/shapes/cylinder.cpp)."""
    ang = np.linspace(0, 2 * np.pi, subdiv, endpoint=False)
    ring = np.stack([np.cos(ang), np.sin(ang)], -1)
    bot = np.concatenate([ring, np.zeros((subdiv, 1))], -1)
    top = np.concatenate([ring, np.ones((subdiv, 1))], -1)
    v = np.concatenate([bot, top])
    n = np.concatenate([np.concatenate([ring, np.zeros((subdiv, 1))], -1)] * 2)
    uv = np.concatenate(
        [np.stack([ang / (2 * np.pi), np.zeros(subdiv)], -1),
         np.stack([ang / (2 * np.pi), np.ones(subdiv)], -1)])
    f = []
    for i in range(subdiv):
        j = (i + 1) % subdiv
        f.append([i, j, subdiv + i])
        f.append([j, subdiv + j, subdiv + i])
    return Mesh(v, np.array(f), n, uv)


def heightfield(heights: np.ndarray, flip_normals: bool = False) -> Mesh:
    """Regular-grid heightfield spanning [-1,1]² in xy with z = h(x, y)
    (ref: src/shapes/heightfield.cpp — winmad's 2D-SAH-quadtree shape;
    here compiled to triangles for the wavefront intersector like every
    other shape; the reference's lod/tiled/composite variants map to
    building this mesh from a chosen mip level of the height texture).

    heights: [H, W] float array of surface heights.
    """
    hts = np.asarray(heights, np.float64)
    hh, ww = hts.shape
    xs = np.linspace(-1.0, 1.0, ww)
    ys = np.linspace(-1.0, 1.0, hh)
    xg, yg = np.meshgrid(xs, ys, indexing="xy")
    v = np.stack([xg, yg, hts], axis=-1).reshape(-1, 3)
    uv = np.stack([(xg + 1) / 2, (yg + 1) / 2], -1).reshape(-1, 2)

    # central-difference shading normals (ref heightfield.cpp derivatives)
    dx = np.gradient(hts, xs, axis=1)
    dy = np.gradient(hts, ys, axis=0)
    n = np.stack([-dx, -dy, np.ones_like(hts)], axis=-1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    if flip_normals:
        n = -n
    n = n.reshape(-1, 3)

    idx = np.arange(hh * ww).reshape(hh, ww)
    a = idx[:-1, :-1].ravel()
    b = idx[:-1, 1:].ravel()
    c = idx[1:, :-1].ravel()
    d = idx[1:, 1:].ravel()
    f = np.concatenate([np.stack([a, b, d], -1), np.stack([d, c, a], -1)])
    return Mesh(v, f, n, uv)


def hair(control_points: np.ndarray, first_vertex: np.ndarray,
         radius: float = 0.025, sides: int = 4) -> Mesh:
    """Hair/fiber geometry: polyline strands tessellated into generalized
    cylinders (ref: src/shapes/hair.cpp + hair.h builds a kd-tree over
    analytic curve segments; this renderer tessellates each segment into
    a `sides`-gon tube so fibers ride the same triangle wavefront —
    radius and segment connectivity semantics match the plugin's
    `radius` property and .hair file format).

    control_points: [P, 3] concatenated strand vertices.
    first_vertex: [S+1] int offsets — strand s uses points
      [first_vertex[s], first_vertex[s+1]).
    """
    cps = np.asarray(control_points, np.float64)
    fv = np.asarray(first_vertex, np.int64)
    verts, norms, uvs, faces = [], [], [], []
    base = 0
    ang = np.arange(sides) * (2 * np.pi / sides)
    circ = np.stack([np.cos(ang), np.sin(ang)], -1)       # [sides, 2]
    for s in range(len(fv) - 1):
        pts = cps[fv[s]:fv[s + 1]]
        if len(pts) < 2:
            continue
        # per-vertex tangents, parallel-transported frame
        tang = np.gradient(pts, axis=0)
        tang /= np.maximum(np.linalg.norm(tang, axis=-1, keepdims=True),
                           1e-12)
        # initial normal: anything perpendicular to t0
        t0 = tang[0]
        ref = np.array([1.0, 0.0, 0.0]) if abs(t0[0]) < 0.9 \
            else np.array([0.0, 1.0, 0.0])
        u = np.cross(t0, ref)
        u /= np.linalg.norm(u)
        rings = []
        ring_n = []
        for i, (p, t) in enumerate(zip(pts, tang)):
            if i > 0:
                # transport u across the tangent rotation
                u = u - t * np.dot(u, t)
                nu = np.linalg.norm(u)
                u = u / nu if nu > 1e-9 else np.cross(
                    t, [1.0, 0.0, 0.0])
            w = np.cross(t, u)
            ring_dir = circ[:, 0:1] * u + circ[:, 1:2] * w  # [sides, 3]
            rings.append(p + radius * ring_dir)
            ring_n.append(ring_dir)
        rings = np.asarray(rings)            # [L, sides, 3]
        ring_n = np.asarray(ring_n)
        L = len(pts)
        verts.append(rings.reshape(-1, 3))
        norms.append(ring_n.reshape(-1, 3))
        vcoord = np.repeat(np.linspace(0, 1, L), sides)
        ucoord = np.tile(ang / (2 * np.pi), L)
        uvs.append(np.stack([ucoord, vcoord], -1))
        for i in range(L - 1):
            for j in range(sides):
                j2 = (j + 1) % sides
                a = base + i * sides + j
                b = base + i * sides + j2
                c = base + (i + 1) * sides + j
                d = base + (i + 1) * sides + j2
                faces.append([a, b, d])
                faces.append([d, c, a])
        base += L * sides
    if not verts:
        return Mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))
    return Mesh(np.concatenate(verts), np.asarray(faces, np.int64),
                np.concatenate(norms), np.concatenate(uvs))


def load_hair(path: str, radius: float = 0.025, sides: int = 4) -> Mesh:
    """Load the reference's .hair format (ref: src/shapes/hair.cpp
    fileformat: binary 'BINARY_HAIR' header + float triples, or ASCII
    lines of xyz with blank lines separating strands) and tessellate."""
    with open(path, "rb") as f:
        head = f.read(11)
        if head == b"BINARY_HAIR":
            n = np.frombuffer(f.read(4), "<u4")[0]
            data = np.frombuffer(f.read(), "<f4")
            pts, fv = [], [0]
            i = 0
            while i + 2 < len(data) and len(pts) < n:
                if np.isinf(data[i]):        # +inf marks a new strand
                    fv.append(len(pts))
                    i += 1
                else:
                    pts.append(data[i:i + 3])
                    i += 3
            fv.append(len(pts))
            fv = [x for k, x in enumerate(fv)
                  if k == 0 or x != fv[k - 1]]
            return hair(np.asarray(pts), np.asarray(fv), radius, sides)
    # ASCII
    pts, fv = [], [0]
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if len(pts) > fv[-1]:
                    fv.append(len(pts))
                continue
            pts.append([float(x) for x in line.split()[:3]])
    if len(pts) > fv[-1]:
        fv.append(len(pts))
    return hair(np.asarray(pts), np.asarray(fv), radius, sides)


@dataclass
class ShapeGroup:
    """Named reusable geometry group (ref: src/shapes/shapegroup.h:34 —
    there a nested kd-tree; here a list of (mesh, to_object, material)
    triplets instanced at compile time)."""
    parts: list = field(default_factory=list)   # (Mesh, transform, mat)

    def add(self, mesh: Mesh, to_group=None, material: int = 0):
        eye = np.eye(4) if to_group is None else np.asarray(to_group)
        self.parts.append((mesh, eye, material))
        return self


def instance(group: ShapeGroup, to_world: np.ndarray):
    """Instantiate a shape group (ref: src/shapes/instance.h:27). Static
    compile-time instancing: every instance re-emits the group's
    triangles under its transform. A TLAS/BLAS two-level intersector is
    the planned upgrade for ray-time instancing (ARCHITECTURE.md);
    semantically this covers the plugin's behavior for static scenes.

    Returns [(mesh, combined_transform, material), ...] ready for
    SceneDesc.add_shape.
    """
    return [(mesh, np.asarray(to_world) @ t, mat)
            for (mesh, t, mat) in group.parts]


@dataclass
class DeformableMesh:
    """Keyframed vertex animation (ref: src/shapes/deformable.cpp:32-300,
    SpaceTimeKDTree). The reference builds a 4D space-time SAH kd-tree
    and lerps the two bracketing keyframes' vertex positions per ray
    time (deformable.cpp:247-270). Wavefront redesign: per-ray time would make
    every intersection data-dependent on t, so the mesh is *evaluated*
    at the compile-time shutter-slice times used by
    integrator.motion.render_motion — `at(t)` returns the lerped static
    Mesh for one slice, and the time axis is integrated by stratified
    slicing exactly like AnimatedTransform motion (core/track.py).
    """
    frames: np.ndarray              # [F, V, 3] keyframed positions
    faces: np.ndarray               # [F_tri, 3]
    times: np.ndarray | None = None  # [F] ascending; default linspace 0..1
    uvs: np.ndarray | None = None

    def at(self, t: float) -> Mesh:
        """Vertex-lerped static mesh at shutter time t (clamped to the
        keyframe range, as the reference clamps via math::clamp)."""
        frames = np.asarray(self.frames, np.float64)
        F = frames.shape[0]
        times = (np.asarray(self.times, np.float64) if self.times
                 is not None else np.linspace(0.0, 1.0, F))
        t = float(np.clip(t, times[0], times[-1]))
        i = int(np.clip(np.searchsorted(times, t, side="right") - 1,
                        0, F - 2))
        dt = times[i + 1] - times[i]
        alpha = 0.0 if dt <= 0 else (t - times[i]) / dt
        v = (1.0 - alpha) * frames[i] + alpha * frames[i + 1]
        return Mesh(vertices=v, faces=np.asarray(self.faces),
                    uvs=self.uvs)


def _subdivide(v, f, n, uv, levels: int):
    """Loop-free 1:4 midpoint subdivision (positions/normals/uvs lerped)."""
    for _ in range(levels):
        edges = {}
        v = list(map(np.asarray, v))
        n = list(map(np.asarray, n))
        uv = list(map(np.asarray, uv))

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = len(v)
                v.append(0.5 * (v[a] + v[b]))
                nm = n[a] + n[b]
                n.append(nm / max(np.linalg.norm(nm), 1e-12))
                uv.append(0.5 * (uv[a] + uv[b]))
            return edges[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        v, f = np.asarray(v), np.asarray(nf)
        n, uv = np.asarray(n), np.asarray(uv)
    return v, f, n, uv


def shellmap_heightfield(base: Mesh, heights: np.ndarray,
                         scale: float = 1.0, offset: float = 0.0,
                         subdiv: int = 3) -> Mesh:
    """Heightfield detail mapped over a base mesh through its shell —
    the shape-side counterpart of the fork's shellmap heightfields
    (ref: src/shapes/shellmap_heightfield.cpp; the tetrahedral VOLUME
    shell mapping lives in media/shellmap.py).

    The reference intersects rays against heightfield tiles warped through
    base-mesh prisms at trace time; in the compile-to-triangles
    architecture the same surface is produced by subdividing the base and
    displacing each vertex along its interpolated shell direction
    (shading normal) by the bilinear heightfield sample at its UV:

        p'(u, v) = p(u, v) + (offset + scale·h(u, v)) · n̂(u, v)

    base must carry per-vertex normals and UVs. heights: [H, W] in [0,1]
    texture space (row 0 = v 0)."""
    assert base.normals is not None and base.uvs is not None, \
        "shellmap_heightfield needs a base mesh with normals and UVs"
    hts = np.asarray(heights, np.float64)
    hh, ww = hts.shape
    v, f, n, uv = _subdivide(base.vertices, base.faces, base.normals,
                             base.uvs, subdiv)
    # bilinear heightfield sample at each vertex UV (clamped)
    fu = np.clip(uv[:, 0], 0.0, 1.0) * (ww - 1)
    fv = np.clip(uv[:, 1], 0.0, 1.0) * (hh - 1)
    x0 = np.clip(fu.astype(int), 0, ww - 1)
    y0 = np.clip(fv.astype(int), 0, hh - 1)
    x1, y1 = np.minimum(x0 + 1, ww - 1), np.minimum(y0 + 1, hh - 1)
    tx, ty = fu - x0, fv - y0
    h = ((1 - ty) * ((1 - tx) * hts[y0, x0] + tx * hts[y0, x1])
         + ty * ((1 - tx) * hts[y1, x0] + tx * hts[y1, x1]))
    disp = (offset + scale * h)[:, None] * n
    v2 = v + disp
    # recompute shading normals from the displaced surface (area-weighted
    # face normals accumulated per vertex, as trimesh.cpp SN generation)
    e1 = v2[f[:, 1]] - v2[f[:, 0]]
    e2 = v2[f[:, 2]] - v2[f[:, 0]]
    fn = np.cross(e1, e2)
    vn = np.zeros_like(v2)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    lens = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = np.where(lens > 1e-12, vn / np.maximum(lens, 1e-12), n)
    return Mesh(v2, f, vn, uv)
