"""Shell-mapped volumes: tetrahedral shell mesh -> texture-space lookup.

Wavefront counterpart of the reference's `shellmap`/`shellmap2` volume
data sources (ref: src/volume/shellmap.cpp:31-130, shellmap2.cpp) and the
`TetrahedronMesh` point-location structure (ref: src/volume/tetra.h:52-230).
A shell is a tetrahedralized thick layer wrapped around a base surface;
a world-space point is located inside one tetrahedron, its barycentric
coordinates interpolate per-vertex *texture-space* positions (and, for
`shellmap2`, normals + tangent frames), and the resulting texture point
indexes an embedded volume (grid/sparse). This lets one small volume
tile ("texel volume") be wrapped over arbitrary geometry — the core of
winmad's appearance-prefiltering pipelines.

The reference locates points with a per-ray BVH walk over tetrahedra
(tetra.h:311 `_node_type`, recursive `lookup`). That is pointer chasing —
the wavefront design replaces it with a **uniform grid over the shell's AABB**:
each cell stores a fixed-width padded list of candidate tetrahedra, and a
lookup is two gathers plus K batched 3x3 mat-vecs (barycentric solves),
fully branchless and vmappable across a wavefront of sample points.

File format parity: `load_shell` reads the reference's text `.shell`
format (tetra.h:78-130: "V T" header, V lines of 15 floats
[pos texcoord normal dpdu dpdv], T lines of 4 vertex indices).
`extrude_shell` builds a shell programmatically from a triangle mesh
(prism per face, split into 3 tets) for tests and Python scene builds.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ShellMesh", "load_shell", "extrude_shell", "build_shell",
    "shell_lookup", "shell_lookup_full", "shellmapped_lookup",
]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class ShellMesh:
    """Tetrahedral shell with a uniform-grid point-location index.

    v0:        [T, 3]    first vertex of each tet (world/shell space)
    inv_m:     [T, 3, 3] inverse edge matrix: bary[1:4] = inv_m @ (p - v0)
    tex:       [T, 4, 3] per-corner texture-space positions
    nrm:       [T, 4, 3] per-corner shell normals
    dpdu/dpdv: [T, 4, 3] per-corner tangent frames
    cells:     [CZ*CY*CX, K] int32 candidate tet ids, -1 padded
    bb_min/bb_ext: [3] shell AABB
    grid_res:  (CZ, CY, CX) static
    """
    v0: jnp.ndarray
    inv_m: jnp.ndarray
    tex: jnp.ndarray
    nrm: jnp.ndarray
    dpdu: jnp.ndarray
    dpdv: jnp.ndarray
    cells: jnp.ndarray
    bb_min: jnp.ndarray
    bb_ext: jnp.ndarray
    grid_res: tuple

    def tree_flatten(self):
        return ((self.v0, self.inv_m, self.tex, self.nrm, self.dpdu,
                 self.dpdv, self.cells, self.bb_min, self.bb_ext),
                (self.grid_res,))

    @classmethod
    def tree_unflatten(cls, aux, ch):
        return cls(*ch, aux[0])


def load_shell(path: str):
    """Parse the reference's text .shell format (tetra.h:78-130).

    Returns (positions [V,3], texcoords [V,3], normals [V,3],
    dpdu [V,3], dpdv [V,3], tets [T,4] int).
    """
    with open(path) as f:
        toks = f.read().split()
    v_count, t_count = int(toks[0]), int(toks[1])
    vdata = np.asarray(toks[2:2 + v_count * 15],
                       dtype=np.float32).reshape(v_count, 5, 3)
    tets = np.asarray(toks[2 + v_count * 15:2 + v_count * 15 + t_count * 4],
                      dtype=np.int64).reshape(t_count, 4)
    return (vdata[:, 0], vdata[:, 1], vdata[:, 2], vdata[:, 3],
            vdata[:, 4], tets)


def extrude_shell(positions, texcoords_2d, normals, faces,
                  thickness: float = 0.1, offset: float = 0.0):
    """Build a shell by extruding a triangle mesh along its normals.

    Mirrors the offline tool the reference expects users to run before
    `shellmap` (the .shell files it loads are produced this way): each
    triangle becomes a prism between `base + offset*n` and
    `base + (offset+thickness)*n`, split into 3 tetrahedra. Texture
    coordinates are (u, v, 0) at the bottom and (u, v, 1) at the top,
    matching the reference's convention that texture z spans the shell
    (shellmap.cpp:103 asserts 0 <= tex.z <= 1).
    """
    pos = np.asarray(positions, np.float32)
    uv = np.asarray(texcoords_2d, np.float32)
    nrm = np.asarray(normals, np.float32)
    faces = np.asarray(faces, np.int64)
    V = pos.shape[0]

    bot = pos + offset * nrm
    top = pos + (offset + thickness) * nrm
    all_pos = np.concatenate([bot, top], 0)
    tex = np.concatenate(
        [np.concatenate([uv, np.zeros((V, 1), np.float32)], 1),
         np.concatenate([uv, np.ones((V, 1), np.float32)], 1)], 0)
    all_nrm = np.concatenate([nrm, nrm], 0)
    # tangents: any orthonormal pair per vertex (reference stores the
    # base mesh's dpdu/dpdv; for the synthetic builder derive from n)
    a = np.where(np.abs(nrm[:, :1]) < 0.9,
                 np.array([[1., 0., 0.]], np.float32),
                 np.array([[0., 1., 0.]], np.float32))
    du = np.cross(nrm, a)
    du /= np.linalg.norm(du, axis=1, keepdims=True) + 1e-20
    dv = np.cross(nrm, du)
    dpdu = np.concatenate([du, du], 0).astype(np.float32)
    dpdv = np.concatenate([dv, dv], 0).astype(np.float32)

    # standard prism -> 3 tets split, consistent across shared faces
    # (order prism corners by global vertex index so neighbouring
    # prisms pick compatible diagonals)
    tets = []
    for (i, j, k) in faces:
        i, j, k = int(i), int(j), int(k)
        # sort so diagonal choice is consistent on shared quad faces
        a0, a1, a2 = sorted((i, j, k))
        b0, b1, b2 = a0 + V, a1 + V, a2 + V
        tets.append((a0, a1, a2, b2))
        tets.append((a0, a1, b2, b1))
        tets.append((a0, b1, b2, b0))
    return (all_pos, tex, all_nrm, dpdu, dpdv,
            np.asarray(tets, np.int64))


def build_shell(positions, texcoords, normals, dpdu, dpdv, tets,
                grid_res: int = 16, max_per_cell: int = 32) -> ShellMesh:
    """Precompute barycentric solve matrices + the uniform-grid index.

    Replaces the reference's tetrahedron BVH build (tetra.h:130-160)
    with a numpy-side binning pass; degenerate tets get a zero inverse
    so they can never report "inside".
    """
    pos = np.asarray(positions, np.float64)
    tets = np.asarray(tets, np.int64)
    T = tets.shape[0]
    corners = pos[tets]                        # [T,4,3]
    v0 = corners[:, 0]
    m = np.stack([corners[:, 1] - v0, corners[:, 2] - v0,
                  corners[:, 3] - v0], axis=-1)   # [T,3,3] columns=edges
    det = np.linalg.det(m)
    ok = np.abs(det) > 1e-18
    inv_m = np.zeros_like(m)
    inv_m[ok] = np.linalg.inv(m[ok])

    bb_min = corners.reshape(-1, 3).min(0)
    bb_max = corners.reshape(-1, 3).max(0)
    ext = np.maximum(bb_max - bb_min, 1e-12)

    res = (grid_res, grid_res, grid_res)
    cells = [[] for _ in range(res[0] * res[1] * res[2])]
    tmin = np.clip(((corners.min(1) - bb_min) / ext * grid_res).astype(int),
                   0, grid_res - 1)
    tmax = np.clip(((corners.max(1) - bb_min) / ext * grid_res).astype(int),
                   0, grid_res - 1)
    for t in range(T):
        if not ok[t]:
            continue
        for z in range(tmin[t, 2], tmax[t, 2] + 1):
            for y in range(tmin[t, 1], tmax[t, 1] + 1):
                for x in range(tmin[t, 0], tmax[t, 0] + 1):
                    cells[(z * grid_res + y) * grid_res + x].append(t)
    K = max(1, min(max_per_cell, max(len(c) for c in cells)))
    cell_arr = np.full((len(cells), K), -1, np.int32)
    for ci, c in enumerate(cells):
        cell_arr[ci, :min(K, len(c))] = c[:K]

    gather = lambda a: jnp.asarray(a[tets], jnp.float32)  # [T,4,3]
    return ShellMesh(
        v0=jnp.asarray(v0, jnp.float32),
        inv_m=jnp.asarray(inv_m, jnp.float32),
        tex=gather(np.asarray(texcoords, np.float64)),
        nrm=gather(np.asarray(normals, np.float64)),
        dpdu=gather(np.asarray(dpdu, np.float64)),
        dpdv=gather(np.asarray(dpdv, np.float64)),
        cells=jnp.asarray(cell_arr),
        bb_min=jnp.asarray(bb_min, jnp.float32),
        bb_ext=jnp.asarray(ext, jnp.float32),
        grid_res=res,
    )


def _locate(shell: ShellMesh, p, eps=1e-5):
    """Find the containing tet: returns (tet_id, bary4 [...,4], inside)."""
    g = shell.grid_res[0]
    q = (p - shell.bb_min) / shell.bb_ext
    ci = jnp.clip((q * g).astype(jnp.int32), 0, g - 1)
    flat = (ci[..., 2] * g + ci[..., 1]) * g + ci[..., 0]
    cand = shell.cells[flat]                          # [..., K]
    safe = jnp.maximum(cand, 0)
    d = p[..., None, :] - shell.v0[safe]              # [..., K, 3]
    b123 = jnp.einsum('...kij,...kj->...ki', shell.inv_m[safe], d)
    b0 = 1.0 - b123.sum(-1, keepdims=True)
    bary = jnp.concatenate([b0, b123], -1)            # [..., K, 4]
    inside_k = (bary.min(-1) >= -eps) & (cand >= 0)
    k = jnp.argmax(inside_k, axis=-1)
    inside = jnp.take_along_axis(inside_k, k[..., None], -1)[..., 0]
    tid = jnp.take_along_axis(safe, k[..., None], -1)[..., 0]
    bb = jnp.take_along_axis(bary, k[..., None, None], -2)[..., 0, :]
    return tid, bb, inside


def shell_lookup(shell: ShellMesh, p):
    """world/shell point -> (texture point [...,3], inside mask).

    Semantics of TetrahedronMesh::lookupPoint (tetra.h:181-194): outside
    the shell -> caller substitutes zero density (shellmap.cpp:109-113).
    """
    tid, bb, inside = _locate(shell, p)
    tex = jnp.einsum('...k,...kc->...c', bb, shell.tex[tid])
    return tex, inside


def shell_lookup_full(shell: ShellMesh, p):
    """shellmap2 variant: also interpolates normal + tangent frame
    (tetra.h:196-230), used to rotate SGGX lobes / orientation vectors
    from texture space into the shell's local frame."""
    tid, bb, inside = _locate(shell, p)
    ip = lambda a: jnp.einsum('...k,...kc->...c', bb, a[tid])
    return ip(shell.tex), ip(shell.nrm), ip(shell.dpdu), ip(shell.dpdv), inside


def shellmapped_lookup(shell: ShellMesh, p, embedded_fn,
                       data_bb_min=None, data_bb_ext=None, tile_xy=True):
    """Full VolumeDataSource semantics (shellmap.cpp:100-126): locate the
    texture point, wrap x/y by frac for tiling (clampPoint), remap into
    the embedded volume's data AABB, then evaluate `embedded_fn(p01)`
    (any of the grid/sparse lookup closures, taking points in [0,1]^3).
    Outside the shell the result is 0."""
    tex, inside = shell_lookup(shell, p)
    xy = tex[..., :2] - jnp.floor(tex[..., :2]) if tile_xy else tex[..., :2]
    p01 = jnp.concatenate([xy, jnp.clip(tex[..., 2:], 0.0, 1.0)], -1)
    if data_bb_min is not None:
        p01 = (p01 - data_bb_min) / data_bb_ext
    val = embedded_fn(p01)
    return jnp.where(inside[..., None] if jnp.ndim(val) > jnp.ndim(inside)
                     else inside, val, 0.0)
