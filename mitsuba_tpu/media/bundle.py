"""Multi-channel volume "bundle" lookups for multi-lobe SGGX media.

Wavefront counterpart of winmad's `VolumeDataSourceEx::lookupBundle`
(ref: include/mitsuba/render/volume2.h:28, src/volume/gridvol2_simple.cpp)
as consumed by the cluster-indexed multi-lobe media
`heterogeneous2/heterogeneous3` (ref: src/medium/heterogeneous2.cpp:94-104,
500-560): each voxel carries density, single-scattering albedo, a
*cluster index* into per-cluster scale tables, and K SGGX lobes
(6 S-matrix coefficients + a lobe pdf each). The medium combines them as

    sigmaS(p)      = albedo(p) * albedoScales[cluster(p)] * density(p)
    lobe weight_k  = pdfLobe_k(p) * lobeScales[cluster(p), k]

and feeds the weighted lobes to the SGGX mixture phase
(`phase.sggx_mix_*`, which implements heterogeneous3's lobe
accumulation). The reference resolves this with a virtual call chain
per lookup; here it is a handful of trilinear gathers producing the
`s6w [..., K, 7]` tensor the mixture phase consumes directly, so the
whole bundle path stays inside one fused XLA kernel.
"""
from __future__ import annotations

import jax.numpy as jnp

from .heterogeneous import trilinear

__all__ = ["lookup_bundle", "cluster_s6w", "scaled_albedo"]


def _tri_nd(grid, p01):
    """Channel-aware trilinear: grid [Z,Y,X,C] -> [..., C]
    (`trilinear` itself is scalar [Z,Y,X]; C is small and static)."""
    return jnp.stack([trilinear(grid[..., c], p01)
                      for c in range(grid.shape[-1])], axis=-1)


def lookup_bundle(p01, density=None, albedo=None, cluster=None,
                  lobe_s6=None, pdf_lobe=None, orientation=None):
    """Evaluate every provided per-voxel channel at points `p01` in
    [0,1]^3. Continuous channels interpolate trilinearly; the cluster
    index uses nearest-voxel (it indexes a discrete table — the
    reference stores it as a float and truncates,
    heterogeneous2.cpp:539-541).

    density [Z,Y,X,1]; albedo [Z,Y,X,3]; cluster [Z,Y,X] int;
    lobe_s6 [Z,Y,X,K,6]; pdf_lobe [Z,Y,X,K]; orientation [Z,Y,X,3].
    Returns a dict with per-point values (keys of provided inputs).
    """
    out = {}
    if density is not None:
        out["density"] = _tri_nd(density, p01)[..., 0]
    if albedo is not None:
        out["albedo"] = _tri_nd(albedo, p01)
    if orientation is not None:
        w = _tri_nd(orientation, p01)
        out["orientation"] = w / jnp.maximum(
            jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    if cluster is not None:
        res = jnp.asarray(cluster.shape[::-1], jnp.float32)  # (X,Y,Z)
        ij = jnp.clip((p01 * res).astype(jnp.int32), 0,
                      jnp.asarray(cluster.shape[::-1], jnp.int32) - 1)
        out["cluster"] = cluster[ij[..., 2], ij[..., 1], ij[..., 0]]
    if lobe_s6 is not None:
        K = lobe_s6.shape[-2]
        flat = _tri_nd(lobe_s6.reshape(*lobe_s6.shape[:3], K * 6), p01)
        out["lobe_s6"] = flat.reshape(*flat.shape[:-1], K, 6)
    if pdf_lobe is not None:
        out["pdf_lobe"] = _tri_nd(pdf_lobe, p01)
    return out


def cluster_s6w(lobe_s6, pdf_lobe, cluster_idx, lobe_scales):
    """Assemble the per-point weighted SGGX mixture tensor.

    lobe_s6   [..., K, 6] per-point S matrices
    pdf_lobe  [..., K]    per-point lobe pdfs
    cluster_idx [...]     int cluster per point
    lobe_scales [C, K]    per-cluster lobe scales (heterogeneous2.cpp:96-103)

    Returns s6w [..., K, 7] = (weight_k, S_k) for `sggx_mix_sigma/eval/
    sample`, with weight_k = pdfLobe_k * lobeScales[cluster, k]
    (heterogeneous2.cpp:552-557).
    """
    w = pdf_lobe * lobe_scales[cluster_idx]          # [..., K]
    return jnp.concatenate([w[..., None], lobe_s6], axis=-1)


def scaled_albedo(albedo, cluster_idx, albedo_scales):
    """sigmaS albedo scaling by cluster (heterogeneous2.cpp:543-548):
    albedo_scales [C, 3] or [C]; returns albedo * scale[cluster]."""
    s = albedo_scales[cluster_idx]
    if s.ndim < albedo.ndim:
        s = s[..., None]
    return albedo * s
