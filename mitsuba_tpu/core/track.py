"""Animated transforms: keyframed R/T/S tracks with interpolation.

Counterpart of the reference's AnimatedTransform (ref: include/mitsuba/
core/track.h:35,335 + track.cpp:394): transforms are decomposed into
translation / rotation (quaternion) / scale keyframes; evaluation lerps
T and S and slerps R, exactly the reference's eval() semantics.

Wavefront mapping of motion blur (the reference's 4D kd-tree `deformable`
shape + sensor shutter sampling): the scene compiler is cheap and
host-side, so motion is rendered by TIME-SLICED distribution ray
tracing — `render_motion` compiles the scene at n_t stratified shutter
times and averages equal sample budgets (integrator/motion.py). Per-ray
continuous time (4D traversal) is deliberately traded for shape-static
slices; slice counts ≥ 8 make the discretization invisible next to MC
noise.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def _quat_from_matrix(m):
    """3×3 rotation → quaternion (w, x, y, z)."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def _quat_to_matrix(q):
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x),
         1 - 2 * (x * x + y * y)]])


def _slerp(q0, q1, t):
    d = float(np.dot(q0, q1))
    if d < 0:
        q1, d = -q1, -d
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(np.clip(d, -1, 1))
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


@dataclass
class AnimatedTransform:
    """Keyframed transform; append with put(time, matrix) or the track
    setters. eval(t) clamps outside the key range (track.h semantics)."""
    times: list = field(default_factory=list)
    trans: list = field(default_factory=list)     # [3]
    quats: list = field(default_factory=list)     # [4]
    scales: list = field(default_factory=list)    # [3]

    def put(self, time: float, matrix: np.ndarray) -> "AnimatedTransform":
        """Decompose a rigid(+scale) 4×4 into T/R/S keys
        (ref: track.cpp appendTransform decomposition)."""
        m = np.asarray(matrix, np.float64)
        t = m[:3, 3].copy()
        a = m[:3, :3]
        s = np.linalg.norm(a, axis=0)
        s = np.where(s < 1e-12, 1.0, s)
        r = a / s
        if np.linalg.det(r) < 0:       # reflection → fold into scale
            r[:, 0] *= -1
            s[0] *= -1
        self.times.append(float(time))
        self.trans.append(t)
        self.quats.append(_quat_from_matrix(r))
        self.scales.append(s)
        return self

    def eval(self, time: float) -> np.ndarray:
        ts = np.asarray(self.times)
        assert len(ts) > 0, "empty transform track"
        if len(ts) == 1 or time <= ts[0]:
            i0 = i1 = 0
            f = 0.0
        elif time >= ts[-1]:
            i0 = i1 = len(ts) - 1
            f = 0.0
        else:
            i1 = int(np.searchsorted(ts, time, side="right"))
            i0 = i1 - 1
            f = (time - ts[i0]) / max(ts[i1] - ts[i0], 1e-12)
        t = (1 - f) * self.trans[i0] + f * self.trans[i1]
        s = (1 - f) * self.scales[i0] + f * self.scales[i1]
        r = _quat_to_matrix(_slerp(self.quats[i0], self.quats[i1], f))
        m = np.eye(4)
        m[:3, :3] = r * s[None, :]
        m[:3, 3] = t
        return m

    @property
    def is_static(self):
        return len(self.times) <= 1
