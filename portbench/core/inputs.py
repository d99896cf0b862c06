"""The inputs of a run, made from ``--seed`` alone and handed alike to the
program and to the reference.

- A render mix: ``views`` cameras of a golden-angle turntable around the
  scene, azimuth ``(a0 + golden_angle_deg·i) mod 360`` with the offset
  ``a0`` drawn from the seed, each a pinhole camera looking at the orbit's
  target (the port's ``Camera.orbit``, worked in float64 and rounded once to
  float32); request ``r`` renders the views ``(r·F + j) mod views`` for
  ``j < F``.
- A fit mix: the configuration's reference camera, and for job ``j`` the
  scene's values with each jittered parameter moved by its own seeded
  offsets (``reference/scene.py::jittered``), job ``-1`` the warm-up's.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference.scene import jittered


def streams(seed: int) -> dict:
    """Independent generators of one seed: ``views``, ``jobs``, ``check``."""
    ss = np.random.SeedSequence(int(seed) % (1 << 128))
    kids = ss.spawn(3)
    return {"views": np.random.default_rng(kids[0]), "jobs": kids[1], "check": np.random.default_rng(kids[2])}


def look_at(position, target, up=(0.0, 1.0, 0.0), fov_deg=60.0) -> dict:
    """A camera at ``position`` looking at ``target`` (−z forward):
    ``position`` (3,), ``c2w`` (3, 3) columns right, up, back, ``fov_deg``,
    float32 numpy arrays."""
    position, target, up = (np.asarray(x, np.float64) for x in (position, target, up))
    forward = target - position
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.stack([right, true_up, -forward], axis=-1)
    return {"position": position.astype(np.float32), "c2w": c2w.astype(np.float32),
            "fov_deg": np.float32(fov_deg)}


def orbit(azimuth_deg: float, orbit_spec: dict) -> dict:
    az, el = math.radians(azimuth_deg), math.radians(orbit_spec["elevation_deg"])
    target = np.asarray(orbit_spec["target"], np.float64)
    eye = target + orbit_spec["radius"] * np.array([math.cos(el) * math.sin(az), math.sin(el),
                                                      math.cos(el) * math.cos(az)])
    return look_at(eye, target, fov_deg=orbit_spec["fov_deg"])


def render_views(traffic: dict, seed: int) -> tuple:
    """``(a0, cameras)`` of a render mix."""
    a0 = float(streams(seed)["views"].uniform(0.0, 360.0))
    o = traffic["orbit"]
    return a0, [orbit((a0 + o["golden_angle_deg"] * i) % 360.0, o) for i in range(traffic["views"])]


def request_views(traffic: dict, r: int) -> list:
    f, v = traffic["frames_per_request"], traffic["views"]
    return [(r * f + j) % v for j in range(f)]


def job_values(config: dict, seed: int, job: int) -> dict:
    """Job ``job``'s start: the scene's values, its jittered parameters moved."""
    ss = streams(seed)["jobs"]
    rng = np.random.default_rng(np.random.SeedSequence(ss.entropy, spawn_key=(*ss.spawn_key, job + 1)))
    return jittered(config["scene"], rng)


def reference_camera(config: dict) -> dict:
    c = config["camera"]
    return {"position": np.asarray(c["position"], np.float32), "c2w": np.asarray(c["c2w"], np.float32),
            "fov_deg": np.float32(c["fov_deg"])}
