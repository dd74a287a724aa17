"""The colonnaded hall: the frozen mesh, materials, sun and sky of
``bench_port/scene.py`` at a configuration's ``scene`` parameters
(``target_tris``, ``seed``, ``sky_resolution``, ``sun_dir``,
``turbidity``)."""

import numpy as np

from bench_port import scene


def arrays(spec: dict) -> dict:
    verts, faces, mat_ids = scene.hall_mesh(spec["target_tris"], spec["seed"])
    center, radius, color = scene.suns()
    return {"verts": verts, "faces": faces, "mat_ids": mat_ids,
            "materials": scene.HALL_MATERIALS,
            "light_center": center, "light_radius": radius,
            "light_color": color,
            "sky": scene.sky_image(spec["sky_resolution"], spec["sun_dir"],
                                   spec["turbidity"]),
            "sky_scale": np.ones((3,), np.float32)}
