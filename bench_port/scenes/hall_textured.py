"""The textured PBR hall: the colonnaded hall of ``hall.py`` with the
textured hall's texcoords and a diffuse, a specular and a bump map on
every material (``bench_port/texture_maps.py``), at a configuration's
``scene`` parameters (those of ``hall.py``, plus ``texture_resolution``,
the maps' side).  The maps are drawn from the scene's ``seed``."""

from bench_port import plugins, scene, texture_maps


def arrays(spec: dict) -> dict:
    out = plugins.load("scenes", "hall").arrays(spec)
    images, bindings = texture_maps.pbr_set(spec["texture_resolution"],
                                            spec["seed"],
                                            len(scene.HALL_MATERIALS))
    out.update(
        texcoords=texture_maps.hall_texcoords(out["verts"]),
        textures=images,
        materials=tuple(dict(m, **b) for m, b in
                        zip(scene.HALL_MATERIALS, bindings)))
    return out
