"""The textured hall's frozen inputs: its texcoords and its PBR texture
set, as plain numpy arrays.

A frozen copy of the port's textured hall
(``prismarine_core_tpu_torch/models/procedural.py:make_hall_scene`` with
``textured=True``: the oblique planar texcoords; ``_procedural_textures``:
the value-noise octaves, the albedo formulas and the height-derived normal
map), so a later change to the port's generator cannot move the
benchmark's inputs; ``procedural_textures`` puts the frozen parts together
as the port does, and equals its maps on the same seed
(``tests/test_torch_textured_bench.py``).  Nothing here imports the port or
torch.

``pbr_set`` draws the configuration's texture set from those parts: each
of the hall's six materials binds a diffuse map (checker or stone albedo),
a specular map (R 1, G the roughness scale, B the metallic scale, each in
[0.3, 1]) and a bump map (a tangent-space normal map from a noise height
field), the way a glTF PBR material binds its base-colour,
roughness/metallic and normal maps.
"""

from __future__ import annotations

import numpy as np

#: the texture kinds a material binds here, in the order of the stack:
#: the diffuse maps of every material, then their specular maps, then
#: their bump maps
KINDS = ("tex_diffuse", "tex_specular", "tex_bump")
#: the lowest roughness and metallic scale a specular map holds
SCALE_LO = 0.3


def hall_texcoords(verts: np.ndarray) -> np.ndarray:
    """The oblique planar projection of the textured hall, f32[V,2]:
    u = 0.25 (x + 0.3 z), v = 0.25 (y + 0.7 z), non-degenerate on every
    wall, floor and column orientation."""
    return np.stack([0.25 * (verts[:, 0] + 0.3 * verts[:, 2]),
                     0.25 * (verts[:, 1] + 0.7 * verts[:, 2])],
                    axis=1).astype(np.float32)


def fbm(rng, n: int, octaves: int = 5, base: int = 8) -> np.ndarray:
    """Tileable value noise f64[n,n] in [0,1]: ``octaves`` bilinear
    octaves of a standard-normal lattice, ``base`` cells at the first and
    twice as many at each next one, amplitude halving."""
    acc = np.zeros((n, n))
    amp = 1.0
    for o in range(octaves):
        cells = base * (2 ** o)
        g = rng.standard_normal((cells + 1, cells + 1))
        g[-1, :] = g[0, :]
        g[:, -1] = g[:, 0]
        yy = np.linspace(0, cells, n, endpoint=False)
        y0 = yy.astype(int)
        fy = (yy - y0)[:, None]
        fx = (yy - y0)[None, :]
        a = g[np.ix_(y0, y0)]
        b = g[np.ix_(y0, y0 + 1)]
        c = g[np.ix_(y0 + 1, y0)]
        d = g[np.ix_(y0 + 1, y0 + 1)]
        acc += amp * ((a * (1 - fx) + b * fx) * (1 - fy)
                      + (c * (1 - fx) + d * fx) * fy)
        amp *= 0.5
    acc -= acc.min()
    return acc / max(acc.max(), 1e-6)


def checker_albedo(rng, n: int) -> np.ndarray:
    """The floor's albedo f64[n,n,3]: an 8x8 checker with noise."""
    y = np.arange(n)
    checker = ((y[:, None] // (n // 8) + y[None, :] // (n // 8)) % 2
               ).astype(np.float64)
    return (0.35 + 0.3 * checker + 0.2 * fbm(rng, n))[..., None] \
        * np.array([1.0, 0.93, 0.82])


def stone_albedo(rng, n: int, base: int = 4, tint=(0.95, 0.9, 0.85)):
    """A stone albedo f64[n,n,3]: noise at ``base`` cells, tinted."""
    return (0.45 + 0.4 * fbm(rng, n, base=base))[..., None] \
        * np.asarray(tint)


def marble_albedo(rng, n: int) -> np.ndarray:
    """The columns' albedo f64[n,n,3]: sine veins bent by noise."""
    y = np.arange(n)
    return (0.5 + 0.45 * np.abs(
        np.sin(6.0 * np.pi * (y[None, :] / n + 0.6 * fbm(rng, n, base=2)))
    ))[..., None] * np.array([0.9, 0.88, 0.85])


def normal_map(height: np.ndarray) -> np.ndarray:
    """The tangent-space normal map f64[n,n,3] (xyz * 0.5 + 0.5) of a
    height field, from its wrapped central differences."""
    dhdx = np.roll(height, -1, 1) - np.roll(height, 1, 1)
    dhdy = np.roll(height, -1, 0) - np.roll(height, 1, 0)
    nrm = np.stack([-dhdx * 4.0, -dhdy * 4.0, np.ones_like(height)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return nrm * 0.5 + 0.5


def procedural_textures(resolution: int = 512, seed: int = 7) -> list:
    """The port's textured-hall maps [checker floor, wall stone, column
    marble, normal map], each f32[n,n,3], drawn as the port draws them."""
    rng = np.random.default_rng(seed)
    n = resolution
    maps = [checker_albedo(rng, n), stone_albedo(rng, n),
            marble_albedo(rng, n), normal_map(fbm(rng, n, base=6))]
    return [m.astype(np.float32) for m in maps]


def pbr_set(resolution: int, seed: int, n_materials: int = 6):
    """The configuration's texture set: (images, bindings).  ``images``
    lists f32[n,n,3] maps, the ``n_materials`` diffuse maps, then their
    specular maps, then their bump maps; ``bindings[m]`` is material m's
    {kind: texture id} for each of ``KINDS``.  Material 0 (the floor)
    takes the checker, 2 (the columns) the marble, every other a stone of
    its own scale; every map is drawn from ``seed``."""
    rng = np.random.default_rng([seed, 1])
    n = resolution
    diffuse, specular, bump = [], [], []
    for m in range(n_materials):
        if m == 0:
            diffuse.append(checker_albedo(rng, n))
        elif m == 2:
            diffuse.append(marble_albedo(rng, n))
        else:
            diffuse.append(stone_albedo(rng, n, base=2 + m))
        rough = SCALE_LO + (1.0 - SCALE_LO) * fbm(rng, n, base=4)
        metal = SCALE_LO + (1.0 - SCALE_LO) * fbm(rng, n, base=3)
        specular.append(np.stack([np.ones_like(rough), rough, metal], -1))
        bump.append(normal_map(fbm(rng, n, base=4 + m)))
    images = [x.astype(np.float32) for x in diffuse + specular + bump]
    bindings = [{kind: k * n_materials + m for k, kind in enumerate(KINDS)}
                for m in range(n_materials)]
    return images, bindings
