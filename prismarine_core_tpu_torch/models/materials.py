"""Material table — a dense SoA table indexed by ``mat_id``.

The counterpart of ``prismarine_core_tpu.models.materials``.  Texture
bindings are indices into a texture stack (-1 = none); ``kinds_bound``
records per kind (diffuse, specular, emissive, bump) whether any material
binds one.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from prismarine_core_tpu_torch.utils.device import resolve_device
from prismarine_core_tpu_torch.utils.math import take_rows

_ARRAY_FIELDS = ("diffuse", "specular", "emissive", "transmission", "ior",
                 "tex_diffuse", "tex_specular", "tex_emissive", "tex_bump")


@dataclasses.dataclass
class MaterialTable:
    diffuse: torch.Tensor       # f32[M,4] rgb + alpha
    specular: torch.Tensor      # f32[M,4] y = roughness, z = metallic
    emissive: torch.Tensor      # f32[M,4]
    transmission: torch.Tensor  # f32[M,4] pass-through tint (0 = none)
    ior: torch.Tensor           # f32[M]
    tex_diffuse: torch.Tensor   # i32[M], -1 = none
    tex_specular: torch.Tensor
    tex_emissive: torch.Tensor
    tex_bump: torch.Tensor

    @property
    def kinds_bound(self) -> tuple:
        """Per kind (diffuse, specular, emissive, bump): does any
        material bind a texture?  Computed from the current ids, so a
        replaced id array never leaves a stale flag; one host sync."""
        return tuple(torch.stack([
            (a >= 0).any() for a in (self.tex_diffuse, self.tex_specular,
                                     self.tex_emissive, self.tex_bump)
        ]).tolist())

    def lookup(self, mat_id: torch.Tensor) -> "MaterialTable":
        """Gather per-ray material records (mat_id: int64[R])."""
        return MaterialTable(**{f: take_rows(getattr(self, f), mat_id)
                                for f in _ARRAY_FIELDS})

    @staticmethod
    def build(mats: Sequence[dict], device=None) -> "MaterialTable":
        """From dicts with keys diffuse/alpha/roughness/metallic/emissive/
        transmission/ior/tex_*; missing keys get the reference defaults.
        ``device`` None is the CUDA card."""
        device = resolve_device(device)
        m = len(mats)
        diffuse = np.zeros((m, 4), np.float32)
        specular = np.zeros((m, 4), np.float32)
        emissive = np.zeros((m, 4), np.float32)
        transmission = np.zeros((m, 4), np.float32)
        ior = np.full((m,), 1.0, np.float32)
        tex = {k: np.full((m,), -1, np.int32) for k in
               ("tex_diffuse", "tex_specular", "tex_emissive", "tex_bump")}
        for i, d in enumerate(mats):
            diffuse[i, :3] = d.get("diffuse", (0.0, 0.0, 0.0))
            diffuse[i, 3] = d.get("alpha", 1.0)
            specular[i, 1] = d.get("roughness", 0.0001)
            specular[i, 2] = d.get("metallic", 0.0)
            emissive[i, :3] = d.get("emissive", (0.0, 0.0, 0.0))
            transmission[i, :3] = d.get("transmission", (0.0, 0.0, 0.0))
            ior[i] = d.get("ior", 1.0)
            for k in tex:
                tex[k][i] = d.get(k, -1)

        def t(a):
            return torch.as_tensor(a, device=device)

        return MaterialTable(diffuse=t(diffuse), specular=t(specular),
                             emissive=t(emissive),
                             transmission=t(transmission), ior=t(ior),
                             **{k: t(v) for k, v in tex.items()})
