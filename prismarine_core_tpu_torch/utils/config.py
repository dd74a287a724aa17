"""Render configuration — the port's copy of ``prismarine_core_tpu.utils.config``.

Every field of ``RenderConfig`` keeps its name and default, so one set of
values drives both packages in the parity tests.  The port runs every value of
every knob that the JAX package defines; ``check_supported`` raises
``ValueError`` for a value that neither package defines.
"""

from __future__ import annotations

import dataclasses

PZERO = 0.0005          # ray-offset epsilon
GAP = 2.0 * PZERO       # surface spawn offset
INF_DIST = 10000.0      # "infinity" hit distance

#: uniforms consumed per bounce / per camera ray (slot layout:
#: ops/sampling.py)
SAMPLES_PER_BOUNCE = 11
SAMPLES_PER_CAMERA_RAY = 4
#: the pair intersector's forms (ops/sb_intersect.py)
KERNEL_FORMS = ("mt", "mt2", "mxu")
#: the packet query's execution strategies ("" = the query type's
#: default: "two_round" for closest hits, "rounds" for any-hit)
STRATEGIES = ("", "single", "two_round", "rounds")
#: the packet query's dense culls ("xla" computes "pallas2"'s functions:
#: accel/packet.py) and two_round's round-2 re-culls under "pallas"
CULL_IMPLS = ("pallas", "pallas2", "xla")
RECULLS = ("sb", "kernel", "tn")
#: the coherence sort's variants (accel/packet.py:_coherence_perm)
SORT_MODES = ("full", "packed", "group")
INTERSECTORS = ("brute", "bvh", "packet", "pallas", "pallas_sharded")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings; field meanings as in the JAX package."""

    width: int = 256
    height: int = 256
    max_bounces: int = 4
    spp: int = 1
    #: next-event estimation toward the sphere lights
    direct_light: bool = True
    #: next-event estimation toward the environment's bright texels,
    #: MIS-weighted against the cosine bounce
    env_nee: bool = False
    camera_360: bool = False
    interlace: bool = False
    dof: bool = False
    dof_focus_radius: float = 10.0
    dof_focal_radius: float = 1.0 / 16.0
    #: kill rays whose throughput falls below this
    min_throughput: float = 1e-4
    rr_start_bounce: int = 0
    rr_min_q: float = 0.05
    ior: float = 1.4
    #: triangle-block size of the brute-force intersector
    tri_block: int = 512
    bvh_leaf_size: int = 4
    #: "brute" | "bvh" (the skip-link walk, accel/traverse.py) | "packet"
    #: (the tile-frustum packet query, accel/packet.py) | "pallas" (the
    #: packet query on the hand-written kernels, accel/packet.py) |
    #: "pallas_sharded" (the packet query over the superblock ranges of
    #: ``mesh``, parallel/shard_intersect.py)
    intersector: str = "bvh"
    #: the device mesh of "pallas_sharded" (parallel/mesh.py:make_mesh)
    mesh: object = None
    traverse_chunk: int = 0
    #: "bicubic", else bilinear
    texture_filter: str = "bilinear"
    samples_lock: int = 0
    coherent_bounce_sampling: bool = False
    reuse_bounce_order: bool = False
    sort_rays: bool = False
    cull_impl: str = "pallas"
    #: pair window of the JAX refine kernel; the port runs each pair list
    #: in one launch, so this only exists for config parity
    cull_window: int = 4096
    #: pair-list alignment of the JAX two-level cull; the port's kernels
    #: take unaligned lists, so this only exists for config parity
    cull_pps: int = 0
    #: pair-intersector form: "mt" (elementwise), "mt2" (elementwise, two
    #: sub-blocks of a ray tile per stage of the walk as two chains, the
    #: same result bit for bit) or "mxu" (determinant form on coefficient
    #: planes)
    kernel_form: str = "mt"
    anyhit_cull_impl: str = ""
    primary_identity: bool = False
    primary_tile_order: bool = False
    sort_mode: str = "full"
    recull: str = "sb"
    stale_round_masks: bool = False
    near_frac: float = 0.0
    #: pair window of the JAX intersect kernel (config parity only)
    kernel_window: int = 1024
    #: same-tile pairs per JAX grid step (config parity only: the port's
    #: intersect kernel walks a tile's whole pair run in one block)
    pairs_per_step: int = 1
    closest_strategy: str = ""
    closest_k: int = 0
    anyhit_strategy: str = ""
    anyhit_k: int = 0

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    @property
    def n_rays(self) -> int:
        return self.width * self.height * self.spp

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: RenderConfig) -> None:
    """Raise ValueError for a knob value that no package defines, and for
    "pallas_sharded" without a mesh."""
    if cfg.intersector not in INTERSECTORS:
        raise ValueError(f"unknown intersector {cfg.intersector!r}")
    if cfg.intersector == "pallas_sharded" and cfg.mesh is None:
        raise ValueError("intersector='pallas_sharded' needs cfg.mesh "
                         "(parallel.mesh.make_mesh)")
    if cfg.intersector in ("pallas", "pallas_sharded"):
        check_query_knobs(
            cull_impl=cfg.cull_impl, sort_mode=cfg.sort_mode,
            kernel_form=cfg.kernel_form,
            anyhit_cull_impl=cfg.anyhit_cull_impl, recull=cfg.recull,
            strategies=(cfg.closest_strategy, cfg.anyhit_strategy or
                        "rounds"))


def check_query_knobs(cull_impl="pallas", sort_mode="full",
                      kernel_form="mt", anyhit_cull_impl="", recull="sb",
                      strategies=()) -> None:
    """The packet-query subset of ``check_supported``."""
    for knob, impl in (("cull_impl", cull_impl),
                       ("anyhit_cull_impl", anyhit_cull_impl or cull_impl)):
        if impl not in CULL_IMPLS:
            raise ValueError(f"{knob}={impl!r} is none of {CULL_IMPLS}")
    if recull not in RECULLS:
        raise ValueError(f"recull={recull!r} is none of {RECULLS}")
    if sort_mode not in SORT_MODES:
        raise ValueError(f"sort_mode={sort_mode!r} is none of {SORT_MODES}")
    if kernel_form not in KERNEL_FORMS:
        raise ValueError(f"kernel_form={kernel_form!r} is none of "
                         f"{KERNEL_FORMS}")
    for s in strategies:
        if s not in STRATEGIES:
            raise ValueError(f"strategy={s!r} is none of {STRATEGIES}")
