"""One turn of an alternating comparison of two checkouts on one card (run
it as parent, change, change, parent), from the ``chip_smoke.py`` of the
checkout given.  The last line is the turn's numbers as JSON.

    python3 tests/torch_alternate_turns.py CHECKOUT LABEL [FIELD=VALUE ...]
    python3 tests/torch_alternate_turns.py CHECKOUT LABEL walk

Frame mode: the device busy of the bench frame and of one variant of it.
Each frame is rendered once, then profiled three times
(``chip_smoke.profile_once``).  ``FIELD=VALUE`` pairs make the variant
(``RenderConfig.replace``), for example ``sort_mode=group``.

Walk mode: CUDA-event times of the BVH walk kernel at the bench frame's
bounce-1 rays under intersector "bvh" (``chip_smoke.first_bounce``,
``record_walks``), in 5 alternating turns of 10 launches: the closest
walk at every cap INF_DIST, with the bounce's cap (dead lanes 0), on
coherence-sorted rays (every cap INF_DIST), and the shadow walk, after
holding the closest (every cap INF_DIST) and the shadow walk equal to
the plain walk on (t, slot).

Needs a CUDA card; imports no JAX.
"""

import json
import sys


def value(text):
    for kind in (int, float):
        try:
            return kind(text)
        except ValueError:
            pass
    return {"True": True, "False": False}.get(text, text)


def frame_turn(cs, dev, label, pairs):
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    scene, cam, cfg = cs.bench_setup(dev)
    variant = cfg.replace(**dict((k, value(v)) for k, v in
                                 (p.split("=", 1) for p in pairs)))
    out = {}
    for name, c in (("frame", cfg), ("variant", variant)):
        cam_s, bounce_s = cs.frame_samples(c, dev)

        def frame():
            return render_with_samples(scene, cam, c, cam_s, bounce_s)

        out[name + "_mean"] = float(frame().mean())
        out[name] = [cs.profile_once(frame, f"{label} {name}")["busy_ms"]
                     for _ in range(3)]
    return out


def walk_turn(cs, dev, label):
    import torch
    from prismarine_core_tpu_torch.accel import traverse as tr
    from prismarine_core_tpu_torch.ops import bvh_walk as bw
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    scene, cam, cfg = cs.bench_setup(dev)
    _, _, _, carry1, bounce_s = cs.first_bounce(scene, cam, cfg, dev)
    (bvh, co, cd, _, _), (_, so, sd, st, _) = cs.record_walks(
        scene, cfg.replace(intersector="bvh"), carry1, bounce_s[1])
    inf = torch.full((co.shape[0],), INF_DIST, device=dev)
    capped = torch.where(carry1[4], INF_DIST, 0.0)
    perm = torch.sort(tr._ray_sort_keys(bvh, co, cd), stable=True)[1]
    po, pd = co[perm].contiguous(), cd[perm].contiguous()
    for args in ((co, cd, inf, False), (so, sd, st, True)):
        got = bw.bvh_walk(bvh, *args)
        ref = bw.bvh_walk_plain_hits(bvh, *args)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise RuntimeError(f"{label}: the walk != its plain version")
    med, runs = cs.alternating_ms({
        "closest": lambda: bw.bvh_walk(bvh, co, cd, inf),
        "closest_capped": lambda: bw.bvh_walk(bvh, co, cd, capped),
        "closest_sorted": lambda: bw.bvh_walk(bvh, po, pd, inf),
        "shadow": lambda: bw.bvh_walk(bvh, so, sd, st, True)})
    return {"ms": med,
            "turns_ms": {k: [round(x, 4) for x in v]
                         for k, v in runs.items()},
            "dead_share": float((capped <= 0).float().mean())}


def main(argv) -> int:
    checkout, label, *pairs = argv
    sys.path.insert(0, checkout)
    import torch
    import chip_smoke as cs
    from prismarine_core_tpu_torch import _build
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
    if pairs == ["walk"]:
        out = walk_turn(cs, dev, label)
        print(f"[walk turns] {label} {json.dumps(out)}", flush=True)
    else:
        out = frame_turn(cs, dev, label, pairs)
        print(f"[turns] {label} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
