"""Device busy of the bench frame and of one variant of it, from the
``chip_smoke.py`` of the checkout given: one turn of an alternating
comparison of two checkouts on one card (run it as parent, change, change,
parent).  Each frame is rendered once, then profiled three times
(``chip_smoke.profile_once``); the last line is the busy ms as JSON.

    python3 tests/torch_alternate_turns.py CHECKOUT LABEL [FIELD=VALUE ...]

``FIELD=VALUE`` pairs make the variant (``RenderConfig.replace``), for
example ``sort_mode=group``.  Needs a CUDA card; imports no JAX.
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


def main(argv) -> int:
    checkout, label, *pairs = argv
    sys.path.insert(0, checkout)
    import torch
    import chip_smoke as cs
    from prismarine_core_tpu_torch import _build
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    _build.build()
    _build.library()
    dev = torch.device("cuda", 0)
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
    print(f"[turns] {label} {json.dumps(out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
