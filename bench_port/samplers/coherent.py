"""Block-coherent bounce samples: every ray of a ``block`` (rows, columns)
pixel block of an spp plane shares its bounce rows
(``{"kind": "coherent", "block": [64, 64]}``)."""

from bench_port import sampling


def draw(spec: dict, render: dict, gen, device):
    return sampling.coherent_samples(
        gen, render["width"], render["height"], render.get("spp", 1),
        render.get("max_bounces", 4), tuple(spec["block"]), device)
