"""Independent bounce samples, the CLI's default
(``{"kind": "independent"}``)."""

from bench_port import sampling


def draw(spec: dict, render: dict, gen, device):
    n_rays = render["width"] * render["height"] * render.get("spp", 1)
    return sampling.independent_samples(gen, n_rays,
                                        render.get("max_bounces", 4), device)
