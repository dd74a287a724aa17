"""Headless render CLI of the PyTorch port.

The counterpart of ``prismarine_core_tpu.cli``: every flag, default and
scene/camera choice of it, plus ``--device`` (the CUDA card unless the
caller asks for another device; no card is an error, never a silent
CPU run).  Progressive frames accumulate and the result is written as
PNG + HDR + NPY.  Every flag value of the JAX CLI renders, including
``--intersector packet``, ``--sort-mode packed|group``, ``--cull-impl
xla`` and ``--reuse-order``.

    python -m prismarine_core_tpu_torch.cli --scene hall --res 1280x720 \
        --depth 4 --frames 8 --out render.png
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prismarine-torch-render",
        description="path tracer on the CUDA card (headless)")
    p.add_argument("-m", "--model", help="OBJ or glTF file (default: a "
                   "built-in scene)")
    p.add_argument("-s", "--scale", type=float, default=1.0,
                   help="model scale")
    p.add_argument("-d", "--depth", type=int, default=4,
                   help="bounce depth")
    p.add_argument("--res", default="512x512", help="WxH")
    p.add_argument("--spp", type=int, default=1,
                   help="samples per pixel per frame")
    p.add_argument("--frames", type=int, default=8,
                   help="progressive frames to accumulate")
    p.add_argument("--out", default="render.png",
                   help="output (.png; .hdr and .npy written alongside)")
    p.add_argument("--scene", default="cornell",
                   choices=["cornell", "sunplane", "hall"],
                   help="built-in scene when no --model given")
    p.add_argument("--hall-tris", type=int, default=100_000)
    p.add_argument("--eye", default=None,
                   help="camera eye 'x,y,z' (scene default otherwise)")
    p.add_argument("--target", default=None, help="camera target 'x,y,z'")
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--env", default=None,
                   help="equirect background image (needs Pillow)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--camera-360", action="store_true")
    p.add_argument("--env-nee", action="store_true",
                   help="importance-sample the environment map's bright "
                        "texels (MIS)")
    p.add_argument("--intersector", default="pallas",
                   choices=["brute", "bvh", "packet", "pallas"],
                   help="intersection backend (default: the packet query "
                        "on the hand-written kernels)")
    p.add_argument("--coherent", action="store_true",
                   help="coherent bounce sampling: block-correlated "
                        "bounce uniforms (unbiased, direction-tight "
                        "secondary packets)")
    p.add_argument("--reuse-order", action="store_true",
                   help="reuse bounce 1's coherence sort for later "
                        "bounces (not ported)")
    p.add_argument("--sort-mode", default="full",
                   choices=["full", "packed", "group"],
                   help="ray coherence sort variant (the port runs "
                        "'full')")
    p.add_argument("--cull-impl", default="pallas2",
                   choices=["pallas2", "pallas", "xla"],
                   help="dense cull implementation: 'pallas2', the "
                        "two-level superblock cull + pair-driven block "
                        "refine, or 'pallas', the block-granular cull "
                        "('xla' is not ported)")
    p.add_argument("--strategy", default="",
                   choices=["", "single", "two_round", "rounds"],
                   help="closest-hit execution strategy override "
                        "(default: two_round)")
    p.add_argument("--strategy-k", type=int, default=16,
                   help="per-round superblock budget K for the "
                        "two_round/rounds strategies (0 = default 8)")
    p.add_argument("--cull-window", type=int, default=8192,
                   help="pair window of the JAX refine kernel (config "
                        "parity)")
    p.add_argument("--cull-pps", type=int, default=16,
                   help="pair-cull alignment of the JAX kernel (config "
                        "parity)")
    p.add_argument("--pairs-per-step", type=int, default=8,
                   help="same-tile pairs per JAX grid step (config "
                        "parity)")
    p.add_argument("--stale-round-masks", action="store_true",
                   help="keep round-0 block masks across any-hit rounds")
    p.add_argument("--rr-start-bounce", type=int, default=0,
                   help="Russian-roulette start bounce (0 = off)")
    p.add_argument("--rr-min-q", type=float, default=0.05,
                   help="Russian-roulette survival-probability floor")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card; 'cpu' "
                        "runs the kernels' plain versions)")
    return p


def _vec(s):
    return tuple(float(x) for x in s.split(","))


def _load_env_image(path: str):
    from PIL import Image
    import numpy as np
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def make_config(args):
    """The RenderConfig of parsed CLI arguments."""
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    w, h = (int(x) for x in args.res.lower().split("x"))
    return RenderConfig(width=w, height=h, spp=args.spp,
                        max_bounces=args.depth,
                        camera_360=args.camera_360,
                        env_nee=args.env_nee,
                        intersector=args.intersector,
                        coherent_bounce_sampling=args.coherent,
                        reuse_bounce_order=args.reuse_order,
                        sort_mode=args.sort_mode,
                        cull_impl=args.cull_impl,
                        cull_window=args.cull_window,
                        cull_pps=args.cull_pps,
                        closest_strategy=args.strategy,
                        closest_k=args.strategy_k,
                        pairs_per_step=args.pairs_per_step,
                        stale_round_masks=args.stale_round_masks,
                        rr_start_bounce=args.rr_start_bounce,
                        rr_min_q=args.rr_min_q)


def make_scene_camera(args, device):
    """The scene (``--model`` or ``--scene``) and camera of parsed CLI
    arguments, on ``device``."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.scene import (
        Scene, make_cornell_scene, make_sun_plane_scene)
    dev = device
    if args.model:
        from prismarine_core_tpu_torch.models.lights import SphereLights
        from prismarine_core_tpu_torch.models.textures import Environment
        if args.model.lower().endswith((".gltf", ".glb")):
            from prismarine_core_tpu_torch.models.gltf_loader import (
                load_gltf)
            soup, mats, texs = load_gltf(args.model, scale=args.scale,
                                         device=dev)
        else:
            from prismarine_core_tpu_torch.models.obj_loader import load_obj
            soup, mats, texs = load_obj(args.model, scale=args.scale,
                                        device=dev)
        env = Environment.constant((0.4, 0.55, 0.75), device=dev)
        if args.env:
            env = Environment.from_image(_load_env_image(args.env),
                                         device=dev)
        scene = Scene.assemble(soup, mats, SphereLights.suns(device=dev),
                               env, texs)
        default_eye, default_target = (3.0, 2.0, 5.0), (0.0, 0.5, 0.0)
    elif args.scene == "cornell":
        scene = make_cornell_scene(device=dev)
        default_eye, default_target = (0.0, 0.0, 3.4), (0.0, 0.0, 0.0)
    elif args.scene == "sunplane":
        scene = make_sun_plane_scene(device=dev)
        default_eye, default_target = (3.0, 2.0, 5.0), (0.0, 0.5, 0.0)
    else:
        from prismarine_core_tpu_torch.models.procedural import (
            make_hall_scene)
        scene = make_hall_scene(target_tris=args.hall_tris, device=dev)
        default_eye, default_target = (-10.0, 2.2, 0.0), (6.0, 1.6, 0.0)
    camera = Camera.look_at(
        eye=_vec(args.eye) if args.eye else default_eye,
        target=_vec(args.target) if args.target else default_target,
        fov_y_deg=args.fov, device=dev)
    return scene, camera


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    from prismarine_core_tpu_torch.render.pipeline import (
        ProgressiveRenderer)
    from prismarine_core_tpu_torch.utils.config import check_supported
    from prismarine_core_tpu_torch.utils.device import resolve_device
    from prismarine_core_tpu_torch.utils.image import (
        save_hdr, save_npy, save_png)

    cfg = make_config(args)
    try:
        check_supported(cfg)
        dev = resolve_device(None if args.device == "cuda" else args.device)
    except (ValueError, RuntimeError) as e:
        parser.exit(2, f"{parser.prog}: {type(e).__name__}: {e}\n")
    scene, camera = make_scene_camera(args, dev)

    renderer = ProgressiveRenderer(scene, camera, cfg, seed=args.seed)
    t0 = time.perf_counter()
    for i in range(args.frames):
        renderer.step()
        if i == 0:
            first = renderer.snapshot()          # waits for the frame
            print(f"[render] first frame {time.perf_counter() - t0:.1f}s "
                  f"(incl. the kernels' build) on {dev}, mean "
                  f"{first.mean():.4f}", file=sys.stderr)
    img = renderer.snapshot()
    dt = time.perf_counter() - t0
    print(f"[render] {args.frames} frames ({renderer.sample_count} spp) "
          f"in {dt:.1f}s; mean={img.mean():.4f}", file=sys.stderr)

    base = args.out.rsplit(".", 1)[0]
    save_png(args.out, img)
    save_hdr(base + ".hdr", img)
    save_npy(base + ".npy", img)
    print(f"[render] wrote {args.out}, {base}.hdr, {base}.npy",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
