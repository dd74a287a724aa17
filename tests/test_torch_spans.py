"""The port's spans (``utils/profiling.py:span``): counts always, profiler
ranges only while a profiler records, the frame's span tree, and an image
that does not change with the profiler on.

The module imports no jax, so its card test runs without the JAX test
harness there:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from prismarine_core_tpu_torch.models import procedural as proc  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.ops.sampling import (  # noqa: E402
    make_sample_arrays)
from prismarine_core_tpu_torch.render.integrator import (  # noqa: E402
    render_with_samples)
from prismarine_core_tpu_torch.utils import profiling  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402

# the CPU frames are thousands of small ops: one thread runs them fastest
torch.set_num_threads(1)

#: the benchmark's "pallas" configuration (bench.py's main RenderConfig),
#: with a round-1 budget of 2 so the small hall takes both rounds
PALLAS = dict(intersector="pallas", pairs_per_step=8, stale_round_masks=True,
              anyhit_strategy="single", cull_impl="pallas2", closest_k=2,
              cull_window=8192, cull_pps=16, kernel_form="mt")
INTERSECTORS = {"bvh": dict(intersector="bvh"), "pallas": PALLAS}


def hall(dev, target_tris=3000):
    """The benchmark's hall, sky and camera at a small size on ``dev``."""
    scene = proc.make_hall_scene(target_tris=target_tris, device=dev)
    scene = dataclasses.replace(scene, environment=proc.make_sky_environment(
        resolution=32, device=dev))
    cam = Camera.look_at((-10.0, 2.2, 0.0), (6.0, 1.6, 0.0), (0.0, 1.0, 0.0),
                         fov_y_deg=60.0, device=dev)
    return scene, cam


def frame_inputs(dev, intersector, width=48, height=27, target_tris=3000):
    scene, cam = hall(dev, target_tris)
    cfg = RenderConfig(width=width, height=height, spp=1, max_bounces=4,
                       direct_light=True, bvh_leaf_size=4,
                       **INTERSECTORS[intersector])
    gen = torch.Generator(device=dev).manual_seed(0)
    samples = make_sample_arrays(gen, cfg.n_rays, cfg.max_bounces,
                                 device=dev)
    return scene, cam, cfg, samples


def span_tree(prof):
    """The ``pc.*`` ranges of a profile as nested (name, children) tuples,
    each range's parent the innermost ``pc.*`` range around it (the
    host ranges of one thread nest).  Read from the profiler's raw
    events: the frame's plain BVH walk records ~450,000 ops on the CPU."""
    spans = sorted(((e.name(), e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("pc.")),
                   key=lambda e: (e[1], -e[2]))
    roots, stack = [], []
    for name, start, end in spans:
        while stack and stack[-1][1] < start:
            stack.pop()
        node = (name, [])
        (stack[-1][0][1] if stack else roots).append(node)
        stack.append((node, end))

    def frozen(nodes):
        return tuple((name, frozen(kids)) for name, kids in nodes)
    return frozen(roots)


def expected_tree(intersector, n_sb):
    """The frame's span tree on the CPU (no kernel spans there): under
    "pallas" the closest query sorts and compacts once a round (two
    rounds when the scene has more superblocks than ``closest_k``), the
    shadow query reuses the sort and compacts once."""
    reeval = ("pc.reeval", ())
    if intersector == "bvh":
        closest, shadow = (reeval,), ()
    else:
        rounds = 2 if n_sb > PALLAS["closest_k"] else 1
        compact = ("pc.sync.compact", ())
        closest = (("pc.sort", ()),) + (compact,) * rounds + (reeval,)
        shadow = (compact,)
    bounce = ("pc.bounce", (("pc.query.closest", closest),
                            ("pc.surface", ()),
                            ("pc.nee", (("pc.query.shadow", shadow),))))
    return (("pc.frame", (("pc.camera", ()),) + (bounce,) * 4
             + (("pc.env", ()), ("pc.image", ()))),)


def test_span_counts_without_a_profiler(monkeypatch):
    """No profiler recording: no profiler range opened, one count a span
    entered."""
    def refuse(*a, **kw):
        raise AssertionError("a profiler range opened without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_range", refuse)
    before = profiling.counts["pc.test.plain"]
    for _ in range(3):
        with profiling.span("pc.test.plain"):
            pass
    assert profiling.counts["pc.test.plain"] - before == 3

    scene, cam, cfg, samples = frame_inputs("cpu", "bvh", 16, 9)
    frames = profiling.counts["pc.frame"]
    bounces = profiling.counts["pc.bounce"]
    render_with_samples(scene, cam, cfg, *samples)
    assert profiling.counts["pc.frame"] - frames == 1
    assert profiling.counts["pc.bounce"] - bounces == 4


def test_span_opens_a_range_under_the_profiler():
    """Under the profiler a span is an op-scope range (no user
    annotation, whose device-side copy the profiler lists among the
    device's ops), and the ops inside it are its children."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pc.test.outer"):
            with profiling.span("pc.test.inner"):
                torch.ones(4).sum()
    assert span_tree(prof) == (("pc.test.outer",
                                (("pc.test.inner", ()),)),)
    events = {e.name: e for e in prof.events()}
    assert not events["pc.test.inner"].is_user_annotation
    assert events["aten::sum"].cpu_parent.name == "pc.test.inner"


@pytest.mark.parametrize("intersector", ["bvh", "pallas"])
def test_frame_span_tree(intersector):
    """A 48x27 hall frame under the CPU profiler: the frame's phases
    nest as the table of spans says, each entered span is counted once,
    and the image equals the frame rendered without a profiler."""
    scene, cam, cfg, samples = frame_inputs("cpu", intersector)
    plain = render_with_samples(scene, cam, cfg, *samples)
    before = dict(profiling.counts)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        img = render_with_samples(scene, cam, cfg, *samples)
    assert torch.equal(img, plain)

    tree = span_tree(prof)
    assert tree == expected_tree(intersector, scene.packets.n_superblocks)
    seen = {}

    def tally(nodes):
        for name, kids in nodes:
            seen[name] = seen.get(name, 0) + 1
            tally(kids)
    tally(tree)
    counted = {k: v - before.get(k, 0) for k, v in profiling.counts.items()
               if v != before.get(k, 0)}
    assert counted == seen
    rounds = 2 if scene.packets.n_superblocks > PALLAS["closest_k"] else 1
    assert counted.get("pc.sync.compact", 0) == (
        0 if intersector == "bvh" else 4 * (rounds + 1))


@pytest.mark.gpu
@pytest.mark.parametrize("intersector", ["bvh", "pallas"])
def test_launches_inside_the_frame_hold_its_device_time(intersector):
    """On the card, a traced hall frame that starts after a device sync:
    the device time of the kernels launched by host events that start
    inside ``pc.frame`` (the port's own raw launches included, through
    their ``pc.kernel.*`` spans) is the device time of every device op of
    the profile, within 2%."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    dev = torch.device("cuda", 0)
    scene, cam, cfg, samples = frame_inputs(dev, intersector, 320, 180,
                                            20000)
    render_with_samples(scene, cam, cfg, *samples)     # builds, packs
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_with_samples(scene, cam, cfg, *samples)
        torch.cuda.synchronize(dev)
    events = list(prof.events())
    cuda = torch.autograd.DeviceType.CUDA
    frame = [e for e in events if e.name == "pc.frame"]
    assert len(frame) == 1 and frame[0].device_type != cuda
    lo, hi = frame[0].time_range.start, frame[0].time_range.end
    launched = sum(k.duration for e in events if e.device_type != cuda
                   and lo <= e.time_range.start <= hi for k in e.kernels)
    device = sum(e.time_range.end - e.time_range.start for e in events
                 if e.device_type == cuda)
    assert device > 0
    assert abs(launched - device) <= 0.02 * device, (launched, device)
    kernels = [e for e in events if e.name.startswith("pc.kernel.")]
    assert kernels and all(e.kernels for e in kernels)
