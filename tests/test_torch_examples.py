"""The port's example programs (``prismarine_core_tpu_torch/examples/``) on
the CPU, against the JAX package's scripts where they have a loop to hold
them to.

- Inverse rendering: the loop of ``examples/inverse_rendering.py:41-73``
  (a closure there, so rebuilt here from the package: ``render_with_samples``
  on cornell under "bvh", ``optax.adam(5e-2)``, jit) against the port's
  ``recover_albedo`` on the same JAX-made samples and initial table, at
  12x12, 2 spp, 2 bounces, 3 steps.  The two differ by float32 rounding
  (XLA on the CPU contracts multiply-adds into FMAs, torch does not), so
  the first gradient is held to relative L2 1e-4, each step's loss to
  rtol 1e-4 and each step's table to atol 1e-4.  Adam's first update is
  about -lr * sign(g), so a component whose gradient is near zero could
  move 2 lr apart between the packages; the test counts the components
  with |g| < 1e-6 and requires their signs to agree where |g| >= 1e-9.
- The studies: one frame of each mode through the port's study frame
  function, with JAX's sample arrays put in its place, against JAX's
  ``render_with_samples`` at the scripts' configurations on a small hall
  (3,000 target triangles, 32x18).  Image gate of
  tests/test_torch_render.py: >= 98% of pixels ``isclose(rtol=1e-3,
  atol=1e-3)`` and the mean within 0.5%.  JAX's "pallas" frames run in
  interpret mode; their compiles are most of this file's time, so they
  run in threads (XLA compiles release the interpreter lock) while the
  inverse loop runs beside them, and the coherent mode's JAX frame takes
  the independent mode's compiled function: JAX's
  ``render_with_samples`` reads no ``coherent_bounce_sampling`` (only
  ``render`` does, ``prismarine_core_tpu/render/integrator.py:672``).
- The seeds, the loop's arithmetic (float64 mean, MSE and the reference's
  variance term against numpy), each ``main`` at a small size with
  ``--cpu``, and each ``main`` refusing to run with neither ``--cpu`` nor
  a card.
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from prismarine_core_tpu.models import procedural as jproc  # noqa: E402
from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops.sampling import (  # noqa: E402
    make_coherent_sample_arrays, make_sample_arrays)
from prismarine_core_tpu.render.integrator import (  # noqa: E402
    render_with_samples as j_render)
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.examples import (  # noqa: E402
    coherent_quality_ab as qab, inverse_rendering as inv, quality as q,
    r5_refit_bench as refit, r6_rr_quality as rrq)
from prismarine_core_tpu_torch.render.integrator import (  # noqa: E402
    render_with_samples)
from tests.test_torch_render import assert_image_parity  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"

#: the inverse-rendering comparison's size and bounds (module docstring)
INV_RES, INV_STEPS = 12, 3
GRAD_REL_L2, LOSS_RTOL, TABLE_ATOL = 1e-4, 1e-4, 1e-4
#: the studies' small hall and frame
HALL_TRIS, W, H = 3000, 32, 18
#: the frames' JAX keys, and the coherent study's block (its default)
FRAME_KEY, QAB_BLOCK = 5, 16
STUDY_MODES = ("rr-off", "rr-2", "coherent", "independent")


def _jax_config(cfg) -> JConfig:
    """The JAX RenderConfig with the port config's fields (both packages'
    fields share names and defaults)."""
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def _jax_inverse_loop():
    """``examples/inverse_rendering.py:41-73`` at INV_RES and INV_STEPS:
    (samples, init, per-step losses, gradients and tables)."""
    cfg = JConfig(width=INV_RES, height=INV_RES, spp=2, max_bounces=2)
    cam = JCamera.look_at(eye=(0, 0, 3.4), target=(0, 0, 0), fov_y_deg=50)
    scene = j_cornell()
    cam_s, bounce_s = make_sample_arrays(jax.random.key(0), cfg.n_rays,
                                         cfg.max_bounces)
    target = j_render(scene, cam, cfg, cam_s, bounce_s)
    init = scene.materials.diffuse.at[:, :3].set(0.5)

    def loss_fn(diffuse):
        s = dataclasses.replace(scene, materials=dataclasses.replace(
            scene.materials, diffuse=diffuse))
        return jnp.mean((j_render(s, cam, cfg, cam_s, bounce_s)
                         - target) ** 2)

    opt = optax.adam(5e-2)

    @jax.jit
    def step(diffuse, state):
        loss, g = jax.value_and_grad(loss_fn)(diffuse)
        updates, state = opt.update(g, state)
        return optax.apply_updates(diffuse, updates), state, loss, g

    diffuse, state = init, opt.init(init)
    losses, grads, tables = [], [], []
    for _ in range(INV_STEPS):
        diffuse, state, loss, g = step(diffuse, state)
        losses.append(float(loss))
        grads.append(np.asarray(g))
        tables.append(np.asarray(diffuse))
    return dict(samples=(np.asarray(cam_s), np.asarray(bounce_s)),
                init=np.asarray(init), losses=np.array(losses),
                grads=grads, tables=tables)


def _study_configs():
    """mode -> (port RenderConfig, the coherent block or None)."""
    rr = rrq.configs(W, H)
    cfg = qab.config(W, H)
    return {"rr-off": (rr["rr-off"], rrq.BLOCK),
            "rr-2": (rr["rr-2"], rrq.BLOCK),
            "coherent": (qab.mode_config(cfg, "coherent"),
                         (QAB_BLOCK, QAB_BLOCK)),
            "independent": (cfg, None)}


def _jax_samples(cfg, block):
    key = jax.random.key(FRAME_KEY)
    if block is None:
        return make_sample_arrays(key, cfg.n_rays, cfg.max_bounces)
    return make_coherent_sample_arrays(key, _jax_config(cfg), block=block)


def _jax_study_frames():
    """The four study frames on JAX's small hall (numpy), and their sample
    arrays: the hall first, then one thread per compiled frame function."""
    hall = dataclasses.replace(
        jproc.make_hall_scene(target_tris=HALL_TRIS),
        environment=jproc.make_sky_environment(resolution=q.SKY_RESOLUTION))
    cam = JCamera.look_at(eye=q.EYE, target=q.TARGET, fov_y_deg=q.FOV_Y_DEG)
    configs = _study_configs()
    samples = {m: tuple(np.asarray(a) for a in _jax_samples(*configs[m]))
               for m in STUDY_MODES}

    def frames(*modes):
        # one compiled function: JAX's render_with_samples reads no
        # coherent_bounce_sampling
        jcfg = dataclasses.replace(_jax_config(configs[modes[0]][0]),
                                   coherent_bounce_sampling=False)
        return {m: np.asarray(j_render(hall, cam, jcfg, *samples[m]))
                for m in modes}

    out = {}
    with ThreadPoolExecutor(3) as pool:
        for job in [pool.submit(frames, "rr-off"),
                    pool.submit(frames, "rr-2"),
                    pool.submit(frames, "independent", "coherent")]:
            out.update(job.result())
    return dict(frames=out, samples=samples)


@pytest.fixture(scope="module", autouse=True)
def jax_runs():
    """The JAX inverse loop and study frames as futures, started in
    background threads when the module's first test runs; the tests that
    read them come last in this file, so the port-only tests run
    meanwhile."""
    pool = ThreadPoolExecutor(2)
    runs = dict(inverse=pool.submit(_jax_inverse_loop),
                study=pool.submit(_jax_study_frames))
    yield runs
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def port_hall():
    return q.study_scene(HALL_TRIS, device=CPU)


def test_inverse_rendering_main_cpu(tmp_path):
    out = tmp_path / "strip.png"
    rc = inv.main(["--cpu", "--res", "8", "--steps", "2", "--out",
                   str(out)])
    assert rc in (0, 1)
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    # IHDR: width 16 (target | recovered), height 8
    assert (int.from_bytes(data[16:20], "big"),
            int.from_bytes(data[20:24], "big")) == (16, 8)


def test_study_configs_are_the_jax_scripts():
    """Field for field: ``examples/r6_rr_quality.py:33-40`` and
    ``examples/coherent_quality_ab.py:37-39``."""
    base = JConfig(width=640, height=360, spp=1, max_bounces=4,
                   intersector="pallas", bvh_leaf_size=4,
                   coherent_bounce_sampling=True,
                   pairs_per_step=8, stale_round_masks=True,
                   anyhit_strategy="single", cull_impl="pallas2",
                   closest_k=16, cull_window=8192, cull_pps=16)
    rr = rrq.configs()
    assert _jax_config(rr["rr-off"]) == base
    assert _jax_config(rr["rr-2"]) == dataclasses.replace(
        base, rr_start_bounce=2)
    assert _jax_config(qab.config()) == JConfig(
        width=640, height=360, spp=1, max_bounces=4, intersector="pallas",
        bvh_leaf_size=4, pairs_per_step=8, stale_round_masks=True)
    assert rrq.BLOCK == (64, 64)


@pytest.mark.parametrize("study", [rrq, qab], ids=["rr", "coherent"])
def test_seed_ranges_disjoint(study):
    """No measured seed equals a reference (or warm-up) seed for any frame
    index below 10^8; the RR modes share theirs, the coherent study's
    modes do not.  (JAX's keys collide: 1000 n + 7 at n = 100 is reference
    key 100000 + 7.)"""
    assert 1000 * 100 + 7 == 100_000 + 7
    n = 10 ** 8
    assert q.SEED_SPAN >= n
    spans = {r: (q.frame_seed(r, 0), q.frame_seed(r, n - 1))
             for r in {q.REFERENCE, q.WARM_UP, *study.SEED_RANGES.values()}}
    for r in set(study.SEED_RANGES.values()):
        lo, hi = spans[r]
        for other in (q.REFERENCE, q.WARM_UP):
            olo, ohi = spans[other]
            assert hi < olo or ohi < lo, (r, other)
    ranges = list(study.SEED_RANGES.values())
    assert (len(set(ranges)) == 1) == (study is rrq)
    with pytest.raises(ValueError):
        q.frame_seed(q.REFERENCE, q.SEED_SPAN)


def _fake_frames(seen, shape=(3, 4, 3)):
    """Frame functions that record their seeds and return a fixed noisy
    image per seed."""
    def make(mode, offset):
        def frame(seed):
            seen.setdefault(mode, []).append(seed)
            g = torch.Generator().manual_seed(seed)
            return offset + torch.rand(shape, generator=g)
        return frame
    return make


@pytest.mark.parametrize("study", [rrq, qab], ids=["rr", "coherent"])
def test_study_loop_seeds_and_arithmetic(study):
    """run_study on recording frame functions: its seeds (measured apart
    from the reference, common across the RR modes), and its mean, MSE and
    reference term against numpy on the frames it drew."""
    modes = list(study.SEED_RANGES)
    reference = modes[0] if study is rrq else "independent"
    seen = {}
    make = _fake_frames(seen)
    frames = {m: make(m, 0.1 * k) for k, m in enumerate(modes)}
    res = q.run_study(frames, study.SEED_RANGES, reference, tuple(modes),
                      budget_s=0.05, n_ref=0)
    n_ref = res["n_ref"]
    most = max(m["frames"] for m in res["modes"].values())
    assert n_ref == q.REF_FACTOR * most
    # the reference's seeds: the last n_ref calls of its mode
    ref_seeds = seen[reference][-n_ref:]
    assert ref_seeds == [q.frame_seed(q.REFERENCE, i) for i in range(n_ref)]
    measured = {}
    for k, m in enumerate(modes):
        calls = seen[m][1:]                      # after the warm-up frame
        assert seen[m][0] == q.frame_seed(q.WARM_UP, k)
        n = res["modes"][m]["frames"]
        measured[m] = calls[:n]
        assert measured[m] == [q.frame_seed(study.SEED_RANGES[m], i)
                               for i in range(n)]
        assert not set(measured[m]) & set(ref_seeds)
    if study is rrq:
        n = min(len(v) for v in measured.values())
        assert measured[modes[0]][:n] == measured[modes[1]][:n]

    def stack(mode, seeds):
        g = [torch.Generator().manual_seed(s) for s in seeds]
        k = modes.index(mode)
        return np.stack([(0.1 * k + torch.rand((3, 4, 3), generator=x))
                         .numpy().astype(np.float64) for x in g])

    ref = stack(reference, ref_seeds)
    ref_mean = ref.mean(axis=0)
    np.testing.assert_allclose(res["reference"]["mean"], ref_mean.mean(),
                               rtol=1e-12)
    np.testing.assert_allclose(res["reference"]["var_of_mean"],
                               (ref.var(axis=0, ddof=1) / n_ref).mean(),
                               rtol=1e-10)
    for m in modes:
        img = stack(m, measured[m]).mean(axis=0)
        np.testing.assert_allclose(res["modes"][m]["mean"], img.mean(),
                                   rtol=1e-12)
        np.testing.assert_allclose(res["modes"][m]["mse"],
                                   ((img - ref_mean) ** 2).mean(),
                                   rtol=1e-10)
    num, den = (res["modes"][m]["mse"] for m in modes)
    assert res["ratio"] == pytest.approx(num / den)


def test_frame_stats_match_numpy():
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((7, 5, 6, 3)).astype(np.float32) + 4.0
    other = rng.standard_normal((4, 5, 6, 3)).astype(np.float32)
    a, b = q.FrameStats(), q.FrameStats()
    for f in frames:
        a.add(torch.tensor(f))
    for f in other:
        b.add(torch.tensor(f))
    x, y = frames.astype(np.float64), other.astype(np.float64)
    assert a.mean.dtype == torch.float64
    np.testing.assert_allclose(a.mean.numpy(), x.mean(axis=0), rtol=1e-13)
    np.testing.assert_allclose(a.var_of_mean(),
                               (x.var(axis=0, ddof=1) / len(x)).mean(),
                               rtol=1e-12)
    np.testing.assert_allclose(
        a.mse(b), ((x.mean(axis=0) - y.mean(axis=0)) ** 2).mean(),
        rtol=1e-12)


def _result_line(text: str, tag: str) -> dict:
    line = next(x for x in text.splitlines()
                if x.startswith(f"[{tag}] result "))
    return json.loads(line[len(f"[{tag}] result "):])


@pytest.mark.parametrize("study", [rrq, qab], ids=["rr", "coherent"])
def test_study_main_cpu(study, capsys):
    argv = ["0.01", "3"] + (["8"] if study is qab else []) + ["--cpu"]
    assert study.main(argv, width=16, height=8, target_tris=HALL_TRIS) == 0
    out = capsys.readouterr().out
    res = _result_line(out, study.TAG)
    assert res["n_ref"] == 3
    for m, r in res["modes"].items():
        assert r["frames"] >= 1
        assert np.isfinite(r["mse"]) and r["mse"] > 0
        assert any(line.startswith(f"[{study.TAG}] {m}") and "n_ref=3" in line
                   and "ref_var=" in line for line in out.splitlines())
    assert f"[{study.TAG}] reference mean=" in out
    assert "equal-wall-clock MSE ratio" in out and "WINS" in out


def test_refit_bench_main_cpu(capsys):
    assert refit.main(["2000", "--cpu"]) == 0
    out = capsys.readouterr().out
    res = _result_line(out, "refit")
    assert res["tris"] > 0
    ms_lines = [x for x in out.splitlines() if x.rstrip().endswith(" ms")]
    assert len(ms_lines) == 3 * len(refit.TOPOLOGIES)
    for topology in refit.TOPOLOGIES:
        assert set(res[topology]) == {"build_bvh_ms", "refit_bvh_ms",
                                      "build_packet_set_ms"}


@pytest.mark.parametrize("module,argv,constructor", [
    (inv, [], "make_cornell_scene"),
    (rrq, [], None),
    (qab, [], None),
    (refit, ["1000"], "make_hall_scene")],
    ids=["inverse_rendering", "r6_rr_quality", "coherent_quality_ab",
         "r5_refit_bench"])
def test_main_without_card_refuses(module, argv, constructor, monkeypatch,
                                   capsys):
    """No --cpu and no card: a message and a non-zero exit, before any
    scene is built."""
    def must_not_run(*args, **kw):
        raise AssertionError("built a scene without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(q, "make_hall_scene", must_not_run)
    if constructor is not None:
        monkeypatch.setattr(module, constructor, must_not_run)
    assert module.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


# the tests that read the JAX runs, last (the jax_runs fixture)

def test_inverse_rendering_matches_jax(jax_runs):
    ref = jax_runs["inverse"].result()
    scene, camera, cfg = inv.setup(INV_RES, CPU)
    cam_s, bounce_s = interop.samples_from_numpy(*ref["samples"], device=CPU)
    init = torch.tensor(ref["init"])
    np.testing.assert_array_equal(init.numpy(), inv.gray_table(
        scene.materials.diffuse).numpy())
    grads, tables = [], []

    def keep(i, loss, diffuse):
        grads.append(diffuse.grad.detach().clone().numpy())
        tables.append(diffuse.detach().clone().numpy())

    with torch.no_grad():       # the target, rendered as main renders it
        target = render_with_samples(scene, camera, cfg, cam_s, bounce_s)
    losses, final = inv.recover_albedo(scene, camera, cfg, cam_s, bounce_s,
                                       init, INV_STEPS, inv.LR,
                                       target=target, on_step=keep)
    g, jg = grads[0], ref["grads"][0]
    rel = np.linalg.norm(g - jg) / np.linalg.norm(jg)
    small = int((np.abs(jg) < 1e-6).sum())
    gaps = [float(np.abs(t - jt).max())
            for t, jt in zip(tables, ref["tables"])]
    print(f"first gradient rel L2 {rel:.3e}; {small} of {jg.size} "
          f"components |g| < 1e-6; losses {losses.tolist()} vs "
          f"{ref['losses'].tolist()}; table gaps {gaps}")
    assert rel <= GRAD_REL_L2
    signed = np.abs(jg) >= 1e-9
    np.testing.assert_array_equal(np.sign(g[signed]), np.sign(jg[signed]))
    np.testing.assert_allclose(losses.numpy(), ref["losses"],
                               rtol=LOSS_RTOL)
    for t, jt in zip(tables, ref["tables"]):
        np.testing.assert_allclose(t, jt, rtol=0, atol=TABLE_ATOL)
    np.testing.assert_array_equal(final.numpy(), tables[-1])
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("mode", STUDY_MODES)
def test_study_frame_matches_jax(jax_runs, port_hall, mode, monkeypatch):
    """The script's frame function on JAX's sample arrays (its own
    ``study_samples`` call replaced, the block it asks for checked)."""
    ref = jax_runs["study"].result()
    cfg, block = _study_configs()[mode]
    asked = []

    def jax_made(c, seed, device, blk=None):
        asked.append((c, seed, blk))
        return interop.samples_from_numpy(*ref["samples"][mode],
                                          device=device)

    monkeypatch.setattr(q, "study_samples", jax_made)
    scene, camera = port_hall
    if mode.startswith("rr"):
        img = rrq.frame(scene, camera, cfg, 7)
    else:
        img = qab.frame(scene, camera, qab.config(W, H), mode, 7, QAB_BLOCK)
    assert asked == [(cfg, 7, block)]
    img = img.numpy()
    assert img.shape == (H, W, 3) and img.mean() > 1e-2
    assert_image_parity(img, ref["frames"][mode])
