"""The port's inverse-rendering train step against the JAX package's.

* One ``make_train_step`` step from the same numpy parameters (cornell,
  brute, 12x12, 2 bounces), in corner mode and in shared-vertex mode,
  against ``prismarine_core_tpu.parallel.mesh.make_train_step`` on a
  one-device mesh: the loss within rtol 1e-5 (float32 rounding of one
  image), every updated parameter within 1e-4 of the step's largest move
  (the gradients differ by float32 rounding only, tests/
  test_torch_gradients.py).
* Ten normalized-SGD steps descend (tests/test_parallel.py:101-111).
* ``shared_vertices`` equals JAX's; a bare list of several devices
  raises (a mesh is built with ``make_mesh``); the parameter interop
  round-trips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tests.conftest  # noqa: E402,F401  (pins JAX to the CPU)
import jax  # noqa: E402

from prismarine_core_tpu.models.camera import Camera as JCamera  # noqa: E402
from prismarine_core_tpu.models.scene import (  # noqa: E402
    make_cornell_scene as j_cornell)
from prismarine_core_tpu.ops.sampling import make_sample_arrays  # noqa: E402
from prismarine_core_tpu.parallel import mesh as jmesh  # noqa: E402
from prismarine_core_tpu.render.integrator import (  # noqa: E402
    render_with_samples as j_render)
from prismarine_core_tpu.utils.config import RenderConfig as JConfig  # noqa: E402
from prismarine_core_tpu_torch import interop  # noqa: E402
from prismarine_core_tpu_torch.models.camera import Camera  # noqa: E402
from prismarine_core_tpu_torch.models.scene import make_cornell_scene  # noqa: E402
from prismarine_core_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from prismarine_core_tpu_torch.utils.config import RenderConfig  # noqa: E402

torch.set_num_threads(1)
CPU = "cpu"
CFG_KW = dict(width=12, height=12, spp=1, max_bounces=2,
              intersector="brute", tri_block=16)
LOOK = dict(eye=(0.0, 0.0, 3.4), target=(0.0, 0.0, 0.0), fov_y_deg=50.0)
STEP_KW = dict(lr=0.02, normalize_grads=True,
               lr_scale={"v0": 0.01, "v1": 0.01, "v2": 0.01,
                         "light_color": 0.1})


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture(scope="module")
def setup():
    """Both packages' cornell scene, camera and samples, the target frame
    (JAX's render of the true scene) and the start: the diffuse table's
    RGB halved."""
    jscene = j_cornell(capacity=64)
    tscene = make_cornell_scene(capacity=64, device=CPU)
    jcam, tcam = JCamera.look_at(**LOOK), Camera.look_at(**LOOK, device=CPU)
    cam_s, bounce_s = make_sample_arrays(
        jax.random.key(3), JConfig(**CFG_KW).n_rays, CFG_KW["max_bounces"])
    target = j_render(jscene, jcam, JConfig(**CFG_KW), cam_s, bounce_s)
    start = {k: np.asarray(v) for k, v in jmesh.init_params(jscene).items()}
    start["mat_diffuse"] = start["mat_diffuse"].copy()
    start["mat_diffuse"][:, :3] *= 0.5
    return dict(jscene=jscene, tscene=tscene, jcam=jcam, tcam=tcam,
                cam_s=cam_s, bounce_s=bounce_s, target=target, start=start)


@pytest.mark.parametrize("mode", ["corners", "shared"])
def test_train_step_matches_jax(setup, mode):
    s = setup
    start = dict(s["start"])
    faces_j = faces_t = None
    if mode == "shared":
        verts, faces_j = jmesh.shared_vertices(s["jscene"].triangles)
        faces_t = _t(faces_j)
        start = {"mat_diffuse": start["mat_diffuse"],
                 "light_color": start["light_color"],
                 "verts": np.asarray(verts)}
    kw = dict(lr=0.05, lr_scale={"v0": 0.01, "v1": 0.01, "v2": 0.01,
                                 "verts": 0.01})
    jstep = jmesh.make_train_step(jmesh.make_mesh(1), JConfig(**CFG_KW),
                                  vertex_faces=faces_j, **kw)
    jp, jloss = jstep({k: jax.numpy.asarray(v) for k, v in start.items()},
                      s["jscene"], s["jcam"], s["cam_s"], s["bounce_s"],
                      s["target"])
    tstep = tmesh.make_train_step(None, RenderConfig(**CFG_KW),
                                  vertex_faces=faces_t, **kw)
    tp, tloss = tstep(interop.params_from_numpy(start, device=CPU),
                      s["tscene"], s["tcam"], _t(s["cam_s"]),
                      _t(s["bounce_s"]), _t(s["target"]))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    tp = interop.params_to_numpy(tp)
    assert set(tp) == set(start)
    for k, v in start.items():
        move = np.abs(np.asarray(jp[k]) - v).max()
        err = np.abs(tp[k] - np.asarray(jp[k])).max()
        print(f"{mode} {k}: step {move:.3g}, |port - jax| {err:.3g}")
        assert move > 0 and err <= 1e-4 * move + 1e-7, (k, move, err)


def test_normalized_steps_descend(setup):
    s = setup
    step = tmesh.make_train_step(None, RenderConfig(**CFG_KW), **STEP_KW)
    params = interop.params_from_numpy(s["start"], device=CPU)
    args = (s["tscene"], s["tcam"], _t(s["cam_s"]), _t(s["bounce_s"]),
            _t(s["target"]))
    losses = []
    for _ in range(10):
        params, loss = step(params, *args)
        losses.append(float(loss))
    assert all(not v.requires_grad for v in params.values())
    assert losses[-1] < losses[0] * 0.95, losses


def test_shared_vertices_match_jax(setup):
    verts_j, faces_j = jmesh.shared_vertices(setup["jscene"].triangles)
    verts_t, faces_t = tmesh.shared_vertices(setup["tscene"].triangles)
    np.testing.assert_array_equal(verts_t.numpy(), np.asarray(verts_j))
    np.testing.assert_array_equal(faces_t.numpy(), np.asarray(faces_j))
    assert faces_t.dtype == torch.int32
    # the shared buffer rebuilds the corner soup exactly
    soup = tmesh.apply_params(
        setup["tscene"], tmesh.init_shared_params(setup["tscene"], verts_t),
        faces_t).triangles
    for k in ("v0", "v1", "v2"):
        assert torch.equal(getattr(soup, k),
                           getattr(setup["tscene"].triangles, k))


def test_multi_device_mesh_raises():
    """One device takes None, a device or a sequence of one; several
    devices take a Mesh (tests/test_torch_parallel.py), and a bare
    sequence of them raises."""
    cfg = RenderConfig(**CFG_KW)
    for one in (None, "cpu", torch.device("cpu"), [torch.device("cpu")],
                tmesh.make_mesh(2, devices=["cpu"] * 2)):
        tmesh.make_train_step(one, cfg)
    with pytest.raises(ValueError, match="make_mesh"):
        tmesh.make_train_step([torch.device("cpu")] * 2, cfg)


def test_params_interop_round_trip(setup):
    start = setup["start"]
    params = interop.params_from_numpy(start, device=CPU)
    assert all(v.dtype == torch.float32 and v.device.type == "cpu"
               for v in params.values())
    back = interop.params_to_numpy(params)
    assert set(back) == set(start)
    for k, v in start.items():
        np.testing.assert_array_equal(back[k], v)
    ref = tmesh.init_params(setup["tscene"])
    np.testing.assert_array_equal(params["v0"].numpy(), ref["v0"].numpy())
    with pytest.raises(KeyError):
        interop.params_from_numpy({**start, "camera": start["v0"]},
                                  device=CPU)
