"""prismarine_core_tpu_torch — the PyTorch + CUDA port of prismarine_core_tpu.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and layout, so ``ops/intersect.py`` here holds what
``prismarine_core_tpu/ops/intersect.py`` holds there.  The three kernels of
the packet query path (the ray-tile cull, the pair cull and the fused
Moller-Trumbore pair intersector) are hand-written CUDA C++ for Hopper
(``csrc/``), built by ``_build.py`` at their first launch on a card.  On
CPU tensors each kernel's wrapper runs its plain PyTorch version instead.

Importing this package imports torch and numpy only: no jax, no nvcc, no
shared library.

Layout::

    utils/    config (RenderConfig), device, vector math, image writers
              (PNG/HDR/NPY), checkpoints (.npz), profiling
    ops/      morton codes, sampling, brute intersectors,
              cull.py + sb_intersect.py + bvh_walk.py (kernel wrappers +
              plain versions)
    models/   triangle soup, materials, lights, env map, camera, scene,
              procedural scenes, OBJ and glTF loaders
    accel/    LBVH build, BVH walk, packet set + packet query
    render/   the bounce integrator, boundary gradients (edge_grad),
              the progressive renderer (pipeline)
    parallel/ the device mesh (one process over torch devices), the
              sharded renderer and "pallas_sharded" query, the
              inverse-rendering train step
    cli       ``python -m prismarine_core_tpu_torch.cli`` (headless render)
    native    g++ build + ctypes binding of the OBJ parser
              (native/src/objparse.cc)
    interop   scene <-> dict of numpy arrays
    _build    nvcc build + ctypes binding of csrc/*.cu
"""

__version__ = "0.1.0"
