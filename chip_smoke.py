#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: the bench frame, the
inverse-rendering train step, the textured hall frame, the env-NEE frame,
the BVH walk and the "bvh" frame (RenderConfig's default intersector),
Russian roulette, interlacing, depth of field, the 360 camera, the
boundary (edge-sampled) gradients, the application layer (the
"rounds" strategy, the progressive renderer, checkpoints, the CLI, OBJ
ingest, bench.py's teapot and independent-sampling frames), the
device mesh ("pallas_sharded", sharded textures, the sharded train step,
on meshes that repeat the card), the reference's default packet cull
(cull_impl="pallas"), the mesh over processes (two worker processes
sharing the card), the last packet knobs and the "packet" intersector,
and the example programs (inverse rendering, the two time-to-quality
studies, the rebuild-vs-refit bench) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device   — the card's name; nvidia-smi's name and power limit;
  2. build    — nvcc builds prismarine_core_tpu_torch/csrc/*.cu into
                build/torch_kernels/, one process per source (timed);
  3. kernels  — each CUDA kernel against its plain PyTorch version on the
                card, on the full hall with 1280x720 bounce-0 and bounce-1
                rays at the main path's shapes (round 1 of the closest
                query): block cull, pair cull masks and the three pair
                intersector forms' (t, slot) must be equal exactly, "mt2"
                must also equal "mt" exactly, and "mxu" must meet
                mxu_bounds against "mt"; the live sub-blocks per ray tile
                (mean, p99, max, empty tiles); kernel and plain times by
                CUDA events after a warm-up, each kernel's bound (the
                larger of its fp32 operations over 67 TFLOP/s and its
                bytes over 3.35 TB/s; the cull kernels' operations are
                what their tile-level reject leaves, cull_work, with
                the survivor shares and the dense bound in the log) and,
                in the log, each intersector's issue floor without the
                walk's skip (its fp32 operations at half that rate: under
                -fmad=false every add and multiply is one instruction);
                then both cull kernels against their plain versions on
                every input of one bounce step at bounce 1 (the closest
                query's rounds 1 and 2, the shadow query), recorded while
                the step runs, and sb_intersect_mt2 against its plain
                version and "mt" on the step's three sb_intersect inputs
                (times of both forms); on every input the "mt2" walk's
                stages and the share that run one chain, as its plain
                model forms them (ops/sb_intersect.py:walk_stages);
  4. frame    — render_with_samples(..., with_stats=True) at bench.py's
                main configuration, with every kernel's launch counter
                set to 0 before and read after (each must be > 0 and at
                most 12 = 2 per closest query + 1 per shadow query over
                4 bounces); then 3 timed frames, one sync each: ms/frame,
                live rays, Mrays/s, host syncs per frame, peak memory;
                and one frame under torch.profiler (device time by group,
                the cull kernels' time and the device's idle gap before
                each of them);
  5. parity   — the same frame with the plain versions in the kernels'
                place: the image must meet the CPU image test's bound;
  6. frame mt2 — the same frame under kernel_form="mt2": bit-identical to
                the "mt" frame, sb_intersect_mt2 launched 1..12 times;
                ms/frame; one frame under torch.profiler (device busy,
                the walk's device time, the idle share);
  7. train    — make_train_step at full width under kernel_form="mxu"
                (target: the "mt" frame; start: init_params with the
                diffuse RGB halved; TRAIN_KW: lr 0.02, normalized
                gradients, the light and vertex rates of
                tests/test_parallel.py:103-105 with the vertex rate scaled
                to the hall): one step from the start under "mt" and
                under "mxu" (losses within 0.5%, cosine of the two updates
                printed; counters read around the "mxu" step); then timed
                steps (finite losses, finite non-zero updates and
                gradients, descent, sb_intersect_mxu launched within a
                step), the forward / backward + update split, peak memory,
                a profile of one step, and the losses under the cornell
                box's own vertex rate (recorded, not required);
  8. frame textured — bench.py's textured hall
                (make_hall_scene(textured=True): 512^2 diffuse and bump
                textures, corner-packed) under the bench configuration:
                the frame's gates (launches 1..12, mean > 1e-2),
                plain-version parity, ms/frame, host syncs, peak memory,
                a profile with the texture gathers as a group of their
                own (profiler ranges set around the fetches), the
                textured surface step and one fetch timed at full width,
                and the kernels against their plain versions on the three
                inputs of its bounce-1 step;
  9. frame env_nee — the bench frame with env_nee=True: the same gates
                with launches 1..16 (a second shadow query a bounce),
                and both culls, "mt" and "mt2" equal to their plain
                versions on the four inputs of its bounce-1 step (closest
                rounds 1 and 2, sun shadow, env shadow);
 10. walk     — the BVH walk kernel (csrc/bvh_walk.cu) at the bench
                frame's bounce-1 rays: equal to its plain version (the
                lockstep walk) on (t, slot) exactly for the closest query
                of the bounce-1 step under "bvh" at every cap INF_DIST,
                the same rays as the step caps them (dead lanes at 0),
                and the shadow query;
                the kernel's registers and spills; traversal_stats of the
                lanes it walks and the bound from them; CUDA-event times
                in alternating turns of the closest walk unsorted (every
                cap INF_DIST, and capped), the coherence sort alone, the
                closest walk sorted and the shadow walk, with node steps
                and leaf visits per second and the dead-lane share; the
                "bvh" closest query against the "pallas"
                one on the same rays (hit/miss and triangle agreement;
                lanes on another triangle are ties (equal t) or edge and
                grazing lanes, and those must stay under 1e-4 of the
                hits);
 11. frame bvh — bench.py's main configuration with intersector="bvh":
                the frame's measurements, the walk launched 8 times and
                no packet-query kernel, the same frame on the kernels'
                plain versions bit-identical, and >= 98% of pixels and the mean
                within 0.5% of the "mt" frame on the same samples;
 12. frames rr — the bench configuration with rr_start_bounce=2 on
                "pallas" and on "bvh" (the same samples): each held to
                the other by the same gate, the per-bounce survivors below
                the frame without RR from bounce 2 on;
 13. features — on "pallas": interlace stages 0 and 1 (each inactive
                parity exactly 0; their sum against the "mt" frame by the
                gate), the DOF frame and the 360 frame (finite, mean >
                1e-2);
 14. edge     — render_with_edge_gradients(shadow_term=True) on the
                env-NEE frame under "bvh" with 2^18 edge samples, the
                gradient of sum(img * W) (W seeded) with respect to the
                corner vertices and the camera eye (phase_edge): the value
                bit-identical to render_with_samples, the walk launched
                44 times (edge_launches) and nothing else, the boundary
                images' vertex gradient non-zero on >= 1,000 entries and
                equal to the plain versions' up to the backward's atomic
                order (relative L2 <= 1e-5, cosine >= 0.99999); the same
                call under "pallas" (value gate, 60 launches of each
                "mt"-path kernel, the boundary images' vertex gradient
                equal to the one on the kernels' plain versions up to the
                atomic order, as above, and within relative L2 1e-3 and
                cosine 0.99999 of "bvh"'s); the finite-difference cases of
                tests/test_edge_gradients.py on the card under "bvh"
                (tests/torch_edge_cases.py); forward, backward and
                boundary-only times, peak memory and one profiled rep;
 15. application — (a) "rounds" (phase_rounds) on the bounce-1 step's
                closest (K 16) and shadow (K 8) queries, stale masks off
                and on: every round's block_cull, pair_cull and
                sb_intersect input equal to the plain versions, closest t
                bit-identical to "two_round" (tie lanes counted),
                occlusion identical to "single", rounds, pairs per round,
                host syncs and times against "two_round" / "single";
                (b) the CLI's default frame (the hall, 1280x720, 4
                bounces, independent sampling, any-hit "rounds") through
                the frame's gates with launches <= CLI_LAUNCHES, its
                plain-version parity, and 8 ProgressiveRenderer frames
                equal to the sum of render_with_samples frames on a clone
                of its generator; (c) save_renderer after 4 frames,
                load_renderer into a fresh renderer, 4 more: bit-identical
                to 8 straight; (d) ``python -m prismarine_core_tpu_torch.cli``
                as a subprocess: exit 0, a 1280x720 PNG, the HDR equal to
                the NPY within RGBE's precision, the NPY against (b)'s
                snapshot by the image gate; (e) bench.py's teapot-512 and
                teapot-512-obj-ingested frames (the OBJ written as bench.py
                writes it, ingested by the native parser, its vertices
                within the text's rounding); (f) bench.py's
                hall-720p-hdr-sky(independent) frame;
 16. mesh     — every mesh position the card, so the shards run one after
                another (phase_mesh): (a) the bounce-1 step's closest
                ("mt" and "mxu") and shadow queries through the sharded
                query at meshes 1x2, 1x3 (256 superblocks padded to 258)
                and 1x4: every shard's block_cull, pair_cull, sb_intersect
                and sb_intersect_mxu input equal to the plain versions,
                the "mt" hits equal to the single card's but on counted
                tie lanes (t bit for bit elsewhere), "mxu"'s other
                triangles counted (<= 1e-4 of the hits), occlusion
                identical, CUDA-event times of both; (b) the bench frame
                under "pallas_sharded" at mesh 2x2 through the frame's
                gates and measurements (launches up to 4 x 12) and the
                image gate against phase 4's frame, make_sharded_renderer
                equal to render_with_samples; (c) the textured hall (100k
                target, 256^2 textures) at 1024x1024 and 8 bounces through
                make_sharded_renderer at mesh 2x4, soup a husk and textures
                split: finite, non-degenerate, the image gate against the
                single-card "pallas" frame, per-shard planes and texture
                bytes at most 1/mp of the whole + 1 KiB; (d) one
                "pallas_sharded" train step under "mxu" at mesh 1x2 (the
                BVH rebuilt inside the loss) against one single-card step:
                the loss within 5e-3 relative, each update's cosine, v0-v2
                moved and finite, sb_intersect_mxu launched;
 17. default cull and processes — (a) the bench frame under the
                reference's default cull_impl="pallas" (phase_default_cull):
                block_cull over the 2,048 block boxes, the pairs' block masks
                from its table, round 2 re-culled per ray over the 256
                superblocks (recull "sb"): every block_cull input of the
                bounce-0 and bounce-1 steps and every sb_intersect input of
                the bounce-1 step equal to the plain versions, no pair_cull;
                the bounce-1 closest query's t bit for bit equal to
                "pallas2"'s on every lane (tie lanes counted), recull
                "kernel" and "tn" equal to "sb", occlusion identical, pairs
                and live sub-blocks per round, alternating CUDA-event times;
                block_cull at 2,048 boxes timed against the 256-box recull
                with its bound and dense bound; the frame through phase 4's
                gates and measurements (launches exactly 12 / 0 / 12) and the
                image gate against phase 4's frame; one frame of
                RenderConfig(intersector="pallas")'s own defaults against the
                same under "pallas2"; (b) the mesh over processes
                (phase_multiprocess): two worker processes (this script with
                --worker), each with two positions on the card, over gloo
                with CUDA tensors staged through the host: the bench frame on
                a global 2x2 mesh whose "model" axis crosses them,
                bit-identical to phase 16b's; tests/test_multihost.py's two
                frames, the means within 1e-6 and each equal to a one-process
                mesh's; phase 16d's 1x2 "mxu" step with its shards in the two
                processes, its loss equal to 16d's; each process's launches,
                device busy and wall;
 18. knobs    — the bench frame under the last packet knobs and the
                "packet" intersector (phase_knobs): every block_cull,
                pair_cull and sb_intersect input of the recorded steps
                (bounce 1 under each knob, bounce 0 under "identity",
                bounce 1 on a reused order, "packet"'s two queries) equal
                to the plain versions; (a) cull_impl="xla": the frame
                bit-identical to phase 4's, launches 12 / 12 / 12, the
                bounce-1 shadow query under "rounds" occluding as under
                "single"; (b) sort_mode "packed" and "group" and (c)
                near_frac=0.4: the bounce-1 closest t bit for bit equal to
                phase 4's (tie lanes counted), pairs and live sub-blocks per
                round, each frame through the image gate with its launches
                and device busy, the three sorts alone at 921,600 rays in
                alternating turns; (d) primary_identity,
                reuse_bounce_order and primary_tile_order frames (the tile
                order's against a scanline frame of the same samples moved
                to their pixels), their host syncs and device busy beside
                phase 4's, the bounce-0 step with and without its sort;
                (e) intersector="packet": the frame (8 sb_intersect
                launches, no cull kernel), the bounce-1 closest t equal to
                "pallas2" "single" at INF_DIST caps (tie lanes counted),
                occlusion identical, the interval cull's time and peak
                memory, pairs and live sub-blocks against "pallas2", the
                sb_intersect time on the packet pairs; (f) the CLI with
                --intersector packet and with --cull-impl xla --sort-mode
                group --reuse-order at 320x180, two subprocesses at once,
                each exiting 0 with its PNG;
 19. examples — the example programs (prismarine_core_tpu_torch/examples/)
                in this process (phase_examples): (a) inverse_rendering at
                its defaults (cornell, 48x48, 60 Adam steps on the "bvh"
                walk): exit 0 (albedo L1 < 0.15), its PNG strip written
                into a temporary directory; the loop again through
                recover_albedo: the walk launched on every step and no
                other kernel, ms/step (host clock, one synchronize a step,
                steps 2-60), peak memory, one profiled step; one loss and
                gradient on the kernels' plain versions within relative L2
                1e-5 of the kernel's; (b) r6_rr_quality and (c)
                coherent_quality_ab at blocks 16 and 64, at the JAX
                scripts' configurations: one frame of each mode with the
                launch counters read around it (phase 4's kind) and
                against the same frame on the kernels' plain versions by
                the image gate, one profiled frame each (device busy, idle
                share), then the study at a 3 s budget a mode with
                the reference 10 x the larger frame count: n_ref >= 10 x
                the frames, every MSE finite and > 0, no measured seed in
                the reference's range; frames, ms/frame, MSE, the
                reference's variance term and the ratio; (d)
                r5_refit_bench at 100,000 target triangles: build_bvh,
                refit_bvh and build_packet_set ms under "karras" and
                "median", and refit_bvh's boxes equal to build_bvh's on
                the unchanged soup;
 20. surface  — the surface kernel (csrc/surface.cu, phase_surface) at
                the bounce-1 hits of bench.py's frame at 4 spp under
                "bvh" (3,686,400 lanes): every field equal bit for bit to
                surface_fields_plain's, its time in alternating turns
                against the plain version's, its bytes bound (12 B read
                and 84 B written a lane, 19 words of each triangle and 21
                of each material once) and its share of it, its
                registers; one 4 spp frame launching it once a bounce;
 21. shade    — the shading kernels (csrc/shade.cu, phase_shade) at the
                bounce-1 step of bench.py's frame at 4 spp under "bvh":
                every output of shade_kernel and nee_resolve_kernel equal
                bit for bit to shade_plain's and nee_resolve_plain's, their
                times in alternating turns against the plain versions',
                their bytes bounds and shares, their registers; one 4 spp
                frame launching each once a bounce.  Every phase's launch
                reader checks one shading launch in each bounce span;
 22. texture  — the texture kernel (csrc/texture.cu, phase_texture) at the
                bounce-1 hits of the benchmark's textured cell
                (hall720-bvh-textured, bench_port/): every field equal bit
                for bit to texture_plain's, its time in alternating turns
                against the plain version's, its bytes bound (each fetch's
                four texels; and each distinct quad row read once) and
                its share of it, its registers; one 4 spp frame launching
                it once a bounce.

The build's ptxas lines (registers, shared memory and spills of each
kernel, by name) go to the log.  The last lines are the kernel table as
JSON (the five ported kernels, bvh_walk, surface_fields, shade,
nee_resolve and texture_fields, with their
launches on each path, the sharded, default-cull and per-process ones
included, and
block_cull's 2,048-box time and bound beside its 256-box ones; and every
frame's, the step's, the edge path's, the application phase's, the mesh
phase's, the default cull's, the processes', the knobs' and the examples'
results),
nvidia-smi's line, and ``{"ok": true, "device": {...}}``.  The script
exits 0 only when every phase passes.  Nothing falls back to the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import struct
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
W, H, BOUNCES = 1280, 720, 4
#: sanity band of the frame's mean radiance (the full frame's mean is
#: 0.29-0.35 over sample seeds 0-3 on an H100)
MEAN_BAND = (0.2, 0.4)
#: the kernels whose launches the phases count (their ``pc.kernel.<name>``
#: spans)
KERNELS = ("block_cull", "pair_cull", "sb_intersect", "sb_intersect_mt2",
           "sb_intersect_mxu", "bvh_walk", "surface")
#: the bounce loop's shading kernels, whose launches ``zero_launches``
#: checks against the bounce spans
SHADE_KERNELS = ("shade", "nee_resolve")
#: the kernels of the "mt" frame's packet query
MT_PATH = ("block_cull", "pair_cull", "sb_intersect")
MAX_LAUNCHES = 2 * BOUNCES + BOUNCES     # per frame, each kernel
#: the "bvh" frame: one closest and one shadow walk a bounce
BVH_LAUNCHES = 2 * BOUNCES
#: the same with env NEE: a second shadow query per bounce
MAX_LAUNCHES_ENV = 2 * BOUNCES + 2 * BOUNCES
#: the card's published peaks (H100 SXM at 700 W): fp32 outside the
#: tensor cores, and HBM bandwidth
FP32_PER_S, BYTES_PER_S = 67e12, 3.35e12
#: fp32 operations per ray-box slab test (6 sub, 6 mul, 11 min/max) and
#: per ray-triangle test of the elementwise and determinant forms
#: (adds, subs, muls, the divide; compares and selects not counted)
SLAB_OPS, MT_OPS, MXU_OPS = 23, 46, 39
#: bytes the walk reads once per ray (o, d, t_cap) and writes (t, slot),
#: per dead ray (capped <= PZERO: t_cap read, (t, slot) written, o and d
#: never loaded), per BVH node (lo, hi, left, skip) and per slot
#: (tv0..2, orig)
WALK_RAY_BYTES, WALK_DEAD_BYTES = 28 + 8, 4 + 8
WALK_NODE_BYTES, WALK_SLOT_BYTES = 32, 40
#: fp32 operations of the cull kernels' tile-level reject
#: (csrc/cull.cu), counted as SLAB_OPS is: per ray of a tile's reduction
#: (bounds_add: min of o, -o, iv, -iv per axis and of -t_cap), and per
#: (tile, box) test (tile_rejects: per axis 2 subs, 4 muls, 1 min, 1 max;
#: 2 max and 2 min across the axes)
BOUND_OPS, REJECT_OPS = 13, 28
TRAIN_STEPS = 8
#: the queries of one bounce step, in order (with env NEE, and without)
STEP_QUERIES = ("closest round 1", "closest round 2", "shadow")
ENV_STEP_QUERIES = STEP_QUERIES + ("env shadow",)
#: profiler ranges around the textured frame's texture fetches and the
#: gathers inside them (chip_smoke's own wrappers, ``texture_ranges``)
TEX_FETCH, TEX_GATHER = "texture fetch", "texture gather"
#: phase 14: edge samples of the boundary terms at full width, the
#: gradient leaves (the corner vertices and the camera eye), the bound
#: (relative L2, least cosine) of a boundary gradient against the same on
#: the kernels' plain versions (the same forward bits: only the backward's
#: atomic order differs), and that of the "pallas" boundary gradient
#: against the "bvh" one (PERF.md, PR 8: a few dozen of the side paths'
#: query lanes tie-break differently; 1.25e-4 measured)
EDGE_SAMPLES = 2 ** 18
EDGE_LEAVES = ("v0", "v1", "v2")
EDGE_PLAIN_BOUND = (1e-5, 0.99999)
EDGE_PALLAS_BOUND = (1e-3, 0.99999)
#: phase 15: the CLI's default frame: per frame each packet kernel runs at
#: most twice per closest query ("two_round") and once per round of a
#: shadow query ("rounds", K 8: 32 rounds over the hall's 256
#: superblocks), over 4 bounces; the frames its renderer accumulates
CLI_LAUNCHES = 2 * BOUNCES + 32 * BOUNCES
CLI_FRAMES = 8
#: bench.py's teapot frame: "single" for both queries (fewer superblocks
#: than K), one launch of each kernel per query
TEAPOT_LAUNCHES = 2 * BOUNCES
#: phase 16: the model-parallel degrees of the query's 1 x mp meshes, and
#: the (data, model) meshes of the bench frame, the textured frame and the
#: train step; every position of each is the one card
QUERY_MESHES = (2, 3, 4)
MESH_FRAME, MESH_TEXTURED, MESH_TRAIN = (2, 2), (2, 4), (1, 2)
#: the textured frame the JAX package could only compile
#: (__graft_entry__.py:76-123): 1024x1024, 8 bounces
BIG_W = BIG_H = 1024
BIG_BOUNCES = 8
#: phase 17a: each kernel's launches on the bench frame under the default
#: cull ("pallas"): per bounce two block culls of the closest query (the
#: blocks, then round 2's superblock re-cull) and one of the shadow query,
#: one pair intersector run each, and no pair_cull
DEFAULT_CULL_LAUNCHES = {"block_cull": 3 * BOUNCES,
                         "sb_intersect": 3 * BOUNCES}
#: phase 17b: worker processes, each with this many mesh positions (all of
#: them the one card), and each worker's time limit in seconds
MP_PROCESSES, MP_POSITIONS = 2, 2
MP_TIMEOUT = 400
#: phase 18: each kernel's launches on the bench frame under every knob
#: of the "pallas2" query (as phase 4's: two of each per closest query and
#: one per shadow query over 4 bounces), and under intersector="packet"
#: (one sb_intersect per query, no cull kernel)
KNOB_LAUNCHES = {**{k: MAX_LAUNCHES for k in MT_PATH}, "surface": BOUNCES}
PACKET_LAUNCHES = {"sb_intersect": 2 * BOUNCES, "surface": BOUNCES}
#: phase 18's frames, by their key in its results and launches_by_path
KNOB_FRAMES = ("frame_xla", "frame_sort_packed", "frame_sort_group",
               "frame_near_frac", "frame_primary_identity",
               "frame_reuse_order", "frame_tile_order", "frame_packet")
#: phase 19: the example programs.  Each study's wall-clock budget a mode
#: (its reference: REF_FACTOR x the larger frame count), the coherent
#: study's blocks (its default, the bench frame's), the inverse-rendering
#: demo's steps, and the refit bench's target triangles
STUDY_BUDGET_S = 3.0
STUDY_BLOCKS = (16, 64)
INVERSE_STEPS = 60
REFIT_TRIS = 100_000
#: the bound (relative L2) of the inverse step's loss and diffuse gradient
#: on the kernels' plain versions against the kernels (the same forward bits:
#: only the backward's atomic order may differ)
INVERSE_PLAIN_BOUND = 1e-5
#: the inverse loop's steps whose per-material error is logged, and where
#: the card's sample draw is saved (for tests/torch_inverse_reference.py,
#: which runs the JAX package's loop on it)
INVERSE_TABLE_STEPS = (20, INVERSE_STEPS - 1)
INVERSE_SAMPLES = REPO / "build" / "inverse_samples.npz"
#: the profiler's own range around each scheduled step (a span, no op)
STEP_RANGE = "ProfilerStep"
#: the normalized-SGD rates of tests/test_parallel.py:103-105, tuned on
#: the 64-triangle cornell box
CORNELL_KW = dict(lr=0.02, normalize_grads=True,
                  lr_scale={"v0": 0.01, "v1": 0.01, "v2": 0.01,
                            "light_color": 0.1})
#: the same with the vertex rate scaled to the hall.  normalize_grads
#: divides each gradient by its RMS over all entries; the vertex gradient
#: is sparse, so its largest normalized entry grows about as the square
#: root of the entry count: 0.01 * sqrt(192 / 411,000) ~ 2e-4 keeps the
#: largest vertex move near the cornell box's
TRAIN_KW = dict(CORNELL_KW, lr_scale={"v0": 1e-4, "v1": 1e-4, "v2": 1e-4,
                                      "light_color": 0.1})


def log(msg=""):
    print(msg, flush=True)


def require(ok: bool, msg: str) -> None:
    """Fail the run (non-zero exit) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def ptxas_lines(text: str):
    """Each kernel's ``-Xptxas -v`` lines (registers, shared memory,
    spills), prefixed with its name demangled as far as the log needs
    (``sb_intersect_walk_kernel<FormMT2>``)."""
    name = "?"
    for line in text.splitlines():
        m = re.search(r"(?:entry function|Function properties for) "
                      r"'?(_Z\w+)", line)
        if m:
            name = short_name(m.group(1))
        elif "registers" in line or "spill" in line:
            yield f"{name}: {line.strip()}"


def short_name(mangled: str) -> str:
    """A kernel's name and, for a walk, its form or query, from its
    mangled name (``sb_intersect_walk_kernel<FormMT2>``,
    ``bvh_walk_kernel<any_hit>``)."""
    flags = re.search(r"\d+(shade_kernel)ILb([01])ELb([01])ELb([01])E",
                      mangled)
    if flags:
        return (f"{flags.group(1)}<nee={flags.group(2)},env="
                f"{flags.group(3)},rr={flags.group(4)}>")
    m = re.search(r"\d+(\w+?_kernel)(?:INS_\d+(Form\w+?)E|ILb([01])E)?",
                  mangled.split("prismarine")[-1])
    if m is None:
        return mangled
    if m.group(3) is not None:
        return m.group(1) + ("<any_hit>" if m.group(3) == "1"
                             else "<closest>")
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over ``reps`` launches (CUDA events, after
    one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, nbytes):
    """(bound_ms, bound_by): the least time the card could take
    (``bench_port/roofline.py:bound_s``) in ms, and which of ops at the
    fp32 peak and bytes at the memory rate sets it."""
    from bench_port.roofline import bound_s
    return (bound_s(ops, nbytes) * 1e3,
            "operations" if bound_s(ops, 0) >= bound_s(0, nbytes)
            else "bytes")


def mt2_stages(pt, pm, n_real) -> str:
    """The "mt2" walk's stages on one input and the share that run one
    chain (a tile boundary or a unit's end), as the plain model
    ``walk_stages`` forms them: the kernel's own pairing is not observed
    (its results are the same bits whatever the pairing)."""
    from prismarine_core_tpu_torch.ops import sb_intersect as si
    _, chain, stage = si.walk_stages(pt, pm, n_real)
    n = int(stage[-1]) + 1 if stage.numel() else 0
    lone = n - int((chain == 1).sum())
    return (f"mt2 stages (plain model) {n} ({chain.numel()} live "
            f"sub-blocks), {lone / max(n, 1):.4f} of them one chain")


def edge_cos(scene, o, d, tri):
    """Per lane, the distance of the hit to the nearest edge of triangle
    ``tri`` in barycentrics, and |cos(d, n)|."""
    import torch
    from prismarine_core_tpu_torch.ops.intersect import moller_trumbore
    from prismarine_core_tpu_torch.utils import math as pm
    s = scene.triangles
    v0, v1, v2 = (pm.take_rows(x, tri.long()) for x in (s.v0, s.v1, s.v2))
    _, u, v, _ = moller_trumbore(o, d, v0, v1, v2)
    n = pm.normalize(pm.cross(v1 - v0, v2 - v0))
    return (torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs(),
            pm.dot(d, n).abs())


def mxu_bounds(scene, rays, tn, tx, sm, sx):
    """The "mxu" form against "mt" on live lanes (``rays`` their kernel
    ray rows): hit parity > 99.5% and slot parity > 99% where both hit,
    as tests/test_packet.py:398-411; and t within rtol 1e-3 / atol 1e-4
    for the same winner, rtol 1e-2 / atol 1e-3 for another winner, which
    that test holds on 2,048 random rays and which here must hold for
    all but 1e-4 of the joint hits.  The lanes off the t bound are
    classed by their two winners: within 1e-3 of an edge of either in
    barycentrics (the reordered sums move the edge, so the ray sees
    through a crack or clips a neighbour) or grazing (|cos(d, n)| <
    1e-2, t = t_num / det ill-conditioned)."""
    import torch
    agree_hit = (sm >= 0) == (sx >= 0)
    both = (sm >= 0) & (sx >= 0)
    same = sm[both] == sx[both]
    hit_parity = float(agree_hit.float().mean())
    slot_parity = float(same.float().mean())
    a, b = tx[both], tn[both]
    tol = torch.where(same, 1e-4 + 1e-3 * b.abs(), 1e-3 + 1e-2 * b.abs())
    off = (a - b).abs() > tol
    n_edge = n_graze = 0
    worst = 0.0
    if off.any():
        r = rays[both][off]
        (em, cm), (ex, cx) = (
            edge_cos(scene, r[:, 0:3], r[:, 3:6],
                     scene.bvh.orig[slot[both][off].long()])
            for slot in (sm, sx))
        near = torch.minimum(em, ex)              # either winner's edge
        edge = near < 1e-3
        graze = ~edge & (torch.minimum(cm, cx) < 1e-2)
        n_edge, n_graze = int(edge.sum()), int(graze.sum())
        worst = float(near.max())
    n_off = int(off.sum())
    log(f"[kernels]   mxu vs mt: {int((~agree_hit).sum())} of "
        f"{agree_hit.numel()} lanes disagree on hit/miss, "
        f"{int((~same).sum())} of {same.numel()} joint hits on the slot; "
        f"t off the bound on {int(off[same].sum())} same-winner and "
        f"{int(off[~same].sum())} other-winner lanes ({n_edge} within 1e-3 "
        f"of an edge of either winner, {n_graze} grazing, "
        f"{n_off - n_edge - n_graze} neither; largest edge distance "
        f"{worst:.3g})")
    require(hit_parity > 0.995, f"mxu hit parity {hit_parity}")
    require(slot_parity > 0.99, f"mxu slot parity {slot_parity}")
    require(n_off <= 1e-4 * both.sum(), f"mxu t off the bound: {n_off}")
    return hit_parity, slot_parity


def block_cull_work(rays, box_rows, n_live):
    """cull_work's block cull half, at any box rows: the survivor share of
    the live tiles' (tile, box) entries, the fp32 operations (the tile
    reductions, the reject of every (live tile, box), all 128 rays of each
    survivor; the dense count beside them) and the bytes (the rays of the
    live tiles, the box rows, the whole output)."""
    from prismarine_core_tpu_torch.ops import cull
    n_live = int(n_live)
    nt, nb = rays.shape[0] // 128 - 1, box_rows.shape[1]
    surv = int((~cull.block_cull_rejects(rays, box_rows, n_live)[
        :n_live]).sum())
    return dict(share=surv / max(n_live * nb, 1),
                ops=(n_live * 128 * BOUND_OPS + n_live * nb * REJECT_OPS
                     + surv * 128 * SLAB_OPS),
                dense_ops=n_live * 128 * nb * SLAB_OPS,
                bytes=(n_live * 128 * rays.shape[1] * 4
                       + box_rows.numel() * 4 + nt * nb * 4))


def cull_work(rays, sb_rows, n_live, pt, psb, n_real, sbbox, pm):
    """What the two cull kernels' inputs need, from the plain emulation of
    their reject (ops/cull.py, deciding as the kernels do): the survivor
    shares (block cull: of the live tiles' (tile, box) entries; pair cull:
    of the real pairs' blocks) and each kernel's fp32 operations: the tile
    reductions, the reject of every (live tile, box) and the slab tests of
    the survivors (block cull: all 128 rays of each; pair cull: 128 for a
    block no ray passes, 1 for a block some ray passes, ``pm`` its
    mask).  The dense counts test every ray against every box.  Bytes:
    each input the kernel reads, once, and its whole output (block cull:
    the rays of the live tiles, the box rows; pair cull: the rays of the
    tiles in the real pairs, their indices, the box table)."""
    import torch
    from prismarine_core_tpu_torch.ops import cull
    n_real = int(n_real)
    tile_b = 128 * rays.shape[1] * 4
    surv = cull.pair_cull_survivors(pt, psb, n_real, rays, sbbox)
    passing = ((pm[:, None] >> torch.arange(8, device=pm.device)) & 1) == 1
    n_pass = int((surv & passing).sum())
    n_fail = int((surv & ~passing).sum())
    n_tiles = int(torch.unique(pt[:n_real]).numel())
    return {"block_cull": block_cull_work(rays, sb_rows, n_live),
            "pair_cull": dict(
                share=(n_pass + n_fail) / max(n_real * 8, 1),
                ops=(n_tiles * 128 * BOUND_OPS + n_real * 8 * REJECT_OPS
                     + (n_fail * 128 + n_pass) * SLAB_OPS),
                dense_ops=n_real * 128 * 8 * SLAB_OPS,
                bytes=(n_tiles * tile_b + 2 * n_real * 4 + pt.shape[0] * 4
                       + sbbox.numel() * 4))}


def bench_setup(dev, target_tris=100_000):
    """Scene, camera and config of bench.py's main metric, on ``dev``."""
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene, make_sky_environment)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    cfg = RenderConfig(width=W, height=H, spp=1, max_bounces=BOUNCES,
                       intersector="pallas", bvh_leaf_size=4,
                       coherent_bounce_sampling=True, pairs_per_step=8,
                       stale_round_masks=True, anyhit_strategy="single",
                       cull_impl="pallas2", closest_k=16,
                       cull_window=8192, cull_pps=16)
    scene = make_hall_scene(target_tris=target_tris, device=dev)
    scene = dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128, device=dev))
    cam = Camera.look_at(eye=(-10.0, 2.2, 0.0), target=(6.0, 1.6, 0.0),
                         fov_y_deg=60.0, device=dev)
    return scene, cam, cfg


def first_bounce(scene, cam, cfg, dev):
    """The camera rays of sample seed 1 and the carry after one bounce
    step on them: (o, d, alive, carry1, bounce samples)."""
    import torch
    from prismarine_core_tpu_torch.models.camera import generate_rays
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.render.integrator import (
        initial_carry, make_bounce_step)
    gen = torch.Generator(device=dev).manual_seed(1)
    cam_s, bounce_s = make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    o, d = generate_rays(cam, cfg, cam_s)
    carry = initial_carry(o, d)
    carry1, _ = make_bounce_step(scene, cfg)(carry, bounce_s[0])
    return o, d, carry[4], carry1, bounce_s


@contextlib.contextmanager
def seam_choice(pick):
    """Every kernel wrapper's choice at the seam
    (``prismarine_core_tpu_torch/ops/dispatch.py``) made by ``pick(x,
    launch, plain, choose)`` in the block, ``choose`` the seam's own."""
    from prismarine_core_tpu_torch.ops import dispatch
    choose = dispatch.choose
    dispatch.choose = lambda x, launch, plain: pick(x, launch, plain, choose)
    try:
        yield
    finally:
        dispatch.choose = choose


@contextlib.contextmanager
def recorded_calls(kernels=MT_PATH):
    """The arguments of every call of ``kernels`` (block_cull, pair_cull,
    sb_intersect, sb_intersect_mxu, bvh_walk) in the block (on the
    kernels), by kernel: each launch the seam hands out, by its name."""
    calls = {k: [] for k in kernels}

    def pick(x, launch, plain, choose):
        run = choose(x, launch, plain)
        name = getattr(launch, "__name__", "").removeprefix("launch_")
        if name not in calls:
            return run

        def recorded(*args):
            calls[name].append(args)
            return run(*args)
        return recorded
    with seam_choice(pick):
        yield calls


def record_step(scene, cfg, carry, samples, queries=STEP_QUERIES):
    """The arguments of every block_cull, pair_cull and sb_intersect call
    of one bounce step at ``carry`` (on the kernels), one per query of
    ``queries``: the closest query's rounds 1 and 2, the shadow query and,
    with env NEE, the env shadow query."""
    from prismarine_core_tpu_torch.render.integrator import make_bounce_step
    with recorded_calls() as calls:
        make_bounce_step(scene, cfg)(carry, samples)
    require(all(len(v) == len(queries) for v in calls.values()),
            f"kernel calls in one bounce step: "
            f"{ {k: len(v) for k, v in calls.items()} }")
    return calls


def phase_kernels(scene, cam, cfg, dev):
    """Every kernel against its plain version on the card at the main
    path's shapes (round 1 of the closest query, bounces 0 and 1)."""
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    from prismarine_core_tpu_torch.utils.config import INF_DIST

    o, d, alive, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    r = o.shape[0]
    ray_sets = {"bounce0": (o, d, alive),
                "bounce1": (carry1[0], carry1[1], carry1[4])}

    ps = scene.packets
    nsb = ps.n_superblocks
    sb_rows = cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi)
    sbbox = cull.sb_box_table(ps.block_lo, ps.block_hi)
    coef = si.mxu_planes_from_planes(
        ps.planes, 0.5 * (scene.bvh.lo[0] + scene.bvh.hi[0]))
    rows = {}
    for name, (o_, d_, alive_) in ray_sets.items():
        t_cap = torch.where(alive_, INF_DIST, 0.0)
        rays, _, _ = pk._sorted_rays_matrix(scene.bvh.lo[0],
                                            scene.bvh.hi[0], o_, d_, t_cap)
        nt = rays.shape[0] // 128 - 1
        n_live = pk._live_tile_bound(rays[:nt * 128, 6].reshape(nt, 128))
        tn = cull.block_cull(rays, sb_rows, n_live)
        tn_p = cull.block_cull_plain(rays, sb_rows, n_live)
        bc_err = (tn - tn_p).abs().max().item()
        require(torch.equal(tn, tn_p), f"{name}: block_cull != plain")

        tn = tn[:, :nsb]
        tn_cand = torch.where(tn < INF_DIST, tn, INF_DIST)
        tn_sorted, sb_sorted = torch.sort(tn_cand, dim=1, stable=True)
        ok = tn_sorted[:, :cfg.closest_k] < INF_DIST
        pt, psb, n_real = pk.compact_pairs(ok, sb_sorted[:, :cfg.closest_k])
        pm = cull.pair_cull(pt, psb, n_real, rays, sbbox)
        pm_p = cull.pair_cull_plain(pt, psb, n_real, rays, sbbox)
        pc_err = (pm - pm_p).abs().max().item()
        require(torch.equal(pm, pm_p), f"{name}: pair_cull != plain")

        t, slot = si.sb_intersect(pt, psb, pm, n_real, rays, ps.planes)
        t_p, slot_p = si.sb_intersect_plain(pt, psb, pm, n_real, rays,
                                            ps.planes, chunk=128)
        si_err = (t - t_p).abs().max().item()
        require(torch.equal(t, t_p) and torch.equal(slot, slot_p),
                f"{name}: sb_intersect (t, slot) != plain")
        t2, slot2 = si.sb_intersect_mt2(pt, psb, pm, n_real, rays, ps.planes)
        require(torch.equal(t2, t) and torch.equal(slot2, slot),
                f"{name}: sb_intersect_mt2 (t, slot) != sb_intersect")
        require(torch.equal(t2, t_p) and torch.equal(slot2, slot_p),
                f"{name}: sb_intersect_mt2 (t, slot) != plain")
        tx, slotx = si.sb_intersect_mxu(pt, psb, pm, n_real, rays, coef)
        tx_p, slotx_p = si.sb_intersect_mxu_plain(pt, psb, pm, n_real, rays,
                                                  coef, chunk=64)
        mxu_err = (tx - tx_p).abs().max().item()
        require(torch.equal(tx, tx_p) and torch.equal(slotx, slotx_p),
                f"{name}: sb_intersect_mxu (t, slot) != plain")
        live = rays[:r, 6] > 0
        hit_par, slot_par = mxu_bounds(scene, rays[:r][live], t[:r][live],
                                       tx[:r][live], slot[:r][live],
                                       slotx[:r][live])
        n_hit = int((slot[:nt * 128] >= 0).sum())
        work = si.tile_work(pt, pm, n_real, nt)
        n_sub = int(work.sum())
        ws = torch.sort(work)[0]
        log(f"[kernels] {name}: live sub-blocks per ray tile: mean "
            f"{float(work.double().mean()):.4f}, p99 "
            f"{int(ws[int(0.99 * (nt - 1))])}, max {int(ws[-1])}, "
            f"{int((work == 0).sum())} empty tiles of {nt}")
        log(f"[kernels] {name}: {r} rays, {nt} tiles, n_live "
            f"{int(n_live)}, {int(n_real)} round-1 pairs, {n_sub} live "
            f"sub-blocks, {n_hit} hits; kernels == plain exactly, mt2 == mt "
            f"exactly; mxu vs mt: hit parity {hit_par:.6f}, slot parity "
            f"{slot_par:.6f}; {mt2_stages(pt, pm, n_real)}")

        # bounds from this run's inputs: every input read once, every
        # output written once; operations of the tests this data needs
        # (the cull kernels': cull_work's, the dense count beside them)
        n_rows = rays.shape[0]
        ray_b, pair_b = n_rows * 16 * 4, int(n_real) * 4
        work = cull_work(rays, sb_rows, n_live, pt, psb, n_real, sbbox, pm)
        dense = {k: bound(w["dense_ops"], w["bytes"]) for k, w in work.items()}
        log(f"[kernels] {name}: cull survivors (plain emulation of the "
            f"reject): block_cull {work['block_cull']['share']:.4f} of the "
            f"live (tile, box) entries, pair_cull "
            f"{work['pair_cull']['share']:.4f} of the "
            f"real pairs' blocks")
        bounds = {
            **{k: bound(w["ops"], w["bytes"]) for k, w in work.items()},
            "sb_intersect": bound(n_sub * 128 * 128 * MT_OPS,
                                  ray_b + 3 * pair_b + ps.planes.numel() * 4
                                  + n_rows * 8),
            "sb_intersect_mxu": bound(n_sub * 128 * 128 * MXU_OPS,
                                      ray_b + 3 * pair_b + coef.numel() * 4
                                      + n_rows * 8),
        }
        bounds["sb_intersect_mt2"] = bounds["sb_intersect"]
        # the -fmad=false issue floor of a walk with no skip: every fp32
        # add and multiply of every test is its own instruction, at most
        # one per lane and cycle (half the fp32 peak, which counts an FMA
        # as two operations).  Log only: the walk's skip leaves out the
        # second half of some tests, so it is no floor of the kernel.
        floors = {k: n_sub * 128 * 128 * ops / (FP32_PER_S / 2) * 1e3
                  for k, ops in (("sb_intersect", MT_OPS),
                                 ("sb_intersect_mt2", MT_OPS),
                                 ("sb_intersect_mxu", MXU_OPS))}

        times = {
            "block_cull": (cuda_ms(lambda: cull.block_cull(
                rays, sb_rows, n_live), 20), cuda_ms(
                lambda: cull.block_cull_plain(rays, sb_rows, n_live), 3),
                bc_err),
            "pair_cull": (cuda_ms(lambda: cull.pair_cull(
                pt, psb, n_real, rays, sbbox), 20), cuda_ms(
                lambda: cull.pair_cull_plain(pt, psb, n_real, rays, sbbox),
                3), pc_err),
            "sb_intersect": (cuda_ms(lambda: si.sb_intersect(
                pt, psb, pm, n_real, rays, ps.planes), 5), cuda_ms(
                lambda: si.sb_intersect_plain(pt, psb, pm, n_real, rays,
                                              ps.planes, chunk=128), 1),
                si_err),
            "sb_intersect_mt2": (cuda_ms(lambda: si.sb_intersect_mt2(
                pt, psb, pm, n_real, rays, ps.planes), 5), None,
                (t2 - t_p).abs().max().item()),
            "sb_intersect_mxu": (cuda_ms(lambda: si.sb_intersect_mxu(
                pt, psb, pm, n_real, rays, coef), 5), cuda_ms(
                lambda: si.sb_intersect_mxu_plain(pt, psb, pm, n_real, rays,
                                                  coef, chunk=64), 1),
                mxu_err),
        }
        # "mt2" computes the "mt" function: one plain version, timed once
        times["sb_intersect_mt2"] = ((times["sb_intersect_mt2"][0],
                                      times["sb_intersect"][1])
                                     + times["sb_intersect_mt2"][2:])
        for k, (ms, pms, err) in times.items():
            times[k] = (ms, pms, err) + bounds[k]
            floor = (f", no-skip issue floor {floors[k]:.4f} ms "
                     f"({floors[k] / ms:.3f} of it)" if k in floors else
                     f", dense bound {dense[k][0]:.4f} ms by {dense[k][1]} "
                     f"({dense[k][0] / ms:.3f} of it)" if k in dense else "")
            log(f"[kernels] {name} {k}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms ({pms / ms:.1f}x), bound {bounds[k][0]:.4f} "
                f"ms by {bounds[k][1]} ({bounds[k][0] / ms:.3f} of it)"
                f"{floor}, max |kernel - plain| {err}")
        rows[name] = times
    return rows, step_inputs(scene, cfg, carry1, bounce_s[1])


def step_inputs(scene, cfg, carry, samples, queries=STEP_QUERIES,
                tag="bounce1"):
    """Both cull kernels, sb_intersect and sb_intersect_mt2 against their
    plain versions on every input one bounce step gives them (the step at
    ``carry``, one input per query of ``queries``), recorded while the
    step runs on the kernels: equal exactly ("mt2" also equal to "mt"),
    with pairs, live sub-blocks, survivor shares, the "mt2" walk's stages
    and kernel times.  Returns each kernel's largest |kernel - plain|."""
    import torch
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    calls = record_step(scene, cfg, carry, samples, queries)
    errs = {}
    for label, bargs, pargs, sargs in zip(queries, calls["block_cull"],
                                          calls["pair_cull"],
                                          calls["sb_intersect"]):
        rays, rows, n_live = bargs
        tn, tn_p = cull.block_cull(*bargs), cull.block_cull_plain(*bargs)
        require(torch.equal(tn, tn_p), f"{tag} {label}: block_cull != "
                "plain")
        pm, pm_p = cull.pair_cull(*pargs), cull.pair_cull_plain(*pargs)
        require(torch.equal(pm, pm_p), f"{tag} {label}: pair_cull != "
                "plain")
        mt = si.sb_intersect(*sargs)
        mt2 = si.sb_intersect_mt2(*sargs)
        ref = si.sb_intersect_plain(*sargs, chunk=128)
        require(all(map(torch.equal, mt, ref)), f"{tag} {label}: "
                "sb_intersect (t, slot) != plain")
        require(all(map(torch.equal, mt2, ref)), f"{tag} {label}: "
                "sb_intersect_mt2 (t, slot) != plain")
        require(all(map(torch.equal, mt2, mt)), f"{tag} {label}: "
                "sb_intersect_mt2 (t, slot) != sb_intersect")
        for k, e in (("block_cull", (tn - tn_p).abs().max().item()),
                     ("pair_cull", (pm - pm_p).abs().max().item()),
                     ("sb_intersect", (mt[0] - ref[0]).abs().max().item()),
                     ("sb_intersect_mt2",
                      (mt2[0] - ref[0]).abs().max().item())):
            errs[k] = max(errs.get(k, 0.0), e)
        pt, psb, n_real, prays, sbbox = pargs
        work = cull_work(rays, rows, n_live, pt, psb, n_real, sbbox, pm)
        ms_b = cuda_ms(lambda: cull.block_cull(*bargs), 20)
        ms_p = cuda_ms(lambda: cull.pair_cull(*pargs), 20)
        ms_mt = cuda_ms(lambda: si.sb_intersect(*sargs), 5)
        ms_mt2 = cuda_ms(lambda: si.sb_intersect_mt2(*sargs), 5)
        n_sub = int(si.live_counts(pm, n_real).sum())
        log(f"[kernels] {tag} {label}: n_live {int(n_live)}, "
            f"{int((tn < INF_DIST).sum())} passing (tile, box) entries, "
            f"{int(n_real)} pairs; survivors block_cull "
            f"{work['block_cull']['share']:.4f}, pair_cull "
            f"{work['pair_cull']['share']:.4f}; "
            f"block_cull {ms_b:.4f} ms, pair_cull {ms_p:.4f} ms; == plain "
            f"exactly; {n_sub} live sub-blocks, sb_intersect {ms_mt:.4f} "
            f"ms, sb_intersect_mt2 {ms_mt2:.4f} ms, mt2 == mt == plain "
            f"exactly; {mt2_stages(pt, pm, n_real)}")
    return errs


def plain_versions():
    """Run every kernel wrapper on its plain version (parity phases only;
    the pair intersector 128 pairs a step)."""
    import functools
    from prismarine_core_tpu_torch.ops import sb_intersect as si
    faster = {si.sb_intersect_plain: functools.partial(
        si.sb_intersect_plain, chunk=128)}
    return seam_choice(lambda x, launch, plain, choose: faster.get(plain,
                                                                   plain))


def frame_samples(cfg, dev, seed=0):
    """A frame's sample arrays as bench.py draws them: 64x64-block
    coherent uniforms under ``coherent_bounce_sampling``, else independent
    ones (the first frame of a ProgressiveRenderer seeded ``seed``)."""
    import torch
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays, make_sample_arrays)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if cfg.coherent_bounce_sampling:
        return make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    return make_sample_arrays(gen, cfg.n_rays, cfg.max_bounces, device=dev)


def phase_frame(scene, cam, cfg, dev, n_frames=3, tag="frame",
                max_launches=MAX_LAUNCHES, mean_band=MEAN_BAND, ranges=None,
                kernels=MT_PATH):
    """One frame of ``cfg`` on ``scene`` with every launch counter read
    around it (each kernel of ``kernels`` 1..``max_launches`` times, every
    other kernel 0), finite, its mean in ``mean_band``; host syncs,
    ``n_frames`` timed frames (equal to the first), peak memory and one
    profiled frame (under the profiler ranges that ``ranges()`` opens, if
    given)."""
    import torch
    from prismarine_core_tpu_torch.utils.profiling import counts
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)

    cam_s, bounce_s = frame_samples(cfg, dev)

    # the main-path run: counters from 0, read right after
    sharded = cfg.intersector == "pallas_sharded"
    read = zero_launches(sharded)
    syncs0 = counts["pc.sync.compact"]
    t0 = time.perf_counter()
    img, stats = render_with_samples(scene, cam, cfg, cam_s, bounce_s,
                                     with_stats=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read()
    compactions = counts["pc.sync.compact"] - syncs0
    log(f"[{tag}] first frame {first_s:.3f} s; launches {launches}; "
        f"{compactions} pair compactions")
    for k, n in launches.items():
        require(n == (0 if sharded else cfg.max_bounces) if k == "surface"
                else 0 < n <= max_launches if k in kernels else n == 0,
                f"{tag} {k}: {n} launches")
    require(img.shape == (cfg.height, cfg.width, 3), f"{tag} image shape "
            f"{tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{tag}: non-finite image")
    mean = float(img.mean())
    require(mean_band[0] <= mean <= mean_band[1], f"{tag} image mean "
            f"{mean}")
    stats = stats.cpu()
    rays = int(stats[:, 0].sum() + stats[:, 4].sum())
    log(f"[{tag}] mean {mean:.6f}; stats {stats.tolist()}")

    # every host sync torch detects over one frame, less what switching
    # the detection on and off reports by itself
    from bench_port.trace import host_syncs
    sources = host_syncs(lambda: render_with_samples(
        scene, cam, cfg, cam_s, bounce_s))
    syncs = sum(sources.values())

    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        out = render_with_samples(scene, cam, cfg, cam_s, bounce_s)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    require(torch.equal(out, img), f"{tag}: frames differ between runs")
    ms = 1e3 * sum(times) / n_frames
    result = dict(ms_per_frame=ms, frame_ms=[1e3 * t for t in times],
                  live_rays=rays, mrays_per_s=rays / (ms * 1e3),
                  host_syncs_per_frame=syncs,
                  compactions_per_frame=compactions,
                  peak_mem_bytes=peak, mean=mean, stats=stats.tolist(),
                  launches=launches)
    log(f"[{tag}] {ms:.3f} ms/frame over {n_frames} frames "
        f"({', '.join(f'{1e3 * t:.3f}' for t in times)}); {rays} live rays "
        f"-> {rays / (ms * 1e3):.3f} Mrays/s; {syncs} host syncs per frame "
        f"({compactions} of them pair compactions); peak memory "
        f"{peak / 2**20:.1f} MiB")
    log(f"[{tag}] host syncs by source line: "
        f"{dict(sources.most_common())}")
    with ranges() if ranges else contextlib.nullcontext():
        result["profile"] = profile_once(lambda: render_with_samples(
            scene, cam, cfg, cam_s, bounce_s), tag,
            (TEX_FETCH, TEX_GATHER) if ranges else ())
    return img, result, (cam_s, bounce_s)


def image_gate(img, ref, tag, what="plain-version frame"):
    """``img`` against ``ref``: >= 98% of pixels ``isclose(rtol=1e-3,
    atol=1e-3)``, the mean within 0.5%, finite; logged with whether the
    two are bit-identical."""
    import numpy as np
    a, b = img.cpu().numpy(), ref.cpu().numpy()
    close = np.isclose(a, b, rtol=1e-3, atol=1e-3).all(axis=-1).mean()
    same = bool(np.array_equal(a, b))
    log(f"[{tag}] against the {what}: pixel parity {close:.6f}, mean "
        f"{a.mean():.6f} vs {b.mean():.6f}, bit-identical {same}")
    require(bool(np.isfinite(a).all()), f"{tag}: non-finite image")
    require(close >= 0.98, f"{tag}: pixel parity {close}")
    require(abs(a.mean() - b.mean()) <= 5e-3 * abs(b.mean()),
            f"{tag}: image mean {a.mean()} vs {b.mean()}")
    return dict(pixel_parity=float(close), ref_mean=float(b.mean()),
                bit_identical=same)


def phase_parity(scene, cam, cfg, img, samples, tag="parity"):
    """The same frame on the kernels' plain versions: the image gate."""
    import torch
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    t0 = time.perf_counter()
    with plain_versions():
        ref = render_with_samples(scene, cam, cfg, *samples)
    torch.cuda.synchronize()
    log(f"[{tag}] plain-version frame in {time.perf_counter() - t0:.1f} s")
    return image_gate(img, ref, tag)


def zero_launches(sharded=False):
    """A reader of every kernel's launches since this call (the counts of
    its ``pc.kernel.<name>`` span).  It checks the surface kernel's at each
    read: one launch in each ``pc.surface`` span since the call, or none on
    a ``sharded`` path (there the sharded query carries the surface); and
    the shading kernel's: one launch in each ``pc.bounce`` span on every
    path, the NEE resolve at most as many."""
    from prismarine_core_tpu_torch.utils.profiling import counts
    start = {k: counts[f"pc.kernel.{k}"] for k in KERNELS + SHADE_KERNELS}
    spans0, bounces0 = counts["pc.surface"], counts["pc.bounce"]

    def read():
        out = {k: counts[f"pc.kernel.{k}"] - n for k, n in start.items()}
        spans = counts["pc.surface"] - spans0
        bounces = counts["pc.bounce"] - bounces0
        require(out["surface"] == (0 if sharded else spans),
                f"surface kernel: {out['surface']} launches in {spans} "
                f"surface spans{' (sharded)' if sharded else ''}")
        require(out["shade"] == bounces
                and out["nee_resolve"] <= out["shade"],
                f"shading kernels: {out['shade']} / {out['nee_resolve']} "
                f"launches in {bounces} bounce spans")
        return {k: n for k, n in out.items() if k in KERNELS}
    return read


def phase_frame_mt2(scene, cam, cfg, img, samples, n_frames=3):
    """The bench frame under kernel_form="mt2": bit-identical to "mt"."""
    import torch
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    cfg2 = cfg.replace(kernel_form="mt2")
    read = zero_launches()
    img2 = render_with_samples(scene, cam, cfg2, *samples)
    torch.cuda.synchronize()
    launches = read()
    log(f"[frame mt2] launches {launches}")
    require(0 < launches["sb_intersect_mt2"] <= MAX_LAUNCHES,
            f"sb_intersect_mt2: {launches['sb_intersect_mt2']} launches")
    require(launches["sb_intersect"] == 0, "the mt2 frame ran sb_intersect")
    require(torch.equal(img2, img), "mt2 frame != mt frame")
    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        render_with_samples(scene, cam, cfg2, *samples)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / n_frames
    log(f"[frame mt2] bit-identical to the mt frame; {ms:.3f} ms/frame over "
        f"{n_frames} frames ({', '.join(f'{1e3 * t:.3f}' for t in times)})")
    prof = profile_once(lambda: render_with_samples(scene, cam, cfg2,
                                                    *samples), "frame mt2")
    return dict(ms_per_frame=ms, frame_ms=[1e3 * t for t in times],
                launches=launches, profile=prof)


@contextlib.contextmanager
def texture_ranges():
    """Profiler ranges around the textured frame's fetches (TEX_FETCH:
    the integrator's ``texture_fields``, the texture kernel's launch on
    the card) and the row gathers of the plain fetch inside them
    (TEX_GATHER: the texel rows and the size table, where the plain
    version runs), by wrappers set in the functions' place for one
    profiled frame."""
    from torch.profiler import record_function
    from prismarine_core_tpu_torch.models import textures as tx
    from prismarine_core_tpu_torch.render import integrator as it

    def ranged(name, fn):
        def run(*args):
            with record_function(name):
                return fn(*args)
        return run
    saved = (it.texture_fields, tx._texel_rows, tx._tex_size)
    it.texture_fields = ranged(TEX_FETCH, saved[0])
    tx._texel_rows = ranged(TEX_GATHER, saved[1])
    tx._tex_size = ranged(TEX_GATHER, saved[2])
    try:
        yield
    finally:
        it.texture_fields, tx._texel_rows, tx._tex_size = saved


def fetch_times(scene, stub_scene, cam, cfg, dev):
    """The textured surface step at full width, on the camera rays' hits
    (CUDA events, 10 launches after a warm-up): ``_interpolate_surface``
    on the textured hall and on the stub hall (the same geometry), one
    packed diffuse fetch (``sample_bilinear``), and that fetch's quad-row
    gather alone beside its bytes bound (each row read and written once,
    the index read once).  Both surfaces take their fields at the hit from
    the surface kernel (``csrc/surface.cu``), so the stub's time is that
    kernel's, and the textured time less the stub's is the texture maps'
    (the texture kernel, and the surface kernel's uv and tangent)."""
    import torch
    from prismarine_core_tpu_torch.models import textures as tx
    from prismarine_core_tpu_torch.models.camera import generate_rays
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.render.integrator import (
        _interpolate_surface, closest_hit)
    from prismarine_core_tpu_torch.utils import math as pm
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    gen = torch.Generator(device=dev).manual_seed(0)
    cam_s, _ = make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    o, d = generate_rays(cam, cfg, cam_s)
    hit = closest_hit(scene, o, d, cfg,
                      t_cap=torch.full(o.shape[:1], INF_DIST, device=dev))
    kinds = scene.materials.kinds_bound
    surf = _interpolate_surface(scene, hit, cfg, kinds)
    tri = torch.clamp(hit.tri, min=0).long()
    tid = pm.take_rows(scene.materials.tex_diffuse,
                       scene.triangles.mat_id[tri].long())
    uv = surf["uv"]
    stack = scene.textures
    # the fetch's own texel index (sample_bilinear's formula)
    n, h, w, _ = stack.quad.shape
    tid_c = torch.clamp(tid, 0, n - 1).long()
    wi, hi = tx._tex_size(stack, tid_c)
    x0 = torch.floor(torch.remainder(uv[:, 0], 1.0) * wi - 0.5)
    y0 = torch.floor(torch.remainder(uv[:, 1], 1.0) * hi - 0.5)
    flat = ((tid_c * h + torch.remainder(y0.to(torch.int32), hi).long())
            * w + torch.remainder(x0.to(torch.int32), wi).long())
    rows = stack.quad.reshape(-1, 16)
    out = dict(
        surface_textured_ms=cuda_ms(
            lambda: _interpolate_surface(scene, hit, cfg, kinds), 10),
        surface_stub_ms=cuda_ms(
            lambda: _interpolate_surface(stub_scene, hit, cfg, None), 10),
        fetch_ms=cuda_ms(lambda: tx.sample_bilinear(stack, tid, uv), 10),
        quad_gather_ms=cuda_ms(lambda: pm.take_rows(rows, flat), 10),
        quad_gather_bound_ms=bound(0, 2 * flat.numel() * 64
                                   + flat.numel() * 8)[0],
        lanes=int(tid.numel()), textured_lanes=int((tid >= 0).sum()))
    out["texture_chain_ms"] = (out["surface_textured_ms"]
                               - out["surface_stub_ms"])
    log(f"[fetch] {out['lanes']} camera-ray hits ({out['textured_lanes']} "
        f"on a diffuse texture): _interpolate_surface textured "
        f"{out['surface_textured_ms']:.4f} ms, stub (the surface kernel) "
        f"{out['surface_stub_ms']:.4f} ms, so the texture chain "
        f"{out['texture_chain_ms']:.4f} ms; one packed bilinear fetch "
        f"{out['fetch_ms']:.4f} ms; its quad-row gather alone "
        f"{out['quad_gather_ms']:.4f} ms against a bytes bound of "
        f"{out['quad_gather_bound_ms']:.4f} ms")
    return out


def phase_textured(bench_scene, cam, cfg, dev, target_tris=100_000):
    """bench.py's textured hall frame: ``make_hall_scene(textured=True)``
    (512^2 diffuse and bump textures, corner-packed), the bench sky,
    camera and config; the frame's gates (mean > 1e-2), its plain-version
    parity, a profile with the texture gathers as a group, the fetch
    times, and the kernels against their plain versions on the three
    inputs of the textured bounce-1 step."""
    import torch
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene, make_sky_environment)
    t0 = time.perf_counter()
    scene = make_hall_scene(target_tris=target_tris, textured=True,
                            device=dev)
    scene = dataclasses.replace(
        scene, environment=make_sky_environment(resolution=128, device=dev))
    torch.cuda.synchronize()
    st = scene.textures
    log(f"[scene textured] {int(scene.triangles.num_valid())} tris, "
        f"textures {tuple(st.data.shape)} + quads "
        f"{st.quad.numel() * 4 / 2**20:.1f} MiB, kinds bound "
        f"{scene.materials.kinds_bound}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    img, res, samples = phase_frame(scene, cam, cfg, dev,
                                    tag="frame textured",
                                    mean_band=(1e-2, math.inf),
                                    ranges=texture_ranges)
    res["parity"] = phase_parity(scene, cam, cfg, img, samples,
                                 tag="parity textured")
    res["fetch"] = fetch_times(scene, bench_scene, cam, cfg, dev)
    _, _, _, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    res["step_errs"] = step_inputs(scene, cfg, carry1, bounce_s[1],
                                   tag="textured bounce1")
    return res


def phase_env_nee(scene, cam, cfg, dev):
    """The bench frame with ``env_nee=True``: the frame's gates with up to
    16 launches (mean > 1e-2), its plain-version parity, and both culls,
    "mt" and "mt2" against their plain versions on the four inputs of one
    bounce-1 step (closest rounds 1 and 2, sun shadow, env shadow)."""
    cfg_e = cfg.replace(env_nee=True)
    img, res, samples = phase_frame(scene, cam, cfg_e, dev,
                                    tag="frame env_nee",
                                    max_launches=MAX_LAUNCHES_ENV,
                                    mean_band=(1e-2, math.inf))
    res["parity"] = phase_parity(scene, cam, cfg_e, img, samples,
                                 tag="parity env_nee")
    _, _, _, carry1, bounce_s = first_bounce(scene, cam, cfg_e, dev)
    res["step_errs"] = step_inputs(scene, cfg_e, carry1, bounce_s[1],
                                   ENV_STEP_QUERIES, tag="env_nee bounce1")
    return res


def record_walks(scene, cfg, carry, samples):
    """The arguments of the two ``bvh_walk`` calls of one bounce step at
    ``carry`` under ``cfg`` (intersector "bvh", on the kernel): the
    closest query and the shadow query."""
    from prismarine_core_tpu_torch.render.integrator import make_bounce_step
    with recorded_calls(("bvh_walk",)) as calls:
        make_bounce_step(scene, cfg)(carry, samples)
    calls = calls["bvh_walk"]
    require(len(calls) == 2, f"walks in one bounce step: {len(calls)}")
    return calls


def alternating_ms(fns, turns=5, reps=10):
    """Median CUDA-event ms of each of ``fns`` over ``turns`` turns taken
    in alternation, ``reps`` launches a turn (and each turn's values)."""
    import statistics
    runs = {k: [] for k in fns}
    for _ in range(turns):
        for k, fn in fns.items():
            runs[k].append(cuda_ms(fn, reps))
    return {k: statistics.median(v) for k, v in runs.items()}, runs


def walk_build_lines():
    """The walk kernels' ``[build]`` lines (registers, spills) from the
    library's ``-Xptxas -v`` log."""
    from prismarine_core_tpu_torch import _build
    lib_path = _build.library_path()
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    if not ptxas.exists():
        return []
    return [line for line in ptxas_lines(ptxas.read_text())
            if line.startswith("bvh_walk_kernel")]


def phase_walk(scene, cam, cfg, dev):
    """The BVH walk kernel at the bench frame's bounce-1 rays: equal to
    its plain version on the closest query (with every cap INF_DIST, the
    first form's input, and as the bounce step gives it, dead lanes
    capped at 0) and the shadow query of the bounce-1 step under "bvh";
    traversal_stats and the bounds of the work each input needs (a dead
    lane ends before its first step), the times in alternating turns with
    node steps and leaf visits per second, the dead-lane share and the
    kernel's registers, and the "bvh" query against the "pallas" one."""
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.accel import traverse as tr
    from prismarine_core_tpu_torch.ops import bvh_walk as bw
    from prismarine_core_tpu_torch.render.integrator import _pallas_kwargs
    from prismarine_core_tpu_torch.utils.config import INF_DIST, PZERO
    cfg_b = cfg.replace(intersector="bvh")
    _, _, _, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    (bvh, co, cd, ct, _), (_, so, sd, st, _) = record_walks(
        scene, cfg_b, carry1, bounce_s[1])
    alive = carry1[4]
    require(torch.equal(ct, torch.where(alive, INF_DIST, 0.0)),
            "the bvh closest query's cap is not the bounce's")
    ci = torch.full_like(ct, INF_DIST)
    queries = {"closest": (co, cd, ci, False),
               "closest_capped": (co, cd, ct, False),
               "shadow": (so, sd, st, True)}
    k = bvh.leaf_size
    tree_b = bvh.n_nodes * WALK_NODE_BYTES + bvh.tv0.shape[0] * WALK_SLOT_BYTES
    dead_share = float((ct <= PZERO).float().mean())
    out = {"rays": co.shape[0], "dead_share_closest": dead_share,
           "dead_share_shadow": float((st <= PZERO).float().mean()),
           "build": walk_build_lines()}
    for line in out["build"]:
        log(f"[walk] {line}")
    for label, (o, d, t_cap, any_hit) in queries.items():
        t, slot = bw.bvh_walk(bvh, o, d, t_cap, any_hit)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp, sp = bw.bvh_walk_plain_hits(bvh, o, d, t_cap, any_hit)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        require(torch.equal(t, tp) and torch.equal(slot, sp),
                f"bvh_walk {label} (t, slot) != plain")
        # the work of the lanes the kernel walks: a lane capped <= PZERO
        # ends before its first step, reading its cap alone
        walked = t_cap > PZERO
        n_walked = int(walked.sum())
        stats = tr.traversal_stats(bvh, o[walked], d[walked], t_cap[walked],
                                   any_hit)
        ops = SLAB_OPS * stats["steps"] + MT_OPS * k * stats["leaf_visits"]
        b = bound(ops, n_walked * WALK_RAY_BYTES + tree_b
                  + (o.shape[0] - n_walked) * WALK_DEAD_BYTES)
        log(f"[walk] bounce1 {label}: {o.shape[0]} rays "
            f"({n_walked} walked, t_cap > PZERO), "
            f"{int((slot >= 0).sum())} hits; == plain exactly on every "
            f"ray, the plain walk {plain_ms:.1f} ms (host clock); "
            f"traversal_stats of the walked lanes {stats}; "
            f"bound {b[0]:.4f} ms by {b[1]}")
        out[label] = dict(stats=stats, bound_ms=b[0], bound_by=b[1],
                          plain_ms=plain_ms, hits=int((slot >= 0).sum()),
                          walked=n_walked,
                          max_abs_err=float((t - tp).abs().max()))

    # the coherence sort of _run_traversal: keys, sort, inverse, the three
    # gathers in and the two out
    def sort_rays():
        perm = torch.sort(tr._ray_sort_keys(bvh, co, cd), stable=True)[1]
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.shape[0], device=dev)
        return co[perm], cd[perm], ci[perm], inv
    po, pd, pt, inv = sort_rays()
    ts_, ss_ = bw.bvh_walk(bvh, po, pd, pt)
    t_u, s_u = bw.bvh_walk(bvh, co, cd, ci)
    require(torch.equal(ts_[inv], t_u) and torch.equal(ss_[inv], s_u),
            "bvh_walk on sorted rays != unsorted")

    def sort_cost():
        _, _, _, i = sort_rays()
        return ts_[i], ss_[i]
    med, runs = alternating_ms({
        "closest": lambda: bw.bvh_walk(bvh, co, cd, ci),
        "closest_capped": lambda: bw.bvh_walk(bvh, co, cd, ct),
        "sort": sort_cost,
        "closest_sorted": lambda: bw.bvh_walk(bvh, po, pd, pt),
        "shadow": lambda: bw.bvh_walk(bvh, so, sd, st, True)})
    out["ms"], out["turns_ms"] = med, runs
    # what walk_records saves each call after the first on one BVH
    out["pack_ms"] = cuda_ms(lambda: (bw.pack_nodes(bvh),
                                      bw.pack_slots(bvh)), 10)
    log(f"[walk] packing the node and slot records {out['pack_ms']:.4f} ms "
        f"({bvh.n_nodes} nodes, {bvh.tv0.shape[0]} slots); walk_records "
        f"packs once per BVH")
    rates = {}
    for label, q in (("closest", "closest"),
                     ("closest_capped", "closest_capped"),
                     ("closest_sorted", "closest"),
                     ("shadow", "shadow")):
        st_ = out[q]["stats"]
        rates[label] = {"node_steps_per_s": st_["steps"] / med[label] * 1e3,
                        "leaf_visits_per_s":
                            st_["leaf_visits"] / med[label] * 1e3}
    out["rates"] = rates
    ci_b, cb = out["closest"]["bound_ms"], out["closest_capped"]["bound_ms"]
    sb = out["shadow"]["bound_ms"]
    log(f"[walk] bounce1 times (medians of 5 alternating turns of 10 "
        f"launches): closest at every cap INF_DIST (the first form's "
        f"input) {med['closest']:.4f} ms ({ci_b / med['closest']:.4f} of "
        f"its bound {ci_b:.4f}); as the bounce step gives it (dead share "
        f"{dead_share:.4f}) {med['closest_capped']:.4f} ms "
        f"({cb / med['closest_capped']:.4f} of its bound {cb:.4f}); "
        f"coherence sort {med['sort']:.4f} ms + closest on sorted rays "
        f"(every cap INF_DIST) {med['closest_sorted']:.4f} ms "
        f"({ci_b / med['closest_sorted']:.4f} of the bound); shadow "
        f"{med['shadow']:.4f} ms ({sb / med['shadow']:.4f} of its bound "
        f"{sb:.4f} by {out['shadow']['bound_by']}); turns "
        f"{({k: [round(x, 4) for x in v] for k, v in runs.items()})}")
    for label, r in rates.items():
        log(f"[walk] bounce1 {label}: {r['node_steps_per_s'] / 1e9:.2f} G "
            f"node steps/s, {r['leaf_visits_per_s'] / 1e9:.3f} G leaf "
            f"visits/s")

    # the "bvh" query against the "pallas" query on the same rays
    o1, d1, alive = carry1[0], carry1[1], carry1[4]
    hb = tr.intersect_closest_bvh(scene.bvh, scene.triangles, o1, d1)
    hp = pk.intersect_closest_pallas(
        scene.bvh, scene.packets, scene.triangles, o1, d1,
        t_cap=torch.where(alive, INF_DIST, 0.0),
        **_pallas_kwargs(cfg, any_hit=False))
    tb, tp_ = hb.tri[alive], hp.tri[alive]
    agree = (tb >= 0) == (tp_ >= 0)
    both = (tb >= 0) & (tp_ >= 0)
    diff = both & (tb != tp_)
    tie = diff & (hb.t[alive] == hp.t[alive])
    other = diff & ~tie
    n_edge = n_graze = 0
    if other.any():
        oo, dd = o1[alive][other], d1[alive][other]
        (eb, cb_), (ep, cp) = (edge_cos(scene, oo, dd, x[other])
                               for x in (tb, tp_))
        edge = torch.minimum(eb, ep) < 1e-3
        graze = ~edge & (torch.minimum(cb_, cp) < 1e-2)
        n_edge, n_graze = int(edge.sum()), int(graze.sum())
    n_hits = int(both.sum())
    non_tie = int(other.sum()) + int((~agree).sum())
    log(f"[walk] bvh vs pallas, bounce-1 closest query on {int(alive.sum())} "
        f"live lanes: hit/miss agree on {float(agree.float().mean()):.6f} "
        f"({int((~agree).sum())} lanes differ), triangle agrees on "
        f"{1 - int(diff.sum()) / max(n_hits, 1):.6f} of {n_hits} joint hits; "
        f"{int(tie.sum())} tie lanes (equal t), {int(other.sum())} others "
        f"({n_edge} within 1e-3 of an edge of either triangle, {n_graze} "
        f"grazing); non-tie lanes {non_tie} against a limit of "
        f"{1e-4 * n_hits:.1f}")
    require(non_tie <= 1e-4 * n_hits, f"bvh vs pallas: {non_tie} non-tie "
            "lanes")
    out["vs_pallas"] = dict(hit_agree=float(agree.float().mean()),
                            joint_hits=n_hits, ties=int(tie.sum()),
                            non_tie=non_tie, edge=n_edge, graze=n_graze)
    return out


#: bytes the surface kernel must move a lane: the hit (tri, u, v) read,
#: and written the fields shading reads (ns, ng, uv, albedo and alpha,
#: roughness and metallic, emissive, transmission, ior)
SURFACE_READ_BYTES, SURFACE_WRITE_BYTES = 12, 84
#: float32 words of a triangle and of a material that the texture-less
#: surface needs, read once: v0..v2, n0..n2 and mat_id; diffuse,
#: specular, emissive, transmission (4 each), ior and the 4 texture ids
SURFACE_TRI_WORDS, SURFACE_MAT_WORDS = 19, 21


def phase_surface(scene, cam, cfg, dev):
    """The surface kernel at the bounce-1 hits of the bench frame at 4 spp
    under "bvh" (the benchmark's 3,686,400 lanes): equal to its plain
    version bit for bit on every field; CUDA-event times of both in
    alternating turns; the bytes bound and the kernel's share of it; its
    registers; one 4-spp frame launching it once a bounce."""
    import torch
    from prismarine_core_tpu_torch import _build
    from prismarine_core_tpu_torch.models.materials import _ARRAY_FIELDS
    from prismarine_core_tpu_torch.ops import surface as sf
    from prismarine_core_tpu_torch.render.integrator import (
        closest_hit, render_with_samples)
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    from prismarine_core_tpu_torch.utils.profiling import counts
    t0 = time.perf_counter()
    cfg4 = cfg.replace(spp=4, intersector="bvh")
    _, _, _, carry1, _ = first_bounce(scene, cam, cfg4, dev)
    o1, d1, alive1 = carry1[0], carry1[1], carry1[4]
    hit = closest_hit(scene, o1, d1, cfg4,
                      t_cap=torch.where(alive1, INF_DIST, 0.0))
    r = int(hit.tri.shape[0])
    got = sf.surface_fields(scene, hit)
    want = sf.surface_fields_plain(scene, hit)
    torch.cuda.synchronize()

    def fields(f):
        ns, ng, uv, tang, mat = f
        return [("ns", ns), ("ng", ng), ("uv", uv)] + [
            (k, getattr(mat, k)) for k in _ARRAY_FIELDS]
    for (k, a), (_, b) in zip(fields(got), fields(want)):
        require(got[3] is None and want[3] is None and a.shape == b.shape
                and a.stride() == b.stride()
                and torch.equal(a.contiguous().view(torch.int32),
                                b.contiguous().view(torch.int32)),
                f"surface kernel != plain on {k}")
    ms, turns = alternating_ms({
        "kernel": lambda: sf.surface_fields(scene, hit),
        "plain": lambda: sf.surface_fields_plain(scene, hit)})
    soup_r, uv_r, mat_r = sf.surface_records(scene)
    nbytes = ((SURFACE_READ_BYTES + SURFACE_WRITE_BYTES) * r
              + 4 * (SURFACE_TRI_WORDS * soup_r.shape[0]
                     + SURFACE_MAT_WORDS * mat_r.shape[0]))
    bound_ms, bound_by = bound(0, nbytes)
    pack_ms = cuda_ms(lambda: (sf.pack_soup(scene.triangles,
                                            mat_r.shape[0]),
                               sf.pack_materials(scene.materials)), 10)
    lib_path = _build.library_path()
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    build = ([line for line in ptxas_lines(ptxas.read_text())
              if line.startswith("surface_fields_kernel")]
             if ptxas.exists() else [])
    gen = torch.Generator(device=dev).manual_seed(1)
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    samples = make_coherent_sample_arrays(gen, cfg4, block=(64, 64))
    k0, s0 = counts["pc.kernel.surface"], counts["pc.surface"]
    render_with_samples(scene, cam, cfg4, *samples)
    torch.cuda.synchronize()
    launches = counts["pc.kernel.surface"] - k0
    require(launches == BOUNCES and counts["pc.surface"] - s0 == BOUNCES,
            f"surface kernel launches in a 4-spp frame: {launches}")
    out = dict(lanes=r, missed=int((hit.tri < 0).sum()),
               ms=ms["kernel"], plain_ms=ms["plain"], turns_ms=turns,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms["kernel"], bytes=nbytes,
               pack_ms=pack_ms, build=build, launches_frame=launches,
               seconds=time.perf_counter() - t0)
    for line in build:
        log(f"[surface] {line}")
    log(f"[surface] {r} bounce-1 lanes ({out['missed']} missed) == plain "
        f"on every field; kernel {ms['kernel']:.4f} ms, plain "
        f"{ms['plain']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes} B), share {out['bound_share']:.4f}; records packed in "
        f"{pack_ms:.4f} ms; {launches} launches a 4-spp frame; "
        f"{out['seconds']:.1f} s")
    return out


#: bytes the shading kernel must move a lane (ops/shade.py): read by
#: every lane o, d, beta, radiance, alive and tri and written o, d, beta,
#: radiance, alive and the miss record (126); read by a lane that did not
#: miss its miss record (24); read by a lane on a surface t, ns, albedo and
#: alpha, roughness and metallic, emissive, transmission, ior and the
#: eight uniforms of a bounce with sphere NEE (100); written by every lane
#: with sphere NEE the shadow ray, t_query and the factor (40)
SHADE_LANE_BYTES, SHADE_KEPT_BYTES = 126, 24
SHADE_SURFACE_BYTES, SHADE_NEE_BYTES = 100, 40
#: the NEE resolve's: radiance and the occlusion bit read and the sum
#: written (25); the factor read where not occluded (12)
RESOLVE_LANE_BYTES, RESOLVE_VISIBLE_BYTES = 25, 12


def phase_shade(scene, cam, cfg, dev):
    """The shading kernels at the bounce-1 step of the bench frame at 4
    spp under "bvh" (the benchmark's 3,686,400 lanes): every output equal
    to the plain version's bit for bit; CUDA-event times of both kernels
    and both plain versions in alternating turns; the bytes bounds and the
    kernels' shares of them; their registers; one 4-spp frame launching
    each once a bounce."""
    import torch
    from prismarine_core_tpu_torch.ops import shade as sh
    from prismarine_core_tpu_torch.render.integrator import (
        _interpolate_surface, closest_hit, occluded, render_with_samples,
        surface_kinds)
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    from prismarine_core_tpu_torch.utils.profiling import counts
    t0 = time.perf_counter()
    cfg4 = cfg.replace(spp=4, intersector="bvh")
    _, _, _, carry1, bounce_s = first_bounce(scene, cam, cfg4, dev)
    alive1 = carry1[4]
    hit = closest_hit(scene, carry1[0], carry1[1], cfg4,
                      t_cap=torch.where(alive1, INF_DIST, 0.0))
    surf = _interpolate_surface(scene, hit, cfg4, surface_kinds(scene))
    spec = sh.Spec.of(cfg4, scene.lights.count, 1)
    require(spec.nee and not spec.env_nee and not spec.rr,
            f"shade phase: flags {spec}")
    xs = sh.shade_inputs(carry1, hit, surf, bounce_s[1], scene.lights)
    got = sh.shade(spec, *xs)
    want = sh.shade_plain(spec, *xs)
    torch.cuda.synchronize()
    for k, a, b in zip(sh.OUTPUTS, got, want):
        require((a is None) == (b is None) and (a is None or (
            a.shape == b.shape and a.dtype == b.dtype and torch.equal(
                a.contiguous().view(torch.int32) if a.is_floating_point()
                else a, b.contiguous().view(torch.int32)
                if b.is_floating_point() else b))),
                f"shade kernel != plain on {k}")
    occ = occluded(scene, got.shadow_o, got.ldir, got.t_query, cfg4)
    res = sh.nee_resolve(got.radiance, got.factor, occ)
    require(torch.equal(res.view(torch.int32), sh.nee_resolve_plain(
        got.radiance, got.factor, occ).view(torch.int32)),
        "nee_resolve kernel != plain")
    ms, turns = alternating_ms({
        "shade": lambda: sh.shade(spec, *xs),
        "shade_plain": lambda: sh.shade_plain(spec, *xs),
        "resolve": lambda: sh.nee_resolve(got.radiance, got.factor, occ),
        "resolve_plain": lambda: sh.nee_resolve_plain(got.radiance,
                                                       got.factor, occ)})
    r = int(alive1.shape[0])
    on = int(got.counts[1])
    missed = int(got.counts[2])
    visible = int((~occ).sum())
    nbytes = (r * (SHADE_LANE_BYTES + SHADE_NEE_BYTES)
              + (r - missed) * SHADE_KEPT_BYTES + on * SHADE_SURFACE_BYTES)
    rbytes = r * RESOLVE_LANE_BYTES + visible * RESOLVE_VISIBLE_BYTES
    bound_ms, bound_by = bound(0, nbytes)
    rbound_ms, rbound_by = bound(0, rbytes)
    from prismarine_core_tpu_torch import _build
    lib_path = _build.library_path()
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    build = ([line for line in ptxas_lines(ptxas.read_text())
              if line.startswith(("shade_kernel", "nee_resolve_kernel"))]
             if ptxas.exists() else [])
    gen = torch.Generator(device=dev).manual_seed(1)
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    samples = make_coherent_sample_arrays(gen, cfg4, block=(64, 64))
    k0, k1, b0 = (counts["pc.kernel.shade"], counts["pc.kernel.nee_resolve"],
                  counts["pc.bounce"])
    render_with_samples(scene, cam, cfg4, *samples)
    torch.cuda.synchronize()
    launches = counts["pc.kernel.shade"] - k0
    resolves = counts["pc.kernel.nee_resolve"] - k1
    require(launches == resolves == BOUNCES == counts["pc.bounce"] - b0,
            f"shading kernel launches in a 4-spp frame: {launches} / "
            f"{resolves}")
    out = dict(lanes=r, on_surface=on, missed=missed, visible=visible,
               ms=ms["shade"], plain_ms=ms["shade_plain"],
               resolve_ms=ms["resolve"],
               resolve_plain_ms=ms["resolve_plain"], turns_ms=turns,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms["shade"], bytes=nbytes,
               resolve_bound_ms=rbound_ms, resolve_bound_by=rbound_by,
               resolve_bound_share=rbound_ms / ms["resolve"],
               resolve_bytes=rbytes, build=build, launches_frame=launches,
               resolve_launches_frame=resolves,
               seconds=time.perf_counter() - t0)
    for line in build:
        log(f"[shade] {line}")
    log(f"[shade] {r} bounce-1 lanes ({on} on a surface, {missed} missed, "
        f"{visible} shadow rays unoccluded) == plain on every output; "
        f"shade {ms['shade']:.4f} ms, plain {ms['shade_plain']:.4f} ms; "
        f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B), share "
        f"{out['bound_share']:.4f}; nee_resolve {ms['resolve']:.4f} ms, "
        f"plain {ms['resolve_plain']:.4f} ms, bound {rbound_ms:.4f} ms "
        f"({rbytes} B), share {out['resolve_bound_share']:.4f}; "
        f"{launches} / {resolves} launches a 4-spp frame; "
        f"{out['seconds']:.1f} s")
    return out


#: bytes the texture kernel must move a lane (ops/texture.py): the uv (8),
#: and per bound kind its texture id (4) and the fields it modulates read
#: and written (bump: the shading normal, 24; diffuse: the albedo, 32;
#: emissive: the emission, 24; specular: roughness and metallic, 16); per
#: fetch (a lane whose id of the kind is >= 0) its four texels (64), and
#: the tangent for a bump fetch (12)
TEX_UV_BYTES, TEX_ID_BYTES, TEX_FETCH_BYTES, TEX_TANG_BYTES = 8, 4, 64, 12
TEX_FIELD_BYTES = {"diffuse": 32, "specular": 16, "emissive": 24,
                   "bump": 24}
TEX_KINDS = ("diffuse", "specular", "emissive", "bump")


def quad_rows(stack, ids, uv):
    """The flat index into the stack's corner quads viewed as [N*H*W, 16]
    of the row each lane's bilinear fetch reads, for the lanes whose id is
    >= 0 (``models/textures.py:sample_bilinear``'s addressing)."""
    import torch
    from prismarine_core_tpu_torch.models import textures as tx
    n, h, w, _ = stack.data.shape
    keep = ids >= 0
    tid = torch.clamp(ids[keep], 0, n - 1).long()
    wi, hi = tx._tex_size(stack, tid)
    x0 = torch.floor(torch.remainder(uv[keep, 0], 1.0) * wi - 0.5)
    y0 = torch.floor(torch.remainder(uv[keep, 1], 1.0) * hi - 0.5)
    return ((tid * h + torch.remainder(y0.to(torch.int32), hi).long()) * w
            + torch.remainder(x0.to(torch.int32), wi).long())


def phase_texture(dev):
    """The texture kernel at the bounce-1 hits of the benchmark's textured
    cell (hall720-bvh-textured: 3,686,400 lanes; a diffuse, a specular
    and a bump map of 1024x1024 on each of six materials): equal to its
    plain version bit for bit on every field; CUDA-event times of both in
    alternating turns; the bytes bound (each fetch's four texels) and the
    kernel's share of it, beside the bound with each distinct quad row
    the fetches read counted once; its registers; one 4-spp frame
    launching it once a bounce."""
    import torch
    from bench_port import harness
    from prismarine_core_tpu_torch import _build
    from prismarine_core_tpu_torch.ops import texture as tx
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.ops.surface import surface_fields
    from prismarine_core_tpu_torch.render.integrator import (
        closest_hit, render_with_samples)
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    from prismarine_core_tpu_torch.utils.profiling import counts
    t0 = time.perf_counter()
    cell = harness.load_cell("hall720-bvh-textured.frames", root=REPO)
    prog = harness.build_program(cell, harness.scene_arrays(cell), dev)
    scene, cam, cfg = prog.scene, prog.camera, prog.cfg
    kinds = scene.materials.kinds_bound
    _, _, _, carry1, _ = first_bounce(scene, cam, cfg, dev)
    hit = closest_hit(scene, carry1[0], carry1[1], cfg,
                      t_cap=torch.where(carry1[4], INF_DIST, 0.0))
    ns, _, uv, tang, mat = surface_fields(scene, hit, kinds)
    args = (scene.textures, cfg.texture_filter, kinds, ns, tang, uv, mat)
    k0 = counts["pc.kernel.texture"]
    got = tx.texture_fields(*args)
    want = tx.texture_plain(*args)
    torch.cuda.synchronize()
    require(counts["pc.kernel.texture"] - k0 == 1,
            "texture_fields did not launch the kernel once")
    for k, a, b in zip(("ns", "albedo", "emissive", "roughness",
                        "metallic"), got, want):
        require(a.shape == b.shape
                and torch.equal(a.contiguous().view(torch.int32),
                                b.contiguous().view(torch.int32)),
                f"texture kernel != plain on {k}")
    ms, turns = alternating_ms({"kernel": lambda: tx.texture_fields(*args),
                                "plain": lambda: tx.texture_plain(*args)})
    r = int(uv.shape[0])
    bound_kinds = [k for k, b in zip(TEX_KINDS, kinds) if b]
    fetches = {k: int((getattr(mat, f"tex_{k}") >= 0).sum())
               for k in bound_kinds}
    nbytes = (r * (TEX_UV_BYTES + sum(TEX_ID_BYTES + TEX_FIELD_BYTES[k]
                                      for k in bound_kinds))
              + TEX_FETCH_BYTES * sum(fetches.values())
              + TEX_TANG_BYTES * fetches.get("bump", 0))
    bound_ms, bound_by = bound(0, nbytes)
    distinct = int(torch.unique(torch.cat([
        quad_rows(scene.textures, getattr(mat, f"tex_{k}"), uv)
        for k in bound_kinds])).numel())
    dbytes = nbytes - TEX_FETCH_BYTES * (sum(fetches.values()) - distinct)
    dbound_ms, _ = bound(0, dbytes)
    lib_path = _build.library_path()
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    build = ([line for line in ptxas_lines(ptxas.read_text())
              if line.startswith("texture_fields_kernel")]
             if ptxas.exists() else [])
    gen = torch.Generator(device=dev).manual_seed(1)
    samples = make_coherent_sample_arrays(gen, cfg, block=(64, 64))
    k0, s0 = counts["pc.kernel.texture"], counts["pc.surface"]
    render_with_samples(scene, cam, cfg, *samples)
    torch.cuda.synchronize()
    launches = counts["pc.kernel.texture"] - k0
    require(launches == BOUNCES == counts["pc.surface"] - s0,
            f"texture kernel launches in a 4-spp frame: {launches}")
    out = dict(lanes=r, missed=int((hit.tri < 0).sum()), kinds=kinds,
               fetches=fetches, ms=ms["kernel"], plain_ms=ms["plain"],
               turns_ms=turns, bound_ms=bound_ms, bound_by=bound_by,
               bound_share=bound_ms / ms["kernel"], bytes=nbytes,
               distinct_rows=distinct, distinct_bound_ms=dbound_ms,
               distinct_bound_share=dbound_ms / ms["kernel"],
               build=build, launches_frame=launches,
               seconds=time.perf_counter() - t0)
    for line in build:
        log(f"[texture] {line}")
    log(f"[texture] {r} bounce-1 lanes ({out['missed']} missed), fetches "
        f"{fetches} == plain on every field; kernel {ms['kernel']:.4f} ms, "
        f"plain {ms['plain']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nbytes} B), share {out['bound_share']:.4f}; {distinct} distinct "
        f"quad rows: bound {dbound_ms:.4f} ms, share "
        f"{out['distinct_bound_share']:.4f}; {launches} launches a 4-spp "
        f"frame; {out['seconds']:.1f} s")
    return out


def phase_frame_bvh(scene, cam, cfg, dev, mt_img):
    """bench.py's main configuration under intersector="bvh": the frame's
    measurements with the walk launched BVH_LAUNCHES times and no other
    kernel, the same frame on the kernels' plain versions bit-identical, and
    the image gate against the "mt" frame (same samples)."""
    import torch
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    cfg_b = cfg.replace(intersector="bvh")
    img, res, samples = phase_frame(scene, cam, cfg_b, dev, tag="frame bvh",
                                    max_launches=BVH_LAUNCHES,
                                    mean_band=(1e-2, math.inf),
                                    kernels=("bvh_walk",))
    require(res["launches"]["bvh_walk"] == BVH_LAUNCHES,
            f"frame bvh: {res['launches']['bvh_walk']} walk launches")
    t0 = time.perf_counter()
    with plain_versions():
        ref = render_with_samples(scene, cam, cfg_b, *samples)
    torch.cuda.synchronize()
    same = torch.equal(img, ref)
    log(f"[frame bvh] against the frame on the kernels' plain versions "
        f"({time.perf_counter() - t0:.1f} s): bit-identical {same}")
    require(same, "frame bvh: the image differs from its plain-version "
            "frame")
    res["plain_walk_bit_identical"] = same
    res["vs_mt"] = image_gate(img, mt_img, "frame bvh", "mt frame")
    return img, res


def phase_rr(scene, cam, cfg, dev, stats_mt, stats_bvh):
    """The bench configuration with rr_start_bounce=2 (the "rr-2"
    configuration of examples/r6_rr_quality.py) on "pallas" and on "bvh"
    with the same samples: each frame's measurements, each image against
    the other by the gate, survivors below the frame without RR from
    bounce 2 on."""
    cfg_r = cfg.replace(rr_start_bounce=2)
    img_p, res_p, _ = phase_frame(scene, cam, cfg_r, dev,
                                  tag="frame rr pallas",
                                  mean_band=(1e-2, math.inf))
    img_b, res_b, _ = phase_frame(scene, cam, cfg_r.replace(intersector="bvh"),
                                  dev, tag="frame rr bvh",
                                  max_launches=BVH_LAUNCHES,
                                  mean_band=(1e-2, math.inf),
                                  kernels=("bvh_walk",))
    res_p["vs_bvh"] = image_gate(img_p, img_b, "frame rr pallas",
                                 "rr bvh frame")
    res_b["vs_pallas"] = image_gate(img_b, img_p, "frame rr bvh",
                                    "rr pallas frame")
    for tag, res, ref in (("pallas", res_p, stats_mt), ("bvh", res_b,
                                                         stats_bvh)):
        surv = [row[3] for row in res["stats"]]
        ref_surv = [row[3] for row in ref]
        log(f"[frame rr {tag}] survivors per bounce {surv} against "
            f"{ref_surv} without RR")
        for b in range(2, BOUNCES):
            require(surv[b] < ref_surv[b], f"frame rr {tag}: survivors of "
                    f"bounce {b}: {surv[b]} vs {ref_surv[b]} without RR")
    return res_p, res_b


def phase_features(scene, cam, cfg, dev, mt_img, samples):
    """Interlacing, depth of field and the 360 camera on "pallas" with the
    bench samples: stage 0 plus stage 1 against the "mt" frame by the
    gate (each stage's inactive parity exactly 0); the DOF and 360 frames
    finite with mean > 1e-2; one timed frame of each after a warm one."""
    import torch
    from prismarine_core_tpu_torch.render.integrator import (
        interlace_mask, render_with_samples)
    out = {}

    def timed(c, stage=0):
        render_with_samples(scene, cam, c, *samples, stage)
        torch.cuda.synchronize()
        read = zero_launches()
        t0 = time.perf_counter()
        img = render_with_samples(scene, cam, c, *samples, stage)
        torch.cuda.synchronize()
        return img, 1e3 * (time.perf_counter() - t0), read()
    cfg_i = cfg.replace(interlace=True)
    parts = []
    for stage in (0, 1):
        img, ms, launches = timed(cfg_i, stage)
        m = interlace_mask(cfg, stage, device=dev)
        require(bool((img[~m] == 0).all()), f"interlace stage {stage}: an "
                "inactive pixel is not 0")
        log(f"[interlace] stage {stage}: {ms:.3f} ms, launches {launches}, "
            f"mean {float(img.mean()):.6f}")
        out[f"interlace{stage}"] = dict(ms=ms, launches=launches,
                                        mean=float(img.mean()))
        parts.append(img)
    out["interlace_vs_mt"] = image_gate(parts[0] + parts[1], mt_img,
                                        "interlace", "mt frame")
    for tag, kw in (("dof", dict(dof=True)), ("360", dict(camera_360=True))):
        img, ms, launches = timed(cfg.replace(**kw))
        mean = float(img.mean())
        log(f"[{tag}] {ms:.3f} ms, launches {launches}, mean {mean:.6f}")
        require(bool(torch.isfinite(img).all()), f"{tag}: non-finite image")
        require(mean > 1e-2, f"{tag}: mean {mean}")
        out[tag] = dict(ms=ms, launches=launches, mean=mean)
    return out


def edge_launches(n_lights, per_query):
    """Launches of each kernel on ``render_with_edge_gradients(...,
    shadow_term=True)`` over the env-NEE frame: the primal frame and each
    of the two side paths make ``per_query[0]`` a bounce (closest, sun NEE
    and env NEE queries), and each shadow term (one a sphere light, one
    the env sun) two closest queries (receivers, camera visibility) and
    two any-hit probes, ``per_query[1]`` and ``per_query[2]`` each."""
    per_bounce, closest, any_hit = per_query
    return (3 * BOUNCES * per_bounce
            + (n_lights + 1) * 2 * (closest + any_hit))


def edge_cases_module():
    """tests/torch_edge_cases.py of this checkout, by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_edge_cases", REPO / "tests" / "torch_edge_cases.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_edge(scene, cam, cfg, dev):
    """Phase 14: ``render_with_edge_gradients(shadow_term=True)`` on the
    env-NEE frame under "bvh", EDGE_SAMPLES edge samples, the loss
    sum(img * W) with W drawn from a seeded generator, gradients with
    respect to the corner vertices and the camera eye.  Gates: the value
    equals ``render_with_samples`` bit for bit; the walk launched
    ``edge_launches`` times and no other kernel; the boundary images'
    vertex gradient finite, non-zero on >= 1,000 entries, and with the
    kernels' plain versions in their place within EDGE_PLAIN_BOUND;
    the same call once under "pallas" (value gate, the three "mt"-path
    kernels launched ``edge_launches`` times, the boundary gradient within
    EDGE_PLAIN_BOUND of the one on the kernels' plain versions and within
    EDGE_PALLAS_BOUND of "bvh"'s); the FD cases of
    tests/test_edge_gradients.py on the card under "bvh".  Times: forward,
    backward and the boundary images alone (forward + backward), 3 reps
    after a warm one, one sync each; peak memory; one profiled rep."""
    import torch
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.parallel.mesh import (
        apply_params, init_params)
    from prismarine_core_tpu_torch.render.edge_grad import (
        boundary_images, make_edge_sample_arrays, render_with_edge_gradients)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    t_phase = time.perf_counter()
    ec = edge_cases_module()
    cfg_b = cfg.replace(env_nee=True, intersector="bvh")
    cfg_p = cfg.replace(env_nee=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    cam_s, bounce_s = make_coherent_sample_arrays(gen, cfg_b, block=(64, 64))
    eu, ebs = make_edge_sample_arrays(gen, EDGE_SAMPLES, BOUNCES)
    w = torch.rand((H, W, 3), generator=gen, device=dev)
    base = {k: v.detach() for k, v in init_params(scene).items()}
    n_lights = scene.lights.count

    def forward(c, boundary_only=False):
        p = {k: v.clone().requires_grad_(k in EDGE_LEAVES)
             for k, v in base.items()}
        eye = cam.eye.detach().clone().requires_grad_(True)
        sc, cm = apply_params(scene, p), dataclasses.replace(cam, eye=eye)
        img = (boundary_images(sc, cm, c, eu, ebs, shadow_term=True)
               if boundary_only else render_with_edge_gradients(
                   sc, cm, c, cam_s, bounce_s, eu, ebs, shadow_term=True))
        return img, [p[k] for k in EDGE_LEAVES] + [eye]

    def backward(img, xs):
        return torch.autograd.grad((img * w).sum(), xs)

    def value_gate(c, img, tag):
        ref = render_with_samples(scene, cam, c, cam_s, bounce_s)
        require(img.shape == (H, W, 3), f"{tag} image shape")
        require(bool(torch.isfinite(img).all()), f"{tag}: non-finite image")
        require(torch.equal(img.detach(), ref), f"{tag}: value != "
                "render_with_samples")

    # the main-path run: counters from 0, read right after
    read = zero_launches()
    img, xs = forward(cfg_b)
    grads = backward(img, xs)
    torch.cuda.synchronize()
    launches = read()
    n_walk = edge_launches(n_lights, (3, 1, 1))
    log(f"[edge bvh] launches {launches} (expected bvh_walk {n_walk})")
    for k, n in launches.items():
        require(n > 0 if k == "surface"
                else n == (n_walk if k == "bvh_walk" else 0),
                f"edge bvh {k}: {n} launches")
    value_gate(cfg_b, img, "edge bvh")
    _finite_nonzero(dict(zip(EDGE_LEAVES + ("eye",), grads)), "edge gradient")

    # the boundary images alone, on the kernels and on the plain versions
    gb = backward(*forward(cfg_b, True))
    nonzero = sum(int((g != 0).sum()) for g in gb[:3])
    require(all(bool(torch.isfinite(g).all()) for g in gb),
            "boundary gradient not finite")
    require(nonzero >= 1000, f"boundary gradient non-zero on {nonzero}")
    t0 = time.perf_counter()
    with plain_versions():
        gb_plain = backward(*forward(cfg_b, True))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    cos_plain, rel_plain = ec.cos_rel(gb[:3], gb_plain[:3])
    log(f"[edge bvh] boundary vertex gradient non-zero on {nonzero} "
        f"entries; against the plain versions ({plain_s:.1f} s): cosine "
        f"{cos_plain:.9f}, relative L2 {rel_plain:.3g}; eye "
        f"{gb[3].tolist()} vs {gb_plain[3].tolist()}")
    require(rel_plain <= EDGE_PLAIN_BOUND[0]
            and cos_plain >= EDGE_PLAIN_BOUND[1],
            f"edge bvh vs plain versions: cosine {cos_plain}, rel "
            f"{rel_plain}")

    # times: 3 reps after a warm one, one sync each
    fwd, bwd, bnd = [], [], []
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, xs = forward(cfg_b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        backward(img, xs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        backward(*forward(cfg_b, True))
        torch.cuda.synchronize()
        if rep:
            fwd.append(1e3 * (t1 - t0))
            bwd.append(1e3 * (t2 - t1))
            bnd.append(1e3 * (time.perf_counter() - t2))
    torch.cuda.reset_peak_memory_stats(dev)
    backward(*forward(cfg_b))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    res = dict(forward_ms=sum(fwd) / 3, backward_ms=sum(bwd) / 3,
               boundary_ms=sum(bnd) / 3, forward_reps_ms=fwd,
               backward_reps_ms=bwd, boundary_reps_ms=bnd,
               peak_mem_bytes=peak, launches=launches,
               boundary_nonzero=nonzero, plain_walk_cos=cos_plain,
               plain_walk_rel=rel_plain, edge_samples=EDGE_SAMPLES,
               mean=float(img.detach().mean()))
    log(f"[edge bvh] forward {res['forward_ms']:.3f} ms, backward "
        f"{res['backward_ms']:.3f} ms, boundary images alone (forward + "
        f"backward) {res['boundary_ms']:.3f} ms (reps {fwd} / {bwd} / "
        f"{bnd}); peak memory {peak / 2**20:.1f} MiB; mean "
        f"{res['mean']:.6f}")
    res["profile"] = profile_once(lambda: backward(*forward(cfg_b)),
                                  "edge bvh")

    # the same call once under "pallas"
    read = zero_launches()
    img_p, xs_p = forward(cfg_p)
    backward(img_p, xs_p)
    torch.cuda.synchronize()
    launches_p = read()
    n_mt = edge_launches(n_lights, (4, 2, 1))
    log(f"[edge pallas] launches {launches_p} (expected {n_mt} of each "
        f"\"mt\"-path kernel)")
    for k, n in launches_p.items():
        require(n > 0 if k == "surface"
                else n == (n_mt if k in MT_PATH else 0),
                f"edge pallas {k}: {n} launches")
    value_gate(cfg_p, img_p, "edge pallas")
    gbp = backward(*forward(cfg_p, True))
    # the kernels against their plain versions on this path's own queries
    # (side paths at 2^18 lanes over the image, shadow-term probes)
    t0 = time.perf_counter()
    with plain_versions():
        gbp_plain = backward(*forward(cfg_p, True))
    torch.cuda.synchronize()
    plain_p_s = time.perf_counter() - t0
    cos_pp, rel_pp = ec.cos_rel(gbp[:3], gbp_plain[:3])
    log(f"[edge pallas] boundary vertex gradient against the plain "
        f"versions ({plain_p_s:.1f} s): cosine {cos_pp:.9f}, relative L2 "
        f"{rel_pp:.3g} (bound {EDGE_PLAIN_BOUND}); eye {gbp[3].tolist()} "
        f"vs {gbp_plain[3].tolist()}")
    require(rel_pp <= EDGE_PLAIN_BOUND[0] and cos_pp >= EDGE_PLAIN_BOUND[1],
            f"edge pallas vs plain versions: cosine {cos_pp}, rel {rel_pp}")
    cos_p, rel_p = ec.cos_rel(gbp[:3], gb[:3])
    log(f"[edge pallas] boundary vertex gradient against bvh: cosine "
        f"{cos_p:.9f}, relative L2 {rel_p:.3g} (bound {EDGE_PALLAS_BOUND})")
    require(rel_p <= EDGE_PALLAS_BOUND[0] and cos_p >= EDGE_PALLAS_BOUND[1],
            f"edge pallas vs bvh: cosine {cos_p}, rel {rel_p}")
    res["pallas"] = dict(launches=launches_p, cos_vs_plain=cos_pp,
                         rel_vs_plain=rel_pp, cos_vs_bvh=cos_p,
                         rel_vs_bvh=rel_p)

    # the FD cases on the card, under "bvh"
    res["fd"] = {}
    for name in ec.CARD_CASES:
        g, fd = ec.fd_check(name, ec.torch_samples(name, 0, dev),
                            intersector="bvh")
        case = ec.CASES[name]
        log(f"[edge fd] {name}: gradient {g:.6g}, FD {fd:.6g}, bound "
            f"|g - fd| < {case.rel} |fd| + {case.abs_}")
        require(abs(fd) > case.min_fd and ec.within(name, g, fd),
                f"edge fd {name}: gradient {g} vs FD {fd}")
        res["fd"][name] = dict(grad=g, fd=fd)
    log(f"[edge] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return res


def _same_args(a, b) -> bool:
    """Two recorded kernel calls' arguments are equal (tensors bit for
    bit)."""
    import torch
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and a.dtype == b.dtype and torch.equal(a, b))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(map(_same_args, a, b)))
    return a == b


def check_recorded(calls, tag, seen):
    """Every recorded block_cull, pair_cull, sb_intersect and
    sb_intersect_mxu call against
    its plain version, exactly; an input equal to one already checked
    (``seen``, per kernel) is not checked twice.  Returns (each kernel's
    largest |kernel - plain|, inputs checked, the plain versions' ms)."""
    import functools
    import torch
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    pairs = {"block_cull": (cull.block_cull, cull.block_cull_plain),
             "pair_cull": (cull.pair_cull, cull.pair_cull_plain),
             "sb_intersect": (si.sb_intersect, functools.partial(
                 si.sb_intersect_plain, chunk=128)),
             "sb_intersect_mxu": (si.sb_intersect_mxu, functools.partial(
                 si.sb_intersect_mxu_plain, chunk=64))}
    errs, n_checked, t0 = {}, 0, time.perf_counter()
    for k, (kernel, plain) in pairs.items():
        for i, args in enumerate(calls.get(k, ())):
            if any(_same_args(args, old) for old in seen[k]):
                continue
            out, ref = kernel(*args), plain(*args)
            out, ref = (((out,), (ref,)) if k in ("block_cull", "pair_cull")
                        else (out, ref))
            require(all(map(torch.equal, out, ref)),
                    f"{tag}: {k} call {i} != plain")
            errs[k] = max(errs.get(k, 0.0),
                          float((out[0] - ref[0]).abs().max())
                          if out[0].numel() else 0.0)
            seen[k].append(args)
            n_checked += 1
    torch.cuda.synchronize()
    return errs, n_checked, 1e3 * (time.perf_counter() - t0)


def phase_rounds(scene, cam, cfg, dev):
    """The "rounds" strategy on the hall at full width: the bounce-1
    step's closest query (K = cfg.closest_k) and shadow query (K 8) under
    "rounds", stale masks off and on; every round's block_cull, pair_cull
    and sb_intersect inputs against the plain versions exactly; closest t
    bit-identical to "two_round" (other triangles only on tie lanes,
    counted), occlusion identical to "single", stale masks changing
    nothing; rounds, pairs per round and host syncs per query, and CUDA
    event times against "two_round" / "single" in alternating turns."""
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.utils.profiling import counts
    from prismarine_core_tpu_torch.render.integrator import (
        _pallas_kwargs, make_bounce_step)
    t_phase = time.perf_counter()
    _, _, _, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    # the bounce-1 step's two queries as the integrator makes them
    made = {}
    saved = pk.intersect_closest_pallas, pk.occluded_pallas

    def rec(name, fn):
        def run(*args, **kw):
            made[name] = (args, kw)
            return fn(*args, **kw)
        return run
    pk.intersect_closest_pallas = rec("closest", saved[0])
    pk.occluded_pallas = rec("shadow", saved[1])
    try:
        make_bounce_step(scene, cfg)(carry1, bounce_s[1])
    finally:
        pk.intersect_closest_pallas, pk.occluded_pallas = saved
    (c_args, c_kw), (s_args, s_kw) = made["closest"], made["shadow"]

    def closest(strategy, stale=False):
        kw = dict(c_kw, return_order=False, **_pallas_kwargs(cfg.replace(
            closest_strategy=strategy, stale_round_masks=stale), False))
        return pk.intersect_closest_pallas(*c_args, **kw)

    def shadow(strategy, stale=False):
        kw = dict(s_kw, **_pallas_kwargs(cfg.replace(
            anyhit_strategy=strategy, stale_round_masks=stale), True))
        return pk.occluded_pallas(*s_args, **kw)

    out = {"rays": int(c_args[3].shape[0]),
           "superblocks": scene.packets.n_superblocks}
    seen = {k: [] for k in MT_PATH}
    errs = {}
    results = {}
    for label, fn in (("closest", closest), ("shadow", shadow)):
        for stale in (False, True):
            tag = f"{label} rounds{' stale' if stale else ''}"
            syncs0 = counts["pc.sync.compact"]
            with recorded_calls() as calls:
                res = fn("rounds", stale)
            torch.cuda.synchronize()
            compactions = counts["pc.sync.compact"] - syncs0
            from bench_port.trace import host_syncs
            detected = sum(host_syncs(lambda: fn("rounds", stale))
                           .values())
            pairs = [int(a[3]) for a in calls["sb_intersect"]]
            e, n_checked, plain_ms = check_recorded(calls, tag, seen)
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            results[tag] = res
            out[tag] = dict(rounds=len(pairs), pairs=pairs,
                            compactions=compactions, host_syncs=detected,
                            launches={k: len(v) for k, v in calls.items()})
            log(f"[rounds] {tag}: {len(pairs)} rounds, pairs per round "
                f"{pairs}; {compactions} pair compactions, {detected} host "
                f"syncs detected; launches "
                f"{ {k: len(v) for k, v in calls.items()} }; {n_checked} new "
                f"inputs == plain exactly (plain versions {plain_ms:.0f} ms)")
    two = closest("two_round")
    fresh, stale = results["closest rounds"], results["closest rounds stale"]
    require(torch.equal(fresh.t, two.t), "rounds closest t != two_round")
    ties = int((fresh.tri != two.tri).sum())
    require(all(torch.equal(getattr(fresh, f), getattr(stale, f))
                for f in ("t", "tri", "u", "v")),
            "closest rounds: stale masks changed the hits")
    single = shadow("single")
    require(torch.equal(results["shadow rounds"], single)
            and torch.equal(results["shadow rounds stale"], single),
            "rounds occlusion != single")
    hits = int((fresh.tri >= 0).sum())
    log(f"[rounds] closest rounds t == two_round bit for bit on "
        f"{out['rays']} rays ({hits} hits; {ties} tie lanes on another "
        f"triangle at equal t); stale == fresh; shadow rounds (fresh, "
        f"stale) == single on every lane ({int(single.sum())} occluded)")
    med, runs = alternating_ms({
        "closest two_round": lambda: closest("two_round"),
        "closest rounds": lambda: closest("rounds"),
        "shadow single": lambda: shadow("single"),
        "shadow rounds": lambda: shadow("rounds"),
        "shadow rounds stale": lambda: shadow("rounds", True)},
        turns=5, reps=3)
    out.update(ties=ties, hits=hits, occluded=int(single.sum()),
               ms=med, turns_ms=runs, max_abs_err=errs)
    log(f"[rounds] ms per query (medians of 5 alternating turns of 3, "
        f"CUDA events, host syncs inside): "
        f"{ {k: round(v, 4) for k, v in med.items()} }; turns "
        f"{ {k: [round(x, 4) for x in v] for k, v in runs.items()} }")
    log(f"[rounds] phase in {time.perf_counter() - t_phase:.1f} s")
    return out


def cli_args(*extra):
    """The CLI's parsed arguments for the hall at the bench frame's size
    (its every other flag at its default)."""
    from prismarine_core_tpu_torch import cli
    return cli.build_parser().parse_args(
        ["--scene", "hall", "--res", f"{W}x{H}", "--depth", str(BOUNCES),
         "--frames", str(CLI_FRAMES), *extra])


def png_size(path) -> tuple:
    """(width, height) from a PNG's signature and IHDR chunk; fails the
    run on any other file."""
    data = Path(path).read_bytes()[:24]
    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: no PNG signature")
    n, kind, w, h = struct.unpack(">I4sII", data[8:24])
    require(kind == b"IHDR" and n == 13, f"{path}: no IHDR chunk first")
    return w, h


def phase_application(scene, cam, cfg, dev):
    """Phase 15: the application layer on the card.  (a) "rounds"
    (phase_rounds); (b) the CLI's default frame (cli_args: the hall, 4
    bounces, independent sampling, "pallas" with any-hit "rounds")
    through phase_frame's gates and measurements with this path's launch
    bound, its plain-version parity, and CLI_FRAMES frames of a
    ProgressiveRenderer equal to the sum of render_with_samples frames
    drawn from a clone of its generator; (c) a checkpoint after 4 frames,
    loaded into a fresh renderer and 4 more frames, bit-identical to 8
    straight; (d) the CLI itself as a subprocess (exit 0, a 1280x720 PNG,
    the HDR round-tripping the NPY within RGBE's precision, the NPY
    against (b)'s snapshot); (e) bench.py's teapot-512 and
    teapot-512-obj-ingested frames (the OBJ written as bench.py writes it,
    ingested by the native parser); (f) bench.py's
    hall-720p-hdr-sky(independent) frame."""
    import numpy as np
    import tempfile
    import torch
    from prismarine_core_tpu_torch import cli, native
    from prismarine_core_tpu_torch.models.camera import Camera
    from prismarine_core_tpu_torch.models.obj_loader import load_obj
    from prismarine_core_tpu_torch.models.procedural import (
        make_teapot_scene)
    from prismarine_core_tpu_torch.models.scene import Scene
    from prismarine_core_tpu_torch.ops.sampling import make_sample_arrays
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.render.pipeline import (
        ProgressiveRenderer)
    from prismarine_core_tpu_torch.utils.checkpoint import (
        load_renderer, save_renderer)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    from prismarine_core_tpu_torch.utils.image import load_hdr
    t_phase = time.perf_counter()
    out = {"rounds": phase_rounds(scene, cam, cfg, dev)}

    # (b) the CLI's default frame
    args = cli_args()
    cfg_c = cli.make_config(args)
    t0 = time.perf_counter()
    scene_c, cam_c = cli.make_scene_camera(args, dev)
    torch.cuda.synchronize()
    log(f"[frame cli] {cfg_c}; hall of {int(scene_c.triangles.num_valid())} "
        f"tris, {scene_c.packets.n_superblocks} superblocks, built in "
        f"{time.perf_counter() - t0:.1f} s")
    img, res, samples = phase_frame(scene_c, cam_c, cfg_c, dev,
                                    tag="frame cli",
                                    max_launches=CLI_LAUNCHES,
                                    mean_band=(1e-2, math.inf))
    res["parity"] = phase_parity(scene_c, cam_c, cfg_c, img, samples,
                                 tag="parity cli")
    renderer = ProgressiveRenderer(scene_c, cam_c, cfg_c, seed=args.seed)
    gen = torch.Generator(device=dev)
    gen.set_state(renderer._generator.get_state())
    read = zero_launches()
    times = []
    for _ in range(CLI_FRAMES):
        t0 = time.perf_counter()
        renderer.step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read()
    for k in MT_PATH:
        require(0 < launches[k] <= CLI_FRAMES * CLI_LAUNCHES,
                f"pipeline {k}: {launches[k]} launches in {CLI_FRAMES} "
                "frames")
    ref = torch.zeros_like(renderer._accum)
    for i in range(CLI_FRAMES):
        f = render_with_samples(scene_c, cam_c, cfg_c, *make_sample_arrays(
            gen, cfg_c.n_rays, cfg_c.max_bounces, device=dev))
        if i == 0:
            require(torch.equal(f, img), "the renderer's first frame != "
                    "the frame cli image (the same seed)")
        ref = ref + f
    require(torch.allclose(renderer._accum, ref, rtol=1e-6, atol=0),
            "pipeline accumulator != the sum of its frames")
    snap = renderer.snapshot()
    require(bool(np.isfinite(snap).all()) and snap.mean() > 1e-2,
            f"pipeline snapshot mean {snap.mean()}")
    ms = 1e3 * sum(times) / CLI_FRAMES
    res["pipeline"] = dict(
        ms_per_frame=ms, frame_ms=[1e3 * t for t in times],
        launches=launches, mean=float(snap.mean()),
        accum_bit_identical=bool(torch.equal(renderer._accum, ref)))
    log(f"[pipeline] {CLI_FRAMES} ProgressiveRenderer frames: {ms:.3f} "
        f"ms/frame ({', '.join(f'{1e3 * t:.3f}' for t in times)}), "
        f"launches {launches}; accumulator == the sum of "
        f"render_with_samples frames on a clone of its generator "
        f"(bit-identical {res['pipeline']['accum_bit_identical']}); "
        f"snapshot mean {snap.mean():.6f}")
    out["frame_cli"] = res

    scratch = REPO / "build" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        tmp = Path(tmp)
        # (c) checkpoint: 4 frames, save, load into a fresh renderer, 4
        half = ProgressiveRenderer(scene_c, cam_c, cfg_c, seed=args.seed)
        half.render_frames(CLI_FRAMES // 2)
        save_renderer(str(tmp / "ckpt"), half)
        resumed = ProgressiveRenderer(scene_c, cam_c, cfg_c,
                                      seed=args.seed + 1)
        load_renderer(str(tmp / "ckpt"), resumed)
        resumed.render_frames(CLI_FRAMES - CLI_FRAMES // 2)
        require(torch.equal(resumed._accum, renderer._accum)
                and torch.equal(resumed._weight, renderer._weight),
                "checkpoint: 4 + 4 frames != 8 straight")
        log(f"[checkpoint] {CLI_FRAMES // 2} frames, save_renderer "
            f"({(tmp / 'ckpt.npz').stat().st_size} bytes), load_renderer "
            f"into a fresh renderer, {CLI_FRAMES - CLI_FRAMES // 2} more: "
            f"bit-identical to {CLI_FRAMES} straight")

        # (d) the CLI as a subprocess
        png = tmp / "r.png"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "prismarine_core_tpu_torch.cli",
             "--scene", "hall", "--res", f"{W}x{H}", "--depth", str(BOUNCES),
             "--frames", str(CLI_FRAMES), "--out", str(png)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        require(proc.returncode == 0, f"CLI exit {proc.returncode}: "
                f"{proc.stderr[-2000:]}")
        size = png_size(png)
        require(size == (W, H), f"CLI PNG size {size}")
        npy = np.load(tmp / "r.npy")
        hdr = load_hdr(str(tmp / "r.hdr"))
        rgbe = npy.max(axis=-1, keepdims=True) / 128.0 + 1e-6
        require(hdr.shape == npy.shape and bool(
            (np.abs(hdr - npy) <= rgbe).all()), "CLI .hdr != .npy within "
            "RGBE's precision")
        gate = image_gate(torch.from_numpy(npy), torch.from_numpy(snap),
                          "cli", "pipeline's snapshot of the same seed")
        out["cli"] = dict(wall_s=wall, png_size=size, vs_pipeline=gate,
                          stderr=proc.stderr.strip().splitlines())
        log(f"[cli] python -m prismarine_core_tpu_torch.cli --scene hall "
            f"--res {W}x{H} --depth {BOUNCES} --frames {CLI_FRAMES}: exit 0 "
            f"in {wall:.1f} s wall (process start, scene, {CLI_FRAMES} "
            f"frames, writes); PNG {size[0]}x{size[1]}, HDR == NPY within "
            f"RGBE's precision; its stderr: {out['cli']['stderr']}")

        # (e) bench.py's teapot-512 and teapot-512-obj-ingested
        tcfg = RenderConfig(width=512, height=512, spp=1,
                            max_bounces=BOUNCES, intersector="pallas",
                            pairs_per_step=8, stale_round_masks=True,
                            anyhit_strategy="single", cull_impl="pallas2",
                            closest_k=16, cull_window=8192, cull_pps=16)
        tscene = make_teapot_scene(device=dev)
        require(tscene.packets.n_superblocks <= tcfg.closest_k,
                "the teapot has more superblocks than K")
        tcam = Camera.look_at(eye=(5.0, 3.2, 6.0), target=(0.0, 1.0, 0.0),
                              fov_y_deg=45.0, device=dev)
        _, out["frame_teapot"], _ = phase_frame(
            tscene, tcam, tcfg, dev, tag="frame teapot",
            max_launches=TEAPOT_LAUNCHES, mean_band=(1e-2, math.inf))
        soup = tscene.triangles
        nv = int(soup.num_valid())
        v = np.concatenate([x[:nv].cpu().numpy()
                            for x in (soup.v0, soup.v1, soup.v2)])
        obj = tmp / "teapot.obj"
        with open(obj, "w") as f:
            f.write("".join(f"v {x:.6f} {y:.6f} {z:.6f}\n"
                            for x, y, z in v))
            f.write("".join(f"f {i+1} {i+1+nv} {i+1+2*nv}\n"
                            for i in range(nv)))
        t0 = time.perf_counter()
        lib_path = native.build()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        osoup, omats, otex = load_obj(str(obj), use_native=True, device=dev)
        oscene = Scene.assemble(osoup, omats, tscene.lights,
                                tscene.environment, textures=otex)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        require(int(osoup.num_valid()) == nv, "ingested triangle count")
        # the text rounds to 6 decimals (5e-7 at |v| <= 1), and parsing
        # it rounds to float32 once more (half an ulp: |v| * 2^-24)
        worst = 0.0
        for k in ("v0", "v1", "v2"):
            a = getattr(osoup, k)[:nv]
            b = getattr(soup, k)[:nv]
            excess = ((a - b).abs() - 5e-7 * torch.clamp(b.abs(), min=1.0)
                      - b.abs() * 2.0 ** -24)
            worst = max(worst, float(excess.max()))
        require(worst <= 0.0, f"ingested vertices off the %.6f rounding "
                f"by {worst}")
        log(f"[teapot obj] {nv} tris through {lib_path.name} (g++ "
            f"{build_s:.1f} s): ingest {ingest_s:.3f} s (native parse + "
            "soup + BVH); vertices within the %.6f text's rounding and "
            "float32's")
        _, res_o, _ = phase_frame(oscene, tcam, tcfg, dev,
                                  tag="frame teapot obj",
                                  max_launches=TEAPOT_LAUNCHES,
                                  mean_band=(1e-2, math.inf))
        res_o.update(ingest_s=ingest_s, native_build_s=build_s)
        out["frame_teapot_obj"] = res_o

    # (f) bench.py's hall-720p-hdr-sky(independent)
    _, out["frame_independent"], _ = phase_frame(
        scene, cam, cfg.replace(coherent_bounce_sampling=False), dev,
        tag="frame independent", mean_band=(1e-2, math.inf))
    log(f"[application] phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return out


def _cos(a, b):
    import torch
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.dot(a, b) / (a.norm() * b.norm() + 1e-300))


def _finite_nonzero(tensors, what):
    import torch
    for k, t in tensors.items():
        require(bool(torch.isfinite(t).all()), f"{what} {k} not finite")
        require(bool((t != 0).any()), f"{what} {k} all zero")


#: device-op groups of a profile, by the first matching name fragment
OP_GROUPS = (("port kernels", ("cull_kernel", "sb_intersect",
                                "bvh_walk")),
             ("index/scatter", ("index", "scatter")),
             ("gather", ("gather",)),
             ("sort", ("sort", "radix")),
             ("memcpy/memset", ("memcpy", "memset")),
             ("elementwise/reduction glue", ("",)))


def profile_once(fn, tag, ranges=()):
    """``fn()`` under torch.profiler (CPU + CUDA activities), in two
    steps: a warm-up whose events are dropped (a profile that starts
    with the call can lose the device ops at its start), then the
    measured call: wall ms, device busy ms (the sum of device ops' self
    times), the idle share, device time by OP_GROUPS and the top ops by
    device time.
    ``ranges``: names of ``record_function`` ranges open around parts of
    ``fn``; each one's device time (its kernels') is logged, and the
    TEX_GATHER range's is a group of its own, taken out of "gather"."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        prof.step()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    averages = prof.key_averages()
    ops = [e for e in averages
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.key not in ranges and not e.key.startswith(STEP_RANGE)]
    range_ms = {}
    for name in ranges:
        rows = [e for e in averages if e.key == name
                and e.device_type == torch.autograd.DeviceType.CPU]
        range_ms[name] = (sum(e.count for e in rows),
                          sum(getattr(e, "device_time_total",
                                      getattr(e, "cuda_time_total", 0))
                              for e in rows) / 1e3)
    ops.sort(key=dev_us, reverse=True)
    rows = [(e.key[:90], e.count, dev_us(e) / 1e3) for e in ops]
    busy = sum(r[2] for r in rows)
    groups = {g: [0.0, 0] for g, _ in OP_GROUPS}
    for name, n, ms in rows:
        g = next(g for g, frags in OP_GROUPS
                 if any(f in name.lower() for f in frags))
        groups[g][0] += ms
        groups[g][1] += n
    if range_ms.get(TEX_GATHER, (0, 0.0))[1] > 0:
        n, ms = range_ms[TEX_GATHER]
        groups["gather"][0] -= ms
        groups["texture gathers"] = [ms, n]
    log(f"[{tag} profile] wall {wall:.3f} ms, device busy {busy:.3f} ms, "
        f"idle share {1 - busy / wall:.4f}, {sum(r[1] for r in rows)} "
        "device ops")
    for g, (ms, n) in groups.items():
        log(f"[{tag} profile]   {ms / max(busy, 1e-9):.4f} of busy  "
            f"{ms:9.3f} ms  "
            f"x{n:<5d} {g}")
    for name, n, ms in rows[:15]:
        log(f"[{tag} profile]   {ms:9.3f} ms  x{n:<5d} {name}")
    cull_ms = {name: (n, ms) for name, n, ms in rows if "cull_kernel" in name}
    walk_ms = {name: (n, ms) for name, n, ms in rows
               if "sb_intersect_walk_kernel" in name
               or "bvh_walk_kernel" in name}
    log(f"[{tag} profile] cull kernels: "
        f"{ {k: (n, round(ms, 4)) for k, (n, ms) in cull_ms.items()} }, "
        f"{sum(ms for _, ms in cull_ms.values()):.4f} ms; "
        f"{launch_gaps(prof)}")
    log(f"[{tag} profile] walk kernels: "
        f"{ {k: (n, round(ms, 4)) for k, (n, ms) in walk_ms.items()} }, "
        f"{sum(ms for _, ms in walk_ms.values()):.4f} ms")
    for name, (n, ms) in range_ms.items():
        log(f"[{tag} profile] range {name!r}: {n} calls, "
            + (f"{ms:.4f} ms of device time" if ms > 0 else
               "device time not measured (the profiler gave the range "
               "no kernels)"))
    return dict(wall_ms=wall, busy_ms=busy, idle_share=1 - busy / wall,
                groups_ms={g: v[0] for g, v in groups.items()},
                cull_ms=sum(ms for _, ms in cull_ms.values()),
                walk_ms=sum(ms for _, ms in walk_ms.values()),
                ranges_ms={k: v[1] for k, v in range_ms.items()})


def launch_gaps(prof) -> str:
    """The device's idle gap before each cull kernel (from the end of the
    device op before it), beside the gap before any device op, from the
    profile's device timeline."""
    import statistics
    import torch
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name not in (TEX_FETCH, TEX_GATHER)
                 and not e.name.startswith(STEP_RANGE)),
                key=lambda e: e.time_range.start)
    gaps = {"cull": [], "all": []}
    for prev, e in zip(ev, ev[1:]):
        gap = max(e.time_range.start - prev.time_range.end, 0)
        gaps["all"].append(gap)
        if "cull_kernel" in e.name:
            gaps["cull"].append(gap)
    if not gaps["cull"]:
        return "launch gap not measured (no cull kernel on the timeline)"
    return ("device idle before a cull kernel: median "
            f"{statistics.median(gaps['cull']):.1f} us, mean "
            f"{statistics.mean(gaps['cull']):.1f} us, max "
            f"{max(gaps['cull']):.1f} us over {len(gaps['cull'])}; before "
            f"any device op: median {statistics.median(gaps['all']):.1f} "
            f"us, mean {statistics.mean(gaps['all']):.1f} us")


def phase_train(scene, cam, cfg, dev, target, samples):
    """The inverse-rendering train step at full width under "mxu"."""
    import torch
    from prismarine_core_tpu_torch.parallel.mesh import (
        init_params, make_train_step)
    cfg_x = cfg.replace(kernel_form="mxu")
    start = {k: v.clone() for k, v in init_params(scene).items()}
    start["mat_diffuse"][:, :3] *= 0.5
    args = (scene, cam, *samples, target)
    step = make_train_step(None, cfg_x, **TRAIN_KW)

    # one step from the start under each form
    p_mt, loss_mt = make_train_step(None, cfg, **TRAIN_KW)(start, *args)
    read = zero_launches()
    p_x, loss_x = step(start, *args)
    torch.cuda.synchronize()
    launches = read()
    loss_mt, loss_x = float(loss_mt), float(loss_x)
    rel = abs(loss_x - loss_mt) / loss_mt
    cosines = {k: _cos(p_x[k] - start[k], p_mt[k] - start[k])
               for k in start}
    log(f"[train] one step from the start: loss mt {loss_mt:.9g}, mxu "
        f"{loss_x:.9g} (rel {rel:.3g}); cosine of the updates (= of the "
        f"gradients) mxu vs mt: "
        f"{ {k: round(c, 6) for k, c in cosines.items()} }; launches "
        f"{launches}")
    require(rel <= 5e-3, f"mt vs mxu loss {rel}")
    require(launches["sb_intersect_mxu"] > 0, "no sb_intersect_mxu launch")
    require(launches["sb_intersect"] == 0, "the mxu step ran sb_intersect")

    torch.cuda.reset_peak_memory_stats(dev)
    params, losses, times = start, [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        new, loss = step(params, *args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        _finite_nonzero({k: new[k] - params[k] for k in new}, "update")
        params = new
    peak = torch.cuda.max_memory_allocated(dev)
    require(all(map(math.isfinite, losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"no descent: {losses}")
    ms = 1e3 * sum(times[1:]) / (TRAIN_STEPS - 1)

    # the step's two halves, timed apart (the same calls the step makes)
    fwd, bwd = [], []
    for _ in range(3):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        t0 = time.perf_counter()
        loss = step.loss_fn(leaves, *args)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        step.update(params, dict(zip(leaves, grads)))
        torch.cuda.synchronize()
        fwd.append(t1 - t0)
        bwd.append(time.perf_counter() - t1)
        _finite_nonzero(dict(zip(leaves, grads)), "gradient")
    fwd_ms, bwd_ms = 1e3 * sum(fwd) / 3, 1e3 * sum(bwd) / 3
    log(f"[train] {TRAIN_STEPS} steps under mxu: losses "
        f"{[round(v, 9) for v in losses]}; {ms:.3f} ms/step over steps "
        f"2..{TRAIN_STEPS} ({', '.join(f'{1e3 * t:.3f}' for t in times)}); "
        f"forward {fwd_ms:.3f} ms, backward + update {bwd_ms:.3f} ms; peak "
        f"memory {peak / 2**20:.1f} MiB")
    prof = profile_once(lambda: step(params, *args), "train")

    # the cornell box's vertex rate on the hall, for the record (no
    # requirement; PERF.md, section 6)
    ref_step = make_train_step(None, cfg_x, **CORNELL_KW)
    params, ref_losses, ref_moves = start, [], []
    for _ in range(TRAIN_STEPS):
        new, loss = ref_step(params, *args)
        ref_losses.append(float(loss))
        ref_moves.append(float((new["v0"] - params["v0"]).abs().max()))
        params = new
    log(f"[train] cornell vertex rate 0.01 on the hall: losses "
        f"{[round(v, 9) for v in ref_losses]}; largest v0 move per step "
        f"{[round(v, 6) for v in ref_moves]}")
    return dict(ms_per_step=ms, step_ms=[1e3 * t for t in times],
                forward_ms=fwd_ms, backward_update_ms=bwd_ms,
                peak_mem_bytes=peak, losses=losses, loss_mt=loss_mt,
                loss_mxu=loss_x, update_cosine=cosines, launches=launches,
                profile=prof, cornell_rate_losses=ref_losses)


def card_mesh(dev, rows, mp):
    """A rows x mp ("data", "model") mesh whose every position is ``dev``."""
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(rows * mp, model_parallel=mp, devices=[dev] * (rows * mp))


def step_queries(scene, cfg, carry, samples):
    """The closest and shadow queries of one bounce step at ``carry`` as
    the integrator makes them on one card: {"closest": (args, kw),
    "shadow": (args, kw)} of ``intersect_closest_pallas`` and
    ``occluded_pallas``."""
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.render.integrator import make_bounce_step
    made = {}
    saved = pk.intersect_closest_pallas, pk.occluded_pallas

    def rec(name, fn):
        def run(*args, **kw):
            made[name] = (args, kw)
            return fn(*args, **kw)
        return run
    pk.intersect_closest_pallas = rec("closest", saved[0])
    pk.occluded_pallas = rec("shadow", saved[1])
    try:
        make_bounce_step(scene, cfg)(carry, samples)
    finally:
        pk.intersect_closest_pallas, pk.occluded_pallas = saved
    return made


def mesh_query(scene, cfg, dev, queries, mp, seen):
    """Phase 16a at one 1 x mp mesh of the card: the bounce-1 step's
    closest query ("mt" and "mxu") and shadow query through the sharded
    query, launches counted around them; every shard's kernel inputs
    against the plain versions exactly; the hits against the single-card
    query (the triangle on all but tie lanes, counted, each within rel
    1e-5 in t; t bit for bit where the triangle is the same), occlusion
    identical; CUDA-event times of both."""
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.parallel.shard_intersect import (
        build_sharded_packets, shard_packets, sharded_intersect_closest,
        sharded_occluded)
    from prismarine_core_tpu_torch.render.integrator import _pallas_kwargs
    tag = f"mesh query 1x{mp}"
    mesh = card_mesh(dev, 1, mp)
    t0 = time.perf_counter()
    sp = shard_packets(build_sharded_packets(scene.bvh, mp,
                                             soup=scene.triangles), mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    (c_args, c_kw), (s_args, s_kw) = queries["closest"], queries["shadow"]
    o, d, t_cap = c_args[3], c_args[4], c_kw["t_cap"]
    so, sd, st = s_args[3:6]
    cfg_x = cfg.replace(kernel_form="mxu")

    def closest(c=cfg):
        return sharded_intersect_closest(
            mesh, sp, o, d, t_cap=t_cap, return_order=True,
            query_kw=_pallas_kwargs(c, any_hit=False))

    def shadow(order):
        return sharded_occluded(mesh, sp, so, sd, st, order=order,
                                query_kw=_pallas_kwargs(cfg, any_hit=True))

    def single(c=cfg):
        kw = dict(c_kw, return_order=False, **_pallas_kwargs(c, False))
        return pk.intersect_closest_pallas(*c_args, **kw)

    read = zero_launches()
    with recorded_calls() as calls:
        hit, order = closest()
        occ = shadow(order)
    with recorded_calls(("block_cull", "pair_cull",
                         "sb_intersect_mxu")) as calls_x:
        hit_x, _ = closest(cfg_x)
    torch.cuda.synchronize()
    launches = read()
    # per shard at most: two closest rounds of each form, one shadow query
    for k, most in (("block_cull", 5), ("pair_cull", 5), ("sb_intersect", 3),
                    ("sb_intersect_mxu", 2)):
        require(mp <= launches[k] <= most * mp,
                f"{tag} {k}: {launches[k]} launches")
    errs, n_checked, plain_ms = check_recorded(calls, tag, seen)
    e_x, n_x, plain_x = check_recorded(calls_x, f"{tag} mxu", seen)
    for k, v in e_x.items():
        errs[k] = max(errs.get(k, 0.0), v)

    res = dict(build_s=build_s, launches=launches, max_abs_err=errs,
               inputs_checked=n_checked + n_x, plain_ms=plain_ms + plain_x,
               superblocks_per_shard=sp.n_superblocks // mp)
    # "mt": other triangles only at equal t (ties); "mxu": its t carries
    # the determinant form's rounding, so a cull at the cap can keep or
    # drop an edge candidate differently per shard: counted, not tied
    for form, got, ref in (("mt", hit, single()),
                           ("mxu", hit_x, single(cfg_x))):
        same = got.tri == ref.tri
        hits = int((ref.tri >= 0).sum())
        other = int((~same).sum())
        require(torch.equal(got.t[same], ref.t[same]),
                f"{tag} {form}: t differs where the triangle is the same")
        gap = (got.t[~same] - ref.t[~same]).abs() / ref.t[~same].abs()
        tied = int((gap <= 1e-5).sum())
        require(other <= 1e-4 * hits and (form == "mxu" or tied == other),
                f"{tag} {form}: {other} lanes on another triangle, "
                f"{other - tied} of them not at equal t")
        res[f"other_{form}"], res[f"tied_{form}"] = other, tied
        res[f"hits_{form}"] = hits
        res[f"max_rel_t_gap_{form}"] = float(gap.max()) if other else 0.0
    occ_ref = pk.occluded_pallas(*s_args, **s_kw)
    require(torch.equal(occ, occ_ref), f"{tag}: occlusion differs")
    res["ms"] = dict(closest=cuda_ms(lambda: closest(), 3),
                     closest_single=cuda_ms(single, 3),
                     shadow=cuda_ms(lambda: shadow(order), 3),
                     shadow_single=cuda_ms(lambda: pk.occluded_pallas(
                         *s_args, **s_kw), 3))
    log(f"[{tag}] {res['superblocks_per_shard']} superblocks a shard "
        f"({sp.n_superblocks} with padding), sharded in {build_s:.2f} s; "
        f"launches {launches}; {n_checked + n_x} kernel inputs of the "
        f"shards == plain exactly (plain versions "
        f"{plain_ms + plain_x:.0f} ms); closest vs single card: mt "
        f"{res['other_mt']} tie lanes of {res['hits_mt']} hits; mxu "
        f"{res['other_mxu']} lanes of {res['hits_mxu']} on another "
        f"triangle ({res['tied_mxu']} at equal t, largest relative t gap "
        f"{res['max_rel_t_gap_mxu']:.3g}); t bit for bit elsewhere; occlusion "
        f"identical ({int(occ.sum())} occluded); ms "
        f"{ {k: round(v, 4) for k, v in res['ms'].items()} }")
    return res


def phase_mesh(scene, cam, cfg, dev, img, samples):
    """Phase 16: the device mesh, on meshes whose every position is the
    card (the shards run one after another).  (a) the bounce-1 step's
    queries at meshes 1x2, 1x3 and 1x4 (mesh_query); (b) the bench frame
    under "pallas_sharded" at mesh 2x2 through phase_frame's gates and
    measurements (launches up to 4 x 12 a kernel), the image gate against
    the phase 4 frame, make_sharded_renderer's image equal to it; (c) the
    textured hall (100k target tris, 256^2 textures) at 1024x1024 and 8
    bounces through make_sharded_renderer at mesh 2x4 with the soup a
    husk and the textures split: finite, non-degenerate, the image gate
    against the same frame on the single-card "pallas" path, per-shard
    bytes of the planes and of the texture stack at most 1/mp of the
    whole + 1 KiB; (d) one train step under "pallas_sharded" at mesh 1x2
    and kernel_form "mxu" from phase_train's start against one
    single-card step: the loss within 5e-3 relative, the cosine of every
    parameter's update, v0, v1 and v2 moved and finite, sb_intersect_mxu
    launched."""
    import torch
    from prismarine_core_tpu_torch.utils.profiling import counts
    from prismarine_core_tpu_torch.models.procedural import (
        make_hall_scene)
    from prismarine_core_tpu_torch.ops.sampling import (
        make_coherent_sample_arrays)
    from prismarine_core_tpu_torch.parallel.mesh import (
        init_params, make_sharded_renderer, make_train_step)
    from prismarine_core_tpu_torch.parallel.shard_intersect import (
        distribute_scene)
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    t_phase = time.perf_counter()
    out = {}

    # (a) the query at 1 x mp
    _, _, _, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    queries = step_queries(scene, cfg, carry1, bounce_s[1])
    seen = {k: [] for k in MT_PATH + ("sb_intersect_mxu",)}
    for mp in QUERY_MESHES:
        out[f"query_1x{mp}"] = mesh_query(scene, cfg, dev, queries, mp, seen)
    # the recorded inputs hold ~60 MB ray matrices: free them before the
    # peak-memory readings below
    del seen, queries, carry1, bounce_s

    # (b) the bench frame at 2 x 2
    rows, mp = MESH_FRAME
    mesh = card_mesh(dev, rows, mp)
    dscene = distribute_scene(scene, mesh)
    cfg_sh = cfg.replace(intersector="pallas_sharded", mesh=mesh)
    tag = f"frame sharded {rows}x{mp}"
    img_sh, res, samples_sh = phase_frame(
        dscene, cam, cfg_sh, dev, tag=tag,
        max_launches=rows * mp * MAX_LAUNCHES)
    res["gate"] = image_gate(img_sh, img, tag, "single-card pallas frame")
    via = make_sharded_renderer(mesh, cfg_sh)(dscene, cam, *samples_sh)
    require(torch.equal(via, img_sh), f"{tag}: make_sharded_renderer's "
            "image differs from render_with_samples'")
    out["frame_2x2"] = res
    del dscene

    # (c) the textured frame the JAX package could only compile
    t0 = time.perf_counter()
    hall = make_hall_scene(target_tris=100_000, textured=True,
                           texture_resolution=256, device=dev)
    cfg_c = RenderConfig(width=BIG_W, height=BIG_H, spp=1,
                         max_bounces=BIG_BOUNCES, intersector="pallas",
                         cull_impl="pallas2", coherent_bounce_sampling=True)
    gen = torch.Generator(device=dev).manual_seed(7)
    big_s = make_coherent_sample_arrays(gen, cfg_c, block=(64, 64))
    torch.cuda.synchronize()
    log(f"[mesh textured] {int(hall.triangles.num_valid())} tris, textures "
        f"{tuple(hall.textures.data.shape)}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    tag = f"frame textured sharded {MESH_TEXTURED[0]}x{MESH_TEXTURED[1]}"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    ref = render_with_samples(hall, cam, cfg_c, *big_s)
    torch.cuda.synchronize()
    single_s, single_peak = (time.perf_counter() - t0,
                             torch.cuda.max_memory_allocated(dev))
    rows, mp = MESH_TEXTURED
    mesh = card_mesh(dev, rows, mp)
    dhall = distribute_scene(hall, mesh, shard_soup=True,
                             shard_textures=True)
    cfg_cs = cfg_c.replace(intersector="pallas_sharded", mesh=mesh)
    shard_bytes = {}
    for name, arr in (("planes", dhall.packets.planes),
                      ("texture data", dhall.textures.data),
                      ("texture quads", dhall.textures.quad)):
        b = arr.shard(0).nbytes
        require(b <= arr.nbytes / mp + 1024, f"{tag}: {name} per shard {b} "
                f"of {arr.nbytes}")
        shard_bytes[name] = (b, arr.nbytes)
    renderer = make_sharded_renderer(mesh, cfg_cs)
    torch.cuda.reset_peak_memory_stats(dev)
    read = zero_launches(sharded=True)
    syncs0 = counts["pc.sync.compact"]
    t0 = time.perf_counter()
    big = renderer(dhall, cam, *big_s)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    compactions = counts["pc.sync.compact"] - syncs0
    require(big.shape == (BIG_H, BIG_W, 3), f"{tag}: shape {big.shape}")
    require(bool(torch.isfinite(big).all()), f"{tag}: non-finite image")
    require(float(big.std()) > 0.0 and float(big.mean()) > 1e-2,
            f"{tag}: degenerate image")
    for k in MT_PATH:
        require(launches[k] > 0, f"{tag}: no {k} launch")
    gate = image_gate(big, ref, tag, "single-card pallas frame")
    out["frame_textured_2x4"] = dict(
        launches=launches, compactions=compactions, sharded_s=sharded_s,
        single_s=single_s, peak_mem_bytes=peak,
        single_peak_mem_bytes=single_peak, mean=float(big.mean()),
        std=float(big.std()), gate=gate,
        shard_bytes={k: list(v) for k, v in shard_bytes.items()})
    log(f"[{tag}] {BIG_W}x{BIG_H}, {BIG_BOUNCES} bounces: sharded frame "
        f"{sharded_s:.3f} s (one card: {single_s:.3f} s); launches "
        f"{launches}; {compactions} pair compactions; peak memory "
        f"{peak / 2**20:.1f} MiB (one card {single_peak / 2**20:.1f}); "
        f"per-shard bytes of the whole: "
        f"{ {k: f'{b} of {t}' for k, (b, t) in shard_bytes.items()} }")
    del hall, dhall, ref, big

    # (d) the sharded train step at 1 x 2 under "mxu"
    rows, mp = MESH_TRAIN
    mesh = card_mesh(dev, rows, mp)
    cfg_x = cfg.replace(kernel_form="mxu")
    cfg_xs = cfg_x.replace(intersector="pallas_sharded", mesh=mesh)
    start = {k: v.clone() for k, v in init_params(scene).items()}
    start["mat_diffuse"][:, :3] *= 0.5
    dscene = distribute_scene(scene, mesh, shard_soup=False)
    p1, loss1 = make_train_step(None, cfg_x, **TRAIN_KW)(
        start, scene, cam, *samples, img)
    step = make_train_step(mesh, cfg_xs, **TRAIN_KW)
    torch.cuda.reset_peak_memory_stats(dev)
    read = zero_launches(sharded=True)
    t0 = time.perf_counter()
    p_s, loss_s = step(start, dscene, cam, *samples, img)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    loss1, loss_s = float(loss1), float(loss_s)
    rel = abs(loss_s - loss1) / loss1
    cosines = {k: _cos(p_s[k] - start[k], p1[k] - start[k]) for k in start}
    tag = f"train sharded {rows}x{mp}"
    require(rel <= 5e-3, f"{tag}: loss {loss_s} vs one card {loss1}")
    _finite_nonzero({k: p_s[k] - start[k] for k in ("v0", "v1", "v2")},
                    f"{tag} update")
    require(launches["sb_intersect_mxu"] > 0, f"{tag}: no sb_intersect_mxu")
    t0 = time.perf_counter()
    step(p_s, dscene, cam, *samples, img)
    torch.cuda.synchronize()
    step2_s = time.perf_counter() - t0
    out["train_1x2"] = dict(loss=loss_s, loss_single=loss1, rel=rel,
                            update_cosine=cosines, launches=launches,
                            step_ms=[1e3 * step_s, 1e3 * step2_s],
                            peak_mem_bytes=peak)
    log(f"[{tag}] loss {loss_s:.9g} vs one card {loss1:.9g} (rel "
        f"{rel:.3g}); cosine of each update against one card's "
        f"{ {k: round(c, 6) for k, c in cosines.items()} }; launches "
        f"{launches}; steps {1e3 * step_s:.1f} / {1e3 * step2_s:.1f} ms "
        f"(the BVH and the sharded packets rebuilt inside the loss); peak "
        f"memory {peak / 2**20:.1f} MiB")
    log(f"[mesh] phase 16 in {time.perf_counter() - t_phase:.1f} s")
    return out, img_sh


def phase_default_cull(scene, cam, cfg, dev, img):
    """Phase 17a: the bench frame under the reference's default cull
    (``cull_impl="pallas"``: block_cull over the 2,048 block boxes, the
    pairs' masks from its table, round 2 re-culled per ray over the
    superblocks, recull "sb").  (a) every block_cull input of the bounce-0
    and bounce-1 steps (2,048 and 256 boxes) and every sb_intersect input
    of the bounce-1 step against the plain versions exactly, no pair_cull
    call; (b) the bounce-1 closest query's t bit for bit equal to
    "pallas2"'s on every lane (slots differ only on those equal-t tie
    lanes, counted), recull "kernel" and "tn" equal to "sb", occlusion
    identical, pairs and live sub-blocks of each round against "pallas2",
    CUDA-event ms in alternating turns; (c) block_cull at 2,048 boxes:
    CUDA-event ms against the 256-box recull in alternating turns, the
    plain version's ms, the bound from block_cull_work's count and the
    dense bound; (d) the frame through phase_frame's gates and
    measurements (launches exactly DEFAULT_CULL_LAUNCHES) and the image
    gate against phase 4's "pallas2" frame; (e) one frame of
    RenderConfig(intersector="pallas")'s own defaults (K 8, any-hit
    "rounds", independent samples) at the bench's scene and size against
    the same under "pallas2" by the image gate."""
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.ops import cull, sb_intersect as si
    from prismarine_core_tpu_torch.render.integrator import (
        _pallas_kwargs, initial_carry, make_bounce_step, render_with_samples)
    from prismarine_core_tpu_torch.utils.config import RenderConfig
    t_phase = time.perf_counter()
    cfg_p = cfg.replace(cull_impl="pallas")
    ps = scene.packets
    widths = [cull.box_rows_from_blocks(ps.block_lo, ps.block_hi).shape[1],
              cull.box_rows_from_blocks(ps.sb_lo, ps.sb_hi).shape[1]]
    out = {}

    # (a) the kernel inputs of the bounce-0 and bounce-1 steps
    o, d, _, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    seen = {k: [] for k in MT_PATH}
    errs, recorded = {}, {}
    for tag, carry, smp in (("bounce0", initial_carry(o, d), bounce_s[0]),
                            ("bounce1", carry1, bounce_s[1])):
        with recorded_calls() as calls:
            make_bounce_step(scene, cfg_p)(carry, smp)
        n = {k: len(v) for k, v in calls.items()}
        boxes = [args[1].shape[1] for args in calls["block_cull"]]
        require(n == {"block_cull": 3, "pair_cull": 0, "sb_intersect": 3}
                and boxes == [widths[0], widths[1], widths[0]],
                f"default cull {tag}: calls {n}, box widths {boxes}")
        check = calls if tag == "bounce1" else {
            "block_cull": calls["block_cull"]}
        e, n_checked, plain_ms = check_recorded(check, f"default cull {tag}",
                                                seen)
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        for (rays, rows, n_live), q in zip(calls["block_cull"],
                                           ("closest round 1",
                                            "closest round 2 (recull sb)",
                                            "shadow")):
            tn = cull.block_cull(rays, rows, n_live)
            log(f"[default cull] {tag} {q}: block_cull over {rows.shape[1]} "
                f"boxes, n_live {int(n_live)}, "
                f"{int((tn < 1e4).sum())} passing (tile, box) entries")
        log(f"[default cull] {tag}: calls {n}; {n_checked} kernel inputs == "
            f"plain exactly ({plain_ms:.0f} ms of plain versions)")
        recorded[tag] = calls
    out["max_abs_err"] = errs

    # (b) the bounce-1 closest and shadow queries against "pallas2"
    queries = step_queries(scene, cfg, carry1, bounce_s[1])
    (c_args, c_kw), (s_args, s_kw) = queries["closest"], queries["shadow"]
    inputs = pk._detached(*c_args[:2], c_args[3], c_args[4], c_kw["t_cap"])

    def closest(c):
        return pk._run_packet_pallas(*inputs, **_pallas_kwargs(c, False))

    def rounds(c):
        """(pairs, live sub-blocks) of each sb_intersect call of a query."""
        with recorded_calls(("sb_intersect",)) as calls:
            res = closest(c)
        return res, [(int(a[3]), int(si.live_counts(a[2], a[3]).sum()))
                     for a in calls["sb_intersect"]]
    (t2, s2, _), work2 = rounds(cfg)
    (tp, sp, _), work_p = rounds(cfg_p)
    require(torch.equal(tp, t2), "default cull: closest t differs from "
            "pallas2")
    ties = int((sp != s2).sum())
    hits = int((s2 >= 0).sum())
    require(ties <= 1e-4 * hits, f"default cull: {ties} tie lanes")
    reculls = {}
    for rc in ("kernel", "tn"):
        (t_rc, s_rc, _), work_rc = rounds(cfg_p.replace(recull=rc))
        require(torch.equal(t_rc, tp), f"default cull: recull {rc} t "
                "differs from sb")
        reculls[rc] = dict(work=work_rc, ties=int((s_rc != sp).sum()))
    occ2 = pk.occluded_pallas(*s_args, **s_kw)
    occp = pk.occluded_pallas(*s_args, **dict(
        s_kw, **_pallas_kwargs(cfg_p, any_hit=True)))
    require(torch.equal(occp, occ2), "default cull: occlusion differs")
    q_ms, _ = alternating_ms({
        "pallas2": lambda: closest(cfg), "pallas": lambda: closest(cfg_p),
        "pallas_kernel": lambda: closest(cfg_p.replace(recull="kernel")),
        "pallas_tn": lambda: closest(cfg_p.replace(recull="tn"))},
        turns=3, reps=3)
    out["closest_bounce1"] = dict(
        ties=ties, hits=hits, rounds_pallas2=work2, rounds_pallas=work_p,
        reculls=reculls, occluded=int(occp.sum()), ms=q_ms)
    log(f"[default cull] bounce-1 closest: t == pallas2 on all "
        f"{t2.numel()} lanes, {ties} tie lanes of {hits} hits; (pairs, "
        f"live sub-blocks) by round: pallas {work_p}, pallas2 {work2}, "
        f"recull kernel {reculls['kernel']['work']}, tn "
        f"{reculls['tn']['work']} (t == sb); occlusion identical "
        f"({int(occp.sum())} occluded); ms "
        f"{ {k: round(v, 4) for k, v in q_ms.items()} }")

    # (c) block_cull at 2,048 boxes (closest round 1) beside the 256-box
    # recull of the same query
    b2048, b256 = recorded["bounce1"]["block_cull"][:2]
    ms, turns = alternating_ms({
        "2048": lambda: cull.block_cull(*b2048),
        "256": lambda: cull.block_cull(*b256)})
    plain_ms = cuda_ms(lambda: cull.block_cull_plain(*b2048), 1)
    res = {}
    for k, args in (("2048", b2048), ("256", b256)):
        w = block_cull_work(*args)
        b, by = bound(w["ops"], w["bytes"])
        db, dby = bound(w["dense_ops"], w["bytes"])
        res[k] = dict(ms=ms[k], turns_ms=turns[k], bound_ms=b, bound_by=by,
                      dense_bound_ms=db, dense_bound_by=dby,
                      survivors=w["share"])
        log(f"[default cull] block_cull at {args[1].shape[1]} boxes: "
            f"{ms[k]:.4f} ms "
            f"(turns {[round(x, 4) for x in turns[k]]}), bound {b:.4f} ms "
            f"by {by} ({b / ms[k]:.3f} of it), dense bound {db:.4f} ms by "
            f"{dby}, survivors of the reject {w['share']:.4f}")
    res["2048"]["plain_ms"] = plain_ms
    log(f"[default cull] block_cull_plain at 2048 boxes {plain_ms:.1f} ms")
    out["block_cull"] = res
    del recorded, seen, queries, inputs

    # (d) the frame
    tag = "frame default cull"
    img_p, frame, samples_p = phase_frame(scene, cam, cfg_p, dev, tag=tag,
                                          kernels=("block_cull",
                                                   "sb_intersect"))
    require(frame["launches"]["block_cull"] ==
            DEFAULT_CULL_LAUNCHES["block_cull"]
            and frame["launches"]["sb_intersect"] ==
            DEFAULT_CULL_LAUNCHES["sb_intersect"],
            f"{tag}: launches {frame['launches']}")
    frame["gate"] = image_gate(img_p, img, tag, "pallas2 frame (phase 4)")
    out["frame"] = frame

    # (e) RenderConfig(intersector="pallas")'s own defaults
    cfg_d = RenderConfig(width=W, height=H, max_bounces=BOUNCES,
                         intersector="pallas")
    smp = frame_samples(cfg_d, dev)
    read = zero_launches()
    t0 = time.perf_counter()
    img_d = render_with_samples(scene, cam, cfg_d, *smp)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    launches = read()
    t0 = time.perf_counter()
    img_d2 = render_with_samples(scene, cam, cfg_d.replace(
        cull_impl="pallas2"), *smp)
    torch.cuda.synchronize()
    wall_d2 = time.perf_counter() - t0
    tag = "frame pallas defaults"
    require(launches["block_cull"] > 0 and launches["sb_intersect"] > 0,
            f"{tag}: launches {launches}")
    gate = image_gate(img_d, img_d2, tag, "same config under pallas2")
    out["frame_pallas_defaults"] = dict(
        launches=launches, wall_s=wall_d, wall_s_pallas2=wall_d2,
        mean=float(img_d.mean()), gate=gate)
    log(f"[{tag}] launches {launches}; {wall_d:.3f} s (pallas2 "
        f"{wall_d2:.3f} s, each a first frame); mean "
        f"{float(img_d.mean()):.6f}")
    log(f"[default cull] phase 17a in {time.perf_counter() - t_phase:.1f} s")
    return out


def query_work(fn):
    """``fn()`` with its sb_intersect calls recorded: (its result, the
    (pairs, live sub-blocks) of each call)."""
    from prismarine_core_tpu_torch.ops import sb_intersect as si
    with recorded_calls(("sb_intersect",)) as calls:
        res = fn()
    return res, [(int(a[3]), int(si.live_counts(a[2], a[3]).sum()))
                 for a in calls["sb_intersect"]]


def knob_frame(scene, cam, cfg, dev, img, tag, launches=None, **kw):
    """One frame of a phase 18 path through phase_frame's gates and
    measurements (``kw``) with each kernel's launches exactly
    ``launches`` (KNOB_LAUNCHES by default), and the image gate against
    phase 4's frame ``img``; returns (image, result, samples)."""
    img_k, res, smp = phase_frame(scene, cam, cfg, dev, tag=tag, **kw)
    want = KNOB_LAUNCHES if launches is None else launches
    require(all(res["launches"][k] == want.get(k, 0) for k in KERNELS),
            f"{tag}: launches {res['launches']}")
    res["gate"] = image_gate(img_k, img, tag, "pallas2 frame (phase 4)")
    return img_k, res, smp


def check_step(scene, cfg, carry, samples, tag, seen, errs,
               fixed_order=None):
    """Phase 18's kernel inputs: every block_cull, pair_cull and
    sb_intersect call of one bounce step of ``cfg`` at ``carry`` against
    the plain versions exactly (check_recorded)."""
    from prismarine_core_tpu_torch.render.integrator import make_bounce_step
    with recorded_calls() as calls:
        make_bounce_step(scene, cfg, fixed_order=fixed_order)(carry, samples)
    e, n_checked, plain_ms = check_recorded(calls, tag, seen)
    for k, v in e.items():
        errs[k] = max(errs.get(k, 0.0), v)
    log(f"[knobs] {tag}: calls { {k: len(v) for k, v in calls.items()} }; "
        f"{n_checked} new kernel inputs == plain exactly ({plain_ms:.0f} ms "
        "of plain versions)")


def phase_knobs(scene, cam, cfg, dev, img, frame):
    """Phase 18: the packet path's last knobs and the "packet" intersector
    at the bench's scene and size (``img`` and ``frame`` phase 4's).  Each
    sub-phase holds its bounce-step kernel inputs against the plain
    versions exactly (check_step).  (a) cull_impl="xla": the frame
    bit-identical to phase 4's, launches 12 / 12 / 12, and the bounce-1
    shadow query under "xla" + "rounds" occluding as "single"; (b)
    sort_mode "packed" and "group" and (c) near_frac 0.4: the bounce-1
    closest t bit for bit equal to phase 4's (tie lanes counted), pairs
    and live sub-blocks per round, the frame through the image gate and
    its device busy, and the three sorts alone at the bounce-1 rays in
    alternating turns; (d) primary_identity, reuse_bounce_order and
    primary_tile_order: their frames (the tile order's against a scanline
    frame of the same samples moved to their pixels), host syncs and
    device busy beside phase 4's, the bounce-0 step with and without the
    sort in alternating turns; (e) intersector="packet": the frame (8
    sb_intersect launches and no cull kernel), the bounce-1 closest t
    equal to "pallas" "single" at INF_DIST caps (tie lanes counted),
    occlusion identical, the interval cull's time and peak memory, pairs
    and live sub-blocks against "pallas2", sb_intersect's time on the
    packet pairs; (f) the CLI with --intersector packet and with
    --cull-impl xla --sort-mode group --reuse-order, two subprocesses at
    once."""
    import tempfile
    import torch
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.models.camera import tile_pixel_inv_perm
    from prismarine_core_tpu_torch.ops import sb_intersect as si
    from prismarine_core_tpu_torch.render.integrator import (
        _pallas_kwargs, initial_carry, make_bounce_step, render_with_samples)
    from prismarine_core_tpu_torch.utils.config import INF_DIST
    t_phase = time.perf_counter()
    out, seen, errs = {}, {k: [] for k in MT_PATH}, {}
    o, d, _, carry1, bounce_s = first_bounce(scene, cam, cfg, dev)
    queries = step_queries(scene, cfg, carry1, bounce_s[1])
    (c_args, c_kw), (s_args, s_kw) = queries["closest"], queries["shadow"]
    inputs = pk._detached(*c_args[:2], c_args[3], c_args[4], c_kw["t_cap"])
    lo, hi, _, co, cd, ct = inputs

    def closest(c):
        return pk._run_packet_pallas(*inputs, **_pallas_kwargs(c, False))
    (t_ref, s_ref, _), work_ref = query_work(lambda: closest(cfg))
    hits = int((s_ref >= 0).sum())
    out["pallas2_bounce1"] = dict(work=work_ref, hits=hits)
    log(f"[knobs] phase 4's bounce-1 closest query: (pairs, live "
        f"sub-blocks) by round {work_ref}, {hits} hits of {co.shape[0]}")

    def same_t(c, tag):
        (t, s, _), work = query_work(lambda: closest(c))
        require(torch.equal(t, t_ref), f"{tag}: bounce-1 closest t differs "
                "from phase 4's")
        ties = int((s != s_ref).sum())
        require(ties <= 1e-4 * hits, f"{tag}: {ties} tie lanes")
        log(f"[knobs] {tag} bounce-1 closest: t == phase 4's on all "
            f"{t.numel()} lanes, {ties} tie lanes; (pairs, live sub-blocks) "
            f"by round {work}")
        return dict(ties=ties, work=work)

    # (a) cull_impl="xla"
    cfg_x = cfg.replace(cull_impl="xla")
    check_step(scene, cfg_x, carry1, bounce_s[1], "xla bounce1", seen, errs)
    out["xla"] = dict(bounce1=same_t(cfg_x, "xla"))
    occ1 = pk.occluded_pallas(*s_args, **dict(s_kw, **_pallas_kwargs(
        cfg_x.replace(anyhit_strategy="single"), True)))
    occr = pk.occluded_pallas(*s_args, **dict(s_kw, **_pallas_kwargs(
        cfg_x.replace(anyhit_strategy="rounds"), True)))
    require(torch.equal(occ1, occr), "xla: rounds occlusion != single")
    img_x, out["frame_xla"], _ = knob_frame(
        scene, cam, cfg_x, dev, img, "frame xla")
    require(torch.equal(img_x, img), "frame xla != phase 4's frame")
    log(f"[knobs] xla: shadow rounds == single ({int(occ1.sum())} occluded);"
        " frame bit-identical to phase 4's")

    # (b) sort modes and (c) near_frac
    sort_ms, sort_turns = alternating_ms(
        {m: (lambda m=m: pk._coherence_perm(lo, hi, co, cd, ct, m))
         for m in ("full", "packed", "group")}, turns=5, reps=5)
    out["sort_ms"], out["sort_turns_ms"] = sort_ms, sort_turns
    log(f"[knobs] the coherence sort alone at {co.shape[0]} bounce-1 rays "
        f"(medians of 5 alternating turns of 5, CUDA events): "
        f"{ {k: round(v, 4) for k, v in sort_ms.items()} }")
    for tag, knob in (("sort packed", dict(sort_mode="packed")),
                      ("sort group", dict(sort_mode="group")),
                      ("near_frac", dict(near_frac=0.4))):
        c = cfg.replace(**knob)
        check_step(scene, c, carry1, bounce_s[1], f"{tag} bounce1", seen,
                   errs)
        key = tag.replace(" ", "_")
        out[key] = dict(bounce1=same_t(c, tag))
        _, out[f"frame_{key}"], _ = knob_frame(
            scene, cam, c, dev, img, f"frame {tag}")

    # (d) the bounce-0 flags
    carry0 = initial_carry(o, d)
    check_step(scene, cfg, carry0, bounce_s[0], "identity bounce0", seen,
               errs, fixed_order="identity")
    order1 = pk._coherence_perm(lo, hi, carry1[0], carry1[1],
                                torch.ones_like(ct), cfg.sort_mode)
    check_step(scene, cfg, carry1, bounce_s[1], "reuse bounce1", seen, errs,
               fixed_order=order1)
    step0 = {"sorted": make_bounce_step(scene, cfg),
             "identity": make_bounce_step(scene, cfg, fixed_order="identity")}
    b0_ms, b0_turns = alternating_ms(
        {k: (lambda s=s: s(carry0, bounce_s[0])) for k, s in step0.items()},
        turns=5, reps=3)
    out["bounce0_step_ms"], out["bounce0_step_turns_ms"] = b0_ms, b0_turns
    log(f"[knobs] bounce-0 step (medians of 5 alternating turns of 3): "
        f"{ {k: round(v, 4) for k, v in b0_ms.items()} }")
    for tag, knob in (("primary identity", dict(primary_identity=True)),
                      ("reuse order", dict(reuse_bounce_order=True))):
        _, out[f"frame_{tag.replace(' ', '_')}"], _ = knob_frame(
            scene, cam, cfg.replace(**knob), dev, img, f"frame {tag}")
    cfg_t = cfg.replace(primary_tile_order=True)
    img_t, res_t, (cs, bs) = phase_frame(scene, cam, cfg_t, dev,
                                         tag="frame tile order")
    require(all(res_t["launches"][k] == KNOB_LAUNCHES.get(k, 0)
                for k in KERNELS), f"frame tile order: launches "
            f"{res_t['launches']}")
    inv = tile_pixel_inv_perm(cfg_t, dev)
    scan = render_with_samples(scene, cam, cfg, cs[inv], bs[:, inv])
    res_t["gate"] = image_gate(img_t, scan, "frame tile order",
                               "scanline frame of the same samples")
    out["frame_tile_order"] = res_t
    for k in ("frame_primary_identity", "frame_reuse_order",
              "frame_tile_order"):
        r = out[k]
        log(f"[knobs] {k}: host syncs {r['host_syncs_per_frame']} (phase 4 "
            f"{frame['host_syncs_per_frame']}), device busy "
            f"{r['profile']['busy_ms']:.3f} ms (phase 4 "
            f"{frame['profile']['busy_ms']:.3f})")

    # (e) intersector="packet"
    cfg_p = cfg.replace(intersector="packet")
    inf = torch.full_like(ct, INF_DIST)
    args_inf = (lo, hi, inputs[2], co, cd, inf)
    with recorded_calls(("sb_intersect",)) as calls:
        make_bounce_step(scene, cfg_p)(carry1, bounce_s[1])
    require(len(calls["sb_intersect"]) == 2, "packet bounce-1 step: "
            f"{len(calls['sb_intersect'])} sb_intersect calls")
    e, n_checked, plain_ms = check_recorded(calls, "packet bounce1", seen)
    for k, v in e.items():
        errs[k] = max(errs.get(k, 0.0), v)
    log(f"[knobs] packet bounce1: {n_checked} sb_intersect inputs == plain "
        f"exactly ({plain_ms:.0f} ms of plain versions)")
    (t_p, s_p), work_p = query_work(lambda: pk._run_packet(*args_inf))
    (t_s, s_s, _), work_d = query_work(lambda: pk._run_packet_pallas(
        *args_inf, strategy="single", cull_impl="pallas"))
    (t_2, _, _), work_s = query_work(lambda: pk._run_packet_pallas(
        *args_inf, strategy="single", cull_impl="pallas2"))
    require(torch.equal(t_p, t_s), "packet: bounce-1 closest t differs "
            "from pallas single")
    require(torch.equal(t_p, t_2), "packet: bounce-1 closest t differs "
            "from pallas2 single")
    hits_p = int((s_s >= 0).sum())
    ties = int((s_p != s_s).sum())
    require(ties <= 1e-4 * hits_p, f"packet: {ties} tie lanes")
    occ_p = pk.occluded_packet(*s_args)
    occ_s = pk.occluded_pallas(*s_args, **dict(s_kw, **_pallas_kwargs(
        cfg.replace(anyhit_strategy="single"), True)))
    require(torch.equal(occ_p, occ_s), "packet: occlusion differs")
    rays, _, _ = pk._sorted_rays_matrix(*args_inf[:2], co, cd, inf)
    ps = scene.packets
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pk.tile_block_overlap(rays, ps.block_lo, ps.block_hi)
    torch.cuda.synchronize()
    cull_peak = torch.cuda.max_memory_allocated(dev) - base
    cull_ms = cuda_ms(lambda: pk.tile_block_overlap(
        rays, ps.block_lo, ps.block_hi), 3)
    sb_args = calls["sb_intersect"][0]
    sb_ms = cuda_ms(lambda: si.sb_intersect(*sb_args), 3)
    out["packet"] = dict(ties=ties, hits=hits_p, work=work_p,
                         work_pallas_single=work_d,
                         work_pallas2_single=work_s,
                         occluded=int(occ_p.sum()), cull_ms=cull_ms,
                         cull_peak_bytes=cull_peak,
                         sb_intersect_ms=sb_ms)
    log(f"[knobs] packet bounce-1 closest at INF_DIST caps: t == pallas "
        f"single's and pallas2 single's on all {t_p.numel()} lanes, {ties} "
        f"tie lanes (slot != pallas single's) of {hits_p} hits; (pairs, live "
        f"sub-blocks) packet {work_p} vs pallas single {work_d} vs pallas2 "
        f"single {work_s} vs phase 4's two_round (live caps) {work_ref}; "
        f"occlusion identical ({int(occ_p.sum())}); interval cull {cull_ms:.4f} ms, "
        f"its peak {cull_peak / 2**20:.1f} MiB over the live tensors; "
        f"sb_intersect on the packet pairs {sb_ms:.4f} ms")
    _, out["frame_packet"], _ = knob_frame(
        scene, cam, cfg_p, dev, img, "frame packet",
        kernels=("sb_intersect",),
        max_launches=PACKET_LAUNCHES["sb_intersect"],
        launches=PACKET_LAUNCHES)

    # (f) the CLI, two subprocesses at once
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        t0 = time.perf_counter()
        for name, flags in (("packet", ["--intersector", "packet"]),
                            ("xla_group_reuse", ["--cull-impl", "xla",
                                                 "--sort-mode", "group",
                                                 "--reuse-order"])):
            png = Path(tmp) / f"{name}.png"
            runs[name] = (png, subprocess.Popen(
                [sys.executable, "-m", "prismarine_core_tpu_torch.cli",
                 "--scene", "hall", "--res", "320x180", "--frames", "2",
                 "--out", str(png), *flags], cwd=REPO,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        cli = {}
        for name, (png, proc) in runs.items():
            try:
                _, err = proc.communicate(timeout=300)
            finally:
                proc.kill()
            require(proc.returncode == 0, f"CLI {name} exit "
                    f"{proc.returncode}: {err[-2000:]}")
            require(png_size(png) == (320, 180), f"CLI {name} PNG size "
                    f"{png_size(png)}")
            cli[name] = dict(wall_s=time.perf_counter() - t0,
                             stderr=err.strip().splitlines()[-1:])
        out["cli"] = cli
        log(f"[knobs] CLI subprocesses exit 0 with a 320x180 PNG: {cli}")
    out["max_abs_err"] = errs
    log(f"[knobs] phase 18 in {time.perf_counter() - t_phase:.1f} s")
    return out


def cases_module():
    """tests/torch_multihost_cases.py of this checkout, by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_cases", REPO / "tests" / "torch_multihost_cases.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def worker_main(work: Path) -> int:
    """One process of phase 17b (``chip_smoke.py --worker DIR``, with the
    coordinator's environment): MP_POSITIONS positions, each the card,
    over gloo with CUDA tensors staged through the host.  Prints one
    ``WORKER {json}`` line; saves its frames under ``DIR``."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO))
    from prismarine_core_tpu_torch.parallel import distributed
    from prismarine_core_tpu_torch.parallel.mesh import (
        init_params, make_sharded_renderer, make_train_step)
    from prismarine_core_tpu_torch.parallel.shard_intersect import (
        distribute_scene)
    cases = cases_module()
    dev = torch.device("cuda", 0)
    ctx = distributed.init_distributed(local_devices=[dev] * MP_POSITIONS)
    rank = ctx.rank
    t_start = time.perf_counter()
    scene, cam, cfg = bench_setup(dev)
    given = torch.load(work / "inputs.pt")
    samples = frame_samples(cfg, dev)
    require(all(float(s.double().sum()) == v for s, v in
                zip(samples, given["samples_sum"])),
            "worker: sample arrays differ from the parent's")
    res = {"rank": rank, "nccl": ctx.nccl_device is not None}

    # (i) the bench frame, "model" across the processes
    mesh = distributed.global_mesh(4, 2, order=cases.CROSSING)
    require(mesh.ranks == ((0, 1), (0, 1)), f"mesh ranks {mesh.ranks}")
    dscene = distribute_scene(scene, mesh)
    renderer = make_sharded_renderer(mesh, cfg.replace(
        intersector="pallas_sharded", mesh=mesh))
    renderer(dscene, cam, *samples)
    torch.cuda.synchronize()
    read = zero_launches(sharded=True)
    t0 = time.perf_counter()
    img = renderer(dscene, cam, *samples)
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    launches = read()
    prof = profile_once(lambda: renderer(dscene, cam, *samples),
                        f"multiprocess frame rank {rank}")
    torch.save(img.cpu(), work / f"frame_{rank}.pt")
    res["frame_2x2"] = dict(launches=launches, wall_ms=wall, profile=prof)
    del dscene

    # (ii) the frames of tests/test_multihost.py
    inputs = dict(np.load(work / "cases.npz"))
    for name, fn, mp in (("brute", cases.brute_frame, 1),
                         ("hall", cases.hall_frame, 2)):
        x = fn(distributed.global_mesh(4, mp), inputs, dev)
        torch.save(x.cpu(), work / f"{name}_{rank}.pt")
        res[f"mean_{name}"] = float(x.double().mean())

    # (iii) phase 16d's train step, its two shards in two processes
    mesh = distributed.global_mesh(2, 2, order=(0, MP_POSITIONS))
    require(mesh.ranks == ((0, 1),), f"train mesh ranks {mesh.ranks}")
    cfg_xs = cfg.replace(kernel_form="mxu", intersector="pallas_sharded",
                         mesh=mesh)
    start = {k: v.clone() for k, v in init_params(scene).items()}
    start["mat_diffuse"][:, :3] *= 0.5
    dscene = distribute_scene(scene, mesh, shard_soup=False)
    step = make_train_step(mesh, cfg_xs, **TRAIN_KW)
    target = given["target"].to(dev)
    read = zero_launches(sharded=True)
    t0 = time.perf_counter()
    params, loss = step(start, dscene, cam, *samples, target)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    res["train_1x2"] = dict(loss=float(loss), launches=read(),
                            step_ms=step_ms, update_abs_sum={
                                k: float((params[k] - start[k]).abs().sum())
                                for k in ("v0", "v1", "v2")})
    res["wall_s"] = time.perf_counter() - t_start
    print("WORKER " + json.dumps(res), flush=True)
    distributed.shutdown()
    return 0


def phase_multiprocess(dev, img_2x2, loss_1x2, img, samples):
    """Phase 17b: the mesh over processes.  MP_PROCESSES worker processes
    (``worker_main``), each with MP_POSITIONS positions on the one card,
    over gloo with CUDA tensors staged through the host (the kernels
    built here before they start, so they only load them): (i) the bench
    frame on a global 2x2 mesh whose "model" axis crosses the processes,
    bit-identical to phase 16b's one-process 2x2 frame; (ii)
    tests/test_multihost.py's two frames on its layout, the processes'
    means within 1e-6 and each frame bit-identical to the same frame on a
    one-process mesh of the card; (iii) phase 16d's 1x2 "mxu" train step
    with its shards in the two processes, its loss equal to phase 16d's.
    Each process's launches, device busy and wall are logged: they show
    the per-process cost of the layout on one card, not scaling across
    cards.  A worker that fails, exits non-zero or outlives MP_TIMEOUT
    fails the phase."""
    import os
    import shutil
    import subprocess
    import tempfile
    import numpy as np
    import torch
    from prismarine_core_tpu_torch.parallel.distributed import free_port
    from prismarine_core_tpu_torch.parallel.mesh import make_mesh
    cases = cases_module()
    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mp_"))
    try:
        torch.save({"target": img.cpu(), "samples_sum": [
            float(s.double().sum()) for s in samples]}, work / "inputs.pt")
        inputs = cases.make_inputs(0)
        np.savez(work / "cases.npz", **inputs)
        port = free_port()
        procs = []
        for rank in range(MP_PROCESSES):
            env = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       NUM_PROCESSES=str(MP_PROCESSES), PROCESS_ID=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--worker",
                 str(work)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=MP_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            logs.append("")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for rank, (p, text) in enumerate(zip(procs, logs)):
            for line in text.splitlines():
                if not line.startswith("WORKER "):
                    log(f"[multiprocess rank {rank}] {line}")
            require(p.returncode == 0, f"multiprocess: worker {rank} exit "
                    f"{p.returncode}")
        results = [json.loads(next(line[7:] for line in text.splitlines()
                                   if line.startswith("WORKER ")))
                   for text in logs]
        wall = time.perf_counter() - t_phase

        frames = [torch.load(work / f"frame_{r}.pt").to(dev)
                  for r in range(MP_PROCESSES)]
        for r, x in enumerate(frames):
            require(torch.equal(x, img_2x2), f"multiprocess: rank {r}'s 2x2 "
                    "frame differs from phase 16b's")
        out = {"ranks": results, "wall_s": wall, "per_rank": [
            dict(rank=r["rank"], frame_wall_ms=r["frame_2x2"]["wall_ms"],
                 frame_busy_ms=r["frame_2x2"]["profile"]["busy_ms"],
                 frame_idle_share=r["frame_2x2"]["profile"]["idle_share"],
                 frame_walk_ms=r["frame_2x2"]["profile"]["walk_ms"],
                 train_step_ms=r["train_1x2"]["step_ms"],
                 train_loss=r["train_1x2"]["loss"],
                 worker_wall_s=r["wall_s"]) for r in results]}
        for name, fn, mp in (("brute", cases.brute_frame, 1),
                             ("hall", cases.hall_frame, 2)):
            means = [res[f"mean_{name}"] for res in results]
            require(abs(means[0] - means[1]) < 1e-6 and means[0] > 1e-3,
                    f"multiprocess {name}: means {means}")
            ref = fn(make_mesh(4, mp, devices=[dev] * 4), inputs, dev).cpu()
            for r in range(MP_PROCESSES):
                require(torch.equal(torch.load(work / f"{name}_{r}.pt"), ref),
                        f"multiprocess {name}: rank {r} differs from the "
                        "one-process mesh")
            out[f"means_{name}"] = means
        for res in results:
            require(res["train_1x2"]["loss"] == loss_1x2,
                    f"multiprocess train: rank {res['rank']} loss "
                    f"{res['train_1x2']['loss']} vs phase 16d's {loss_1x2}")
            require(res["train_1x2"]["launches"]["sb_intersect_mxu"] > 0,
                    "multiprocess train: no sb_intersect_mxu")
        for res in results:
            f, t = res["frame_2x2"], res["train_1x2"]
            log(f"[multiprocess] rank {res['rank']}: frame 2x2 launches "
                f"{f['launches']}, {f['wall_ms']:.1f} ms, device busy "
                f"{f['profile']['busy_ms']:.3f} ms, idle share "
                f"{f['profile']['idle_share']:.4f}; train 1x2 loss "
                f"{t['loss']:.9g}, launches {t['launches']}, "
                f"{t['step_ms']:.1f} ms; worker wall {res['wall_s']:.1f} s")
        log(f"[multiprocess] {MP_PROCESSES} processes x {MP_POSITIONS} "
            f"positions on one card: the 2x2 frame bit-identical to phase "
            f"16b's; brute means {out['means_brute']}, hall means "
            f"{out['means_hall']}, each == the one-process mesh; train loss "
            f"== phase 16d's {loss_1x2:.9g}; phase 17b in {wall:.1f} s "
            "(per-process cost of the layout, not scaling across cards)")
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run_main(module, argv):
    """``module.main(argv)`` in this process, its stdout and stderr
    captured and then logged: (exit code, the text, seconds)."""
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = module.main(argv)
    secs = time.perf_counter() - t0
    name = module.__name__.rsplit(".", 1)[-1]
    for line in buf.getvalue().splitlines():
        log(f"[{name}] | {line}")
    log(f"[{name}] main({' '.join(argv)}) exit {rc} in {secs:.1f} s")
    return rc, buf.getvalue(), secs


def result_line(text: str, tag: str) -> dict:
    """The JSON of an example's ``[tag] result {...}`` line."""
    head = f"[{tag}] result "
    lines = [x for x in text.splitlines() if x.startswith(head)]
    require(len(lines) == 1, f"{tag}: {len(lines)} result lines")
    return json.loads(lines[0][len(head):])


def phase_inverse(dev):
    """Phase 19a: examples/inverse_rendering at its defaults (cornell,
    48x48, 2 spp, 2 bounces, "bvh", Adam 5e-2, INVERSE_STEPS steps): its
    main exits 0 (albedo L1 < 0.15) with its PNG strip written into a
    temporary directory; the same loop again through ``recover_albedo``
    with the launch counters read around it (the walk and the surface on
    every step, no other kernel), a host clock around each step ended by one synchronize
    (ms/step: the mean of steps 2-INVERSE_STEPS), the error by material
    and channel at INVERSE_TABLE_STEPS, peak memory and one profiled step;
    and one loss and gradient on the kernels' plain versions against the
    kernels' (INVERSE_PLAIN_BOUND).  The sample draw is saved as
    INVERSE_SAMPLES."""
    import tempfile
    import numpy as np
    import torch
    from prismarine_core_tpu_torch.examples import inverse_rendering as inv
    from prismarine_core_tpu_torch.render.integrator import (
        render_with_samples)
    res = 48
    with tempfile.TemporaryDirectory() as tmp:
        png = Path(tmp) / "inverse_result.png"
        rc, text, secs = run_main(inv, ["--out", str(png)])
        require(rc == 0, f"inverse_rendering exit {rc}")
        require(png_size(png) == (2 * res, res), f"inverse strip "
                f"{png_size(png)}")

    scene, cam, cfg = inv.setup(res, dev)
    cam_s, bounce_s = inv.sample_arrays(cfg, dev)
    with torch.no_grad():
        target = render_with_samples(scene, cam, cfg, cam_s, bounce_s)
    true = scene.materials.diffuse
    init = inv.gray_table(true)
    INVERSE_SAMPLES.parent.mkdir(exist_ok=True)
    np.savez(INVERSE_SAMPLES, cam=cam_s.cpu().numpy(),
             bounce=bounce_s.cpu().numpy())
    torch.cuda.synchronize()

    stamps, tables = [], {}

    def stamp(i, loss, diffuse):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if i in INVERSE_TABLE_STEPS:
            tables[i] = (diffuse.detach()[:, :3] - true[:, :3]).cpu()

    torch.cuda.reset_peak_memory_stats(dev)
    read = zero_launches()
    stamps.append(time.perf_counter())
    losses, final = inv.recover_albedo(scene, cam, cfg, cam_s, bounce_s,
                                       init, INVERSE_STEPS, target=target,
                                       on_step=stamp)
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    steps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    ms = sum(steps_ms[1:]) / len(steps_ms[1:])
    losses = losses.cpu().tolist()
    l1 = inv.albedo_l1(final, true)
    per_step = launches["bvh_walk"] / INVERSE_STEPS
    log(f"[inverse] {INVERSE_STEPS} steps: loss {losses[0]:.6f} -> "
        f"{losses[-1]:.6f}, albedo L1 {l1:.4f}; launches {launches} "
        f"({per_step:g} walks a step); {ms:.3f} ms/step over steps 2-"
        f"{INVERSE_STEPS} (step 1 {steps_ms[0]:.1f} ms); peak memory "
        f"{peak / 2**20:.1f} MiB")
    for i, err in tables.items():
        log(f"[inverse] step {i} error by material (r g b): " + "; ".join(
            f"m{m} " + " ".join(f"{v:+.4f}" for v in row)
            for m, row in enumerate(err.tolist())))
    require(all(math.isfinite(x) for x in losses), "inverse: losses")
    require(l1 < inv.L1_PASS and losses[-1] < losses[0],
            f"inverse: albedo L1 {l1}, losses {losses[0]} -> {losses[-1]}")
    require(launches["bvh_walk"] > 0 and per_step == int(per_step)
            and launches["surface"] == cfg.max_bounces * INVERSE_STEPS
            and all(n == 0 for k, n in launches.items()
                    if k not in ("bvh_walk", "surface")),
            f"inverse launches {launches}")

    def loss_grad():
        d = init.clone().requires_grad_(True)
        img = render_with_samples(inv.with_diffuse(scene, d), cam, cfg,
                                  cam_s, bounce_s)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        return loss.detach(), d.grad
    loss_k, grad_k = loss_grad()
    with plain_versions():
        loss_p, grad_p = loss_grad()
    rel = float((grad_k - grad_p).norm() / grad_p.norm())
    loss_rel = float((loss_k - loss_p).abs() / loss_p.abs())
    small = int((grad_k.abs() < 1e-6).sum())
    same = bool(torch.equal(loss_k, loss_p) and torch.equal(grad_k, grad_p))
    log(f"[inverse] plain versions: loss {float(loss_p):.9f} vs "
        f"{float(loss_k):.9f} (rel {loss_rel:.2e}), gradient rel L2 "
        f"{rel:.2e}, bit-identical {same}; {small} of {grad_k.numel()} "
        f"components |g| < 1e-6")
    require(rel <= INVERSE_PLAIN_BOUND and loss_rel <= INVERSE_PLAIN_BOUND,
            f"inverse: plain versions' gradient rel {rel}, loss rel "
            f"{loss_rel}")

    prof = profile_once(lambda: inv.recover_albedo(
        scene, cam, cfg, cam_s, bounce_s, init, 1, target=target),
        "inverse step")
    return dict(exit=rc, main_s=secs, first_loss=losses[0],
                last_loss=losses[-1], albedo_l1=l1, ms_per_step=ms,
                step1_ms=steps_ms[0], walks_per_step=per_step,
                peak_mem_bytes=peak, plain_grad_rel_l2=rel,
                plain_loss_rel=loss_rel, plain_bit_identical=same,
                small_grad_components=small, profile=prof,
                error_tables={i: t.tolist() for i, t in tables.items()},
                launches=launches)


def study_frame_gate(fn, tag, bounds):
    """One study frame ``fn()`` with every launch counter read around it
    (each kernel within ``bounds`` = {kernel: (least, most)}, every other
    kernel 0), finite, then the same frame on the kernels' plain versions,
    bit for bit (the image gate's numbers logged beside), and one profiled
    frame."""
    import torch
    read = zero_launches()
    img = fn()
    torch.cuda.synchronize()
    launches = read()
    log(f"[{tag}] launches {launches}, mean {float(img.mean()):.6f}")
    for k, n in launches.items():
        lo, hi = bounds.get(k, (1, math.inf) if k == "surface" else (0, 0))
        require(lo <= n <= hi, f"{tag} {k}: {n} launches")
    require(bool(torch.isfinite(img).all()), f"{tag}: non-finite image")
    t0 = time.perf_counter()
    with plain_versions():
        ref = fn()
    torch.cuda.synchronize()
    log(f"[{tag}] plain-version frame in {time.perf_counter() - t0:.1f} s")
    gate = image_gate(img, ref, tag)
    require(torch.equal(img, ref), f"{tag}: frame != its plain-version "
            "frame")
    return dict(launches=launches, gate=gate, profile=profile_once(fn, tag))


def study_gates(result, tag, seed_ranges):
    """The study's gates: n_ref >= REF_FACTOR x the larger frame count,
    every MSE finite and > 0, every measured seed outside the reference's
    range."""
    from prismarine_core_tpu_torch.examples import quality as q
    n_ref = result["n_ref"]
    most = max(m["frames"] for m in result["modes"].values())
    require(n_ref >= q.REF_FACTOR * most, f"{tag}: n_ref {n_ref} < "
            f"{q.REF_FACTOR} x {most} frames")
    ref_seeds = (q.frame_seed(q.REFERENCE, 0),
                 q.frame_seed(q.REFERENCE, n_ref - 1))
    for mode, m in result["modes"].items():
        require(math.isfinite(m["mse"]) and m["mse"] > 0,
                f"{tag} {mode}: MSE {m['mse']}")
        lo = q.frame_seed(seed_ranges[mode], 0)
        hi = q.frame_seed(seed_ranges[mode], m["frames"] - 1)
        require(hi < ref_seeds[0] or lo > ref_seeds[1],
                f"{tag} {mode}: seeds [{lo}, {hi}] meet the reference's "
                f"{ref_seeds}")
        log(f"[{tag}] {mode}: {m['frames']} frames, {m['ms_per_frame']:.3f}"
            f" ms/frame, MSE {m['mse']:.4e}, reference term "
            f"{result['reference']['var_of_mean']:.4e} (n_ref {n_ref}, "
            f"{result['ref_factor']:.1f} x)")
    log(f"[{tag}] ratio {'/'.join(result['ratio_modes'])} "
        f"{result['ratio']:.4f} -> {result['winner']}")


def phase_studies(dev):
    """Phases 19b and 19c: examples/r6_rr_quality (modes "rr-off", "rr-2")
    and examples/coherent_quality_ab at each of STUDY_BLOCKS ("coherent",
    "independent") at the JAX scripts' configurations: first one frame of
    each mode through study_frame_gate (the RR modes and their packet
    query as phase 4's frame; the coherent study's cull "pallas" with
    any-hit "rounds": block_cull 1..3 a bounce, sb_intersect 1..2 + the
    rounds a bounce, no pair_cull under stale masks), then each main with
    budget STUDY_BUDGET_S (the reference REF_FACTOR x the larger frame
    count) through study_gates."""
    from prismarine_core_tpu_torch.accel import packet as pk
    from prismarine_core_tpu_torch.examples import (
        coherent_quality_ab as qab, quality as q, r6_rr_quality as rrq)
    scene, cam = q.study_scene(device=dev)
    out, frames = {}, {}

    for mode, c in rrq.configs().items():
        frames[f"rr_quality_{mode}"] = study_frame_gate(
            lambda c=c: rrq.frame(scene, cam, c, 1), f"rrq {mode}",
            {k: (1, MAX_LAUNCHES) for k in MT_PATH})
    rc, text, secs = run_main(rrq, [str(STUDY_BUDGET_S), "0"])
    require(rc == 0, f"r6_rr_quality exit {rc}")
    out["rr"] = result_line(text, rrq.TAG)
    out["rr"]["seconds"] = secs
    study_gates(out["rr"], "rrq", rrq.SEED_RANGES)

    rounds = -(-scene.packets.n_superblocks // pk.K_FIRST)
    bounds = {"block_cull": (1, 3 * BOUNCES),
              "sb_intersect": (1, (2 + rounds) * BOUNCES)}
    cfg = qab.config()
    for blk in STUDY_BLOCKS:
        for mode in qab.MODES:
            if mode == "independent" and blk != STUDY_BLOCKS[0]:
                continue            # the same frame at every block
            key = (f"coherent_quality_{mode}" if mode == "independent"
                   else f"coherent_quality_{mode}_b{blk}")
            frames[key] = study_frame_gate(
                lambda mode=mode, blk=blk: qab.frame(scene, cam, cfg, mode,
                                                     1, blk),
                f"qab {mode} b{blk}", bounds)
        rc, text, secs = run_main(
            qab, [str(STUDY_BUDGET_S), "0", str(blk)])
        require(rc == 0, f"coherent_quality_ab exit {rc}")
        out[f"coherent_b{blk}"] = result_line(text, qab.TAG)
        out[f"coherent_b{blk}"]["seconds"] = secs
        study_gates(out[f"coherent_b{blk}"], f"qab b{blk}", qab.SEED_RANGES)
    return out, frames


def phase_refit(dev):
    """Phase 19d: examples/r5_refit_bench at REFIT_TRIS target triangles
    (its three ms lines under each topology, no kernel launched), and
    ``refit_bvh``'s boxes equal to ``build_bvh``'s on the unchanged soup
    under each topology."""
    import torch
    from prismarine_core_tpu_torch.accel.lbvh import build_bvh, refit_bvh
    from prismarine_core_tpu_torch.examples import r5_refit_bench as rb
    from prismarine_core_tpu_torch.models.procedural import make_hall_scene
    read = zero_launches()
    rc, text, secs = run_main(rb, [str(REFIT_TRIS)])
    launches = read()
    require(rc == 0, f"r5_refit_bench exit {rc}")
    res = result_line(text, "refit")
    require(all(n == 0 for n in launches.values()),
            f"refit bench launches {launches}")
    soup = make_hall_scene(target_tris=REFIT_TRIS, build_bvh=False,
                           device=dev).triangles
    for topology in rb.TOPOLOGIES:
        times = res[topology]
        require(all(math.isfinite(v) and v > 0 for v in times.values()),
                f"refit {topology}: {times}")
        bvh = build_bvh(soup, leaf_size=rb.LEAF_SIZE, topology=topology)
        refit = refit_bvh(bvh, soup)
        same = bool(torch.equal(refit.lo, bvh.lo)
                    and torch.equal(refit.hi, bvh.hi))
        log(f"[refit] {topology}: build {times['build_bvh_ms']:.3f} ms, "
            f"refit {times['refit_bvh_ms']:.3f}, packet set "
            f"{times['build_packet_set_ms']:.3f}; refit boxes == build "
            f"boxes {same}")
        require(same, f"refit {topology}: boxes differ from the build's")
        res[topology]["refit_boxes_equal"] = same
    res.update(seconds=secs, launches=launches)
    return res


def phase_examples(dev):
    """Phase 19: the example programs (phase_inverse, phase_studies,
    phase_refit)."""
    t0 = time.perf_counter()
    inverse = phase_inverse(dev)
    studies, frames = phase_studies(dev)
    refit = phase_refit(dev)
    secs = time.perf_counter() - t0
    log(f"[examples] phase 19 in {secs:.1f} s")
    return dict(inverse=inverse, studies=studies, study_frames=frames,
                refit=refit, seconds=secs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script "
            "runs only on an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(REPO))
    from prismarine_core_tpu_torch import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    ptxas = lib_path.with_name(lib_path.stem + ".ptxas.txt")
    if ptxas.exists():
        for line in ptxas_lines(ptxas.read_text()):
            log(f"[build] {line}")

    t0 = time.perf_counter()
    scene, cam, cfg = bench_setup(dev)
    torch.cuda.synchronize()
    log(f"[scene] {int(scene.triangles.num_valid())} tris, "
        f"{scene.bvh.n_nodes} nodes, {scene.packets.n_superblocks} "
        f"superblocks, built in {time.perf_counter() - t0:.1f} s")

    ktimes, step_errs = phase_kernels(scene, cam, cfg, dev)
    img, frame, samples = phase_frame(scene, cam, cfg, dev)
    phase_parity(scene, cam, cfg, img, samples)
    frame2 = phase_frame_mt2(scene, cam, cfg, img, samples)
    train = phase_train(scene, cam, cfg, dev, img, samples)
    textured = phase_textured(scene, cam, cfg, dev)
    env = phase_env_nee(scene, cam, cfg, dev)
    walk = phase_walk(scene, cam, cfg, dev)
    _, frame_bvh = phase_frame_bvh(scene, cam, cfg, dev, img)
    rr_pallas, rr_bvh = phase_rr(scene, cam, cfg, dev, frame["stats"],
                                 frame_bvh["stats"])
    features = phase_features(scene, cam, cfg, dev, img, samples)
    edge = phase_edge(scene, cam, cfg, dev)
    app = phase_application(scene, cam, cfg, dev)
    mesh, img_2x2 = phase_mesh(scene, cam, cfg, dev, img, samples)
    default_cull = phase_default_cull(scene, cam, cfg, dev, img)
    multiprocess = phase_multiprocess(dev, img_2x2,
                                      mesh["train_1x2"]["loss"], img, samples)
    knobs = phase_knobs(scene, cam, cfg, dev, img, frame)
    examples = phase_examples(dev)
    surface = phase_surface(scene, cam, cfg, dev)
    shading = phase_shade(scene, cam, cfg, dev)
    texturing = phase_texture(dev)
    step_errs = {k: max(v, textured["step_errs"].get(k, 0.0),
                        env["step_errs"].get(k, 0.0),
                        app["rounds"]["max_abs_err"].get(k, 0.0),
                        default_cull["max_abs_err"].get(k, 0.0),
                        knobs["max_abs_err"].get(k, 0.0),
                        *(mesh[f"query_1x{mp}"]["max_abs_err"].get(k, 0.0)
                          for mp in QUERY_MESHES))
                 for k, v in step_errs.items()}
    for mp in QUERY_MESHES:
        for k, v in mesh[f"query_1x{mp}"]["max_abs_err"].items():
            step_errs[k] = max(step_errs.get(k, 0.0), v)

    # each kernel's launches on its path: the frame's for the "mt" path
    # kernels, the "mt2" frame's and one train step's for the other forms,
    # the "bvh" frame's for the walk
    launches = dict(frame["launches"])
    launches["sb_intersect_mt2"] = frame2["launches"]["sb_intersect_mt2"]
    launches["sb_intersect_mxu"] = train["launches"]["sb_intersect_mxu"]
    launches["bvh_walk"] = frame_bvh["launches"]["bvh_walk"]
    paths = {"frame_mt": frame, "frame_mt2": frame2, "train_step_mxu": train,
             "frame_textured": textured, "frame_env_nee": env,
             "frame_bvh": frame_bvh, "frame_rr_pallas": rr_pallas,
             "frame_rr_bvh": rr_bvh, "edge_bvh": edge,
             "edge_pallas": edge["pallas"], "frame_cli": app["frame_cli"],
             "pipeline_8_frames": app["frame_cli"]["pipeline"],
             "frame_teapot": app["frame_teapot"],
             "frame_teapot_obj": app["frame_teapot_obj"],
             "frame_independent": app["frame_independent"],
             **{f"query_sharded_1x{mp}": mesh[f"query_1x{mp}"]
                for mp in QUERY_MESHES},
             "frame_sharded_2x2": mesh["frame_2x2"],
             "frame_textured_sharded_2x4": mesh["frame_textured_2x4"],
             "train_step_sharded_1x2": mesh["train_1x2"],
             "frame_default_cull": default_cull["frame"],
             "frame_pallas_defaults": default_cull["frame_pallas_defaults"],
             **{k: knobs[k] for k in KNOB_FRAMES},
             **{f"multiprocess_{part}_rank{res['rank']}": res[part]
                for res in multiprocess["ranks"]
                for part in ("frame_2x2", "train_1x2")},
             "inverse_rendering": examples["inverse"],
             **examples["study_frames"],
             "refit_bench": examples["refit"]}
    replaces = {
        "block_cull": ("prismarine_core_tpu_torch/csrc/cull.cu",
                       "prismarine_core_tpu/ops/pallas_cull.py:51"),
        "pair_cull": ("prismarine_core_tpu_torch/csrc/cull.cu",
                      "prismarine_core_tpu/ops/pallas_cull.py:200"),
        "sb_intersect": ("prismarine_core_tpu_torch/csrc/sb_intersect.cu",
                         "prismarine_core_tpu/ops/pallas_intersect.py:85"),
        "sb_intersect_mt2": ("prismarine_core_tpu_torch/csrc/sb_intersect.cu",
                             "prismarine_core_tpu/ops/pallas_intersect.py:201"),
        "sb_intersect_mxu": (
            "prismarine_core_tpu_torch/csrc/sb_intersect_mxu.cu",
            "prismarine_core_tpu/ops/pallas_intersect.py:397"),
    }
    by_path = {k: {p: r["launches"][k] for p, r in paths.items()}
               for k in KERNELS}
    rows = [
        {"name": k, "route": "cuda", "source": replaces[k][0],
         "replaces": replaces[k][1], "launches": launches[k],
         "launches_by_path": by_path[k],
         "max_abs_err": max([ktimes[s][k][2] for s in ktimes]
                            + [step_errs.get(k, 0.0)]),
         "ms": ktimes["bounce1"][k][0], "plain_ms": ktimes["bounce1"][k][1],
         "bound_ms": ktimes["bounce1"][k][3],
         "bound_by": ktimes["bounce1"][k][4], "library_ms": None,
         "shape": "bounce-1 rays, round 1 of the closest query"}
        for k in KERNELS if k not in ("bvh_walk", "surface")]
    # the default cull's block-granular dense cull beside the 256-box one
    bc = default_cull["block_cull"]
    rows[0].update({
        "ms_2048_boxes": bc["2048"]["ms"],
        "plain_ms_2048_boxes": bc["2048"]["plain_ms"],
        "bound_ms_2048_boxes": bc["2048"]["bound_ms"],
        "bound_by_2048_boxes": bc["2048"]["bound_by"],
        "dense_bound_ms_2048_boxes": bc["2048"]["dense_bound_ms"],
        "ms_256_boxes_same_query": bc["256"]["ms"],
        "bound_ms_256_boxes_same_query": bc["256"]["bound_ms"],
        "shape_2048_boxes": "bounce-1 rays, round 1 of the closest query "
                            "under cull_impl='pallas' (the 2,048 block "
                            "boxes); 256: its round-2 superblock recull"})
    # the port's own kernel (the JAX package walks the BVH in XLA): the
    # closest walk unsorted at bounce-1 rays at every cap INF_DIST, with
    # the same rays as the bounce step caps them, the sorted and the
    # shadow walks beside it
    rows.append(
        {"name": "bvh_walk", "route": "cuda",
         "source": "prismarine_core_tpu_torch/csrc/bvh_walk.cu",
         "replaces": None, "launches": launches["bvh_walk"],
         "launches_by_path": by_path["bvh_walk"],
         "max_abs_err": max(walk[q]["max_abs_err"] for q in
                            ("closest", "closest_capped", "shadow")),
         "ms": walk["ms"]["closest"], "plain_ms": walk["closest"]["plain_ms"],
         "bound_ms": walk["closest"]["bound_ms"],
         "bound_by": walk["closest"]["bound_by"], "library_ms": None,
         "dead_share": walk["dead_share_closest"],
         "ms_capped": walk["ms"]["closest_capped"],
         "plain_ms_capped": walk["closest_capped"]["plain_ms"],
         "bound_ms_capped": walk["closest_capped"]["bound_ms"],
         "ms_sorted": walk["ms"]["closest_sorted"],
         "sort_ms": walk["ms"]["sort"], "ms_shadow": walk["ms"]["shadow"],
         "bound_ms_shadow": walk["shadow"]["bound_ms"],
         "bound_by_shadow": walk["shadow"]["bound_by"],
         "plain_ms_shadow": walk["shadow"]["plain_ms"],
         "rates": walk["rates"], "build": walk["build"],
         "pack_ms": walk["pack_ms"],
         "shape": "bounce-1 rays of the bench frame, the closest query "
                  "at every cap INF_DIST (sort_rays=False), as through "
                  "the first form; _capped: the same rays as the bounce "
                  "step gives them (dead lanes capped at 0); sorted: "
                  "every cap INF_DIST, coherence-sorted"})
    # the port's own surface kernel (the JAX package leaves the surface to
    # XLA): the bounce-1 hits of the 4-spp frame under "bvh"
    rows.append(
        {"name": "surface_fields", "route": "cuda",
         "source": "prismarine_core_tpu_torch/csrc/surface.cu",
         "replaces": None, "launches": launches["surface"],
         "launches_by_path": by_path["surface"],
         "launches_4spp_frame": surface["launches_frame"],
         "max_abs_err": 0.0, "ms": surface["ms"],
         "plain_ms": surface["plain_ms"], "bound_ms": surface["bound_ms"],
         "bound_by": surface["bound_by"], "library_ms": None,
         "bound_share": surface["bound_share"], "build": surface["build"],
         "pack_ms": surface["pack_ms"],
         "shape": "bounce-1 hits of the bench frame at 4 spp under "
                  "\"bvh\" (3,686,400 lanes), texture-less"})
    # the port's own shading kernels (the JAX package shades in XLA): the
    # bounce-1 step of the 4-spp frame under "bvh"
    for kname, key in (("shade", ""), ("nee_resolve", "resolve_")):
        rows.append(
            {"name": kname, "route": "cuda",
             "source": "prismarine_core_tpu_torch/csrc/shade.cu",
             "replaces": None,
             "launches_4spp_frame": shading[f"{key}launches_frame"],
             "max_abs_err": 0.0, "ms": shading[f"{key}ms"],
             "plain_ms": shading[f"{key}plain_ms"],
             "bound_ms": shading[f"{key}bound_ms"],
             "bound_by": shading[f"{key}bound_by"], "library_ms": None,
             "bound_share": shading[f"{key}bound_share"],
             "build": [b for b in shading["build"]
                       if b.startswith(kname + "_kernel")],
             "shape": "the bounce-1 step of the bench frame at 4 spp "
                      "under \"bvh\" (3,686,400 lanes), sphere NEE"})
    # the port's own texture kernel (the JAX package fetches in XLA): the
    # bounce-1 hits of the benchmark's textured cell
    rows.append(
        {"name": "texture_fields", "route": "cuda",
         "source": "prismarine_core_tpu_torch/csrc/texture.cu",
         "replaces": None,
         "launches_4spp_frame": texturing["launches_frame"],
         "max_abs_err": 0.0,
         **{k: texturing[k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "bound_share",
             "distinct_rows", "distinct_bound_ms", "distinct_bound_share",
             "fetches", "build")},
         "library_ms": None,
         "shape": "bounce-1 hits of hall720-bvh-textured.frames "
                  "(3,686,400 lanes; diffuse, specular, bump)"})
    table = {"kernels": rows,
        "frame": {k: v for k, v in frame.items() if k != "launches"},
        "frame_mt2": {k: v for k, v in frame2.items() if k != "launches"},
        "train": {k: v for k, v in train.items() if k != "launches"},
        "frame_textured": {k: v for k, v in textured.items()
                           if k not in ("launches", "step_errs")},
        "frame_env_nee": {k: v for k, v in env.items()
                          if k not in ("launches", "step_errs")},
        "walk": {k: v for k, v in walk.items() if k != "turns_ms"},
        "frame_bvh": {k: v for k, v in frame_bvh.items() if k != "launches"},
        "frame_rr_pallas": {k: v for k, v in rr_pallas.items()
                            if k != "launches"},
        "frame_rr_bvh": {k: v for k, v in rr_bvh.items() if k != "launches"},
        "features": features,
        "edge": {k: v for k, v in edge.items() if k != "launches"},
        "application": {
            "rounds": {k: v for k, v in app["rounds"].items()
                       if k != "turns_ms"},
            "cli": {k: v for k, v in app["cli"].items() if k != "stderr"},
            **{k: {f: x for f, x in app[k].items() if f != "launches"}
               for k in ("frame_cli", "frame_teapot", "frame_teapot_obj",
                         "frame_independent")}},
        "mesh": {
            **{k: {f: x for f, x in v.items() if f != "launches"}
               for k, v in mesh.items() if k != "frame_2x2"},
            "frame_2x2": {k: v for k, v in mesh["frame_2x2"].items()
                          if k != "launches"}},
        "default_cull": {k: v for k, v in default_cull.items()
                         if k not in ("frame", "frame_pallas_defaults")},
        "frame_default_cull": {k: v for k, v in default_cull["frame"].items()
                               if k != "launches"},
        "multiprocess": {k: v for k, v in multiprocess.items()
                         if k != "ranks"},
        "knobs": {k: ({f: x for f, x in v.items() if f != "launches"}
                      if k in KNOB_FRAMES else v) for k, v in knobs.items()},
        "examples": {
            "inverse": {k: v for k, v in examples["inverse"].items()
                        if k != "launches"},
            "studies": examples["studies"],
            "study_frames": {k: {f: x for f, x in v.items()
                                 if f != "launches"}
                             for k, v in examples["study_frames"].items()},
            "refit": {k: v for k, v in examples["refit"].items()
                      if k != "launches"},
            "seconds": examples["seconds"]},
        "card": smi}
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} "
        "s")
    log(json.dumps(table))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker_main(Path(sys.argv[2])))
    sys.exit(main())
