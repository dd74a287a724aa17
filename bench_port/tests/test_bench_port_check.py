"""The check on the CPU at a small size: the reference agrees with the
port's plain path (a frame of each intersector, the train step), the
control (the reference in bfloat16 in the program's place) fails, and a
run driven with the timed path broken underneath comes out not correct."""

import contextlib
import time

import pytest
import torch

from bench_port import faults, harness

CPU = torch.device("cpu")
#: the cells' configurations at a size a CPU test can hold (their spp,
#: bounces and RenderConfig as they are)
SIZE = {"width": 32, "height": 18, "target_tris": 3000, "sky_resolution": 16}
SEED = 2 ** 31 + 101
FRAME_CELLS = ["hall720-bvh.frames", "hall720-pallas.frames"]


def small_cell(name):
    """A workload of ``workloads/`` at a small size, listed in
    ``BENCHMARK.json`` or not (the train job's is not yet)."""
    workload = harness.load_json(harness.HERE / "workloads" / f"{name}.json")
    config = harness.load_json(
        harness.HERE / "configs" / f"{workload['config']}.json")
    config["render"].update(width=SIZE["width"], height=SIZE["height"])
    config["scene"].update(target_tris=SIZE["target_tris"],
                           sky_resolution=SIZE["sky_resolution"])
    return harness.Cell(name, dict(workload, chips=1), config, [], [])


def readings(cell_name, kind, seconds=0.3):
    """(check numbers, limits) of a short run of ``kind``: "program",
    "control" or a fault of ``faults.py``."""
    cell = small_cell(cell_name)
    arrays = harness.scene_arrays(cell)
    prog = harness.build_program(cell, arrays, CPU)
    ctx = (contextlib.nullcontext() if kind in ("program", "control")
           else faults.fault(cell.workload["job"], kind))
    with ctx:
        job = harness.job_module(cell).Job(cell, prog, SEED)
        job.warmup()
        times, _ = harness.timed_window(job, CPU, seconds)
    n = len(times)
    numbers = (job.control(n, arrays, CPU) if kind == "control"
               else job.check(n, arrays, CPU))
    return numbers, cell.workload["check"]["limits"]


def passes(numbers, limits):
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("cell", FRAME_CELLS + ["hall720-bvh.train"])
def test_reference_agrees_with_port(cell):
    numbers, limits = readings(cell, "program")
    assert set(numbers) == set(limits)
    assert passes(numbers, limits), numbers


@pytest.mark.parametrize("cell", ["hall720-bvh.frames", "hall720-bvh.train"])
def test_control_fails(cell):
    numbers, limits = readings(cell, "control")
    assert not passes(numbers, limits), numbers


@pytest.mark.parametrize("kind", faults.FRAME_FAULTS)
def test_frame_fault_fails(kind):
    numbers, limits = readings("hall720-bvh.frames", kind)
    assert not passes(numbers, limits), numbers


@pytest.mark.parametrize("kind", faults.TRAIN_FAULTS)
def test_train_fault_fails(kind):
    numbers, limits = readings("hall720-bvh.train", kind)
    assert not passes(numbers, limits), numbers


def test_run_with_broken_path_is_not_correct():
    """A whole run past the look for a chip, the image altered where it is
    produced: ``correct`` false, each number beside its limit."""
    cell = small_cell("hall720-bvh.frames")
    with faults.fault("frames", "altered"):
        result = harness.measure(cell, CPU, SEED, 0.3, False,
                                 time.perf_counter())
    assert result["correct"] is False
    assert list(result)[-1] == "check"
    assert harness.check_lines(result)[0].startswith("check mismatch_share ")
