"""The inverse-rendering step of ``parallel/mesh.py:make_train_step``
chained: each step's parameters are the last one's output, with fresh
samples each step.  ``step_ms`` is the window over the steps completed in
it.  The first steps run in set-up through the window's own call and are
the ones the plain reference follows."""

from __future__ import annotations

import torch

from bench_port import compare, sampling
from bench_port.reference import tracer


def make_target(render: dict, seed: int, dev):
    """The step's target, standing for a photograph: a smooth image drawn
    from the seed (a 9 x 16 grid of colours in [0, 0.7), upsampled)."""
    gen = sampling.generator(dev, seed, sampling.TARGET, 0)
    grid = torch.rand((1, 3, 9, 16), generator=gen, device=dev) * 0.7
    img = torch.nn.functional.interpolate(
        grid, size=(render["height"], render["width"]), mode="bilinear",
        align_corners=False)
    return img[0].permute(1, 2, 0).contiguous()


def _copy(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


class Job:
    def __init__(self, cell, prog, seed: int):
        from prismarine_core_tpu_torch.parallel import mesh
        self.cell, self.prog, self.seed = cell, prog, seed
        self.render = cell.config["render"]
        self.train = cell.config["train"]
        self.target = make_target(self.render, seed, prog.device)
        params = mesh.init_params(prog.scene)
        diffuse = params["mat_diffuse"].clone()
        diffuse[:, :3] = diffuse[:, :3] * self.train["diffuse_scale"]
        params["mat_diffuse"] = diffuse
        self.params = params
        self.p0 = _copy(params)
        self.step = mesh.make_train_step(
            None, prog.cfg, lr=self.train["lr"],
            normalize_grads=self.train["normalize_grads"],
            lr_scale=self.train["lr_scale"])
        self.losses, self.p1, self.pn = [], None, None

    def samples(self, stream: int, i: int, dev=None):
        dev = dev or self.prog.device
        gen = sampling.generator(dev, self.seed, stream, i)
        return sampling.frame_samples(self.cell.workload["sampling"],
                                      self.render, gen, dev, self.cell.base)

    def run_step(self, stream: int, i: int):
        p = self.prog
        cam_s, bounce_s = self.samples(stream, i)
        self.params, loss = self.step(self.params, p.scene, p.camera, cam_s,
                                      bounce_s, self.target)
        return loss

    def warmup(self):
        """The first steps (the workload's checked ones), through the
        window's own call."""
        for k in range(self.cell.workload["check"]["steps"]):
            self.losses.append(float(self.run_step(sampling.FIRST_STEPS, k)))
            if k == 0:
                self.p1 = _copy(self.params)
        self.pn = _copy(self.params)

    def unit(self, i: int):
        self.run_step(sampling.WINDOW, i)

    def e2e(self, times, window_s) -> dict:
        return {"step_ms": 1e3 * window_s / len(times)}

    def failed(self, n: int) -> int:
        return int(not all(bool(torch.isfinite(v).all())
                           for v in self.params.values()))

    def free(self):
        self.p0 = {k: v.cpu() for k, v in self.p0.items()}
        self.p1 = {k: v.cpu() for k, v in self.p1.items()}
        self.pn = {k: v.cpu() for k, v in self.pn.items()}
        self.target = self.target.cpu()
        self.prog = self.step = self.params = None

    def reference(self, arrays: dict, dev, dtype) -> dict:
        """The reference's first steps from the same start, samples and
        target: losses, the parameters before them, after the first and
        after the last, the first step's raw gradients."""
        ref_scene = tracer.build_scene(arrays, dev, dtype)
        index = tracer.scene_index(ref_scene)
        params = tracer.initial_params(ref_scene,
                                       self.train["diffuse_scale"])
        out = {"p0": _copy(params), "losses": []}
        for k in range(self.cell.workload["check"]["steps"]):
            cam_s, bounce_s = self.samples(sampling.FIRST_STEPS, k, dev)
            params, loss, grads = tracer.train_step(
                ref_scene, index, self.cell.config["camera"], self.render,
                self.train, params, cam_s, bounce_s, self.target.to(dev))
            out["losses"].append(float(loss))
            if k == 0:
                out["grads1"] = grads
                out["p1"] = _copy(params)
            del grads
        out["pn"] = params
        return out

    def check(self, n: int, arrays: dict, dev) -> dict:
        prog = {"losses": self.losses, "p0": self.p0, "p1": self.p1,
                "pn": self.pn}
        return compare.train_numbers(
            prog, self.reference(arrays, dev, torch.float32), self.train)

    def control(self, n: int, arrays: dict, dev) -> dict:
        """The check with the reference in bfloat16 in the program's
        place."""
        low = self.reference(arrays, dev, torch.bfloat16)
        low = {"losses": low["losses"],
               **{k: {p: v.float() for p, v in low[k].items()}
                  for k in ("p0", "p1", "pn")}}
        return compare.train_numbers(
            low, self.reference(arrays, dev, torch.float32), self.train)
