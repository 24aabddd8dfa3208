"""Cell driver: the NeRF-Actor joint train step, `NerfActTrainer.train_step`
of the port, closed loop, one batch of keyframe samples a step from the
traffic's staged pool.

Set-up builds one training state from the benchmark's weights and drives it
through the traffic's checked steps with the window's own feed; their
losses, the first gradient as the optimizer holds it after step one, and
each leaf's change over the checked steps are what `check` holds against
the reference. The same state then trains on in the window."""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch

from h100_bench.core import counts, traffic
from h100_bench.core.gaps import leaf_norm_gap, moving_leaves, relative_gap
from h100_bench.core.window import phase
from h100_bench.reference import nerfact_train as ref

# the plain module's name of a leaf the program holds in its kernel layout
KERNEL_LAYOUT = {"policy.final.pallas_kernel": ("policy.final.Conv_0.weight", (2, 3, 4, 1, 0)),
                 "policy.final.pallas_bias": ("policy.final.Conv_0.bias", None)}


def program_state_dict(sd: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    """The plain layout's state dict in the program's: the k3 kernel's
    (3, 3, 3, Cin, Cout) weight where the program's conv holds one."""
    out = dict(sd)
    for name in names:
        if name in KERNEL_LAYOUT:
            src, perm = KERNEL_LAYOUT[name]
            w = out.pop(src)
            out[name] = w.permute(*perm).contiguous() if perm else w
    return out


def plain_name(name: str) -> str:
    return KERNEL_LAYOUT.get(name, (name,))[0]


class Cell:
    def __init__(self, spec: dict, seed: int, device):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.program = self.config["program"]
        self.seed, self.device = seed, torch.device(device)
        self.i = 0

    # ------------------------------------------------------------- set-up
    def setup(self) -> None:
        from real_robot_nerf_actor_tpu_torch.models.nerf_field import VoxelNerfField
        from real_robot_nerf_actor_tpu_torch.models.perceiver import PerceiverIO
        from real_robot_nerf_actor_tpu_torch.train.nerfact import NerfActConfig, NerfActTrainer
        from real_robot_nerf_actor_tpu_torch.train.trainer import Optimizer, TrainState
        from real_robot_nerf_actor_tpu_torch.utils.config import from_dict

        for path, value in self.config.get("module_settings", {}).items():
            mod, attr = path.rsplit(".", 1)
            setattr(importlib.import_module(mod), attr, value)
        t, p, dev = self.traffic, self.program, self.device
        cfg = from_dict(NerfActConfig, p)
        self.tr = NerfActTrainer(cfg, device=dev)
        rc = cfg.renderer
        with phase("pool", dev):
            self.pool = traffic.keyframe_pool(
                t, p["peract"]["coord_bounds"], p["peract"]["rotation_resolution"],
                p["peract"]["model"]["voxel_size"], rc.field.d_embed,
                (cfg.peract.model.lang_max_seq_len, cfg.peract.model.lang_emb_dim), self.seed,
                dev)
        self.order = traffic.pool_order(t["pool"], self.seed)
        self.gen = traffic.generator(self.seed, traffic.DRAWS, dev)
        self.draw_args = (t["batch"], rc.ray_chunk_size, rc.n_coarse, rc.n_fine,
                          rc.n_fine_depth, rc.image_height * rc.image_width)
        with phase("weights", dev):
            with torch.device(dev):
                net = torch.nn.ModuleDict({"policy": PerceiverIO(cfg.peract.model),
                                           "nerf": VoxelNerfField(rc.field)})
            sd = ref.initial_state(p, self.seed, dev, self.batch(), t["occupied_share"])
            net.load_state_dict(program_state_dict(sd, dict(net.named_parameters())))
            del sd
            net.train()
            self.state = TrainState(step=0, module=net, optimizer=Optimizer(
                cfg.peract.train.optim, net.named_parameters()))
        with phase("checked_steps", dev):
            self._checked_steps(t["checked_steps"])
        with phase("warmup_steps", dev):
            for _ in range(t["warmup_steps"]):
                self.step()

    def batch(self) -> dict:
        """The next step's batch: views of the staged pool."""
        b = self.traffic["batch"]
        idx = [int(self.order[(self.i * b + j) % len(self.order)]) for j in range(b)]
        sel = torch.as_tensor(idx, device=self.device)
        return {k: (v[idx[0]:idx[0] + 1] if b == 1 else v.index_select(0, sel))
                for k, v in self.pool.items()}

    def feed(self):
        """The next step's batch and draws."""
        return self.batch(), traffic.train_draws(self.gen, *self.draw_args)

    def step(self) -> int:
        batch, d = self.feed()
        self.state, self.metrics = self.tr.train_step(self.state, batch, **d)
        self.i += 1
        return self.traffic["batch"]

    def _checked_steps(self, n: int) -> None:
        named = list(self.state.module.named_parameters())
        start = {k: v.detach().clone() for k, v in named}
        self.checked: dict = {"samples": [], "draws": [], "losses": [], "render_losses": []}
        for i in range(n):
            batch, d = self.feed()
            self.checked["samples"].append({k: v.clone() for k, v in batch.items()})
            self.checked["draws"].append(d)
            self.state, metrics = self.tr.train_step(self.state, batch, **d)
            self.i += 1
            self.checked["losses"].append(float(metrics["loss_total"]))
            self.checked["render_losses"].append(float(metrics["loss_render"]))
            if i == 0:
                opt = self.state.optimizer.adamw
                b1 = opt.param_groups[0]["betas"][0]
                self.checked["grad"] = {
                    plain_name(k): (float(opt.state[v]["exp_avg"].norm()) / (1 - b1)
                                    if "exp_avg" in opt.state.get(v, {}) else 0.0)
                    for k, v in named}
        self.checked["change"] = {plain_name(k): float((v.detach() - start[k]).norm())
                                  for k, v in named}

    # -------------------------------------------------------------- window
    def end_to_end(self, record) -> Dict[str, float]:
        return {"train_samples_per_s": record.rate()}

    def attempted_failed(self, record):
        return len(record.work), 0

    def window_closed(self) -> None:
        pass

    def free(self) -> None:
        self.state = self.tr = self.pool = self.metrics = None

    # ------------------------------------------------------------ per layer
    def unit_work(self, i: int) -> dict:
        """The port kernels' launches of one step, each as counts.Work."""
        p = self.program
        m, f = p["peract"]["model"], p["renderer"]
        v, c = m["voxel_size"], m.get("im_channels", 64)
        rays = f["ray_chunk_size"]
        b = self.traffic["batch"]
        return {"conv3d_k3": [counts.conv3d_k3(b, v, v, v, c + m.get("final_dim", 64), c)],
                "corner_lerp": [counts.corner_lerp(rays * f["n_coarse"], f["field"]["d_latent"]),
                                counts.corner_lerp(rays * f["n_fine"], f["field"]["d_latent"])]}

    def unit_model_ops(self, i: int) -> Dict[str, float]:
        """A step's model operations by dtype: the policy's forward and
        backward and the field's on the render loss's samples, counted on
        the meta device in the program's dtypes (once)."""
        if getattr(self, "_model_ops", None) is None:
            self._model_ops = self._count_model_ops()
        return self._model_ops

    def _count_model_ops(self) -> Dict[str, float]:
        p, t = self.program, self.traffic
        m, f = p["peract"]["model"], p["renderer"]
        net = ref.plain_module(p).to("meta").train()
        b, v = t["batch"], m["voxel_size"]
        vox = torch.zeros((b, v, v, v, 10), device="meta")
        lang = torch.zeros((b, m.get("lang_max_seq_len", 77), m.get("lang_emb_dim", 512)),
                           device="meta")
        n = f["ray_chunk_size"] * (f["n_coarse"] + f["n_fine"])

        def run():
            out = net["policy"](vox, torch.zeros((b, 7), device="meta"), lang, train=True)
            pts = torch.zeros((1, n, 3), device="meta")
            field = net["nerf"](out[3][:1], pts, pts, coarse=True)
            loss = sum(o.float().sum() for o in out[:3]) + field["rgb"].float().sum() \
                + field["embed"].float().sum()
            loss.backward()
        return counts.model_ops(run)

    # --------------------------------------------------------------- check
    def check(self) -> List[tuple]:
        """(name, value, limit) of each number compared with the reference."""
        got = self.checked
        want = ref.joint_steps(self.program, reference_state(self), got["samples"],
                               got["draws"], self.device)
        return compare(got, want, self.traffic["limits"])


def reference_state(cell: Cell) -> Dict[str, torch.Tensor]:
    """The run's weights made again, from the seed and the first checked
    step's sample."""
    return ref.initial_state(cell.program, cell.seed, cell.device, cell.checked["samples"][0],
                             cell.traffic["occupied_share"])


def compare(got: dict, want: dict, limits: dict) -> List[tuple]:
    """Each step's loss (relative gap); the first gradient by the median
    leaf (the worst leaf swings from seed to seed under bf16 rounding:
    PERF.md); each moving leaf's change by the worst."""
    keep = moving_leaves(want["grad"])
    return [("loss_gap", relative_gap(got["losses"], want["losses"]), limits["loss_gap"]),
            ("grad_gap", leaf_norm_gap(got["grad"], want["grad"], quantile=0.5),
             limits["grad_gap"]),
            ("change_gap", leaf_norm_gap(got["change"], want["change"], keep),
             limits["change_gap"])]


def not_compared(got: dict, want: dict) -> dict:
    """Two numbers read beside the compared ones and not compared, since no
    control or fault separates them from sound runs (PERF.md): the render
    term's relative gap and the first gradient's by the field's median
    leaf."""
    field = [n for n in want["grad"] if n.startswith("nerf.")]
    return {"render_loss_gap": relative_gap(got["render_losses"], want["render_losses"]),
            "field_grad_gap": leaf_norm_gap(got["grad"], want["grad"], field, quantile=0.5)}


def readings(cell: Cell, seconds: float) -> dict:
    """The numbers `check` compares, read for setting its limits: the
    program's (the set-up's checked steps), the control's (the reference in
    fp8 in the program's place) and a planted fault's (half the rendered
    rays left out, the mean over the rest), each against the reference;
    beside them the numbers that are not compared."""
    got = cell.checked
    cell.free()
    args = (cell.program, reference_state(cell), got["samples"], got["draws"], cell.device)
    want = ref.joint_steps(*args)
    lim = cell.traffic["limits"]
    out = {"program": got, "control_fp8": ref.joint_steps(*args, lower="fp8"),
           "fault_half_rays": ref.joint_steps(*args, fault="half_rays")}
    return dict({k: compare(v, want, lim) for k, v in out.items()},
                not_compared={k: not_compared(v, want) for k, v in out.items()})
