"""MPNet neural planner harness (reference src/vamp/mpnet_planner.py).

Port of `vamp_mvt_tpu/planning/mpnet.py`.  An encoder MLP maps a padded
pointcloud to a 28-d latent; a planner MLP maps [latent, current, goal] to
the next configuration; bidirectional rollouts with motion validation and
perturbation recovery, falling back to partial paths.

Both networks are `MLP` modules of `nn.Linear` layers with one scalar
`nn.PReLU` between layers, at the reference's published widths
(mpnet_planner.py:21-61): pointcloud 11978 x 3 -> 512-256-128-28 encoder;
planner 1280-1024-896-768-512-384-256-256-128-64-32 -> d.  Weights come from
`init_mlp` (the JAX package's draws, through `sampling/threefry.py`), from a
reference checkpoint (`load_torch_state_dict`) or from the JAX package's
parameters (`convert.mpnet_params_from_numpy`).  The rollout logic runs on
the host in numpy with the same `default_rng(seed)` draws in the same order
as the JAX planner; each network forward and each motion check runs on the
planner's device, a check as one `validate.validate_motion` call: on the GPU
one fkcc kernel launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from vamp_mvt_tpu_torch.collision.environment import Environment
from vamp_mvt_tpu_torch.convert import mpnet_params_from_numpy
from vamp_mvt_tpu_torch.device import resolve_device
from vamp_mvt_tpu_torch.planning import validate as validate_mod
from vamp_mvt_tpu_torch.robots.spec import RobotSpec
from vamp_mvt_tpu_torch.sampling import threefry

# Full float32 products, as the planners keep them (planning/rrtc.py).
torch.backends.cuda.matmul.allow_tf32 = False

MAX_POINTCLOUD_SIZE = 11978
ENCODER_WIDTHS = (512, 256, 128, 28)
PLANNER_WIDTHS = (1280, 1024, 896, 768, 512, 384, 256, 256, 128, 64, 32)
LATENT = 28

# Planner forwards and motion checks since a caller last set them to 0.
FORWARDS = 0
VALIDATIONS = 0


class MLP(nn.Module):
    """`mlp_apply`: Linear layers with a scalar PReLU after each, except after
    the last when `final_linear`."""

    def __init__(self, sizes, final_linear: bool = True):
        super().__init__()
        sizes = tuple(int(s) for s in sizes)
        self.linears = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.prelus = nn.ModuleList(nn.PReLU(1) for _ in self.linears)
        self.final_linear = final_linear

    @property
    def sizes(self) -> tuple[int, ...]:
        return (self.linears[0].in_features,) + tuple(l.out_features for l in self.linears)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.linears) - 1
        for i, (lin, act) in enumerate(zip(self.linears, self.prelus)):
            x = lin(x)
            if not (i == last and self.final_linear):
                x = act(x)
        return x

    def params(self) -> list[tuple]:
        """The layers as `mlp_apply` takes them: (W (a, b), b (b,), alpha ())
        views of the module's parameters, so gradients reach the module."""
        return [(lin.weight.T, lin.bias, act.weight.reshape(()))
                for lin, act in zip(self.linears, self.prelus)]


def _prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The JAX package's PReLU, slope 1 at x = 0 also in the gradient."""
    return torch.where(x >= 0, x, alpha * x)


def mlp_apply(params, x: torch.Tensor, final_linear: bool = True) -> torch.Tensor:
    """The JAX package's functional MLP over (W, b, alpha) tensors a layer:
    `x @ W + b`, then a scalar PReLU after every layer but the last when
    `final_linear`.  `MLP.params()` gives a module's layers in this form."""
    for i, (W, b, alpha) in enumerate(params):
        x = x @ W + b
        if not (i == len(params) - 1 and final_linear):
            x = _prelu(x, alpha)
    return x


def init_mlp(key: torch.Tensor, sizes, device=None) -> MLP:
    """The JAX package's `init_mlp`: the key split once a layer, weights
    normal(sub, (a, b)) * sqrt(2 / a), zero biases, alpha 0.25; drawn on
    the key's device, the module on `device` (default: the key's)."""
    sizes = tuple(int(s) for s in sizes)
    mlp = MLP(sizes).to(key.device)
    with torch.no_grad():
        for lin, act, a, b in zip(mlp.linears, mlp.prelus, sizes[:-1], sizes[1:]):
            key, sub = threefry.split(key)
            W = threefry.normal(sub, (a, b)) * np.float32(np.sqrt(2.0 / a))
            lin.weight.copy_(W.T)
            lin.bias.zero_()
            act.weight.fill_(0.25)
    return mlp.to(key.device if device is None else device)


def _digits(k: str) -> int:
    return int("".join(filter(str.isdigit, k)) or 0)


def load_torch_state_dict(path, sizes=None, device=None) -> MLP:
    """An MLP from a reference checkpoint (an `nn.Sequential` state dict or
    a pickled module), by the JAX package's rules: the 2-D `.weight` keys
    sorted by their digits, each transposed with its `.bias`; a layer's
    PReLU alpha is the first 1-D weight whose key holds `.{i + 1}.`, for the
    layer's index i, else 0.25.  `sizes`, when given, must match the
    checkpoint's widths."""
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    weights = sorted([k for k in sd if k.endswith(".weight") and sd[k].ndim == 2], key=_digits)
    params = []
    for wk in weights:
        alpha = 0.25
        for k in sd:
            if "weight" in k and sd[k].ndim == 1 and f".{int(wk.split('.')[1]) + 1}." in k:
                alpha = sd[k].reshape(())
                break
        params.append((sd[wk].numpy().T, sd[wk.replace(".weight", ".bias")].numpy(),
                       np.asarray(alpha, np.float32)))
    mlp = mpnet_params_from_numpy(params, device)
    if sizes is not None and tuple(sizes) != mlp.sizes:
        raise ValueError(f"checkpoint {path} has widths {mlp.sizes}, not {tuple(sizes)}")
    return mlp


@dataclasses.dataclass
class MPNetPlanner:
    """Mirrors the reference MPNetPlanner orchestration
    (mpnet_planner.py:369-646).  `env` is one environment (tables (n, f));
    everything runs on `device` (default: the GPU)."""

    spec: RobotSpec
    env: Environment
    encoder_params: MLP | None = None
    planner_params: MLP | None = None
    goal_tolerance: float = 1.0
    max_step_size: float = 0.3
    seed: int = 0
    device: object = None

    def __post_init__(self):
        dev = self.device = resolve_device(self.device)
        d = self.spec.dimension
        k1, k2 = threefry.split(threefry.prng_key(self.seed, dev))
        if self.encoder_params is None:
            self.encoder_params = init_mlp(k1, (MAX_POINTCLOUD_SIZE * 3,) + ENCODER_WIDTHS)
        if self.planner_params is None:
            self.planner_params = init_mlp(k2, (LATENT + 2 * d,) + PLANNER_WIDTHS + (d,))
        self.encoder_params = self.encoder_params.to(dev).eval()
        self.planner_params = self.planner_params.to(dev).eval()
        self.latent = None
        self._rng = np.random.default_rng(self.seed)
        span = float(np.linalg.norm(self.spec.limits_high - self.spec.limits_low))
        self._num = validate_mod.n_points_bound(self.spec, span)
        self._envs = self.env.to(dev).map(lambda t: t[None])

    # --- environment encoding (mpnet_planner.py:402-416, 586-609) ---------
    def encode_environment(self, pointcloud) -> bool:
        pc = np.asarray(pointcloud, np.float32).reshape(-1, 3)
        if len(pc) > MAX_POINTCLOUD_SIZE:
            idx = self._rng.choice(len(pc), MAX_POINTCLOUD_SIZE, replace=False)
            pc = pc[idx]
        elif len(pc) < MAX_POINTCLOUD_SIZE:
            pc = np.vstack([pc, np.zeros((MAX_POINTCLOUD_SIZE - len(pc), 3), np.float32)])
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(pc.reshape(-1))).to(self.device)
            self.latent = self.encoder_params(x).cpu().numpy()
        return True

    def _predict_next(self, current, goal):
        global FORWARDS
        x = np.concatenate([self.latent, current, goal]).astype(np.float32)
        with torch.no_grad():
            pred = self.planner_params(torch.from_numpy(x).to(self.device)).cpu().numpy()
        FORWARDS += 1
        step = pred - current
        n = np.linalg.norm(step)
        if n > self.max_step_size:
            pred = current + step * (self.max_step_size / n)
        return pred

    def _valid(self, a, b) -> bool:
        global VALIDATIONS
        q = torch.from_numpy(np.asarray([a, b], np.float32)).to(self.device)
        VALIDATIONS += 1
        return bool(validate_mod.validate_motion(
            self.spec, self._envs, q[None, 0], q[None, 1], self._num)[0])

    def path_valid(self, path) -> bool:
        """Every segment of a waypoint list collision-free: one
        `validate_motion_batch` call (one fkcc launch on the GPU)."""
        q = torch.from_numpy(np.asarray(path, np.float32)).to(self.device)
        if len(q) < 2:
            return bool(len(q))
        return bool(validate_mod.validate_motion_batch(
            self.spec, self._envs, q[None, :-1], q[None, 1:], self._num).all())

    def _single_attempt(self, start, goal, max_steps):
        current = np.array(start, np.float32)
        path = [current.copy()]
        for _ in range(max_steps):
            nxt = self._predict_next(current, goal)
            if self._valid(current, nxt):
                path.append(nxt.copy())
                current = nxt
                if np.linalg.norm(current - goal) < self.goal_tolerance:
                    return path
            else:
                noisy = np.clip(
                    nxt + self._rng.normal(0, 0.25, nxt.shape),
                    self.spec.limits_low, self.spec.limits_high,
                )
                if self._valid(current, noisy):
                    path.append(noisy.astype(np.float32))
                    current = noisy.astype(np.float32)
                else:
                    break
        return path if len(path) > 1 else None

    def _bidirectional_attempt(self, start, goal, max_steps):
        fwd = self._single_attempt(start, goal, max_steps // 2)
        if not fwd or len(fwd) < 2:
            return None
        bwd = self._single_attempt(goal, start, max_steps // 2)
        if not bwd or len(bwd) < 2:
            return fwd
        if self._valid(fwd[-1], bwd[-1]):
            # The reference drops bwd[-1] here (mpnet_planner.py:516), leaving
            # the fwd[-1] -> bwd[-2] segment unvalidated; the validated
            # junction vertex stays, so every merged segment is checked.
            return fwd + list(reversed(bwd))
        bridge = self._single_attempt(fwd[-1], bwd[-1], max_steps // 4)
        if bridge and len(bridge) > 1:
            return fwd + bridge[1:] + list(reversed(bwd[:-1]))
        return fwd if len(fwd) >= len(bwd) else bwd

    def plan(self, start, goal, max_iterations=50, max_planning_steps=50):
        """A waypoint list or None (mpnet_planner.py:419-491)."""
        if self.latent is None:
            raise RuntimeError("call encode_environment() first")
        start = np.asarray(start, np.float32)
        goal = np.asarray(goal, np.float32)
        if self._valid(start, goal):
            return [start, goal]
        best, best_d = None, np.inf
        for _ in range(max_iterations):
            path = self._bidirectional_attempt(start, goal, max_planning_steps)
            if path and len(path) > 1:
                d = np.linalg.norm(path[-1] - goal)
                if d < self.goal_tolerance:
                    path.append(goal)
                    return path
                if d < best_d:
                    best, best_d = list(path), d
        return best


def plan_with_mpnet(robot_name, start, goal, env, pointcloud, encoder_path=None,
                    planner_path=None, rrtc_fallback=True, device=None):
    """MPNet attempt with an RRT-Connect fallback when the rollouts do not
    reach the goal or yield an invalid path (mpnet_planner.py:648+): (path,
    "mpnet" | "rrtc_fallback" | "partial").  `env` is an `api.Environment`,
    a builder or a built environment; the fallback plans with the port's
    `api.RobotModule(robot_name).rrtc` on the same device.

    A rollout's path can hold unchecked segments: `plan` appends the goal
    once a rollout ends within goal_tolerance of it, and a bridge joins
    bwd[-2] from its own end.  The JAX function names an invalid path as a
    reason to fall back but does not check it; here every segment of an
    MPNet path is checked (`path_valid`) before it is returned as "mpnet"."""
    from vamp_mvt_tpu_torch import api

    dev = resolve_device(device)
    module = api.RobotModule(robot_name)
    enc = load_torch_state_dict(encoder_path) if encoder_path else None
    planner = load_torch_state_dict(planner_path) if planner_path else None
    mp = MPNetPlanner(module.spec, api._as_env(env, dev), encoder_params=enc,
                      planner_params=planner, device=dev)
    mp.encode_environment(pointcloud)
    path = mp.plan(start, goal)
    if (path is not None and np.linalg.norm(path[-1] - np.asarray(goal)) < 1e-6
            and mp.path_valid(path)):
        return path, "mpnet"
    if rrtc_fallback:
        res = module.rrtc(start, goal, env, device=dev)
        if bool(res.solved):
            L = int(res.path_length)
            return [np.asarray(p) for p in res.path[:L].cpu().numpy()], "rrtc_fallback"
    return path, "partial"
