"""Locate why async TD3 on Walker2d learns faster on the card than on the
CPU (`ROADMAP.md` queue 3, S4): the arms of the bisection over device
placements, each built from the port's own classes.

An arm names, for each part of an async TD3 run, the device it runs on:
"card" (the GPU, or the CPU with --device cpu) or "cpu".

  env       the Walker2d fleet: its state, its physics, its eval
  kernels   K2 and K3 ("cuda": the port's wrappers; "plain": their plain
            versions, swapped in as `chip_smoke.plain_kernels()` does)
  update    the nets, targets and both optimisers: where `TD3._update`
            runs
  acting    the acting snapshot and the actor the eval reads
  ring      the replay ring and its gather
  draws     the generator of the learner and the collection (the nets'
            init, the warm-up and exploration noise, the replay indices,
            the target-policy noise); each draw is moved to where it is
            used
  env_draws the generator of the env's reset draws; where it is the
            device of `draws`, the two are one generator, as in the port

Arms (seeds 10-12 in the S4 runs):
  card  the port's own `TD3` on the card, bit for bit (the reference arm)
  B1    the port on the card with K2 and K3 swapped for their plain versions
  B2    env, physics, K2/K3 on the card; the learner (nets, optimisers,
        ring, acting, every generator it draws from) on the CPU:
        observations and actions cross the bus each step
  B3    everything on the card; every draw of the learner and the
        collection comes from a CPU generator and is moved to the card
  B4    everything on the card but `TD3._update`, which runs on CPU
        copies of the nets (batch and target noise drawn on the card)
  B3p   the env on the CPU, the learner on the card

Every arm evaluates as the curve does: `TD3._evaluate`'s protocol on the
env's device, its generator seeded (7 << 32) + iteration. The loop, the
random warm-up and the snapshot refresh are those of
`scripts/torch_train_offpolicy_curve.py td3_async`. Modes:

  probe   the process's fp32 matmul settings and a matmul against float64
  step0   one actor's evals on the curve's own eval generators (iterations
          0, 10, ..., 500), with the moments of each fresh fleet's draws
  welch   step 0's rule: Welch's test of the card's step0 files against
          the CPU's (one-sided, card higher)
  graphcheck
          an arm eager and with B1's graphed fleet step, bit for bit
  arm     train one arm; writes <out>/<arm>_seed<n>.npz (the curve
          script's keys) and prints the curve script's lines
  judge   U: the pairs (arm seed, reference seed) in which the arm is
          higher, at the given iterations (`curve_band.py`'s centred
          5-point means, every curve cut at the last point all reach)

  python3 scripts/s4_bisect.py probe
  python3 scripts/s4_bisect.py step0 --actor
      curves/jax_eval_draws/td3_async_walker.npz --out step0_jax_card.json
  python3 scripts/s4_bisect.py graphcheck B1 --n-itr 3
  python3 scripts/s4_bisect.py arm B1 --seed 10 --n-itr 501 --out curves/s4
  python scripts/s4_bisect.py judge --arm-curves curves/s4/B1_seed1?.npz
      --reference curves/jax_cpu_td3_async_walker_seed?.npz
      curves/torch_cpu_td3_async_walker_seed?.npz --at 250 500

It runs on the card unless --device cpu is given; on the CPU every "card"
part is the CPU (the tests run the arms' wiring so). Needs no JAX.
"""
import argparse
import collections
import contextlib
import dataclasses
import json
import os
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from apex_tpu_torch.agents.ppo import ClippedAdam  # noqa: E402
from apex_tpu_torch.agents.replay import ReplayBuffer  # noqa: E402
from apex_tpu_torch.agents.rollout import (evaluate_policy,  # noqa: E402
                                           init_runner, rollout_scan)
from apex_tpu_torch.agents.td3 import (ADAM_EPS, TD3, TD3Config,  # noqa: E402
                                       TD3TrainState, copy_params,
                                       frozen_copy)
from apex_tpu_torch.device import (card_line, launch_counts,  # noqa: E402
                                   resolve_device)
from apex_tpu_torch.envs import walker2d  # noqa: E402
from apex_tpu_torch.envs.walker2d import Walker2dEnv  # noqa: E402
from apex_tpu_torch.models.nets import (DualQCritic, FFActor,  # noqa: E402
                                        NormState)
from apex_tpu_torch.ops import pallas_linalg  # noqa: E402
from apex_tpu_torch.physics import fleet, fleet_fk  # noqa: E402

PARTS = ("env", "kernels", "update", "acting", "ring", "draws", "env_draws")
_CARD = dict(env="card", kernels="cuda", update="card", acting="card",
             ring="card", draws="card", env_draws="card")
ARMS = {
    "card": dict(_CARD),
    "B1": dict(_CARD, kernels="plain"),
    "B2": dict(_CARD, update="cpu", acting="cpu", ring="cpu", draws="cpu"),
    "B3": dict(_CARD, draws="cpu", env_draws="cpu"),
    "B4": dict(_CARD, update="cpu"),
    "B3p": dict(_CARD, env="cpu", env_draws="cpu"),
}
EVAL_BASE = 7          # the curve's eval generator: (7 << 32) + iteration


def eval_generator(device, it: int) -> torch.Generator:
    """`scripts/torch_train_offpolicy_curve.py`'s eval generator of
    iteration `it` for td3."""
    gen = torch.Generator(device=device)
    gen.manual_seed((EVAL_BASE << 32) + it)
    return gen


class GraphedStep:
    """`fleet.fleet_step` replayed from a CUDA graph per fleet size, on the
    card: the same kernels as the eager step, without the host's launch of
    each (B1's plain K2 and K3 are hundreds of small eager kernels per
    substep). The caller keeps the fleet's `params` tensors alive and the
    same (Walker2d caches them per fleet size); `dyn` and `contact` are the
    graph's own buffers, overwritten by the next replay (Walker2d reads
    neither). The constants `fk_plain` makes from numpy at each call are
    captured as copies from pinned host buffers that the graph keeps. Off
    the card it is the eager step."""

    def __init__(self, step):
        self.step, self.graphs = step, {}

    def __call__(self, m, params, qpos, qvel, ctrl):
        if qpos.device.type != "cuda":
            return self.step(m, params, qpos, qvel, ctrl)
        g = self.graphs.get(qpos.shape[1])
        if g is None:
            ins = [x.clone() for x in (qpos, qvel, ctrl)]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):      # warm-up, as capture needs
                for _ in range(2):
                    self.step(m, params, *ins)
            torch.cuda.current_stream().wait_stream(side)
            graph, pinned = torch.cuda.CUDAGraph(), []
            as_tensor = torch.as_tensor

            def pinned_as_tensor(data, dtype=None, device=None):
                """fk_plain's per-call constants: a capture copies to the
                card only from pinned host memory, kept alive here."""
                if device is None or torch.device(device).type != "cuda":
                    return as_tensor(data, dtype=dtype, device=device)
                host = as_tensor(data, dtype=dtype).pin_memory()
                pinned.append(host)
                return host.to(device, non_blocking=True)

            torch.as_tensor = pinned_as_tensor
            try:
                with torch.cuda.graph(graph):
                    outs = self.step(m, params, *ins)
            finally:
                torch.as_tensor = as_tensor
            g = self.graphs[qpos.shape[1]] = (graph, ins, outs, pinned)
        graph, ins, outs, _ = g
        for buf, x in zip(ins, (qpos, qvel, ctrl)):
            buf.copy_(x)
        graph.replay()
        dyn, contact, *rest = outs
        return (dyn, contact, *(x.clone() for x in rest))


@contextlib.contextmanager
def kernels(which: str, graphed: bool = True):
    """K2 and K3 as the port launches them ("cuda") or their plain
    versions in the fleet step ("plain", `chip_smoke.plain_kernels()`);
    with `graphed`, the plain fleet step on the card replays a CUDA graph
    (`GraphedStep`)."""
    saved = fleet.fleet_fk, fleet.spd_inverse_bt, walker2d.fleet_step
    if which == "plain":
        fleet.fleet_fk = fleet_fk.fk_plain
        fleet.spd_inverse_bt = pallas_linalg.spd_inverse_bt_plain
        if graphed:
            walker2d.fleet_step = GraphedStep(fleet.fleet_step)
    try:
        yield
    finally:
        fleet.fleet_fk, fleet.spd_inverse_bt, walker2d.fleet_step = saved


class PlacedEnv:
    """The Walker2d fleet of `env`, whose reset draws are taken on the
    device of the generator passed (by a Walker2d env there) and moved to
    the fleet's device; everything else is the fleet's own."""

    def __init__(self, env: Walker2dEnv, bisect: "Bisect"):
        self.env, self.bisect = env, bisect
        self._drawers = {env.device: env}

    def __getattr__(self, name):
        return getattr(self.env, name)

    def sample_reset_noise(self, generator, batch):
        dev = torch.device(generator.device)
        drawer = self._drawers.get(dev)
        if drawer is None:
            drawer = self._drawers[dev] = Walker2dEnv(device=dev)
        # the run's env generator, or an eval's on the env's device
        src = ("env_draws" if generator is self.bisect.env_gen else "env")
        noise = drawer.sample_reset_noise(generator, batch)
        return type(noise)(*(self.bisect.move(x, src, "env", "reset_draws")
                             for x in noise))


class Bisect:
    """One arm of async TD3 on Walker2d: `TD3`'s init, collection, updates
    and eval, each part on the device its arm names. On one device with
    one generator it computes what `TD3.init`, `TD3._train_iteration` and
    `TD3._evaluate` compute, bit for bit."""

    def __init__(self, arm: dict, card: torch.device, cfg: TD3Config):
        self.arm, self.cfg = dict(arm), cfg
        card = torch.device(card)
        if card.type == "cuda" and card.index is None:
            # a generator's device carries its index
            card = torch.device("cuda", torch.cuda.current_device())
        cpu = torch.device("cpu")
        self.dev = {p: (card if arm[p] == "card" else cpu)
                    for p in PARTS if p != "kernels"}
        self.env = Walker2dEnv(device=self.dev["env"])
        self.placed = PlacedEnv(self.env, self)
        self.td3 = TD3(self.env, cfg)
        self.scales = self.td3.noise_scales[:, None].to(self.dev["acting"])
        self.moves = collections.Counter()

    # -- placement ------------------------------------------------------
    def move(self, x: torch.Tensor, src: str, dst: str, what: str):
        """x from part `src` to part `dst`, counted under `what` where the
        arm puts the two on different devices (counted by the arm's
        names, so that the CPU's runs count what the card's would)."""
        if self.arm[src] != self.arm[dst]:
            self.moves[what] += 1
        return x.to(self.dev[dst])

    def draw(self, fn, gen, shape, dst: str, what: str, *args):
        """fn(*args, shape) from the learner's generator `gen` on its own
        device, moved to part `dst`."""
        x = fn(*args, shape, generator=gen, device=gen.device)
        return self.move(x, "draws", dst, what)

    # -- init -------------------------------------------------------------
    def init(self, seed: int) -> TD3TrainState:
        """`TD3.init`: the actor, then the critic, then the first fleet's
        reset draws, from one generator where the arm puts `draws` and
        `env_draws` in one place."""
        cfg = self.cfg
        gen = torch.Generator(device=self.dev["draws"])
        gen.manual_seed(seed)
        if self.arm["env_draws"] == self.arm["draws"]:
            self.env_gen = gen
        else:
            self.env_gen = torch.Generator(device=self.dev["env_draws"])
            self.env_gen.manual_seed(seed)
        obs_dim, act_dim = self.env.observation_size, self.env.action_size
        upd = self.dev["update"]
        actor = FFActor.init(gen, obs_dim, act_dim, max_action=cfg.max_action)
        critic = DualQCritic.init(gen, obs_dim, act_dim)
        if self.arm["draws"] != self.arm["update"]:
            self.moves["init"] += 1
        actor, critic = actor.to(upd), critic.to(upd)
        with torch.no_grad():
            runner = init_runner(self.placed, self.env_gen, cfg.num_envs)
        norm = NormState(obs_dim).to(upd)
        state = TD3TrainState(
            actor=actor, actor_target=frozen_copy(actor),
            behavior=frozen_copy(actor).to(self.dev["acting"]),
            critic=critic, critic_target=frozen_copy(critic), norm=norm,
            actor_opt=ClippedAdam(actor.parameters(), cfg.a_lr, None,
                                  ADAM_EPS),
            critic_opt=ClippedAdam(critic.parameters(), cfg.c_lr, None,
                                   ADAM_EPS),
            replay=ReplayBuffer(cfg.replay_size, obs_dim, act_dim,
                                self.dev["ring"]),
            runner=runner, generator=gen, seed=seed, update_count=0,
            param_noise_sigma=torch.tensor(0.05, device=upd))
        if self.arm["acting"] == self.arm["update"]:
            self.actor_act, self.norm_act = actor, norm
        else:
            self.actor_act = frozen_copy(actor).to(self.dev["acting"])
            self.norm_act = NormState(obs_dim).to(self.dev["acting"])
        return state

    def refresh_snapshot(self, state: TD3TrainState) -> None:
        """The acting snapshot from the actor (the loop's load_freq
        refresh)."""
        copy_params(state.behavior, self.actor_act)

    # -- one iteration -----------------------------------------------------
    def collect(self, state: TD3TrainState, random_actions: bool):
        """`agents/td3.collect` with the snapshot on `acting`, the fleet on
        `env` and the ring on `ring`."""
        cfg, gen, m = self.cfg, state.generator, self.cfg.max_action
        act_size = self.env.action_size

        def policy_fn(obs):
            obs = self.move(obs, "env", "acting", "obs")
            if random_actions:
                a = -m + 2.0 * m * self.draw(torch.rand, gen,
                                             (obs.shape[0], act_size),
                                             "acting", "action_draws")
            else:
                a = state.behavior.act(self.norm_act, obs)
                noise = self.draw(torch.randn, gen, a.shape, "acting",
                                  "action_draws")
                a = torch.clamp(a + noise * self.scales, -m, m)
            return self.move(a, "acting", "env", "action")

        with torch.no_grad():
            runner, traj = rollout_scan(self.placed, policy_fn, state.runner,
                                        self.env_gen, cfg.collect_steps,
                                        cfg.max_traj_len)
            flat = lambda x: x.reshape((-1,) + x.shape[2:])
            rows = (flat(traj.obs), flat(traj.action), flat(traj.reward),
                    flat(traj.next_obs),
                    1.0 - flat(traj.terminated).float())
            state.replay.add_batch(*(self.move(x, "env", "ring", "rows")
                                     for x in rows))
        return dataclasses.replace(state, runner=runner), traj

    def train_iteration(self, state: TD3TrainState, random_actions: bool):
        """`TD3._train_iteration` (no parameter noise, as the curve runs
        it): collect, then `updates_per_iter` updates, each on `update`.
        Returns (state, mean critic loss)."""
        cfg = self.cfg
        state, _ = self.collect(state, random_actions)
        gen, ring = state.generator, state.replay
        losses = []
        for _ in range(cfg.updates_per_iter):
            idx = self.draw(torch.randint, gen, (cfg.batch_size,), "ring",
                            "index_draws", 0, max(ring.size, 1))
            batch = tuple(self.move(x, "ring", "update", "batch")
                          for x in ring.gather(idx))
            noise = self.draw(torch.randn, gen, batch[1].shape, "update",
                              "target_noise")
            losses.append(self.td3._update(state, batch, noise)[0])
        if self.actor_act is not state.actor:
            self.moves["actor_sync"] += 1
            copy_params(self.actor_act, state.actor)
        return state, torch.stack(losses).mean()

    def evaluate(self, it: int) -> dict:
        """`TD3._evaluate` of the actor on the env's device, with the
        curve's eval generator of iteration `it`."""
        def policy(obs):
            a = self.actor_act.act(self.norm_act,
                                   self.move(obs, "env", "acting", "obs"))
            return self.move(a, "acting", "env", "action")

        return evaluate_policy(self.placed, policy,
                               eval_generator(self.dev["env"], it),
                               self.cfg.num_envs, self.cfg.max_traj_len)


def td3_config(args) -> TD3Config:
    return TD3Config(num_envs=args.num_envs, collect_steps=args.collect_steps,
                     updates_per_iter=args.updates,
                     max_traj_len=args.max_traj_len, async_mode=True)


def run_arm(name: str, seed: int, n_itr: int, card, cfg: TD3Config,
            eval_every: int = 10, out=None, log=print, graphed=True):
    """Train arm `name` for n_itr iterations as the curve script's
    td3_async loop does, evaluating every `eval_every`-th iteration and
    the last; returns (Bisect, state, curve dict)."""
    b = Bisect(ARMS[name], card, cfg)
    steps_per_iter = cfg.collect_steps * cfg.num_envs
    warmup = max(1, cfg.start_timesteps // steps_per_iter)
    curve = {k: [] for k in ("iters", "wall_s", "env_steps", "eval_return")}
    with kernels(b.arm["kernels"], graphed):
        state = b.init(seed)
        t0, total = time.time(), 0
        for it in range(n_itr):
            if it % cfg.load_freq == 0:
                b.refresh_snapshot(state)
            state, closs = b.train_iteration(state, it < warmup)
            total += steps_per_iter
            if it % eval_every == 0 or it == n_itr - 1:
                ret = float(b.evaluate(it)["ep_return"])
                for k, v in zip(curve, (it, time.time() - t0, total, ret)):
                    curve[k].append(v)
                if out is not None:
                    np.savez(out, **{k: np.asarray(v) for k, v in
                                     curve.items()}, algo="td3_async",
                             env="Walker2d", seed=seed, arm=name)
                log(f"it {it:5d} | wall {curve['wall_s'][-1]:7.1f}s | "
                    f"steps {total / 1e6:6.2f}M | eval {ret:8.2f} | "
                    f"closs {float(closs):8.4f}")
    return b, state, curve


def graphcheck(name: str, seed: int, n_itr: int, card,
               cfg: TD3Config) -> dict:
    """Arm `name` eager and with the graphed fleet step: every net and
    eval return bit for bit alike."""
    runs = [run_arm(name, seed, n_itr, card, cfg, eval_every=1,
                    log=lambda s: None, graphed=g) for g in (False, True)]
    (_, a, ca), (_, b, cb) = runs
    nets = ("actor", "actor_target", "critic", "critic_target")
    same = all(torch.equal(x, y) for n in nets
               for x, y in zip(getattr(a, n).state_dict().values(),
                               getattr(b, n).state_dict().values()))
    return {"arm": name, "n_itr": n_itr, "nets_equal": same,
            "evals": [ca["eval_return"], cb["eval_return"]],
            "equal": same and ca["eval_return"] == cb["eval_return"]}


# -- probe and step 0 --------------------------------------------------------
def probe(device) -> dict:
    """The fp32 matmul settings this process runs with, and what a
    (256, 256) @ (256, 256) float32 matmul on `device` gives against
    float64: TF32 rounds the inputs to 10 mantissa bits, ~1e-3 relative."""
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((256, 256), generator=gen)
    b = torch.randn((256, 256), generator=gen)
    ref = a.double() @ b.double()
    got = (a.to(device) @ b.to(device)).cpu().double()
    out = {"device": str(device),
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "cuda_matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "env": {k: os.environ.get(k) for k in (
               "TORCH_ALLOW_TF32_CUBLAS_OVERRIDE", "NVIDIA_TF32_OVERRIDE",
               "TORCH_CUDNN_V8_API_ENABLED")},
           "matmul_max_rel_err": float(((got - ref).abs()
                                        / ref.abs().max()).max())}
    fp32 = getattr(torch.backends.cuda.matmul, "fp32_precision", None)
    if fp32 is not None:
        out["cuda_matmul_fp32_precision"] = fp32
    return out


def step0(actor_path: str, iters, device, n_envs: int = 64,
          traj_len: int = 400) -> dict:
    """The actor's `TD3._evaluate` on each of the curve's eval generators
    of `iters`, with the moments of each fresh fleet's reset draws (the
    generator's first draw, as `init_runner` takes it)."""
    from apex_tpu_torch.runtime.checkpoint import load_td3_actor

    env = Walker2dEnv(device=device)
    actor, norm = load_td3_actor(actor_path, device)
    td3 = TD3(env, TD3Config(num_envs=n_envs, max_traj_len=traj_len,
                             async_mode=True))
    holder = types.SimpleNamespace(actor=actor, norm=norm)
    rows = []
    for it in iters:
        noise = env.sample_reset_noise(eval_generator(device, it), n_envs)
        ev = td3._evaluate(holder, eval_generator(device, it))
        rows.append({"iter": it, "ep_return": float(ev["ep_return"]),
                     "ep_len": float(ev["ep_len"]),
                     "num_episodes": int(ev["num_episodes"]),
                     "reset_qpos_mean": float(noise.qpos.mean()),
                     "reset_qpos_var": float(noise.qpos.var()),
                     "reset_qvel_mean": float(noise.qvel.mean()),
                     "reset_qvel_var": float(noise.qvel.var())})
    ret = np.array([r["ep_return"] for r in rows])
    return {"actor": actor_path, "device": str(device), "n": len(rows),
            "mean": float(ret.mean()), "std": float(ret.std(ddof=1))
            if len(rows) > 1 else 0.0, "rows": rows}


def welch(a, b) -> dict:
    """Welch's two-sample t-test, two-sided and one-sided (a > b)."""
    from scipy import stats

    a, b = np.asarray(a, float), np.asarray(b, float)
    t = stats.ttest_ind(a, b, equal_var=False)
    return {"t": float(t.statistic), "p_two_sided": float(t.pvalue),
            "p_a_greater": float(stats.ttest_ind(
                a, b, equal_var=False, alternative="greater").pvalue),
            "mean_a": float(a.mean()), "mean_b": float(b.mean())}


def step0_test(card_files, cpu_files) -> dict:
    """Step 0's rule on its files (one actor, a device per side): Welch's
    test of the card's returns against the CPU's, with each side's spread
    and the mean moments of its fresh fleets' reset draws."""
    def rows(files):
        return [r for f in files for r in json.loads(
            pathlib.Path(f).read_text())["rows"]]

    sides = {"card": rows(card_files), "cpu": rows(cpu_files)}
    ret = {k: [r["ep_return"] for r in v] for k, v in sides.items()}
    keys = ("reset_qpos_mean", "reset_qpos_var", "reset_qvel_mean",
            "reset_qvel_var", "ep_len", "num_episodes")
    return dict(welch(ret["card"], ret["cpu"]),
                n={k: len(v) for k, v in ret.items()},
                std={k: float(np.std(v, ddof=1)) for k, v in ret.items()},
                moments={k: {m: float(np.mean([r[m] for r in v]))
                             for m in keys} for k, v in sides.items()})


# -- judge -------------------------------------------------------------------
def smoothed_at(curve: dict, itr: int, last: int) -> float:
    """`curve_band.py`'s centred 5-point mean at the eval point nearest
    `itr`, on the curve cut at iteration `last`."""
    from curve_band import smoothed

    iters = np.asarray(curve["iters"])
    keep = iters <= last
    r = smoothed(np.asarray(curve["eval_return"])[keep])
    return float(r[int(np.argmin(np.abs(iters[keep] - itr)))])


def judge(arm_paths, ref_paths, at) -> dict:
    """U at each iteration of `at` (and at the last point every curve
    reaches): the (arm, reference) pairs with the arm higher, and the
    class: card-like (U >= 24 of 27), CPU-like (U <= 18), else undecided;
    other pair counts are scaled to 27. With each, the one-sided
    Mann-Whitney p of U under no difference (the arm higher)."""
    from scipy import stats

    load = lambda p: {k: v for k, v in np.load(p).items()}
    arms = [load(p) for p in arm_paths]
    refs = [load(p) for p in ref_paths]
    last = int(min(c["iters"][-1] for c in arms + refs))
    points = []
    for itr in sorted(set(list(at) + [last])):
        if itr > last:
            continue
        a = [smoothed_at(c, itr, last) for c in arms]
        r = [smoothed_at(c, itr, last) for c in refs]
        u = sum(x > y for x in a for y in r)
        pairs = len(a) * len(r)
        scaled = u * 27 / pairs
        p = stats.mannwhitneyu(a, r, alternative="greater").pvalue
        points.append({"iter": itr, "arm": a, "reference": r, "U": u,
                       "pairs": pairs, "p_arm_greater": float(p),
                       "class": ("card-like" if scaled >= 24 else
                                 "CPU-like" if scaled <= 18 else
                                 "undecided")})
    return {"arm": list(map(str, arm_paths)), "last": last,
            "points": points}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["probe", "step0", "welch", "arm",
                                     "judge", "graphcheck"])
    ap.add_argument("arm", nargs="?", choices=sorted(ARMS), default="card")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=10)
    ap.add_argument("--n-itr", type=int, default=501)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--collect-steps", type=int, default=80)
    ap.add_argument("--updates", type=int, default=80)
    ap.add_argument("--max-traj-len", type=int, default=400)
    ap.add_argument("--actor", help="step0: a TD3 run dir, .pkl or .npz")
    ap.add_argument("--iters", type=int, nargs="+",
                    default=list(range(0, 501, 10)))
    ap.add_argument("--out", default=None)
    ap.add_argument("--reference", nargs="+", help="judge: CPU curves")
    ap.add_argument("--arm-curves", nargs="+", help="judge: an arm's curves")
    ap.add_argument("--at", type=int, nargs="+", default=[500])
    ap.add_argument("--card-json", nargs="+",
                    help="welch: step0 files of the card")
    ap.add_argument("--cpu-json", nargs="+",
                    help="welch: step0 files of the CPU")
    args = ap.parse_args(argv)
    # arms run side by side, several to the host's cores
    torch.set_num_threads(1)

    if args.mode == "judge":
        out = judge(args.arm_curves, args.reference, args.at)
        print(json.dumps(out))
        return out
    if args.mode == "welch":
        out = step0_test(args.card_json, args.cpu_json)
        print(json.dumps(out))
        return out
    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else "cpu"
    if args.mode == "probe":
        out = dict(probe(device), card=card)
    elif args.mode == "graphcheck":
        out = dict(graphcheck(args.arm, args.seed, args.n_itr, device,
                              td3_config(args)), card=card)
        if not out["equal"]:
            print(json.dumps(out))
            raise SystemExit("graphcheck: the graphed run parts from the "
                             "eager one")
    elif args.mode == "step0":
        t0 = time.time()
        out = dict(step0(args.actor, args.iters, device, args.num_envs,
                         args.max_traj_len), card=card,
                   seconds=time.time() - t0)
    else:
        out_dir = pathlib.Path(args.out or ROOT / "curves" / "s4")
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{args.arm}_seed{args.seed}.npz"
        t0, launches0 = time.time(), launch_counts()
        b, _, curve = run_arm(args.arm, args.seed, args.n_itr, device,
                              td3_config(args), args.eval_every, path,
                              log=lambda s: print(s, flush=True))
        out = {"arm": args.arm, "placement": b.arm, "seed": args.seed,
               "n_itr": args.n_itr, "seconds": time.time() - t0,
               "s_per_itr": (time.time() - t0) / args.n_itr,
               "eval_return_last": curve["eval_return"][-1],
               "moves": dict(b.moves),
               "launches": {k: v - launches0[k]
                            for k, v in launch_counts().items()},
               "curve": str(path), "card": card}
        if device.type == "cuda":
            out["peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
    if args.out and args.mode != "arm":
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out if args.mode != "step0" else
                     {k: v for k, v in out.items() if k != "rows"}))
    return out


if __name__ == "__main__":
    main()
