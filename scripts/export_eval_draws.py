"""The draws JAX's deterministic evaluation of a run directory uses, saved
for the port's evaluation on the card (`chip_smoke.py` eval_switches), and
JAX's return with its own spread.

jax.random and torch draw different numbers from the same seed, and a
checkpoint whose policy falls often moves by several percent between
seeds (JAX's main: 114.65 / 121.12 / 125.54 at seeds 42 / 0 / 1), so the
two stacks' evaluations are compared on the same draws. This script runs
`apex.py eval`'s protocol (`init_runner` with PRNGKey(seed), then
`rollout_scan`, 64 envs, 300 steps) on the CPU and saves, sparsely, the
draws that run used: the first fleet reset's, each auto-reset's rows for
the envs that finished at that step, and each step's command changes
(the hit masks, and the values where a change hit). The port draws its
own numbers and takes JAX's in their place (`chip_smoke.jax_draws`).

With --spread N it also runs the same evaluation N more times with the
reset state's joint positions changed by random factors 1 +- 1e-6 (the
repo's measure of chaotic divergence, ROADMAP limit (a)) and saves the
largest change of the mean return.

    JAX_PLATFORMS=cpu python scripts/export_eval_draws.py \\
        --path curves/cassie_main_ckpt --out curves/jax_eval_draws/main.npz
"""
import argparse
import importlib.util
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from apex_tpu.agents.rollout import init_runner, rollout_scan  # noqa: E402


def _loader():
    spec = importlib.util.spec_from_file_location(
        "reference_eval_seeds", ROOT / "scripts" / "reference_eval_seeds.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load_experiment_lenient


def reset_draws(env, keys):
    """JAX's reset draws per key, as the port's ResetNoise (or
    TrajResetNoise, or WalkerResetNoise) fields, batch-first numpy."""
    if type(env).__name__ == "Walker2dEnv":       # walker2d.py:63-70
        def walker(rng):
            k1, k2 = jax.random.split(rng)
            return dict(
                qpos=jax.random.uniform(k1, (env.model.nq,), minval=-1.0,
                                        maxval=1.0),
                qvel=jax.random.uniform(k2, (env.model.nv,), minval=-1.0,
                                        maxval=1.0))
        return {k: np.asarray(v) for k, v in jax.vmap(walker)(keys).items()}
    traj = type(env).__name__ == "CassieTrajEnv"

    def one(rng):
        k_speed, k_side, k_clock, k_phase, k_dyn = jax.random.split(rng, 5)
        k_damp, k_mass, k_fric, k_slope, k_menc, k_jenc = \
            jax.random.split(k_dyn, 6)
        u = lambda k, shape, lo, hi: jax.random.uniform(
            k, shape, minval=lo, maxval=hi)
        m = env.model
        if traj:
            first = {"speed_idx": jax.random.randint(
                k_speed, (), 0, env.num_speeds if env.aslip else 41)}
        else:
            first = {"speed": u(k_speed, (), env.min_speed, env.max_speed)}
        return dict(
            first,
            side_speed=u(k_side, (), env.min_side_speed, env.max_side_speed),
            phase_u=jax.random.uniform(k_phase, ()),
            damp_scale=u(k_damp, (m.nv,), env.damping_low, env.damping_high),
            mass_scale=u(k_mass, (m.nbody,), env.mass_low, env.mass_high),
            friction=u(k_fric, (), env.fric_low, env.fric_high),
            roll=u(k_slope, (), -env.max_roll_incline, env.max_roll_incline),
            pitch=u(jax.random.fold_in(k_slope, 1), (),
                    -env.max_pitch_incline, env.max_pitch_incline),
            motor_enc=u(k_menc, (10,), -env.encoder_noise,
                        env.encoder_noise),
            joint_enc=u(k_jenc, (6,), -env.encoder_noise, env.encoder_noise))
    return {k: np.asarray(v) for k, v in jax.vmap(one)(keys).items()}


def step_draws(env, keys):
    """JAX's command-change draws per key: (hit masks, values); none on
    Walker2d, whose step draws nothing."""
    if type(env).__name__ == "Walker2dEnv":
        return {}
    traj = type(env).__name__ == "CassieTrajEnv"

    def one(rng):
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)
        if traj:
            k1, k2 = jax.random.split(rng)
            return dict(orient_hit=jax.random.randint(k1, (), 0, 300) == 0,
                        orient_delta=u(k2, -env.max_orient_change,
                                       env.max_orient_change))
        k1, k2, k3, k4, k5, k6, k7, k8, k9 = jax.random.split(rng, 9)
        out = dict(
            orient_hit=jax.random.randint(k1, (), 0, 300) == 0,
            orient_delta=u(k2, -env.max_orient_change,
                           env.max_orient_change),
            speed_hit=jax.random.randint(k3, (), 0, 100) == 0,
            new_speed=u(k4, env.min_speed, env.max_speed),
            side_hit=jax.random.randint(k5, (), 0, 300) == 0,
            new_side=u(k6, env.min_side_speed, env.max_side_speed))
        if env.orient_jump_prob > 0:
            out.update(jump_size=u(k7, jnp.pi / 6, jnp.pi / 3),
                       jump_sign=jax.random.bernoulli(k8),
                       jump_hit=jax.random.uniform(k9, ())
                       < env.orient_jump_prob)
        return out
    return {k: np.asarray(v) for k, v in jax.vmap(one)(keys).items()}


def eval_draws(env, done, seed: int):
    """The draws of JAX's evaluation protocol with PRNGKey(seed) whose
    values the run used, sparsely: the first fleet reset's; each
    auto-reset's rows of the envs done (T, B) at that step; each step's
    hit masks (packed bits) and the values where they hit."""
    T, B = done.shape
    rng, key = jax.random.split(jax.random.PRNGKey(seed))
    out = {f"reset0_{k}": v
           for k, v in reset_draws(env, jax.random.split(key, B)).items()}
    steps, rows = [], []
    for t in range(T):
        rng, _, k_step, k_reset = jax.random.split(rng, 4)
        steps.append(step_draws(env, jax.random.split(k_step, B)))
        if done[t].any():
            r = reset_draws(env, jax.random.split(k_reset, B))
            rows.append({k: v[done[t]] for k, v in r.items()})
    out["reset_step"], out["reset_env"] = np.nonzero(done)
    for k in rows[0] if rows else ():
        out[f"reset_{k}"] = np.concatenate([r[k] for r in rows])
    for k in steps[0]:
        if k.endswith("_hit"):
            out[f"step_{k}"] = np.packbits(np.stack([s[k] for s in steps]),
                                           axis=-1)
    hit_of = {"orient_delta": "orient_hit", "new_speed": "speed_hit",
              "new_side": "side_hit", "jump_size": "jump_hit",
              "jump_sign": "jump_hit"}
    for k, h in hit_of.items():
        if k in steps[0]:
            mask = np.stack([s[h] for s in steps])
            out[f"step_{k}"] = np.stack([s[k] for s in steps])[mask]
    out.update(batch=np.int64(B), steps=np.int64(T), seed=np.int64(seed))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--path", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--n_episodes", type=int, default=64)
    p.add_argument("--traj_len", type=int, default=300)
    p.add_argument("--spread", type=int, default=0)
    args = p.parse_args(argv)
    ppo, state, _ = _loader()(args.path)
    env = ppo.env
    if getattr(env, "estimator_noise", 0.0) > 0:
        raise SystemExit("export_eval_draws: estimator noise is not saved")
    B, T = args.n_episodes, args.traj_len

    def policy_fn(_, obs):
        return state.actor.act(state.norm, obs, deterministic=True)

    t0 = time.time()
    runner0 = init_runner(env, jax.random.PRNGKey(args.seed), B)
    rollout = jax.jit(lambda r: rollout_scan(env, policy_fn, r, T, T))
    _, traj = rollout(runner0)
    done_len = np.asarray(traj.done_ep_len)
    n_done = int((done_len > 0).sum())
    ret = float(np.asarray(traj.done_ep_return).sum() / max(n_done, 1))
    length = float(done_len.sum() / max(n_done, 1))
    print(f"{args.path} seed {args.seed}: mean return {ret:.4f}, mean "
          f"length {length:.2f} ({time.time() - t0:.0f} s)", flush=True)

    out = eval_draws(env, done_len > 0, args.seed)
    out.update(jax_return=np.float64(ret), jax_length=np.float64(length))

    if args.spread:
        rng_np = np.random.default_rng(0)
        moved = []
        for _ in range(args.spread):
            q = runner0.env_state.phys.qpos
            scale = 1.0 + 1e-6 * rng_np.choice([-1.0, 1.0],
                                               size=q[:, 7:].shape)
            r = runner0.replace(env_state=runner0.env_state.replace(
                phys=runner0.env_state.phys.replace(
                    qpos=q.at[:, 7:].multiply(scale.astype(np.float32)))))
            _, tr = rollout(r)
            dl = np.asarray(tr.done_ep_len)
            moved.append(float(np.asarray(tr.done_ep_return).sum()
                               / max(int((dl > 0).sum()), 1)))
            print(f"  perturbed 1e-6: mean return {moved[-1]:.4f}",
                  flush=True)
        out["jax_perturbed_returns"] = np.float64(moved)
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({pathlib.Path(args.out).stat().st_size} B)")


if __name__ == "__main__":
    main()
