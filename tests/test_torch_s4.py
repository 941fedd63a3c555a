"""The wiring of `scripts/s4_bisect.py`'s arms at a tiny size on the CPU.

On this host every "card" part of an arm is the CPU, so the arms cannot
differ in where their numbers are computed. What is held is the wiring:
the reference arm is the port's own `TD3` (init, collection, updates,
snapshot refresh, eval) bit for bit; each arm moves each part (the
fleet, the nets and optimisers, the acting snapshot, the ring, the
generators) between the places its arm names and nowhere else, counted
by the arm's names; the arms that keep the port's one generator (B1, B3,
B4) are the port's numbers bit for bit when both places are the CPU; and
B1 runs the fleet step through K2's and K3's plain versions, the others
through the wrappers.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from apex_tpu_torch.agents.td3 import TD3, TD3Config, copy_params
from apex_tpu_torch.envs.walker2d import Walker2dEnv
from apex_tpu_torch.physics import fleet

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "s4_bisect", ROOT / "scripts" / "s4_bisect.py")
s4 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(s4)

B, T, U, L, N_ITR, SEED = 4, 8, 3, 6, 2, 10
# iteration 0 is the random warm-up, iteration 1 acts with the snapshot;
# episodes of L steps reset inside each collection
CFG = TD3Config(num_envs=B, collect_steps=T, updates_per_iter=U,
                max_traj_len=L, start_timesteps=B * T, replay_size=256,
                async_mode=True)
STEPS = N_ITR * T                 # collection steps over the run
EVAL_STEPS = N_ITR * L            # eval steps (an eval every iteration)
# every move each arm makes over the run, by what moves
MOVES = {
    "card": {},
    "B1": {},
    "B2": {"obs": STEPS + EVAL_STEPS, "action": STEPS + EVAL_STEPS,
           "rows": 5 * N_ITR},
    "B3": {"init": 1, "action_draws": STEPS,
           "reset_draws": 2 * (STEPS + 1), "index_draws": N_ITR * U,
           "target_noise": N_ITR * U},
    "B4": {"init": 1, "batch": 5 * N_ITR * U, "target_noise": N_ITR * U,
           "actor_sync": N_ITR},
    "B3p": {"obs": STEPS + EVAL_STEPS, "action": STEPS + EVAL_STEPS,
            "rows": 5 * N_ITR},
}
ONE_GENERATOR = ("card", "B1", "B3", "B4")


def port_run():
    """The port's TD3 as the curve script's td3_async loop drives it."""
    td3 = TD3(Walker2dEnv(device="cpu"), CFG)
    state = td3.init(SEED)
    evals = []
    for it in range(N_ITR):
        copy_params(state.behavior, state.actor)
        state, _ = td3._train_iteration(state, it < 1)
        evals.append(td3._evaluate(state, s4.eval_generator("cpu", it)))
    return state, evals


def arm_run(name):
    b, state, curve = s4.run_arm(name, SEED, N_ITR, "cpu", CFG,
                                 eval_every=1, log=lambda s: None)
    return b, state, curve


def tensors(state):
    """Every tensor a run leaves: nets, targets, snapshot, optimiser
    moments, the ring, the fleet, the generator's state."""
    out = {}
    for name in ("actor", "actor_target", "behavior", "critic",
                 "critic_target"):
        for k, v in getattr(state, name).state_dict().items():
            out[f"{name}.{k}"] = v
    for name in ("actor_opt", "critic_opt"):
        opt = getattr(state, name)
        for i, (m, n) in enumerate(zip(opt.mu, opt.nu)):
            out[f"{name}.mu{i}"], out[f"{name}.nu{i}"] = m, n
    for f in state.replay.FIELDS:
        out[f"replay.{f}"] = getattr(state.replay, f)
    out["qpos"] = state.runner.env_state.qpos
    out["qvel"] = state.runner.env_state.qvel
    out["obs"] = state.runner.obs
    out["gen"] = state.generator.get_state()
    return out


@pytest.fixture(scope="module")
def port():
    state, evals = port_run()
    return tensors(state), [float(e["ep_return"]) for e in evals]


@pytest.mark.parametrize("name", ONE_GENERATOR)
def test_one_generator_arm_is_the_port_bit_for_bit(name, port):
    want, want_evals = port
    b, state, curve = arm_run(name)
    got = tensors(state)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert curve["eval_return"] == want_evals
    assert state.replay.size == N_ITR * B * T
    assert state.update_count == N_ITR * U


@pytest.mark.parametrize("name", sorted(s4.ARMS))
def test_arm_moves_what_it_names(name):
    b, state, curve = arm_run(name)
    assert dict(b.moves) == MOVES[name]
    assert b.arm == s4.ARMS[name]
    assert set(b.arm) == set(s4.PARTS)
    # each part on the device its arm names (the CPU here)
    dev = b.dev
    assert state.runner.obs.device == dev["env"]
    assert state.actor.out.weight.device == dev["update"]
    assert state.actor_opt.mu[0].device == dev["update"]
    assert state.critic_opt.nu[0].device == dev["update"]
    assert state.behavior.out.weight.device == dev["acting"]
    assert b.actor_act.out.weight.device == dev["acting"]
    assert state.replay.obs.device == dev["ring"]
    assert torch.device(state.generator.device) == dev["draws"]
    assert torch.device(b.env_gen.device) == dev["env_draws"]
    # one generator where the learner's and the env's draws share a place
    shared = b.arm["draws"] == b.arm["env_draws"]
    assert (b.env_gen is state.generator) == shared
    # the acting actor is the learner's where they share a place
    assert (b.actor_act is state.actor) == (b.arm["acting"]
                                           == b.arm["update"])
    assert len(curve["eval_return"]) == N_ITR
    assert np.all(np.isfinite(curve["eval_return"]))


@pytest.mark.parametrize("name", ["B2", "B3p"])
def test_two_generator_arms_draw_the_env_apart(name):
    """B2 and B3p give the env a generator of its own, seeded as the
    learner's: the nets start as the port's, the first fleet is the reset
    of a fresh generator's first draws, and a run repeats itself."""
    b = s4.Bisect(s4.ARMS[name], "cpu", CFG)
    state = b.init(SEED)
    ref = s4.Bisect(s4.ARMS["card"], "cpu", CFG).init(SEED)
    for k, v in ref.actor.state_dict().items():
        assert torch.equal(state.actor.state_dict()[k], v), k
    for k, v in ref.critic.state_dict().items():
        assert torch.equal(state.critic.state_dict()[k], v), k
    env = Walker2dEnv(device="cpu")
    first, _ = env.reset(env.sample_reset_noise(
        torch.Generator().manual_seed(SEED), B))
    assert torch.equal(state.runner.env_state.qpos, first.qpos)
    assert not torch.equal(ref.runner.env_state.qpos, first.qpos)
    a, c = (tensors(arm_run(name)[1]) for _ in range(2))
    assert all(torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("name", ["card", "B1"])
def test_b1_swaps_k2_and_k3_for_their_plain_versions(name, monkeypatch):
    calls = {"fk": 0, "inv": 0}
    fk, inv = fleet.fleet_fk, fleet.spd_inverse_bt

    def spy_fk(*a, **k):
        calls["fk"] += 1
        return fk(*a, **k)

    def spy_inv(*a, **k):
        calls["inv"] += 1
        return inv(*a, **k)

    monkeypatch.setattr(fleet, "fleet_fk", spy_fk)
    monkeypatch.setattr(fleet, "spd_inverse_bt", spy_inv)
    arm_run(name)
    # the wrappers: 4 substeps per env step, collection and eval
    want = 0 if name == "B1" else 4 * (STEPS + EVAL_STEPS)
    assert calls == {"fk": want, "inv": want}
    assert fleet.fleet_fk is spy_fk and fleet.spd_inverse_bt is spy_inv


def test_judge_counts_pairs():
    def curve(vals):
        return {"iters": np.arange(0, 10 * len(vals), 10),
                "eval_return": np.asarray(vals, float)}

    assert s4.smoothed_at(curve([1, 2, 3, 4, 5, 6]), 50, 50) == 5.0
    assert s4.smoothed_at(curve([1, 2, 3, 4, 5, 6]), 40, 50) == 4.5
    assert s4.smoothed_at(curve([1, 2, 3, 4, 5, 6, 100]), 50, 50) == 5.0


def test_judge_classes(tmp_path):
    paths = {}
    for name, level in [("a0", 10), ("a1", 11), ("a2", 12), ("r0", 1),
                        ("r1", 2), ("r2", 30)]:
        p = tmp_path / f"{name}.npz"
        np.savez(p, iters=np.arange(0, 60, 10),
                 eval_return=np.full(6, float(level)))
        paths[name] = str(p)
    arms = [paths[k] for k in ("a0", "a1", "a2")]
    refs = [paths[k] for k in ("r0", "r1", "r2")]
    out = s4.judge(arms, refs, [50])
    pt = out["points"][0]
    assert (pt["U"], pt["pairs"], pt["class"]) == (6, 9, "CPU-like")
    out = s4.judge(arms, refs[:2], [50])
    assert out["points"][0]["class"] == "card-like"


def test_probe_reads_the_matmul_settings():
    out = s4.probe(torch.device("cpu"))
    assert out["float32_matmul_precision"] == "highest"
    assert out["matmul_max_rel_err"] < 1e-5
