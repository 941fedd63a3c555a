"""The port's analysis and profiling tools (`apex_tpu_torch/runtime/
analysis.py`, `profiling.py`) and the step diagnostics they read against
the JAX package on the CPU.

The envs are tests/test_analysis.py's fixtures (the aslip CassieTrajEnv in
delta mode with the traj commands and the aslip_old reward, and CassieEnv
with the early_clock reward, dynamics randomization off) at 3 substeps per
policy step, in both stacks; the policy is the same linear map obs @ W in
both, W drawn with numpy. JAX's jobs draw from jax.random keys; the port
is handed those very draws (`jax_draws`: the key splits of JAX's
`rollout_record` and `perturb_response`, recomputed).

What is compared:
  * `rollout_record` end to end, both envs: the same keys, shapes and
    dtypes, and for the first steps every stream within the per-substep
    tolerances of tests/test_fleet_parity.py:39-68 plus twice the port's
    own spread when the joint positions of its reset state change by
    random factors 1 +- 1e-6 (four draws): contact onsets amplify f32
    noise over the substeps, in either stack;
  * the step info of both envs after one step (F4): JAX's keys, key for
    key, `motor_pos` the measured qpos;
  * `perturb_response` end to end on a short schedule, the same way;
  * `grf_profile`, `foot_placement_error`, `taskspace_tracking` and
    `input_and_state_record` on the same recorded rollout (JAX's), handed
    to both stacks' jobs in place of their rollouts: the same numbers;
  * and the port's jobs end to end on JAX's draws: JAX's keys and shapes.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.envs.cassie_traj import CassieTrajEnv as JaxCassieTrajEnv
from apex_tpu.physics.cassie_sim import MOTOR_QPOS_IDX
from apex_tpu.runtime import analysis as jax_analysis
from apex_tpu_torch.envs.cassie import CassieEnv
from apex_tpu_torch.envs.cassie_traj import CassieTrajEnv
from apex_tpu_torch.runtime import analysis, profiling
from test_torch_switches import reset_draws, step_draws
from test_torch_traj import traj_reset_draws, traj_step_draws

SIMRATE = 3
N_TRIALS = 2
T_CLOSE = 3        # steps of a record held to JAX's within the bounds
TRAJ = 10          # the aslip trajectory (32 steps per gait cycle)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run side by side in several worker processes: one
    torch thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def jax_draws(jenv, reset_fn, step_fn):
    """The port's `draws` function for JAX's key splits: trial i of a job
    at `seed` resets from split(split(PRNGKey(seed), n)[i])[0] and steps
    from split(split(...)[1], n_steps) (analysis.py:47-64, :283-290)."""
    def draws(seed, n_trials, n_steps):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_trials)
        pair = jax.vmap(jax.random.split)(keys)
        step_keys = jax.vmap(lambda k: jax.random.split(k, n_steps))(
            pair[:, 1])
        return (reset_fn(jenv, pair[:, 0]),
                [step_fn(jenv, step_keys[:, t]) for t in range(n_steps)])
    return draws


def _setup(kind):
    """(JAX env, port env, JAX policy, port policy, draws) of one env."""
    if kind == "aslip":
        config = dict(traj="aslip", command_profile="traj",
                      reward="aslip_old", dynamics_randomization=False,
                      simrate=SIMRATE)
        jenv, penv = JaxCassieTrajEnv(**config), CassieTrajEnv(
            device="cpu", **config)
        fns = (traj_reset_draws, traj_step_draws)
    else:
        config = dict(dynamics_randomization=False, reward="early_clock",
                      simrate=SIMRATE)
        jenv, penv = JaxCassieEnv(**config), CassieEnv(device="cpu",
                                                       **config)
        fns = (reset_draws, step_draws)
    W = (0.01 * np.random.default_rng(3).normal(
        size=(jenv.observation_size, jenv.action_size))).astype(np.float32)
    Wt = torch.tensor(W)
    return dict(jenv=jenv, penv=penv, jpol=lambda ob: ob @ W,
                ppol=lambda ob: ob @ Wt, draws=jax_draws(jenv, *fns))


@pytest.fixture(scope="module")
def aslip():
    """The aslip env and JAX's 2-trial, 128-step record on trajectory 10
    (four gait cycles: enough for every job's record)."""
    s = _setup("aslip")
    s["rec"] = jax_analysis.rollout_record(
        s["jenv"], s["jpol"], 128, traj_idx=TRAJ, seed=0, n_trials=N_TRIALS)
    return s


@pytest.fixture(scope="module")
def cassie():
    """CassieEnv and JAX's 2-trial, 8-step record at 2 m/s."""
    s = _setup("cassie")
    s["rec"] = jax_analysis.rollout_record(
        s["jenv"], s["jpol"], 8, speed=2.0, seed=0, n_trials=N_TRIALS)
    return s


# per-substep tolerances (rtol, atol) by stream: positions, velocities,
# forces (tests/test_fleet_parity.py:39-68); the PD targets (the policy's
# action on an observation holding velocities) and the reward (a function
# of velocity-level quantities: foot velocities, pelvis velocity, forces)
# take the velocities'; the phase, speed and falls must agree exactly
POS, VEL, FRC = (1e-4, 2e-5), (5e-2, 2e-2), (5e-2, 1.0)
TOL = dict(l_foot_frc=FRC, r_foot_frc=FRC, height=POS, grf_seq=FRC,
           foot_pos=POS, est_lfoot_pos=POS, est_rfoot_pos=POS, qpos=POS,
           pd_target=VEL, motor_pos=POS, motor_vel=VEL, motor_torque=FRC,
           reward=VEL, phase=(0, 0), speed=(0, 0), fallen=(0, 0))


def _port_record(s, n_steps, spread_draws=0, **kw):
    """The port's rollout_record on JAX's draws, and its spread over
    `spread_draws` reset states whose joint positions change by random
    factors 1 +- 1e-6."""
    run = lambda pre=None: analysis.rollout_record(
        s["penv"], s["ppol"], n_steps, seed=0, n_trials=N_TRIALS,
        draws=s["draws"], pre_state_fn=pre, **kw)
    rec = run()
    spread = {k: np.zeros(v.shape) for k, v in rec.items()}
    rng = np.random.default_rng(4)
    for _ in range(spread_draws):
        def pre(state):
            q = state.phys.qpos.clone()
            q[7:] *= torch.tensor(1.0 + 1e-6 * rng.choice(
                [-1.0, 1.0], size=q[7:].shape), dtype=q.dtype)
            return dataclasses.replace(
                state, phys=dataclasses.replace(state.phys, qpos=q))
        for k, v in run(pre).items():
            spread[k] = np.maximum(spread[k], np.abs(
                v.astype(np.float64) - rec[k]))
    return rec, spread


def _check_streams(got, ref, spread, steps):
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        assert got[k].shape == r.shape, (k, got[k].shape, r.shape)
        assert got[k].dtype.kind == r.dtype.kind, (k, got[k].dtype, r.dtype)
        rtol, atol = TOL[k]
        a, b = got[k][:, :steps].astype(np.float64), r[:, :steps]
        err = np.abs(a - b)
        bound = atol + rtol * np.abs(b) + 2 * spread[k][:, :steps]
        worst = np.unravel_index(np.argmax(err - bound), err.shape)
        assert (err <= bound).all(), (k, worst, err[worst], bound[worst])


@pytest.mark.parametrize("kind", ["cassie", "aslip"])
def test_rollout_record_matches_jax(kind, request):
    """rollout_record end to end on JAX's draws: JAX's keys, shapes and
    dtypes, and the first steps within the bounds."""
    s = request.getfixturevalue(kind)
    kw = dict(traj_idx=TRAJ) if kind == "aslip" else dict(speed=2.0)
    n = s["rec"]["qpos"].shape[1] if kind == "cassie" else 8
    got, spread = _port_record(s, n, spread_draws=4, **kw)
    ref = {k: v[:, :n] for k, v in s["rec"].items()}
    _check_streams(got, ref, spread, T_CLOSE)


@pytest.mark.parametrize("kind", ["cassie", "aslip"])
def test_step_info_matches_jax_key_for_key(kind, request):
    """F4: the step info of CassieEnv (envs/cassie.py:834-850) and
    CassieTrajEnv (envs/cassie_traj.py:456-466) carries JAX's keys, and
    after one step JAX's values (the same bounds); motor_pos is the
    measured qpos[MOTOR_QPOS_IDX], as in JAX, also where the firmware
    estimator filters the velocities."""
    s = request.getfixturevalue(kind)
    kw = dict(traj_idx=TRAJ) if kind == "aslip" else dict(speed=2.0)
    got, spread = _port_record(s, 1, spread_draws=4, **kw)
    ref = {k: v[:, :1] for k, v in s["rec"].items()}
    _check_streams(got, ref, spread, 1)
    if kind == "cassie":
        np.testing.assert_array_equal(got["motor_pos"],
                                      got["qpos"][..., MOTOR_QPOS_IDX])
        env = CassieEnv(device="cpu", simrate=SIMRATE, estimator="firmware")
        gen = torch.Generator()
        gen.manual_seed(0)
        state, _ = env.reset(env.sample_reset_noise(gen, 2))
        state, *_, info = env.step_info(state, torch.zeros(2, 10),
                                        env.sample_step_noise(gen, 2))
        torch.testing.assert_close(
            info["motor_pos"], state.phys.qpos[MOTOR_QPOS_IDX], rtol=0,
            atol=0)


def test_perturb_response_matches_jax(cassie):
    """perturb_response end to end on a short schedule (one step of wait,
    two of a 170 N push, one of recovery) at 4 angles x 2 phases, on JAX's
    draws: the pelvis trajectories within the bounds (the port's spread
    from the same 1e-6 changes of the pushed fleet's joint positions),
    the falls and survivals exactly."""
    s = cassie
    sched = dict(wait_steps=1, perturb_steps=2, recover_steps=1,
                 phases=[0, 8])
    ref = jax_analysis.perturb_response(s["jenv"], s["jpol"], **sched)
    run = lambda env: analysis.perturb_response(env, s["ppol"],
                                                draws=s["draws"], **sched)
    got = run(s["penv"])
    assert sorted(got) == sorted(ref)
    for k in ("angles", "phases", "survived", "fallen_seq", "push_window"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
    assert got["force"] == ref["force"]
    assert got["pelvis"].shape == ref["pelvis"].shape

    rng = np.random.default_rng(5)
    spread = np.zeros(got["pelvis"].shape)
    orig = analysis._rebuild_obs
    for _ in range(4):
        def rebuild(env, state):
            q = state.phys.qpos
            q[7:] *= torch.tensor(1.0 + 1e-6 * rng.choice(
                [-1.0, 1.0], size=q[7:].shape), dtype=q.dtype)
            return orig(env, state)
        analysis._rebuild_obs = rebuild
        try:
            spread = np.maximum(spread, np.abs(
                run(s["penv"])["pelvis"] - got["pelvis"]))
        finally:
            analysis._rebuild_obs = orig
    err = np.abs(got["pelvis"] - ref["pelvis"])
    assert (err <= 2e-5 + 1e-4 * np.abs(ref["pelvis"]) + 2 * spread).all()


# ---------------------------------------------------------------------------
# the jobs on the same record
# ---------------------------------------------------------------------------

def _same_record(monkeypatch, rec, trials=None):
    """Both stacks' jobs read `rec` (JAX's, cut to the steps a job asks
    for) in place of their rollouts."""
    def cut(n_steps, n):
        return {k: v[:n, :n_steps] for k, v in rec.items()}

    def jax_fake(env, policy_fn, n_steps, *a, n_trials=1, **kw):
        return cut(n_steps, n_trials)

    def port_fake(env, policy_fn, n_steps, reset_noise, step_noise, *a,
                  **kw):
        return cut(n_steps, trials or reset_noise.side_speed.shape[-1])

    monkeypatch.setattr(jax_analysis, "rollout_record", jax_fake)
    monkeypatch.setattr(analysis, "_record", port_fake)


def _assert_same(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_same(got[k], ref[k])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_same(a, b)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(ref, np.float64), rtol=1e-6,
                                   atol=1e-7)


def test_grf_profile_on_the_same_record(aslip, monkeypatch):
    """GRF_compare: one cycle of trajectory 10 after a cycle of wait."""
    kw = dict(traj_idx=TRAJ, n_cycles=1, wait_cycles=1, seeds=(0,))
    _same_record(monkeypatch, aslip["rec"])
    ref = jax_analysis.grf_profile(aslip["jenv"], aslip["jpol"], **kw)
    got = analysis.grf_profile(aslip["penv"], aslip["ppol"],
                               draws=aslip["draws"], **kw)
    _assert_same(got, ref)
    assert got["mean"].shape == (32 * SIMRATE, 2)


def test_foot_placement_on_the_same_record(aslip, monkeypatch):
    """parallelized.py's footstep error over four cycles, both trials."""
    kw = dict(traj_idx=TRAJ, num_steps=0, n_trials=N_TRIALS)
    _same_record(monkeypatch, aslip["rec"])
    ref = jax_analysis.foot_placement_error(aslip["jenv"], aslip["jpol"],
                                            **kw)
    got = analysis.foot_placement_error(aslip["penv"], aslip["ppol"],
                                        draws=aslip["draws"], **kw)
    _assert_same(got, ref)


def test_taskspace_tracking_on_the_same_record(aslip, monkeypatch):
    """taskspace_tracking's rows for trajectory 10, two cycles."""
    kw = dict(traj_indices=[TRAJ], n_cycles=1, ramp_cycles=1)
    _same_record(monkeypatch, aslip["rec"], trials=1)
    ref = jax_analysis.taskspace_tracking(aslip["jenv"], aslip["jpol"], **kw)
    got = analysis.taskspace_tracking(aslip["penv"], aslip["ppol"],
                                      draws=aslip["draws"], **kw)
    _assert_same(got, ref)


def test_input_and_state_record_on_the_same_record(cassie, monkeypatch):
    """vis_input_and_state's arrays and estimator deltas."""
    _same_record(monkeypatch, cassie["rec"])
    ref = jax_analysis.input_and_state_record(cassie["jenv"], cassie["jpol"],
                                              n_steps=8)
    got = analysis.input_and_state_record(cassie["penv"], cassie["ppol"],
                                          n_steps=8, draws=cassie["draws"])
    _assert_same(got, ref)


def test_jobs_run_end_to_end_on_jax_draws(aslip):
    """The port's fleets of trials through their own rollouts on JAX's
    draws: a seed or a speed per env, JAX's keys and shapes (the numbers
    are held above)."""
    s = aslip
    prof = analysis.grf_profile(s["penv"], s["ppol"], traj_idx=TRAJ,
                                n_cycles=1, wait_cycles=0, seeds=(0, 10),
                                draws=s["draws"])
    assert prof["mean"].shape == prof["std"].shape == (32 * SIMRATE, 2)
    assert np.isfinite(prof["mean"]).all() and prof["cycle_steps"] == 32
    rows = analysis.taskspace_tracking(s["penv"], s["ppol"],
                                       traj_indices=[TRAJ, 15],
                                       n_cycles=1, ramp_cycles=0,
                                       draws=s["draws"])
    assert [r["traj_idx"] for r in rows] == [TRAJ, 15]
    assert sorted(rows[0]) == ["lfoot_rms", "rfoot_rms", "speed",
                               "survived", "traj_idx"]


def test_profiling_trace_names_the_annotated_region(tmp_path, cassie):
    """profiling.trace writes a Chrome trace holding the annotate region
    around one policy step."""
    env = cassie["penv"]
    gen = torch.Generator()
    gen.manual_seed(0)
    state, obs = env.reset(env.sample_reset_noise(gen, 2))
    with profiling.trace(str(tmp_path)) as t:
        with profiling.annotate("policy_step"):
            env.step(state, cassie["ppol"](obs),
                     env.sample_step_noise(gen, 2))
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "policy_step" for e in events)
    assert t.path.startswith(str(tmp_path))
