"""The port's math utilities, gait clock, reward and mirror tables against
the JAX package, element-wise on random batches drawn with numpy. The
port keeps the component axis first and the batch last; JAX keeps the
component last, so inputs and outputs are transposed between the two."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from apex_tpu.envs import base as jax_base
from apex_tpu.envs.cassie import CassieEnv as JaxCassieEnv
from apex_tpu.rewards import clock as jax_clock
from apex_tpu.utils import pchip as jax_pchip
from apex_tpu.utils import quaternion as jax_quat
from apex_tpu_torch.envs import base, cassie
from apex_tpu_torch.rewards import clock
from apex_tpu_torch.utils import pchip, quaternion

B = 16
T = lambda x: torch.tensor(np.moveaxis(np.asarray(x), 0, -1).copy())
J = lambda x: np.moveaxis(x.numpy(), -1, 0)


def _unit_quats(rng, n=B):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def test_quaternion_ops_match_jax():
    """Products, rotations, conversions and integration to f32 rounding."""
    rng = np.random.default_rng(0)
    q1, q2 = _unit_quats(rng), _unit_quats(rng)
    v = rng.normal(size=(B, 3)).astype(np.float32)
    close = lambda a, b: np.testing.assert_allclose(
        J(a), np.asarray(b), rtol=1e-5, atol=1e-6)
    tq1, tq2, tv = (torch.tensor(x.T.copy()) for x in (q1, q2, v))
    close(quaternion.quat_mul(tq1, tq2), jax_quat.quat_mul(q1, q2))
    close(quaternion.quat_inverse(tq1), jax_quat.quat_inverse(q1))
    close(quaternion.quat_rotate(tq1, tv), jax_quat.quat_rotate(q1, v))
    close(quaternion.quat_rotate_inv(tq1, tv), jax_quat.quat_rotate_inv(q1, v))
    close(quaternion.quat2euler(tq1), jax_quat.quat2euler(q1))
    mats = np.asarray(jax_quat.quat2mat(q1))
    np.testing.assert_allclose(
        quaternion.quat2mat(tq1).permute(2, 0, 1).numpy(), mats,
        rtol=1e-5, atol=1e-6)
    close(quaternion.mat2quat(torch.tensor(mats).permute(1, 2, 0)),
          jax_quat.mat2quat(mats))
    close(quaternion.quat_integrate(tq1, 3.0 * tv, 0.01),
          jax_quat.quat_integrate(q1, 3.0 * v, 0.01))
    z, y, x = rng.uniform(-3, 3, size=(3, B)).astype(np.float32)
    close(quaternion.euler2quat(z=torch.tensor(z), y=torch.tensor(y),
                                x=torch.tensor(x)),
          jax_quat.euler2quat(z=z, y=y, x=x))
    axis = v / np.linalg.norm(v, axis=1, keepdims=True)
    close(quaternion.axis_angle_to_quat(torch.tensor(axis.T.copy()),
                                        torch.tensor(z)),
          jax_quat.axis_angle_to_quat(axis, z))


def test_pchip_matches_jax():
    """Per-env knots (B envs of 24 knots, 4 channels), derivatives and
    evaluation inside and beyond the knot span."""
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.uniform(0.1, 1.0, size=(B, 24)), axis=1).astype(
        np.float32)
    y = rng.choice([-1.0, 0.0, 1.0], size=(B, 4, 24)).astype(np.float32)
    t = rng.uniform(-1.0, 16.0, size=B).astype(np.float32)
    d_ref = jax.vmap(jax_pchip.pchip_derivatives)(x, y)
    v_ref = jax.vmap(jax_pchip.pchip_eval)(x, y, d_ref, t)
    tx = torch.tensor(x.T.copy())                          # (24, B)
    ty = torch.tensor(np.transpose(y, (1, 2, 0)).copy())   # (4, 24, B)
    d = pchip.pchip_derivatives(tx, ty)
    np.testing.assert_allclose(np.transpose(d.numpy(), (2, 0, 1)),
                               np.asarray(d_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pchip.pchip_eval(tx, ty, d,
                                                torch.tensor(t)).numpy().T,
                               np.asarray(v_ref), rtol=1e-5, atol=1e-6)


def test_clock_and_early_clock_reward_match_jax():
    """Clock construction from commanded speeds and the early_clock reward
    on random per-step inputs."""
    rng = np.random.default_rng(2)
    f32 = lambda *s, lo=-1.0, hi=1.0: rng.uniform(lo, hi, size=s).astype(
        np.float32)
    speed = f32(B, lo=-0.3, hi=4.0)
    sw_j, st_j = jax_clock.speed_to_durations(speed)
    ck_j = jax.vmap(lambda a, b: jax_clock.build_clock(
        a, b, jax_clock.STANCE_ZERO, 0.1, True, 40.0))(sw_j, st_j)
    sw, st = clock.speed_to_durations(torch.tensor(speed))
    ck = clock.build_clock(sw, st, torch.tensor(
        [clock.STANCE_ZERO] * B).T.contiguous(), 0.1, True, 40.0)
    np.testing.assert_allclose(sw.numpy(), np.asarray(sw_j), rtol=1e-6)
    for name in ("x", "phaselen"):
        np.testing.assert_allclose(J(getattr(ck, name)),
                                   np.asarray(getattr(ck_j, name)),
                                   rtol=1e-5, atol=1e-5)
    for name in ("y", "d"):
        np.testing.assert_allclose(np.transpose(getattr(ck, name).numpy(),
                                                (2, 0, 1)),
                                   np.asarray(getattr(ck_j, name)),
                                   rtol=1e-5, atol=1e-5)

    qpos = np.zeros((B, 35), np.float32)
    qpos[:, 1:4] = f32(B, 3, lo=-0.2, hi=1.1)
    qvel = f32(B, 32, lo=-2, hi=2)
    vals = dict(l_foot_frc=f32(B, lo=0, hi=500), r_foot_frc=f32(B, lo=0, hi=500),
                l_foot_vel=f32(B, 3, lo=-3, hi=3), r_foot_vel=f32(B, 3, lo=-3, hi=3),
                l_foot_orient_cost=f32(B, lo=0, hi=0.5),
                r_foot_orient_cost=f32(B, lo=0, hi=0.5),
                phase=f32(B, lo=0, hi=30))
    ri_j = jax_clock.RewardInputs(
        qpos=qpos, qvel=qvel, speed=speed, pelvis_rot_vel=np.zeros((B, 3)),
        pelvis_accel=np.zeros((B, 3)), motor_torque=np.zeros((B, 10)),
        prev_torque=np.zeros((B, 10)), action=np.zeros((B, 10)),
        prev_action=np.zeros((B, 10)),
        est_lfoot_orient=np.zeros((B, 4)), est_rfoot_orient=np.zeros((B, 4)),
        **vals)
    r_j = jax.vmap(jax_clock.early_clock_reward)(ck_j, ri_j)
    ri = clock.RewardInputs(qpos=T(qpos), qvel=T(qvel),
                            speed=torch.tensor(speed),
                            **{k: T(v) for k, v in vals.items()})
    np.testing.assert_allclose(clock.early_clock_reward(ck, ri).numpy(),
                               np.asarray(r_j), rtol=1e-5, atol=1e-6)


def test_mirror_tables_match_jax():
    """Mirror matrices of the Cassie-v0 obs and actions, and the clock
    mirror."""
    env_j = JaxCassieEnv()
    env = cassie.CassieEnv(device="cpu")
    assert env.mirrored_obs == list(env_j.mirrored_obs)
    assert env.mirrored_acts == list(env_j.mirrored_acts)
    assert env.clock_inds == list(env_j.clock_inds)
    assert (env.observation_size, env.action_size) == (
        env_j.observation_size, env_j.action_size)
    for table in (env.mirrored_obs, env.mirrored_acts):
        np.testing.assert_array_equal(base.mirror_matrix(table),
                                      jax_base.mirror_matrix(table))
    obs = np.random.default_rng(3).normal(size=(B, 50)).astype(np.float32)
    np.testing.assert_array_equal(
        base.mirror_clock(torch.tensor(obs), env.clock_inds).numpy(),
        np.asarray(jax_base.mirror_clock(jnp.asarray(obs), env_j.clock_inds)))
