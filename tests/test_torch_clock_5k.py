"""The 5k suite's gait clock in the port against the JAX package's as the
5k compiles it, bit for bit, on the CPU.

Every trial of a 5k cell follows one discrete clock: at each schedule step
`update_speed_state` rebuilds the clock for the commanded speed and
floors the rescaled phase, then step_basic advances the phase by
phase_add and wraps it past the clock's length. No physics enters it, so
all trials of a (mission, speed) share one sequence, and the floor turns
one ulp of the clock's length into a frozen or a moving gait clock.

The JAX side is `eval_5k_matrix`'s program without the physics
(`apex_tpu/runtime/eval_suites.py`: `jax.jit(jax.vmap(single))`, the
schedule unbatched, a `lax.scan` over update_speed_state and the
heading); JAX has no function of its own for step_basic's phase advance,
so its three lines (`apex_tpu/envs/cassie.py:511-514`) are copied here.
The port runs its own `update_speed_state` and `_advance_phase`, all 24
schedules as one fleet (`eval_suites.gait_clock_5k`). The envs take
mk5c's settings at its own simrate (60 substeps, a clock of 33 steps a
second).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu.envs.trajectory import CommandTrajectory
from apex_tpu_torch.runtime import eval_suites
from test_torch_eval_suites import envs

NAMES = [f"{m}_{s}" for m in eval_suites.MISSIONS_5K
         for s in eval_suites.SPEEDS_5K]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tests run side by side in several worker processes: one torch
    thread each keeps them from oversubscribing the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _schedules():
    """{name: (speeds, orients, n)}: the mission schedules as
    eval_5k_matrix cuts them (trajlen - 1 steps)."""
    out = {}
    for name in NAMES:
        cmd = CommandTrajectory(name)
        n = cmd.trajlen - 1
        out[name] = (np.float32(cmd.speed_cmd[:n]),
                     np.float32(cmd.orient[:n]), n)
    return out


def _jax_sequences(jenv, scheds):
    """{name: (phase, counter, phaselen)} per step, each schedule padded
    to the longest as eval_5k_matrix pads it, so one program compiles."""

    def single(speeds, orients, key):
        state, _ = jenv.reset_for_test(key)

        def body(st, cmd):
            _, sp, orr = cmd
            st = jenv.update_speed_state(st, sp)
            st = st.replace(orient_add=orr)
            # step_basic's phase advance (apex_tpu/envs/cassie.py:511-514)
            phase = st.phase + st.phase_add
            wrapped = phase > st.clock.phaselen
            counter = st.counter + wrapped.astype(jnp.int32)
            phase = jnp.where(wrapped, 0.0, phase)
            st = st.replace(phase=phase, counter=counter)
            return st, (st.phase, st.counter, st.clock.phaselen)

        _, seq = jax.lax.scan(
            body, state, (jnp.arange(speeds.shape[0]), speeds, orients))
        return seq

    fn = jax.jit(jax.vmap(single, in_axes=(None, None, 0)))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    maxlen = max(n for _, _, n in scheds.values())
    out = {}
    for name, (sp, orr, n) in scheds.items():
        pad = lambda x: jnp.asarray(np.concatenate(
            [x, np.full(maxlen - n, x[-1], np.float32)]))
        seq = fn(pad(sp), pad(orr), keys)
        out[name] = tuple(np.asarray(x)[0, :n] for x in seq)
    return out


@pytest.fixture(scope="module")
def sequences():
    jenv, penv = envs("mk5c")
    assert jenv._freq == penv._freq == 33
    scheds = _schedules()
    return _jax_sequences(jenv, scheds), eval_suites.gait_clock_5k(penv)


def _first_differences(got, want):
    bad = np.flatnonzero(got != want)
    return (f"{bad.size} of {want.size} steps differ, first at "
            f"{bad[:5].tolist()}: port {got[bad[:5]].tolist()} JAX "
            f"{want[bad[:5]].tolist()}")


@pytest.mark.parametrize("name", NAMES)
def test_phase_and_counter_match_jax(sequences, name):
    """The phase after every step and the count of wrapped cycles."""
    (jphase, jcount, _), (pphase, pcount, _) = (sequences[0][name],
                                                 sequences[1][name])
    assert np.array_equal(pphase, jphase), _first_differences(pphase, jphase)
    assert np.array_equal(pcount, jcount), _first_differences(pcount, jcount)


@pytest.mark.parametrize("name", NAMES)
def test_phaselen_matches_jax(sequences, name):
    """The clock's length after every update_speed_state: the quantity
    the floor divides by, and whose ulp decides where the clock
    freezes."""
    jlen, plen = sequences[0][name][2], sequences[1][name][2]
    assert np.array_equal(plen.view(np.int32), jlen.view(np.int32)), \
        _first_differences(plen, jlen)


def _round_f32(q):
    """The exact rational q rounded once to float32, ties to even."""
    from fractions import Fraction

    f = np.float32(float(q))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    dist = [abs(Fraction(float(c)) - q) for c in cands]
    best = min(dist)
    near = [c for c, d in zip(cands, dist) if d == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """`fma_f32` against a * b + c computed exactly and rounded once: on
    random floats, and on the two sums whose float64 value is a tie
    between two floats while the exact value lies past it (a double
    rounding would give the even neighbour, the wrong one here)."""
    from fractions import Fraction

    from apex_tpu_torch.rewards.clock import fma_f32

    u = 2.0 ** -23
    a = [2.0 ** -12 * (1 + u), -(2.0 ** -12) * (1 + u)]
    b = [2.0 ** -12 * (1 - u)] * 2
    c = [1 + u] * 2
    rng = np.random.default_rng(0)
    n = 2000
    a += list(rng.uniform(-4, 4, n) * 2.0 ** rng.integers(-30, 3, n))
    b += list(rng.uniform(-4, 4, n))
    c += list(rng.uniform(-4, 4, n))
    a, b, c = (np.float32(x) for x in (a, b, c))
    got = fma_f32(torch.as_tensor(a), torch.as_tensor(b),
                  torch.as_tensor(c)).numpy()
    want = np.float32([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)])
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[0] == got[1] == np.float32(1 + u)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[0] != got[0] and naive[1] != got[1]
