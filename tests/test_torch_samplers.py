"""PyTorch port, schedules and samplers: every beta schedule, the forward
process helpers, the DDIM spacings, and the DDIM, UniPC, DPM-Solver(++)
and PLMS loops and the DDIM inversion pair against the JAX package on the
same deterministic epsilon field (no model)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prompt_diffusion_tpu.pipelines import control_window as jcw
from prompt_diffusion_tpu.schedulers import ddim as jddim
from prompt_diffusion_tpu.schedulers import dpm_solver as jdpm
from prompt_diffusion_tpu.schedulers import plms as jplms
from prompt_diffusion_tpu.schedulers import schedules as jsched
from prompt_diffusion_tpu.schedulers import unipc as junipc
from prompt_diffusion_tpu_torch.pipelines import control_window as cw
from prompt_diffusion_tpu_torch.schedulers import ddim, dpm_solver, plms, schedules, unipc

torch.set_num_threads(2)

STEPS = (1, 2, 3, 5, 10, 25)
# the loops against JAX: max |port - JAX| within REL of max |JAX|
REL = 1e-5
SHAPE = (2, 4, 6, 5)
SCHEDULES = ("linear", "cosine", "sqrt_linear", "sqrt")
FIELDS = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
          "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2")


def _schedule_kwargs(name):
    # the sqrt schedules with the ldm defaults (their betas stay below 1)
    return {} if name in ("linear", "cosine") else dict(linear_start=1e-4, linear_end=2e-2)


def _field():
    """A deterministic epsilon field on the same inputs in both frameworks:
    eps(x, t) = 0.3 cos(t / 250) x + sin(t / 170) base."""
    base = np.random.default_rng(0).normal(size=SHAPE).astype(np.float32)
    x_T = np.random.default_rng(1).normal(size=SHAPE).astype(np.float32)

    def j_eps(x, t):
        tf = t.astype(jnp.float32)[:, None, None, None]
        return 0.3 * jnp.cos(tf / 250.0) * x + jnp.sin(tf / 170.0) * jnp.asarray(base)

    base_t = torch.from_numpy(base)

    def t_eps(x, t):
        tf = t.float()[:, None, None, None]
        return 0.3 * torch.cos(tf / 250.0) * x + torch.sin(tf / 170.0) * base_t

    return x_T, j_eps, t_eps


def _close(got, ref, rel=REL):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("name", SCHEDULES)
def test_beta_schedules_match(name):
    ref = jsched.DiffusionSchedule.create(schedule=name, **_schedule_kwargs(name))
    got = schedules.DiffusionSchedule.create(schedule=name, **_schedule_kwargs(name))
    for f in FIELDS:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f)
        assert g.dtype == np.float32 and g.shape == r.shape, f
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=0, err_msg=f)
    np.testing.assert_array_equal(
        schedules.make_beta_schedule(name, 100), jsched.make_beta_schedule(name, 100))
    with pytest.raises(ValueError, match="unknown"):
        schedules.make_beta_schedule("exp", 10)


@pytest.mark.parametrize("name", ("linear", "cosine"))
def test_forward_process_helpers_match(name):
    ref = jsched.DiffusionSchedule.create(schedule=name)
    got = schedules.DiffusionSchedule.create(schedule=name)
    rng = np.random.default_rng(2)
    x, noise = (rng.normal(size=(3, 4, 5, 6)).astype(np.float32) for _ in range(2))
    t = np.asarray([0, 517, 999], np.int32)
    jx, jn, jt = jnp.asarray(x), jnp.asarray(noise), jnp.asarray(t)
    tx, tn, tt = torch.from_numpy(x), torch.from_numpy(noise), torch.from_numpy(t)
    pairs = {
        "q_sample": (got.q_sample(tx, tt, tn), ref.q_sample(jx, jt, jn)),
        "get_v": (got.get_v(tx, tn, tt), ref.get_v(jx, jn, jt)),
        "start_from_z_and_v": (got.predict_start_from_z_and_v(tx, tt, tn),
                               ref.predict_start_from_z_and_v(jx, jt, jn)),
        "eps_from_z_and_v": (got.predict_eps_from_z_and_v(tx, tt, tn),
                             ref.predict_eps_from_z_and_v(jx, jt, jn)),
        "start_from_noise": (got.predict_start_from_noise(tx, tt, tn),
                             ref.predict_start_from_noise(jx, jt, jn)),
    }
    for k, (g, r) in pairs.items():
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("method", ("uniform", "quad"))
def test_ddim_timesteps_bit_equal(method):
    for s in (1, 2, 3, 7, 30, 50, 250):
        np.testing.assert_array_equal(schedules.make_ddim_timesteps(s, 1000, method),
                                      jsched.make_ddim_timesteps(s, 1000, method))
    ref = jddim.DDIMTables.create(jsched.DiffusionSchedule.create(), 20, eta=0.3, method=method)
    got = ddim.DDIMTables.create(schedules.DiffusionSchedule.create(), 20, eta=0.3,
                                 method=method)
    for f in ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas", "sigmas"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(ref, f)), err_msg=f)
    with pytest.raises(NotImplementedError):
        schedules.make_ddim_timesteps(10, 1000, "cubic")


@pytest.mark.parametrize("temperature", (1.0, 0.6))
def test_ddim_step_with_noise_matches(temperature):
    ref_t = jddim.DDIMTables.create(jsched.DiffusionSchedule.create(), 10, eta=0.7)
    got_t = ddim.DDIMTables.create(schedules.DiffusionSchedule.create(), 10, eta=0.7)
    rng = np.random.default_rng(3)
    x, eps, z = (rng.normal(size=SHAPE).astype(np.float32) for _ in range(3))
    for index in (0, 4, 9):
        ref, ref0 = jddim.ddim_step(jnp.asarray(x), jnp.asarray(eps), index, ref_t,
                                    noise=jnp.asarray(z), temperature=temperature)
        got, got0 = ddim.ddim_step(torch.from_numpy(x), torch.from_numpy(eps), index, got_t,
                                   noise=torch.from_numpy(z), temperature=temperature)
        _close(got, ref)
        _close(got0, ref0)


@pytest.mark.parametrize("steps", STEPS)
def test_ddim_and_plms_loops_match(steps):
    x_T, j_eps, t_eps = _field()
    ref_t = jddim.DDIMTables.create(jsched.DiffusionSchedule.create(), steps)
    got_t = ddim.DDIMTables.create(schedules.DiffusionSchedule.create(), steps)
    _close(ddim.ddim_sample_loop(t_eps, torch.from_numpy(x_T), got_t),
           jddim.ddim_sample_loop(j_eps, jnp.asarray(x_T), ref_t))
    _close(plms.plms_sample_loop(t_eps, torch.from_numpy(x_T), got_t),
           jplms.plms_sample_loop(j_eps, jnp.asarray(x_T), ref_t))


def test_plms_step_zero_evaluates_twice():
    _, _, t_eps = _field()
    calls = []
    tables = ddim.DDIMTables.create(schedules.DiffusionSchedule.create(), 4)
    plms.plms_sample_loop(lambda x, t: calls.append(int(t[0])) or t_eps(x, t),
                          torch.zeros(SHAPE), tables)
    ts = tables.timesteps[::-1].tolist()
    assert calls == [ts[0], ts[1]] + ts[1:]


@pytest.mark.parametrize("steps", STEPS)
def test_unipc_matches_jax(steps):
    x_T, j_eps, t_eps = _field()
    ref_t = junipc.UniPCTables.create(jsched.DiffusionSchedule.create(), steps)
    got_t = unipc.UniPCTables.create(schedules.DiffusionSchedule.create(), steps)
    for f in ("timesteps", "pred_order", "corr_order", "alpha_cur", "lambda_next"):
        np.testing.assert_array_equal(getattr(got_t, f), np.asarray(getattr(ref_t, f)))
    _close(unipc.unipc_sample_loop(t_eps, torch.from_numpy(x_T), got_t),
           junipc.unipc_sample_loop(j_eps, jnp.asarray(x_T), ref_t))


@pytest.mark.parametrize("steps", STEPS)
def test_dpm_solver_matches_jax(steps):
    """Orders 1-3, data and noise prediction, and the 2M fast path."""
    x_T, j_eps, t_eps = _field()
    ref_t = jdpm.DPMTables.create(jsched.DiffusionSchedule.create(), steps)
    got_t = dpm_solver.DPMTables.create(schedules.DiffusionSchedule.create(), steps)
    np.testing.assert_array_equal(got_t.lam, np.asarray(ref_t.lam))
    for order in (1, 2, 3):
        np.testing.assert_array_equal(dpm_solver._order_schedule(steps, order, True),
                                      jdpm._order_schedule(steps, order, True))
        for predict_x0 in (True, False):
            _close(dpm_solver.dpm_solver_multistep_loop(
                       t_eps, torch.from_numpy(x_T), got_t, order=order, predict_x0=predict_x0),
                   jdpm.dpm_solver_multistep_loop(
                       j_eps, jnp.asarray(x_T), ref_t, order=order, predict_x0=predict_x0))
    _close(dpm_solver.dpm_solver_pp_2m_loop(t_eps, torch.from_numpy(x_T), got_t),
           jdpm.dpm_solver_pp_2m_loop(j_eps, jnp.asarray(x_T), ref_t))
    with pytest.raises(ValueError, match="order"):
        dpm_solver.dpm_solver_multistep_loop(t_eps, torch.from_numpy(x_T), got_t, order=4)


def test_dpm_order_schedule_long_runs_keep_their_order():
    """lower_order_final applies only below 15 steps."""
    assert dpm_solver._order_schedule(20, 3, True).tolist() == [1, 2] + [3] * 18
    assert dpm_solver._order_schedule(5, 3, True).tolist() == [1, 2, 3, 2, 1]
    assert dpm_solver._order_schedule(5, 3, False).tolist() == [1, 2, 3, 3, 3]


@pytest.mark.parametrize("t_enc", (0, 3, 8))
def test_ddim_encode_decode_loops_match(t_enc):
    x_T, j_eps, t_eps = _field()
    ref_t = jddim.DDIMTables.create(jsched.DiffusionSchedule.create(), 8)
    got_t = ddim.DDIMTables.create(schedules.DiffusionSchedule.create(), 8)
    enc = ddim.ddim_encode_loop(t_eps, torch.from_numpy(x_T), got_t, t_enc)
    ref_enc = jddim.ddim_encode_loop(j_eps, jnp.asarray(x_T), ref_t, t_enc)
    _close(enc, ref_enc)
    _close(ddim.ddim_decode_loop(t_eps, enc, got_t, t_enc),
           jddim.ddim_decode_loop(j_eps, ref_enc, ref_t, t_enc))
    with pytest.raises(ValueError, match="t_start"):
        ddim.ddim_decode_loop(t_eps, enc, got_t, 9)


def test_stochastic_encode_draws_from_the_generator():
    tables = ddim.DDIMTables.create(schedules.DiffusionSchedule.create(), 10)
    x0 = torch.from_numpy(np.random.default_rng(4).normal(size=SHAPE).astype(np.float32))
    got = ddim.stochastic_encode(x0, 6, tables, torch.Generator().manual_seed(5))
    noise = torch.randn(SHAPE, generator=torch.Generator().manual_seed(5))
    a = tables.alphas[6]
    np.testing.assert_array_equal(
        got.numpy(), (float(np.sqrt(a)) * x0 + float(np.sqrt(1.0 - a)) * noise).numpy())
    ref_a = np.asarray(jddim.DDIMTables.create(jsched.DiffusionSchedule.create(), 10).alphas[6])
    assert a == ref_a


@pytest.mark.parametrize("table", ("ddim", "unipc", "dpm"))
def test_step_index_from_timestep_matches(table):
    """Ascending (DDIM) and descending (UniPC, DPM) tables, and a DDIM
    table longer than the requested steps (1000 % 30 != 0)."""
    sched = schedules.DiffusionSchedule.create()
    ts = {"ddim": ddim.DDIMTables.create(sched, 30).timesteps,
          "unipc": unipc.UniPCTables.create(sched, 7).timesteps,
          "dpm": dpm_solver.DPMTables.create(sched, 7).timesteps}[table]
    for t in list(ts) + [0, 999]:
        assert cw.step_index_from_timestep(ts, int(t)) == int(
            jcw.step_index_from_timestep(jnp.asarray(ts), int(t)))
